// Flash-attention forward for Hopper (sm_90a): the LM stack's prefill and
// full-sequence attention.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// _flash_kernel (entry flash_attention_fwd).  q, k, v (BH, S, D) in f32 or
// bf16 -> out (BH, S, D) in q's dtype: scores q.k * (1/sqrt(D)) in f32,
// masked row >= col with -1e30 when causal, an online softmax over the kv
// tiles in order, out = acc / max(l, 1e-30), rounded once.  Any D from 1
// to 256: D is padded with zeros inside the shared-memory tiles to the
// next instantiated width (16, 32, 64, 80, 96, 112, 128, 192, 256), so
// the wrapper allocates no padded copies.
//
// What bounds it on the card: by the roofline, operations.  At the smollm
// prefill (BH = 72, S = 2048, D = 64, causal, bf16) it moves 75.5 MB
// (q, k, v read once, out written once: 22.5 us at 3.35 TB/s) and does
// 4 * BH * D * (S^2 + S) / 2 = 38.7 GFLOP (39 us on the bf16 tensor cores).
//
// bf16 inputs (the LM's path) run on the tensor cores.  A CTA holds two
// consumer warpgroups (256 threads); each owns 64 query rows of one
// (batch, head), and the two share every K/V tile, which halves the
// tiles' traffic from L2 per query row.  Thread 0 loads the query tiles
// once and the K/V tiles through a ring of 2-4 stages with TMA (a 2-D
// tensor map over the (BH * S, D) tensor, one box of 8 columns by the
// tile's rows per 8-column chunk) completing on mbarriers; a D that is
// not a multiple of 8, or rows that are not 16-byte aligned, are loaded
// element by element instead, one tile at a time.  Tiles are kept in the
// no-swizzle core-matrix layout that wgmma reads: 8-column chunks one
// after another, each chunk rows x 8 contiguous, so any D that is a
// multiple of 16 after padding fits, and out-of-range rows and chunks
// arrive as zeros.
//   S = Q K^T    wgmma m64nKBNk16 (KBN = 64, or 32 above D = 128), both
//                operands from shared memory (K-major), over D / 16 slabs;
//                f32 accumulators.
//   softmax      on the accumulator fragment in registers: row max over
//                the quad with two shuffles, p = 2^(s c - m) as one fmaf
//                and one ex2 (c = scale * log2(e)); the row sum l is kept
//                per thread from the f32 probabilities and summed over the
//                quad once at the end.
//   O += P V     wgmma with A from registers and V from shared memory
//                (MN-major, transposed), twice: P_hi = bf16(P) truncated
//                and P_lo = bf16(P - P_hi) rounded.  The split keeps about
//                16 significant bits of P, so the result stays within one
//                bf16 ULP of the plain version (which keeps P in f32) even
//                where an output cancels toward zero; it costs 1.5x the
//                bound's operations.  The accumulator fragment of m64nN is
//                the A fragment of m64nNk16 once packed to bf16 pairs, so
//                P never leaves the registers.
// The three run as a software pipeline inside each warpgroup: S of tile
// kt and PV of tile kt - 1 are issued together, and the softmax of tile
// kt overlaps PV of tile kt - 1 on the tensor cores.  Every register an
// in-flight wgmma reads is fenced until its wait, or ptxas serializes all
// wgmma of the kernel.  Causal: the kv loop stops at the last tile a row
// of the CTA can see, only the diagonal and ragged tiles are masked, and
// the CTAs of a group of heads run together, longest query tiles first.
//
// f32 inputs stay on the f32 cores (TF32 would not hold the 2e-5 f32
// gate): 4 warps, a warp per 16 query rows, Q and one K/V tile in shared
// memory as f32 (K rows padded to DP + 1, conflict-free), scores two
// columns a lane with explicit fmaf, the row max and sum by shuffles.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

extern "C" {

// Mirrored by repro_torch/kernels/flash_attention.py::_Params.
struct FlashParams {
  const void* q;     // (BH, S, D)
  const void* k;     // (BH, S, D)
  const void* v;     // (BH, S, D)
  void* out;         // (BH, S, D)
  int bh, s, d;
  int causal;        // 1: mask row < col
  int dtype;         // 0: f32, 1: bf16
  float scale;       // 1 / sqrt(D)
};

}  // extern "C"

namespace {

constexpr int kTile = 64;                      // query rows a CTA
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kTile / kWarps;          // query rows a warp (f32)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kHeadGroup = 8;                  // heads whose CTAs run together

// The (head, query tile) of this CTA in a 1-D grid of bh * n_q CTAs: the
// heads go in groups of kHeadGroup, and within a group the longest causal
// query tiles come first, head by head.  The CTAs resident at one time
// then share the K/V tiles of a few heads, which stay in L2.
__device__ __forceinline__ void cta_tile(int bh, int n_q, int& head,
                                         int& qt) {
  const int b = (int)blockIdx.x;
  const int h0 = b / (kHeadGroup * n_q) * kHeadGroup;
  const int heads = min(kHeadGroup, bh - h0);
  const int r = b - h0 * n_q;
  head = h0 + r % heads;
  qt = n_q - 1 - r / heads;
}

// ---------------------------------------------------------------- f32 path

template <int DP>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (size_t)kTile * (3 * DP + 1);
}

// Rows row0 .. row0 + 63 of one (S, d) slab into dst[r * stride + c] as
// f32, zeros past S and at and past column d.
template <int DP>
__device__ __forceinline__ void load_tile_f32(float* dst, int stride,
                                              const float* src, int row0,
                                              int s, int d) {
  for (int i = threadIdx.x; i < kTile * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    const int row = row0 + r;
    dst[r * stride + c] = row < s && c < d ? src[(size_t)row * d + c] : 0.f;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(
    const FlashParams p) {
  constexpr int kCpl = (DP + 31) / 32;         // accumulator columns a lane
  constexpr int kKStride = DP + 1;
  extern __shared__ float smem[];
  float* qs = smem;                            // (64, DP)
  float* ks = qs + kTile * DP;                 // (64, DP + 1)
  float* vs = ks + kTile * kKStride;           // (64, DP)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d = p.d;
  const int n_tiles = (p.s + kTile - 1) / kTile;
  int head, qt;
  cta_tile(p.bh, n_tiles, head, qt);
  const int q0 = qt * kTile;
  const size_t base = (size_t)head * p.s * d;
  const float* q = static_cast<const float*>(p.q) + base;
  const float* k = static_cast<const float*>(p.k) + base;
  const float* v = static_cast<const float*>(p.v) + base;
  float* out = static_cast<float*>(p.out) + base;

  load_tile_f32<DP>(qs, DP, q, q0, p.s, d);
  const float* qw = qs + warp * kRows * DP;

  float m[kRows], l[kRows], acc[kRows][kCpl];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kCpl; ++j) acc[r][j] = 0.f;
  }

  const int last = p.causal ? qt : n_tiles - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                           // the last tile's readers
    load_tile_f32<DP>(ks, kKStride, k, k0, p.s, d);
    load_tile_f32<DP>(vs, DP, v, k0, p.s, d);
    __syncthreads();

    // scores of columns k0 + lane and k0 + lane + 32 for the warp's rows
    float s0[kRows], s1[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s0[r] = s1[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      const float ka = ks[lane * kKStride + c];
      const float kb = ks[(lane + 32) * kKStride + c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = qw[r * DP + c];
        s0[r] = fmaf(qv, ka, s0[r]);
        s1[r] = fmaf(qv, kb, s1[r]);
      }
    }

    // online softmax: s0 / s1 become the tile's probabilities
    const int ca = k0 + lane, cb = ca + 32;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + warp * kRows + r;
      float a = s0[r] * p.scale, b = s1[r] * p.scale;
      if (ca >= p.s || (p.causal && ca > row)) a = kNegInf;
      if (cb >= p.s || (p.causal && cb > row)) b = kNegInf;
      float mx = fmaxf(a, b);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float pa = expf(a - m_new), pb = expf(b - m_new);
      const float alpha = expf(m[r] - m_new);
      float sum = pa + pb;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kCpl; ++j) acc[r][j] *= alpha;
      s0[r] = pa;
      s1[r] = pb;
    }

    // acc += p @ v: column c's probability comes from lane c % 32
#pragma unroll 2
    for (int c = 0; c < 32; ++c) {
      float va[kCpl], vb[kCpl];
#pragma unroll
      for (int j = 0; j < kCpl; ++j) {
        const int col = lane + 32 * j;
        va[j] = col < DP ? vs[c * DP + col] : 0.f;
        vb[j] = col < DP ? vs[(c + 32) * DP + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pa = __shfl_sync(kFull, s0[r], c);
        const float pb = __shfl_sync(kFull, s1[r], c);
#pragma unroll
        for (int j = 0; j < kCpl; ++j) {
          acc[r][j] = fmaf(pa, va[j], acc[r][j]);
          acc[r][j] = fmaf(pb, vb[j], acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= p.s) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCpl; ++j) {
      const int col = lane + 32 * j;
      if (col < d) out[(size_t)row * d + col] = acc[r][j] / den;
    }
  }
}

// --------------------------------------------------------------- bf16 path

using bf16 = __nv_bfloat16;

// 2^x on the MUFU unit, results below 2^-126 flushed to zero (they add
// nothing to a row sum of at least 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Element (r, c) of an R-row tile in the core-matrix layout: 8-column
// chunks one after another, each an (R, 8) row-major block of 16-byte rows.
template <int R>
__device__ __forceinline__ int cm_off(int r, int c) {
  return (c >> 3) * (R * 8) + r * 8 + (c & 7);
}

// A wgmma shared-memory descriptor, no swizzle: the start address, the
// leading byte offset (between the core matrices along K for a K-major
// operand, along K for an MN-major one) and the stride byte offset
// (between 8-row groups along M or N), all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(const void* ptr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(ptr) & 0x3FFFF) >> 4)
      | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
      | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// The same tile element by element, for a d that is not a multiple of 8
// or rows that are not 16-byte aligned.
template <int R, int DP, int NT>
__device__ __forceinline__ void load_tile_sync(bf16* dst, const bf16* src,
                                               int row0, int s, int d) {
  for (int i = threadIdx.x; i < R * DP; i += NT) {
    const int r = i / DP, c = i % DP;
    const int row = row0 + r;
    dst[cm_off<R>(r, c)] = row < s && c < d ? src[(size_t)row * d + c]
                                            : __float2bfloat16_rn(0.f);
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// One TMA copy of a box of `map` at (c0 = column, c1 = row) into dst,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(smem_u32(bar)) : "memory");
}

// The R-row tile at global row `row` of a (rows, d) tensor into the
// core-matrix tile dst (R, DP): one box of 8 columns by R rows a chunk,
// which lands as that chunk's (R, 8) block.  Rows past the tensor and
// chunks past d are zero-filled by the TMA unit.
template <int R, int DP>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map,
                                         int row, uint64_t* bar) {
#pragma unroll
  for (int ch = 0; ch < DP / 8; ++ch)
    tma_load(dst + ch * R * 8, map, ch * 8, row, bar);
}

// Shared-memory writes of this thread (the element-wise loads) made
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of this warpgroup's committed wgmma groups are
// still running (groups complete in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins accumulator registers across the asynchronous wgmma: no read or
// write of them moves over this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// The same for A fragments read from registers: they must stay untouched
// (and their registers unused) until the wgmma that reads them completes.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
  }
}

// d[64 x 64] (+)= A * B^T: A (64 x 16) and B (64 x 16) in shared
// memory, both K-major.
template <int OFF, int NR>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[NR], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 32] (+)= A * B^T: A (64 x 16) and B (32 x 16) in shared
// memory, both K-major.
template <int OFF, int NR>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[NR], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] += A * B: A (64 x 16) bf16 pairs in registers, B (16 x 64)
// in shared memory, MN-major (transposed).
template <int OFF, int NR>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[NR],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 32] += A * B: A (64 x 16) bf16 pairs in registers, B (16 x 32)
// in shared memory, MN-major (transposed).
template <int OFF, int NR>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[NR],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 16] += A * B: A (64 x 16) bf16 pairs in registers, B (16 x 16)
// in shared memory, MN-major (transposed).
template <int OFF, int NR>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[NR],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// o[64 x DP] += A (registers, one 16-column kv slab) * V slab (16 x DP):
// DP in chunks of 64, then 32 and 16 columns.  desc points at the slab's
// first column chunk; the next 8 columns are kBn core matrices on.
template <int DP, int BN>
__device__ __forceinline__ void pv_slab(float (&o)[DP / 2],
                                        const uint32_t (&a)[4],
                                        uint64_t desc) {
  constexpr uint64_t kChunk = BN * 16 / 16;    // 8 columns, in 16-byte units
  constexpr int kN64 = DP / 64;
  constexpr int kRem = DP % 64;
  if constexpr (kN64 >= 1) wgmma_rs_n64<0>(o, a, desc);
  if constexpr (kN64 >= 2) wgmma_rs_n64<32>(o, a, desc + 8 * kChunk);
  if constexpr (kN64 >= 3) wgmma_rs_n64<64>(o, a, desc + 16 * kChunk);
  if constexpr (kN64 >= 4) wgmma_rs_n64<96>(o, a, desc + 24 * kChunk);
  static_assert(kN64 <= 4, "at most 256 columns");
  if constexpr ((kRem & 32) != 0)
    wgmma_rs_n32<kN64 * 32>(o, a, desc + kN64 * 8 * kChunk);
  if constexpr ((kRem & 16) != 0)
    wgmma_rs_n16<kN64 * 32 + (kRem & 32) / 2>(
        o, a, desc + (kN64 * 8 + (kRem & 32) / 8) * kChunk);
}

template <int DP>
struct Bf16Tiles {
  // consumer warpgroups a CTA, each with its own 64 query rows; they share
  // every K/V tile, which halves the tiles' traffic from L2 per query row
  static constexpr int kWg = 2;
  static constexpr int kThreadsCta = kWg * kThreads;
  static constexpr int kRows = kWg * kTile;        // query rows a CTA
  static constexpr int kBn = DP > 128 ? 32 : 64;   // kv rows a tile
  // stages of the K/V ring, and CTAs an SM is meant to hold
  // (measured on the H100: at D <= 64 two CTAs an SM, registers capped at
  // 128, beat one CTA with more registers by a third)
  static constexpr int kStages = DP <= 64 ? 4 : (DP <= 128 ? 3 : 2);
  static constexpr int kMinBlocks = DP <= 64 ? 2 : 1;
  static constexpr int kQ = kTile * DP;            // elements a warpgroup
  static constexpr int kKv = kBn * DP;
  static constexpr size_t kSmem =
      sizeof(bf16) * (size_t)(kWg * kQ + 2 * kStages * kKv);
};

// use_tma: q, k and v are read through the tensor maps tq, tk, tv (d % 8
// == 0, 16-byte aligned); otherwise element by element, one tile at a time.
template <int DP>
__global__ void __launch_bounds__(Bf16Tiles<DP>::kThreadsCta,
                                  Bf16Tiles<DP>::kMinBlocks)
    flash_bf16_kernel(const FlashParams p,
                      const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, int use_tma) {
  using T = Bf16Tiles<DP>;
  constexpr int kBn = T::kBn;
  constexpr int kStages = T::kStages;
  constexpr int kSr = kBn / 2;                 // score registers a thread
  constexpr int kOr = DP / 2;                  // output registers a thread
  constexpr uint32_t kTileBytes = 2u * sizeof(bf16) * T::kKv;   // K and V
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[kStages + 1];   // the ring, then Q
  constexpr int kNt = T::kThreadsCta;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // kWg tiles of (64, DP)
  bf16* ks = qs + T::kWg * T::kQ;              // kStages of (kBn, DP)
  bf16* vs = ks + kStages * T::kKv;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;      // row in 8, column pair
  const int d = p.d, s = p.s;
  const int n_q = (s + T::kRows - 1) / T::kRows;
  int head, qt;
  cta_tile(p.bh, n_q, head, qt);
  const int q0 = qt * T::kRows;                // the CTA's first query row
  const int qw = q0 + wg * kTile;              // the warpgroup's
  const int row_base = head * s;               // TMA row of the head
  const size_t base = (size_t)head * s * d;
  const bf16* q = static_cast<const bf16*>(p.q) + base;
  const bf16* k = static_cast<const bf16*>(p.k) + base;
  const bf16* v = static_cast<const bf16*>(p.v) + base;
  bf16* out = static_cast<bf16*>(p.out) + base;

  const int last_col = min(q0 + T::kRows, s) - 1;
  const int n_kv = p.causal ? last_col / kBn + 1 : (s + kBn - 1) / kBn;

  auto issue_kv = [&](int kt, int stage) {
    mbar_expect(&bars[stage], kTileBytes);
    tma_tile<kBn, DP>(ks + stage * T::kKv, &tk, row_base + kt * kBn,
                      &bars[stage]);
    tma_tile<kBn, DP>(vs + stage * T::kKv, &tv, row_base + kt * kBn,
                      &bars[stage]);
  };
  if (use_tma) {
    if (tid == 0) {
      for (int i = 0; i <= kStages; ++i) mbar_init(&bars[i]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect(&bars[kStages], sizeof(bf16) * T::kWg * T::kQ);
      for (int w = 0; w < T::kWg; ++w)
        tma_tile<kTile, DP>(qs + w * T::kQ, &tq, row_base + q0 + w * kTile,
                            &bars[kStages]);
      for (int kt = 0; kt < min(kStages, n_kv); ++kt) issue_kv(kt, kt);
    }
  } else {
    for (int w = 0; w < T::kWg; ++w)
      load_tile_sync<kTile, DP, kNt>(qs + w * T::kQ, q, q0 + w * kTile, s,
                                     d);
  }

  // Q: 64 rows, K-major; a k16 slab is two 8-column chunks, 64 * 16 bytes
  // apart.  K: kBn rows, K-major.  V: (kBn, DP) read as B = V with N = DP
  // (MN-major): 8-row (kv) groups 128 bytes apart, 8-column groups
  // kBn * 16 bytes apart.
  const uint64_t q_desc = make_desc(qs + wg * T::kQ, kTile * 16, 128);

  const float c = p.scale * kLog2e;            // scores to log2 units
  const int r0 = qw + warp * 16 + g, r1 = r0 + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float o[kOr];
#pragma unroll
  for (int i = 0; i < kOr; ++i) o[i] = 0.f;

  // Tile kt's K and V in shared memory (waited for, or loaded here).
  auto wait_tile = [&](int kt) {
    const int stage = kt % kStages;
    if (use_tma) {
      if (kt == 0) mbar_wait(&bars[kStages], 0);
      mbar_wait(&bars[stage], (kt / kStages) & 1);
    } else {
      load_tile_sync<kBn, DP, kNt>(ks + stage * T::kKv, k, kt * kBn, s, d);
      load_tile_sync<kBn, DP, kNt>(vs + stage * T::kKv, v, kt * kBn, s, d);
      fence_proxy_async();
      __syncthreads();
    }
  };
  // S = Q K^T over DP / 16 slabs, issued and committed as one group.
  auto issue_s = [&](int kt, float (&sc)[kSr]) {
    const uint64_t k_desc =
        make_desc(ks + (kt % kStages) * T::kKv, kBn * 16, 128);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t da = q_desc + (uint64_t)(kk * 2 * kTile);
      const uint64_t db = k_desc + (uint64_t)(kk * 2 * kBn);
      if constexpr (kBn == 64) {
        wgmma_ss_n64<0>(sc, da, db, kk > 0);
      } else {
        wgmma_ss_n32<0>(sc, da, db, kk > 0);
      }
    }
    wgmma_commit();
  };
  // O += P_hi V + P_lo V, issued and committed as one group.
  auto issue_pv = [&](int kt, uint32_t (&ph)[kBn / 16][4],
                      uint32_t (&pl)[kBn / 16][4]) {
    const uint64_t v_desc =
        make_desc(vs + (kt % kStages) * T::kKv, 128, kBn * 16);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBn / 16; ++kk) {
      const uint64_t db = v_desc + (uint64_t)(kk * 16);   // 2 x 128 bytes
      pv_slab<DP, kBn>(o, ph[kk], db);
      pv_slab<DP, kBn>(o, pl[kk], db);
    }
    wgmma_commit();
  };
  // The online softmax of tile kt on its score fragment: sc[4j + e] is
  // row (e < 2 ? r0 : r1), column k0 + 8j + 2 t4 + (e & 1).  m0 / m1 are
  // the running row maxima of the scaled scores in log2 units, so that
  // p = 2^(s c - m) is one fmaf and one ex2.  Updates m and l, returns the
  // factors a0 / a1 that rescale the rows of o, and packs P into the A
  // fragments ph (bf16(P) by truncation) and pl (bf16(P - P_hi) rounded):
  // about 16 significant bits of P together.
  auto softmax = [&](int kt, float (&sc)[kSr], uint32_t (&ph)[kBn / 16][4],
                     uint32_t (&pl)[kBn / 16][4], float& a0, float& a1) {
    const int k0 = kt * kBn;
    if (k0 + kBn > s || (p.causal && k0 + kBn - 1 > qw)) {
#pragma unroll
      for (int j = 0; j < kBn / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t4 + (e & 1);
          const int row = e < 2 ? r0 : r1;
          if (col >= s || (p.causal && col > row)) sc[4 * j + e] = kNegInf;
        }
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kBn / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, o2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, o2));
    }
    const float mn0 = fmaxf(m0, mx0 * c), mn1 = fmaxf(m1, mx1 * c);
    a0 = ex2(m0 - mn0);
    a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBn / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        // A register r of slab kk: row (r & 1 ? r1 : r0), columns
        // 16 kk + 8 (r >> 1) + 2 t4 + {0, 1}
        const int i = 8 * kk + 2 * r;
        const float mn = (r & 1) ? mn1 : mn0;
        const float pa = ex2(fmaf(sc[i], c, -mn));
        const float pb = ex2(fmaf(sc[i + 1], c, -mn));
        if (r & 1) sum1 += pa + pb; else sum0 += pa + pb;
        const uint32_t ua = __float_as_uint(pa), ub = __float_as_uint(pb);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            pa - __uint_as_float(ua & 0xffff0000u),
            pb - __uint_as_float(ub & 0xffff0000u));
        ph[kk][r] = __byte_perm(ua, ub, 0x7632);   // the high halves
        pl[kk][r] = *reinterpret_cast<const uint32_t*>(&lo);
      }
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
  };

  // Software pipeline: S of tile kt is issued with PV of tile kt - 1 behind
  // it, and the softmax of tile kt runs while PV of tile kt - 1 is still on
  // the tensor cores.  P of tile kt - 1 stays in its fragments until its PV
  // completes; P of tile kt is built in the other pair, and the two pairs
  // swap roles from one tile to the next (the loop is unrolled by two).
  auto step = [&](int kt, uint32_t (&ph)[kBn / 16][4],
                  uint32_t (&pl)[kBn / 16][4], uint32_t (&qh)[kBn / 16][4],
                  uint32_t (&ql)[kBn / 16][4], float (&sc)[kSr]) {
    float a0, a1;
    wait_tile(kt);
    issue_s(kt, sc);
    issue_pv(kt - 1, ph, pl);
    wgmma_wait<1>();                           // S of tile kt is done
    fence_regs(sc);
    softmax(kt, sc, qh, ql, a0, a1);
    wgmma_wait<0>();                           // PV of tile kt - 1 is done
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
#pragma unroll
    for (int i = 0; i < kOr; ++i) o[i] *= (i & 2) ? a1 : a0;
    __syncthreads();                           // tile kt - 1's stage is free
    if (use_tma && tid == 0 && kt - 1 + kStages < n_kv)
      issue_kv(kt - 1 + kStages, (kt - 1) % kStages);
  };
  auto last_pv = [&](uint32_t (&ph)[kBn / 16][4],
                     uint32_t (&pl)[kBn / 16][4]) {
    issue_pv(n_kv - 1, ph, pl);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
  };
  float sc[kSr];
  uint32_t ph[kBn / 16][4], pl[kBn / 16][4], qh[kBn / 16][4],
      ql[kBn / 16][4];
  {
    float a0, a1;                              // o is still zero
    wait_tile(0);
    issue_s(0, sc);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0, sc, ph, pl, a0, a1);
  }
  int kt = 1;
  for (; kt + 1 < n_kv; kt += 2) {
    step(kt, ph, pl, qh, ql, sc);
    step(kt + 1, qh, ql, ph, pl, sc);
  }
  if (kt < n_kv) {
    step(kt, ph, pl, qh, ql, sc);
    last_pv(qh, ql);
  } else {
    last_pv(ph, pl);
  }

  // the row sums over the quad, then out = o / max(l, 1e-30)
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, o2);
    l1 += __shfl_xor_sync(kFull, l1, o2);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? r1 : r0;
      const float den = h ? den1 : den0;
      const int col = 8 * j + 2 * t4;
      if (row >= s || col >= d) continue;
      const float x0 = o[4 * j + 2 * h] / den;
      const float x1 = o[4 * j + 2 * h + 1] / den;
      bf16* dst = out + (size_t)row * d + col;
      if (col + 1 < d) {
        if ((d & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          dst[0] = __float2bfloat16_rn(x0);
          dst[1] = __float2bfloat16_rn(x1);
        }
      } else {
        dst[0] = __float2bfloat16_rn(x0);
      }
    }
  }
}

// ----------------------------------------------------------------- launch

template <typename Kernel>
int opt_in(Kernel kernel, size_t smem, bool& configured) {
  if (configured) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  configured = true;              // dynamic + static above 48 KB needs it
  return 0;
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime
// (nothing links against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
        ? reinterpret_cast<EncodeTiled>(ptr) : nullptr;
  }();
  return fn;
}

// A (rows, d) bf16 tensor read in boxes of 8 columns by box_rows rows.
bool tensor_map(CUtensorMap* map, const void* base, unsigned long long rows,
                int d, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * sizeof(bf16)};
  const cuuint32_t box[2] = {8, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch_width(const FlashParams& p, cudaStream_t stream) {
  if (p.dtype == 1) {
    using T = Bf16Tiles<DP>;
    const long long ctas = (long long)p.bh * ((p.s + T::kRows - 1) / T::kRows);
    if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    static bool configured = false;
    const int err = opt_in(flash_bf16_kernel<DP>, T::kSmem, configured);
    if (err) return err;
    const unsigned long long rows = (unsigned long long)p.bh * p.s;
    const bool aligned = ((reinterpret_cast<uintptr_t>(p.q)
                           | reinterpret_cast<uintptr_t>(p.k)
                           | reinterpret_cast<uintptr_t>(p.v)) & 15) == 0;
    CUtensorMap tq{}, tk{}, tv{};
    const int use_tma = p.d % 8 == 0 && aligned && rows < (1ull << 31)
        && tensor_map(&tq, p.q, rows, p.d, kTile)
        && tensor_map(&tk, p.k, rows, p.d, T::kBn)
        && tensor_map(&tv, p.v, rows, p.d, T::kBn);
    flash_bf16_kernel<DP><<<(unsigned)ctas, T::kThreadsCta, T::kSmem,
                            stream>>>(p, tq, tk, tv, use_tma);
  } else {
    const long long ctas = (long long)p.bh * ((p.s + kTile - 1) / kTile);
    if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    static bool configured = false;
    constexpr size_t smem = f32_smem_bytes<DP>();
    const int err = opt_in(flash_f32_kernel<DP>, smem, configured);
    if (err) return err;
    flash_f32_kernel<DP><<<(unsigned)ctas, kThreads, smem, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_launch(const FlashParams* p, void* stream) {
  if (p->bh == 0 || p->s == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int d = p->d;
  if (d <= 16) return launch_width<16>(*p, st);
  if (d <= 32) return launch_width<32>(*p, st);
  if (d <= 64) return launch_width<64>(*p, st);
  if (d <= 80) return launch_width<80>(*p, st);
  if (d <= 96) return launch_width<96>(*p, st);
  if (d <= 112) return launch_width<112>(*p, st);
  if (d <= 128) return launch_width<128>(*p, st);
  if (d <= 192) return launch_width<192>(*p, st);
  if (d <= 256) return launch_width<256>(*p, st);
  return (int)cudaErrorInvalidValue;
}
