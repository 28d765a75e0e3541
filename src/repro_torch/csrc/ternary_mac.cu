// Twin-cell ternary MAC for Hopper (sm_90a): the first stage of the composed
// chain, a dense product on the int8 tensor cores.
//
// Replaces the Pallas TPU kernel repro/kernels/ternary_mac.py::
// _ternary_mac_kernel (entry ternary_mac; ops.ternary_mac).  x (M, K) int8
// ternary events against the twin-cell planes msb / lsb (K, N) int8 ternary:
// out = x @ (ratio * msb + lsb), (M, N) f32.
//
// What bounds it on the card: by the roofline, bytes.  At the chain's step
// shape (M=64, K=512, N=128) it reads 32 KB of events and 128 KB of planes
// and writes 32 KB: 196,608 B, 0.06 us at 3.35 TB/s; a dense product of
// both planes is 16.8 M int8 operations, 8.5 ns at 1,979 TOP/s.  So the
// tensor cores' arithmetic costs nothing; what costs time is getting 160 KB
// of operands into enough SMs in one round trip, and the launch.
//
// What the design does about that:
// * A dense product on the tensor cores, mma.sync.m16n8k32.s32.s8.s8.s32,
//   with one int32 accumulator per output and plane.  Its cost does not
//   depend on how many events fired (the event-driven MAC it replaces read
//   one pair of plane rows per event, in series: ~25 round trips a row at
//   5 % events, ~340 at 67 %).
// * Enough CTAs in flight, each loading a few KB.  A CTA owns 64 rows, 32
//   columns of both planes and one slice of K: the grid is (k_split,
//   ceil(N / 32), ceil(M / 64)), the k_split CTAs of a column tile form a
//   thread-block cluster, and each sums its slice.  At the step shape that
//   is 32 CTAs of 8 KB each.  (A first version of this kernel tiled the
//   dense product without splitting K; with 8 CTAs at this shape it took
//   39 us on the card: too few CTAs, each loading too much.)
// * The split-K sums meet in distributed shared memory.  Rank r of a
//   cluster owns row block r of the tile: every CTA sends its int32
//   partials of those rows, both planes in one word (acc_msb * 2^16 +
//   acc_lsb, exact while a slice is under 2^15 rows), straight into rank
//   r's shared memory with asynchronous stores (st.async) that complete on
//   rank r's mbarrier; rank r, once all of them have landed, adds them,
//   applies the epilogue and writes its rows.  No scratch in global
//   memory, no atomics, no second launch, and no cluster barrier after the
//   product: the one before it only makes sure every CTA of the cluster
//   has started.  (Each rank pulling the partials from the others, or
//   plain remote stores behind a release barrier, put a cluster barrier
//   and a remote round trip in series after the product, and both were
//   slower on the card.)  The wrapper (kernels/ternary_mac.py) plans
//   k_split, the slice and the grid.
// * Operands staged by TMA on mbarriers (fused_macro_common.cuh's
//   stage_by_tma / plane_map, a third map for the events), two tiles of 32,
//   64 or 128 K rows in a ring; boxes past M, K or N are zero-filled.  Rows
//   that are not 16-byte multiples (K or N not a multiple of 16, as at
//   K=300, N=100) take a plain copy that zero-fills the same places itself.
//   Each tile is swizzled (32, 64 or 128 bytes, the width of its rows), so
//   the fragment loads below spread over the banks.
// * The planes are (K, N) row-major, but the B operand of the s8 mma wants
//   K-major.  Within a tile's 32 columns, n8 tile j holds columns 4 g + j
//   (g the lane's group): a lane's four B registers are then the 4 x 4 byte
//   transpose (__byte_perm) of four 32-bit words, one from each of four K
//   rows, and a lane's accumulators cover eight consecutive columns.
//
// Bitwise parity with the reference: x * msb and x * lsb are small integers,
// so both int32 sums are exact, in any order and over any split of K; the
// epilogue fmaf(ratio, acc_msb, acc_lsb) is applied once, to the full sums
// (one rounding, as the plain version repro_torch/kernels/ref.py::
// ternary_mac_ref computes).  For an integral ratio that is the reference's
// f32 product exactly while |MAC| < 2^24, where the int -> f32 conversions
// are exact too.

#include "fused_macro_common.cuh"

extern "C" {

// Mirrored by repro_torch/kernels/ternary_mac.py::_Params.
struct TmacParams {
  const int8_t* x;     // (M, K)
  const int8_t* msb;   // (K, N)
  const int8_t* lsb;   // (K, N)
  float* out;          // (M, N)
  int m, k_dim, n;
  float ratio;
  int k_split;         // CTAs of a cluster along K, 1..8
  int k_chunk;         // K rows of a CTA's slice, a multiple of k_tile
  int k_tile;          // K rows a staged tile: 32, 64 or 128
  int n_tiles;         // ceil(N / 32)
  int m_tiles;         // ceil(M / 64)
};

}  // extern "C"

namespace {

using namespace fm;

constexpr int kBm = 64;            // rows of a CTA: 4 warps x m16
constexpr int kBn = 32;            // columns of a CTA, each plane
constexpr int kThreads = 128;
constexpr int kMaxSplit = 8;       // the portable cluster size
constexpr int kMaxChunk = 32767;   // K rows a slice: its sums fit 16 bits

// Byte offset o of a staged tile as the TMA unit lays it out with the
// swizzle of a tile whose rows are `pitch` = 32, 64 or 128 bytes: the 16-byte
// chunk bits [4, 4 + log2(pitch / 16)) XOR the row bits above bit 7, so that
// the eight (or four) lanes reading one column of consecutive rows hit
// different banks.  The tile's base is 1024-byte aligned.
__device__ __forceinline__ int swz(int o, int pitch) {
  return o ^ (((o >> 7) & (pitch / 16 - 1)) << 4);
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B registers of the four n8 tiles for K rows k..k+3 of a staged plane
// tile (kBn bytes a row, 32-byte swizzle): word i is row k + i at columns
// 4g..4g+3, and register j gathers byte j of each word (column 4g + j, rows
// k..k+3).
__device__ __forceinline__ void b_regs(const int8_t* pl, int k, int g,
                                       uint32_t (&b)[4]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = lds32(pl + swz((k + i) * kBn + 4 * g, kBn));
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  b[0] = __byte_perm(t0, t2, 0x5410);
  b[1] = __byte_perm(t0, t2, 0x7632);
  b[2] = __byte_perm(t1, t3, 0x5410);
  b[3] = __byte_perm(t1, t3, 0x7632);
}

// rows x pitch bytes at src (row stride src_ld) into a staged tile of
// `pitch`-byte rows laid out as the TMA unit swizzles it, by every thread
// of the block, zero where r >= rows_in or c >= cols_in.
__device__ __forceinline__ void copy_zfill(int8_t* dst, int pitch,
                                           const int8_t* src, size_t src_ld,
                                           int rows, int rows_in,
                                           int cols_in) {
  for (int i = threadIdx.x; i < rows * pitch; i += kThreads) {
    const int r = i / pitch, c = i - r * pitch;
    dst[swz(i, pitch)] = r < rows_in && c < cols_in
        ? src[(size_t)r * src_ld + c] : (int8_t)0;
  }
}

// This CTA's rank in its cluster.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// The 32-bit shared::cluster address of `addr` in the shared memory of
// cluster rank `rank`.
__device__ __forceinline__ uint32_t remote(const void* addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(smem_u32(addr)), "r"(rank));
  return out;
}

// 16 bytes into another CTA's shared memory, completing on its mbarrier.
__device__ __forceinline__ void st_async(uint32_t addr, int4 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n"
      :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

constexpr int kSlotBytes = kBm * kBn * 4;   // partials a rank receives

// Dynamic shared memory: 1 KB for aligning the ring, the two-stage ring,
// the slots the cluster's partials land in, three mbarriers.
__host__ __device__ constexpr int tmac_smem(int k_tile) {
  return 1024 + 2 * k_tile * (kBm + 2 * kBn) + kSlotBytes + 24;
}

// KT: K rows a staged tile (the plan's k_tile), 32, 64 or 128.
template <int KT>
__global__ void __launch_bounds__(kThreads) tmac_kernel(
    const TmacParams p, const __grid_constant__ CUtensorMap tm_x,
    const __grid_constant__ CUtensorMap tm_msb,
    const __grid_constant__ CUtensorMap tm_lsb, int bulk) {
  extern __shared__ __align__(128) int8_t smem_raw[];
  const int rank = cluster_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.z * kBm, n0 = blockIdx.y * kBn;
  constexpr int kt = KT;
  const int k_begin = min(p.k_dim, rank * p.k_chunk);
  const int k_end = min(p.k_dim, k_begin + p.k_chunk);
  const int n_t = (k_end - k_begin + kt - 1) / kt;
  const int stage = kt * (kBm + 2 * kBn);
  // the ring at a 1024-byte boundary (the swizzle reads address bits)
  int8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // slot (src, r, c): rank src's partials at row r of this rank's share of
  // the tile, column c, both planes in one word (see below)
  int* slots = reinterpret_cast<int*>(ring + 2 * stage);
  uint64_t* bar = reinterpret_cast<uint64_t*>(slots + kBm * kBn);
  const CUtensorMap* maps[3] = {&tm_x, &tm_msb, &tm_lsb};
  // tile i into stage i % 2, one TMA copy an operand, by thread 0 (which
  // initialised the barriers; the others wait on them only after the
  // block barrier below), after a barrier that every read of the stage's
  // previous tile precedes
  auto issue = [&](int i) {
    if (i >= n_t || threadIdx.x != 0) return;
    int8_t* st = ring + (i & 1) * stage;
    const int k0 = k_begin + i * kt;
    mbar_expect(&bar[i & 1], (uint32_t)stage);
    tma_load_2d(st, maps[0], k0, m0, &bar[i & 1]);
    tma_load_2d(st + kBm * kt, maps[1], n0, k0, &bar[i & 1]);
    tma_load_2d(st + (kBm + kBn) * kt, maps[2], n0, k0, &bar[i & 1]);
  };
  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    // the reduction's barrier: complete once every rank's partials of
    // this rank's rows have landed
    mbar_init(&bar[2]);
    mbar_expect(&bar[2], (uint32_t)kSlotBytes);
    fence_mbar_init();
    if (bulk) {
      issue(0);
      issue(1);
    }
  }
  // every CTA of the cluster has started and set up its barriers once
  // this barrier is passed (while the first tile is in flight)
  cluster_arrive_relaxed();
  __syncthreads();
  cluster_wait();
  int acc[2][4][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][j][e] = 0;
  const bool rows_live = m0 + warp * 16 < p.m;
  for (int i = 0; i < n_t; ++i) {
    const int8_t* st = ring + (i & 1) * stage;
    const int k0 = k_begin + i * kt;
    if (bulk) {
      mbar_wait(&bar[i & 1], (i >> 1) & 1);
    } else {
      int8_t* dst = ring + (i & 1) * stage;
      copy_zfill(dst, kt, p.x + (size_t)m0 * p.k_dim + k0, p.k_dim, kBm,
                 p.m - m0, k_end - k0);
      copy_zfill(dst + kBm * kt, kBn, p.msb + (size_t)k0 * p.n + n0, p.n,
                 kt, k_end - k0, p.n - n0);
      copy_zfill(dst + (kBm + kBn) * kt, kBn, p.lsb + (size_t)k0 * p.n + n0,
                 p.n, kt, k_end - k0, p.n - n0);
      __syncthreads();
    }
    if (rows_live) {
      const int8_t* xs = st;
      const int8_t* ms = st + kBm * kt;
      const int8_t* ls = ms + kBn * kt;
      const int r0 = warp * 16 + g;
      // every step of the tile: rows past K are zeros
#pragma unroll
      for (int s = 0; s < kt / 32; ++s) {
        const int kk = 32 * s;
        uint32_t a[4];
        a[0] = lds32(xs + swz(r0 * kt + kk + 4 * t, kt));
        a[1] = lds32(xs + swz((r0 + 8) * kt + kk + 4 * t, kt));
        a[2] = lds32(xs + swz(r0 * kt + kk + 16 + 4 * t, kt));
        a[3] = lds32(xs + swz((r0 + 8) * kt + kk + 16 + 4 * t, kt));
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          uint32_t lo[4], hi[4];
          b_regs(q == 0 ? ms : ls, kk + 4 * t, g, lo);
          b_regs(q == 0 ? ms : ls, kk + 16 + 4 * t, g, hi);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8(acc[q][j], a, lo[j], hi[j]);
        }
      }
    }
    __syncthreads();
    if (bulk) issue(i + 2);
  }
  // Send the partials to the rank that owns their rows (rank r owns rows
  // [r R, r R + R) of the tile, R = kBm / k_split), into slot `rank`, by
  // asynchronous stores that complete on the owner's barrier.  Both planes
  // go in one word, acc_msb * 2^16 + acc_lsb: a slice's sums are at most
  // k_chunk < 2^15 in magnitude (the wrapper's plan), so the word is exact
  // and the owner splits it again.
  // Accumulator e of n8 tile j is row g (+8 for e >= 2), column 4 (2t +
  // (e & 1)) + j: columns 8t..8t+3 and 8t+4..8t+7 of the row.
  const int share = kBm / p.k_split;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h, owner = r / share;
    const uint32_t d = remote(slots, owner)
        + 4 * ((rank * share + r - owner * share) * kBn + 8 * t);
    const uint32_t rbar = remote(&bar[2], owner);
    int w[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = acc[0][j][2 * h] * 65536 + acc[1][j][2 * h];
      w[4 + j] = acc[0][j][2 * h + 1] * 65536 + acc[1][j][2 * h + 1];
    }
    st_async(d, make_int4(w[0], w[1], w[2], w[3]), rbar);
    st_async(d + 16, make_int4(w[4], w[5], w[6], w[7]), rbar);
  }
  // this rank's rows: once every rank's slot has landed, the sum over the
  // slots, four columns a thread, then fmaf(ratio, msb, lsb) once.  Nothing
  // reads another CTA's shared memory, so no barrier holds a CTA after it.
  mbar_wait(&bar[2], 0);
  const bool vec = p.n % 4 == 0;
  for (int e = threadIdx.x; e < share * (kBn / 4); e += kThreads) {
    const int r = e / (kBn / 4), c = 4 * (e % (kBn / 4));
    const int row = m0 + rank * share + r, col = n0 + c;
    if (row >= p.m || col >= p.n) continue;
    int sm[4] = {0, 0, 0, 0}, sl[4] = {0, 0, 0, 0};
    int4 got[kMaxSplit];   // every slot's load in flight at once
#pragma unroll
    for (int src = 0; src < kMaxSplit; ++src)
      got[src] = src < p.k_split ? reinterpret_cast<const int4*>(
                                       slots + (src * share + r) * kBn + c)[0]
                                 : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int src = 0; src < kMaxSplit; ++src) {
      const int vs[4] = {got[src].x, got[src].y, got[src].z, got[src].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int lo = (int)(int16_t)(vs[u] & 0xffff);
        sl[u] += lo;
        sm[u] += (vs[u] - lo) >> 16;
      }
    }
    const float4 v = make_float4(fmaf(p.ratio, (float)sm[0], (float)sl[0]),
                                 fmaf(p.ratio, (float)sm[1], (float)sl[1]),
                                 fmaf(p.ratio, (float)sm[2], (float)sl[2]),
                                 fmaf(p.ratio, (float)sm[3], (float)sl[3]));
    float* o = p.out + (size_t)row * p.n + col;
    if (vec && col + 4 <= p.n) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
      for (int u = 0; u < 4 && col + u < p.n; ++u) o[u] = vs[u];
    }
  }
}

// The TMA swizzle of a tile with `pitch`-byte rows (swz's layout).
inline CUtensorMapSwizzle swizzle_of(int pitch) {
  return pitch == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
       : pitch == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                     : CU_TENSOR_MAP_SWIZZLE_128B;
}

template <int KT>
cudaError_t launch_tile(const TmacParams& p, const CUtensorMap& tx,
                        const CUtensorMap (&tm)[2], bool bulk,
                        cudaStream_t stream) {
  constexpr int smem = tmac_smem(KT);
  static bool configured = false;   // above the default 48 KB: opt in once
  if (smem > 48 * 1024 && !configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        tmac_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.k_split, p.n_tiles, p.m_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.k_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, tmac_kernel<KT>, p, tx,
                                             tm[0], tm[1], (int)bulk);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" int tmac_launch(const TmacParams* p, void* stream) {
  if (p->m == 0 || p->n == 0) return 0;
  const int kt = p->k_tile;
  if (p->k_split < 1 || p->k_split > kMaxSplit || kBm % p->k_split
      || (kt != 32 && kt != 64 && kt != 128) || p->k_chunk % kt
      || p->k_chunk > kMaxChunk
      || (long long)p->k_split * p->k_chunk < p->k_dim
      || (long long)p->n_tiles * kBn < p->n
      || (long long)p->m_tiles * kBm < p->m)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm[2] = {}, tx = {};
  bool bulk = false;
  cudaError_t err = fm::stage_by_tma(tm, &bulk, p->msb, p->lsb, p->k_dim,
                                     p->n, kBn, p->x, kt, swizzle_of(kBn));
  if (err == cudaSuccess && bulk)
    err = fm::plane_map(&tx, p->x, p->m, p->k_dim, kt, kBm, swizzle_of(kt));
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kt == 32) err = launch_tile<32>(*p, tx, tm, bulk, st);
  else if (kt == 64) err = launch_tile<64>(*p, tx, tm, bulk, st);
  else err = launch_tile<128>(*p, tx, tm, bulk, st);
  return (int)err;
}
