// Flash-attention forward for Hopper (sm_90a): the LM stack's prefill and
// full-sequence attention.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// _flash_kernel (entry flash_attention_fwd).  q, k, v (BH, S, D) in f32 or
// bf16 -> out (BH, S, D) in q's dtype: scores q.k * (1/sqrt(D)) in f32,
// masked row >= col with -1e30 when causal, an online softmax over the kv
// tiles in order, out = acc / max(l, 1e-30).
//
// What bounds it on the card: by the roofline, operations.  At the smollm
// prefill (BH = 72, S = 2048, D = 64, causal, bf16) it moves 75.5 MB
// (q, k, v read once, out written once: 22.5 us at 3.35 TB/s) and does
// 4 * BH * D * (S^2 + S) / 2 = 38.7 GFLOP (39 us on the bf16 tensor cores,
// 577 us on the f32 cores this kernel uses).
//
// What the design does: one CTA per (64-row query tile, bh), 4 warps, a
// warp per 16 query rows.  The query tile and one 64-row kv tile at a time
// live in shared memory as f32 (the K rows padded to D + 1 floats, so the
// lanes' row-strided reads fall in distinct banks); the kv loop stops at
// the last tile a causal row can see, which replaces the TPU's sequential
// kv grid axis and its pl.when block skip, and the longest rows' tiles
// are launched first.  Each lane scores two kv columns for each of its
// warp's 16 rows with explicit fmaf over D; row max and row sum are
// __shfl_xor_sync reductions; m and l stay in registers, and each lane
// holds ceil(D/32) accumulator columns of each row.  Rows and columns at
// and past S are masked in the kernel, so the wrapper pads nothing; the
// kv tiles go in the reference's order, so no row starts from a tile that
// is masked whole.  The products run on the f32 cores: wgmma, TMA and the
// bf16 tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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

constexpr int kTile = 64;                      // query rows a CTA, kv rows a tile
constexpr int kWarps = 4;
constexpr int kRows = kTile / kWarps;          // query rows a warp
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)kTile * (3 * D + 1);
}

// Rows row0 .. row0 + 63 of one (S, D) slab into dst[r * stride + c] as
// f32, zeros past S.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* src, int row0, int s) {
  for (int i = threadIdx.x; i < kTile * D; i += kWarps * 32) {
    const int r = i / D, c = i % D;
    const int row = row0 + r;
    dst[r * stride + c] = row < s ? to_f32(src[(size_t)row * D + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32) flash_kernel(
    const FlashParams p) {
  constexpr int kCpl = (D + 31) / 32;          // accumulator columns a lane
  constexpr int kKStride = D + 1;
  extern __shared__ float smem[];
  float* qs = smem;                            // (64, D)
  float* ks = qs + kTile * D;                  // (64, D + 1)
  float* vs = ks + kTile * kKStride;           // (64, D)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_tiles = (p.s + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - (int)blockIdx.x;  // longest causal rows first
  const int q0 = qt * kTile;
  const size_t base = (size_t)blockIdx.y * p.s * D;
  const T* q = static_cast<const T*>(p.q) + base;
  const T* k = static_cast<const T*>(p.k) + base;
  const T* v = static_cast<const T*>(p.v) + base;
  T* out = static_cast<T*>(p.out) + base;

  load_tile<T, D>(qs, D, q, q0, p.s);
  const float* qw = qs + warp * kRows * D;

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
    load_tile<T, D>(ks, kKStride, k, k0, p.s);
    load_tile<T, D>(vs, D, v, k0, p.s);
    __syncthreads();

    // scores of columns k0 + lane and k0 + lane + 32 for the warp's rows
    float s0[kRows], s1[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s0[r] = s1[r] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float ka = ks[lane * kKStride + d];
      const float kb = ks[(lane + 32) * kKStride + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = qw[r * D + d];
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
        va[j] = col < D ? vs[c * D + col] : 0.f;
        vb[j] = col < D ? vs[(c + 32) * D + col] : 0.f;
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
      if (col < D) out[(size_t)row * D + col] = from_f32<T>(acc[r][j] / den);
    }
  }
}

template <typename T, int D>
int launch_typed(const FlashParams& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;              // above 48 KB needs opting in
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((p.s + kTile - 1) / kTile, p.bh);
  flash_kernel<T, D><<<grid, kWarps * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const FlashParams& p, cudaStream_t stream) {
  switch (p.d) {
    case 16: return launch_typed<T, 16>(p, stream);
    case 32: return launch_typed<T, 32>(p, stream);
    case 64: return launch_typed<T, 64>(p, stream);
    case 128: return launch_typed<T, 128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_launch(const FlashParams* p, void* stream) {
  if (p->bh == 0 || p->s == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return p->dtype == 1 ? launch_dim<__nv_bfloat16>(*p, st)
                       : launch_dim<float>(*p, st);
}
