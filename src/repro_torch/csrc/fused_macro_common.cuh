// Device code shared by the fused macro kernels (fused_macro_seq_kwn.cu,
// fused_macro_seq_nld.cu, fused_macro_multi_seq_kwn.cu, and the backward
// fused_macro_seq_kwn_bwd.cu) and the composed chain's stages
// (ternary_mac.cu, nlq_lut.cu, kwn_topk.cu, lif_step.cu): the counter PRNG
// and the Fig. 7 noise model, the ramp conversion, the KWN priority sweep
// and the LIF update; and, for the fused kernels' heads, bulk-copy (TMA)
// staging on mbarriers and the event-driven twin-cell MAC from weight
// planes staged in shared memory.
//
// Every function reproduces the JAX reference's rounding: the kernels are
// built with -fmad=false, and the reference's fused multiply-adds are
// written out as fmaf.  The plain PyTorch versions are in
// repro_torch/kernels/ref.py, repro_torch/core/lif.py,
// repro_torch/core/ctrprng.py and repro_torch/core/f32math.py.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fm {

constexpr int kRowsPerCta = 4;       // one warp per batch row
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kTagIma = 0x494D4101u;
constexpr uint32_t kTagSnl = 0x534E4C01u;
constexpr float kTwoPiF = 0x1.921fb6p+2f;

// ---------------------------------------------------------------------------
// Counter PRNG: Threefry-2x32-20 (repro/core/ctrprng.py).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t* o0, uint32_t* o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  *o0 = x0;
  *o1 = x1;
}

__device__ __forceinline__ float unit_open(uint32_t bits) {
  return ((float)(bits >> 8) + 0.5f) * 0x1p-24f;
}

// f32 log: the Cephes polynomial with fused multiply-adds (the reference's).
__device__ float ref_logf(float x) {
  int ei;
  float m = frexpf(x, &ei);
  float e = (float)ei;
  const bool small = m < 0x1.6a09e6p-1f;
  float t = (m - 1.0f) + (small ? m : 0.0f);
  e = e - (small ? 1.0f : 0.0f);
  const float x2 = t * t;
  const float x3 = x2 * t;
  float y = fmaf(t, 0x1.204376p-4f, -0x1.d7a370p-4f);
  float y1 = fmaf(t, -0x1.fcba9ep-4f, 0x1.23d37ep-3f);
  float y2 = fmaf(t, 0x1.999d58p-3f, -0x1.fffff8p-3f);
  y = fmaf(y, t, 0x1.de4a34p-4f);
  y1 = fmaf(y1, t, -0x1.555ca0p-3f);
  y2 = fmaf(y2, t, 0x1.555554p-2f);
  y = fmaf(y, x3, y1);
  y = fmaf(y, x3, y2);
  y = fmaf(y, x3, e * -0x1.bd0106p-13f);
  t = t - 0.5f * x2;
  t = t + y;
  return fmaf(e, 0x1.63p-1f, t);
}

// sinf/cosf as the C library computes them: double-precision reduction and
// polynomials, one rounding to f32.
__constant__ uint32_t kInvPio4[24] = {
    0xa2,       0xa2f9,     0xa2f983,   0xa2f9836e, 0xf9836e4e, 0x836e4e44,
    0x6e4e4415, 0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1,
    0x2757d1f5, 0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62,
    0xc0db6295, 0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041};

__device__ double reduce_large(uint32_t xi, int* np) {
  const uint32_t* arr = &kInvPio4[(xi >> 26) & 15];
  const int shift = (xi >> 23) & 7;
  xi = (xi & 0xffffff) | 0x800000;
  xi <<= shift;
  uint64_t res0 = xi * arr[0];
  const uint64_t res1 = (uint64_t)xi * arr[4];
  const uint64_t res2 = (uint64_t)xi * arr[8];
  res0 = (res2 >> 32) | (res0 << 32);
  res0 += res1;
  const uint64_t n = (res0 + (1ULL << 61)) >> 62;
  res0 -= n << 62;
  *np = (int)n;
  return (double)(int64_t)res0 * 0x1.921FB54442D18p-62;
}

__device__ float ref_sincosf(float y, bool want_cos) {
  const uint32_t bits = __float_as_uint(y);
  const uint32_t top = (bits >> 20) & 0x7ff;
  if (top < 0x398) return want_cos ? 1.0f : y;
  const double x = (double)y;
  double xr = x;
  int n = 0, quad = 0;
  if (top >= 0x3F4 && top < 0x42F) {
    const double r = x * 0x1.45F306DC9C883p+23;
    n = ((int32_t)r + 0x800000) >> 24;
    xr = x - (double)n * 0x1.921FB54442D18p0;
    quad = n;
  } else if (top >= 0x42F) {
    xr = reduce_large(bits, &n);
    quad = n + (int)(bits >> 31);
  }
  const bool reduced = top >= 0x3F4;
  const double sgn = (!reduced || ((quad & 3) == 0) || ((quad & 3) == 3))
                         ? 1.0 : -1.0;
  const bool neg_cos = reduced && (quad & 2);
  const bool odd = want_cos ? ((n ^ 1) & 1) : (n & 1);
  const double xs = xr * sgn;
  const double x2 = xr * xr;
  double out;
  if (!odd) {
    const double x3 = xs * x2;
    const double s1 = 0x1.1107605230bc4p-7 + x2 * -0x1.994eb3774cf24p-13;
    const double x7 = x3 * x2;
    const double s = xs + x3 * -0x1.555545995a603p-3;
    out = s + x7 * s1;
  } else {
    const double c0 = neg_cos ? -1.0 : 1.0;
    const double c1 = neg_cos ? 0x1.ffffffd0c621cp-2 : -0x1.ffffffd0c621cp-2;
    const double c2 = neg_cos ? -0x1.55553e1068f19p-5 : 0x1.55553e1068f19p-5;
    const double c3 = neg_cos ? 0x1.6c087e89a359dp-10 : -0x1.6c087e89a359dp-10;
    const double c4 = neg_cos ? -0x1.99343027bf8c3p-16 : 0x1.99343027bf8c3p-16;
    const double x4 = x2 * x2;
    const double cc2 = c3 + x2 * c4;
    const double cc1 = c0 + x2 * c1;
    const double x6 = x4 * x2;
    const double c = cc1 + x4 * c2;
    out = c + x6 * cc2;
  }
  return (float)out;
}

__device__ __forceinline__ float counter_normal(uint32_t seed, uint32_t step,
                                                uint32_t row, uint32_t col) {
  uint32_t b0, b1;
  threefry2x32(seed, kTagIma ^ step, row, col, &b0, &b1);
  const float r = sqrtf(-2.0f * ref_logf(unit_open(b0)));
  const float theta = kTwoPiF * unit_open(b1);
  return r * ref_sincosf(theta, true);
}

__device__ __forceinline__ float counter_sign(uint32_t seed, uint32_t step,
                                              uint32_t row, uint32_t col) {
  uint32_t b0, b1;
  threefry2x32(seed, kTagSnl ^ step, row, col, &b0, &b1);
  return (float)(b0 & 1u) * 2.0f - 1.0f;
}

struct NoiseModel {
  float offset_lsb, sigma_lsb, inl_lsb, in_lo, in_span;
  int n_codes;
};

// Fig. 7 error in code space: INL sinusoid + offset + Gaussian, rounded half
// to even and clipped to the ripple counter (repro/core/ctrprng.py).
__device__ __noinline__ int noisy_code(int ideal, float x, uint32_t seed,
                                       uint32_t step, uint32_t row,
                                       uint32_t col, NoiseModel nm) {
  const float u = (x - nm.in_lo) / nm.in_span;
  const float s = ref_sincosf(kTwoPiF * u, false);
  const float g = counter_normal(seed, step, row, col);
  const float eps = fmaf(nm.sigma_lsb, g, nm.offset_lsb);
  const float pre = fmaf(nm.inl_lsb, s, (float)ideal) + eps;
  const int code = (int)rintf(pre);
  return min(max(code, 0), nm.n_codes - 1);
}

// ---------------------------------------------------------------------------
// Ramp, KWN and LIF.  Column c of a row's width lives on lane c % 32,
// register slot c / 32.
// ---------------------------------------------------------------------------

// KWN: the descending ramp admits winners per level in column order (the
// priority encoder), until k have won.  Code -1 never wins.  Returns the
// early-stop step count: n_codes - 1 - the K-th winner's code, or n_codes - 1
// when fewer than k columns can win.
template <int CPL>
__device__ __forceinline__ int kwn_sweep(const int (&code)[CPL],
                                         bool (&win)[CPL], int k,
                                         int n_codes, int lane) {
  const unsigned lanes_below = (1u << lane) - 1u;
  int top = -1;
#pragma unroll
  for (int j = 0; j < CPL; ++j) top = max(top, code[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    top = max(top, __shfl_xor_sync(kFull, top, off));
#pragma unroll
  for (int j = 0; j < CPL; ++j) win[j] = false;
  int found = 0, steps = -1;
  for (int level = top; level >= 0 && found < k; --level) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int room = k - found;
      const bool hit = code[j] == level;
      const unsigned b = __ballot_sync(kFull, hit);
      if (hit && __popc(b & lanes_below) < room) win[j] = true;
      found += min(__popc(b), max(room, 0));
    }
    if (found >= k) steps = n_codes - 1 - level;
  }
  return steps < 0 ? n_codes - 1 : steps;
}

struct LifParams {
  float beta, v_th1, v_th2, v_reset, v_lim;
};

// Eq. (1) up to the comparator: an active neuron leaks and integrates (one
// fused multiply-add), the rest hold; the SNL kick in (v_th2, v_th1);
// saturate.  Returns the saturated membrane before the reset (the training
// trace).
__device__ __forceinline__ float lif_clip(float v, float drive, bool active,
                                          float nz, bool use_snl,
                                          const LifParams& lp) {
  float vn = active ? fmaf(lp.beta, v, drive) : v;
  if (use_snl && vn > lp.v_th2 && vn < lp.v_th1) vn = vn + nz;
  return fminf(fmaxf(vn, -lp.v_lim), lp.v_lim);
}

// Eq. (1): lif_clip, then compare and reset.
__device__ __forceinline__ float lif_update(float v, float drive, bool active,
                                            float nz, bool use_snl,
                                            const LifParams& lp,
                                            float* spike) {
  const float vn = lif_clip(v, drive, active, nz, use_snl, lp);
  *spike = vn >= lp.v_th1 ? 1.0f : 0.0f;
  return *spike > 0.0f ? lp.v_reset : vn;
}

// ---------------------------------------------------------------------------
// Staging through shared memory by bulk copies (TMA) on mbarriers, and the
// staged twin-cell MAC of the fused kernels' heads and the backward's remat
// pass: the work that does not depend on the membrane, spread over every
// (step, row) pair.
// ---------------------------------------------------------------------------

constexpr int kStageRows = 128;   // K rows of one staged plane tile
constexpr int kStages = 3;        // tiles of the staged MAC's ring
constexpr int kItemWarps = 8;     // item warps of a staged-MAC CTA
constexpr int kMacThreads = 32 * (kItemWarps + 1);   // + the copy warp

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
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

// Makes the initialised mbarriers visible to the async proxy.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Bulk copies of a rows x bytes tile (row strides src_ld in global memory,
// dst_ld in shared memory), issued by the lanes of one warp and completing
// on `bar`: one copy when the tile is contiguous on both sides, else one a
// row.  Bytes, strides and addresses are multiples of 16.
__device__ __forceinline__ void bulk_tile(int8_t* dst, int dst_ld,
                                          const int8_t* src, size_t src_ld,
                                          int rows, int bytes, uint64_t* bar,
                                          int lane) {
  if (src_ld == (size_t)bytes && dst_ld == bytes) {
    if (lane == 0) bulk_g2s(dst, src, (uint32_t)(rows * bytes), bar);
    return;
  }
  for (int r = lane; r < rows; r += 32)
    bulk_g2s(dst + r * dst_ld, src + (size_t)r * src_ld, (uint32_t)bytes,
             bar);
}

// copy_tile in words of type W (rows x bytes, every offset a multiple of
// sizeof(W)).
template <class W>
__device__ __forceinline__ void copy_words(int8_t* dst, int dst_ld,
                                           const int8_t* src, size_t src_ld,
                                           int rows, int bytes) {
  const int wpr = bytes / (int)sizeof(W);
  for (int i = threadIdx.x; i < rows * wpr; i += blockDim.x) {
    const int r = i / wpr, c = i - r * wpr;
    reinterpret_cast<W*>(dst + r * dst_ld)[c] =
        reinterpret_cast<const W*>(src + (size_t)r * src_ld)[c];
  }
}

// The same tile copied by plain loads and stores of every thread of the
// block (rows the bulk copy cannot take), in the widest words (16, 8, 4, 2
// or 1 bytes) that divide the addresses, the strides and the row length.
__device__ __forceinline__ void copy_tile(int8_t* dst, int dst_ld,
                                          const int8_t* src, size_t src_ld,
                                          int rows, int bytes) {
  const uintptr_t a = (uintptr_t)dst | (uintptr_t)src | (uintptr_t)dst_ld
                      | (uintptr_t)src_ld | (uintptr_t)bytes;
  if (a % 16 == 0) copy_words<int4>(dst, dst_ld, src, src_ld, rows, bytes);
  else if (a % 8 == 0)
    copy_words<int2>(dst, dst_ld, src, src_ld, rows, bytes);
  else if (a % 4 == 0)
    copy_words<int>(dst, dst_ld, src, src_ld, rows, bytes);
  else if (a % 2 == 0)
    copy_words<short>(dst, dst_ld, src, src_ld, rows, bytes);
  else copy_words<int8_t>(dst, dst_ld, src, src_ld, rows, bytes);
}

// One TMA copy of a box of the 2D tensor `map` at (c0 = column, c1 = row)
// into dst, completing on `bar`.  Elements past the tensor are zero-filled
// and count toward the box's bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(smem_u32(bar)) : "memory");
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up once through the runtime
// (nothing links against libcuda).
inline EncodeTiled encode_tiled() {
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

// The tensor map of a (k_dim, n) int8 plane read in boxes of box_cols
// columns by box_rows rows (kStageRows unless given), laid out in shared
// memory with `swizzle` (none unless given): one TMA copy a staged tile,
// whatever n.  A missing encoder or a refused map is an error, never a
// silent fallback.
inline cudaError_t plane_map(
    CUtensorMap* map, const int8_t* plane, int k_dim, int n, int box_cols,
    int box_rows = kStageRows,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)k_dim};
  const cuuint64_t strides[1] = {(cuuint64_t)n};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
            const_cast<int8_t*>(plane), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
      ? cudaSuccess : cudaErrorInvalidValue;
}

// How staged_mac stages the (k_dim, n) int8 planes and the event rows at x
// (k_dim bytes each): by the TMA unit when every row is 16-byte aligned
// (*bulk true, with tensor maps tm[0] of msb and tm[1] of lsb for boxes of
// box_cols columns by box_rows rows, laid out with `swizzle`), else by
// plain loads (*bulk false).
inline cudaError_t stage_by_tma(
    CUtensorMap (&tm)[2], bool* bulk, const int8_t* msb, const int8_t* lsb,
    int k_dim, int n, int box_cols, const int8_t* x,
    int box_rows = kStageRows,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  *bulk = ((uintptr_t)msb | (uintptr_t)lsb | (uintptr_t)x) % 16 == 0
          && n % 16 == 0 && k_dim % 16 == 0 && k_dim > 0;
  if (!*bulk) return cudaSuccess;
  const cudaError_t err = plane_map(&tm[0], msb, k_dim, n, box_cols,
                                    box_rows, swizzle);
  return err != cudaSuccess ? err : plane_map(&tm[1], lsb, k_dim, n,
                                              box_cols, box_rows, swizzle);
}

// Ramp conversion of CPT values at once: the number of boundaries strictly
// below each, in any boundary order.  Each boundary is loaded once for all
// of them, eight loads in flight at a time.
template <int CPT>
__device__ __forceinline__ void ramp_codes(const float (&x)[CPT],
                                           int (&code)[CPT],
                                           const float* bounds,
                                           int n_codes) {
#pragma unroll
  for (int j = 0; j < CPT; ++j) code[j] = 0;
  int i = 0;
  for (; i + 8 <= n_codes - 1; i += 8) {
    float b[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) b[u] = bounds[i + u];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int j = 0; j < CPT; ++j) code[j] += x[j] > b[u];
  }
  for (; i < n_codes - 1; ++i) {
    const float b = bounds[i];
#pragma unroll
    for (int j = 0; j < CPT; ++j) code[j] += x[j] > b;
  }
}

// float(v) for an int8 value, exact, by integer add and one float
// subtraction (the 2^23 + 2^22 trick) instead of the quarter-rate I2F.
__device__ __forceinline__ float i8_to_f32(int v) {
  return __int_as_float(0x4B400000 + v) - 0x1.8p23f;
}

// Adds the staged weight rows of the inputs set in `live` (a ballot over 32
// input rows; lane b holds input b's value in `xv`): rows of BN = 32 CPT
// columns, all in bounds (columns past the layer hold stale bytes whose
// sums are never read), so no column is guarded and each event's 2 CPT
// plane bytes load together; two events a pass, added in order.  With
// ternary events and planes every product (s * w, ratio * m) is exact, so
// fmaf rounds as the reference's multiply-then-add does, and every partial
// is a small integer: the same bits in any order.
template <int CPT>
__device__ __forceinline__ void mac_add_rows_staged(float (&acc)[CPT],
                                                    unsigned live, int xv,
                                                    const int8_t* msb,
                                                    const int8_t* lsb,
                                                    float ratio, int lane) {
  constexpr int BN = 32 * CPT;
  while (live) {
    const int b0 = __ffs(live) - 1;
    live &= live - 1;
    const bool two = live != 0u;
    const int b1 = two ? __ffs(live) - 1 : b0;
    if (two) live &= live - 1;
    const float s0 = i8_to_f32(__shfl_sync(kFull, xv, b0));
    const float s1 = i8_to_f32(__shfl_sync(kFull, xv, b1));
    int m0[CPT], l0[CPT], m1[CPT], l1[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      m0[j] = msb[b0 * BN + lane + 32 * j];
      l0[j] = lsb[b0 * BN + lane + 32 * j];
      m1[j] = msb[b1 * BN + lane + 32 * j];
      l1[j] = lsb[b1 * BN + lane + 32 * j];
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      acc[j] = fmaf(s0, fmaf(ratio, i8_to_f32(m0[j]), i8_to_f32(l0[j])),
                    acc[j]);
    if (two) {
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        acc[j] = fmaf(s1, fmaf(ratio, i8_to_f32(m1[j]), i8_to_f32(l1[j])),
                      acc[j]);
    }
  }
}

// Dynamic shared memory of staged_mac's ring for BN columns a tile and
// `items` (step, row) items a CTA: kStages stages of (kStageRows x BN) MSB
// and LSB planes and the items' (items x kStageRows) event bytes, then one
// mbarrier a stage.
__host__ __device__ constexpr int staged_mac_smem(int bn, int items) {
  return kStages * kStageRows * (2 * bn + items) + 8 * kStages;
}

// The MAC of IPW (step, row) items per warp for NCT column tiles of
// BN = 32 CPT columns, the first starting at column c_base.  The CTA owns
// kItemWarps * IPW consecutive items, of which the first n_rows exist; their
// event rows (k_dim int8 values each, the first at x_cta) and the (k_dim, n)
// planes stream through a kStages-stage ring in
// shared memory (`ring`, staged_mac_smem(BN, kItemWarps * IPW) bytes,
// 16-byte aligned).  The block is kMacThreads threads: kItemWarps item
// warps and, last, a copy warp.  With `bulk` (stage_by_tma, which makes the
// planes' tensor maps tm_msb and tm_lsb) the copy warp copies each tile as
// one TMA copy a plane and a bulk copy an event row, completing on the
// stage's mbarrier, kStages - 1 tiles ahead of the MAC, off the item warps'
// path; otherwise every thread copies it with plain loads.
// Each byte is read from global memory once per CTA.  Every thread of the
// block must call it (it holds __syncthreads).
//
// Item i of warp w is slot w * IPW + i; on[i] false: no events (its MAC
// stays 0).  occ[i] gates it (one word per bk rows of K, or null): a chunk
// whose word is 0 is not read.  K need not be a whole number of chunks:
// lanes past k_dim read no event.  Events are added in ascending K, each as
// acc + s * (ratio * msb + lsb) (mac_add_rows_staged): the plain version's
// order and rounding, so the same bits.  With kBits it returns the tile
// bits: bit k / bk of word i for each 32-row chunk starting at k that held
// an event of item i (kept in registers; without kBits none is computed, so
// a caller that needs none pays nothing in the event loop).  After the last
// K tile of column tile ct, epi(ct, acc) receives acc[i][j] for column
// c_base + BN ct + lane + 32 j.
template <int IPW>
struct TileBits {
  unsigned w[IPW];
};

template <int CPT, int NCT, int IPW, bool kBits = false, class Epi>
__device__ __forceinline__ TileBits<IPW> staged_mac(
    int8_t* ring, const int8_t* msb, const int8_t* lsb,
    const CUtensorMap* tm_msb, const CUtensorMap* tm_lsb, int k_dim, int n,
    int c_base, bool bulk, const int8_t* x_cta, int n_rows,
    const bool (&on)[IPW], const int32_t* const (&occ)[IPW], int bk,
    float ratio, Epi&& epi) {
  constexpr int BN = 32 * CPT;
  constexpr int kItems = kItemWarps * IPW;
  constexpr int kStage = kStageRows * (2 * BN + kItems);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_kt = (k_dim + kStageRows - 1) / kStageRows;
  const int total = NCT * n_kt;
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  TileBits<IPW> bits;
#pragma unroll
  for (int i = 0; i < IPW; ++i) bits.w[i] = 0u;
  if (bulk && threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&bar[i]);
    fence_mbar_init();
  }
  __syncthreads();
  // tile q into stage q % kStages (called after a barrier that every read
  // of the stage's previous tile precedes)
  auto issue = [&](int q) {
    if (q >= total) return;
    const int ct = q / n_kt, k0 = (q - ct * n_kt) * kStageRows;
    const int c0 = c_base + ct * BN;
    const int rows = min(kStageRows, k_dim - k0), cols = min(BN, n - c0);
    int8_t* st = ring + (q % kStages) * kStage;
    const size_t g = (size_t)k0 * n + c0;
    if (bulk) {
      if (warp != kItemWarps) return;
      uint64_t* b = &bar[q % kStages];
      if (lane == 0) {
        // whole boxes: the rows and columns past the planes count too
        mbar_expect(b, (uint32_t)((cols > 0 ? 2 * kStageRows * BN : 0)
                                  + n_rows * rows));
        if (cols > 0) {
          tma_load_2d(st, tm_msb, c0, k0, b);
          tma_load_2d(st + kStageRows * BN, tm_lsb, c0, k0, b);
        }
      }
      __syncwarp();
      bulk_tile(st + 2 * kStageRows * BN, kStageRows, x_cta + k0, k_dim,
                n_rows, rows, b, lane);
    } else {
      if (cols > 0) {
        copy_tile(st, BN, msb + g, n, rows, cols);
        copy_tile(st + kStageRows * BN, BN, lsb + g, n, rows, cols);
      }
      copy_tile(st + 2 * kStageRows * BN, kStageRows, x_cta + k0, k_dim,
                n_rows, rows);
    }
  };
  for (int q = 0; q < kStages - 1; ++q) issue(q);
  int q = 0;
#pragma unroll
  for (int ct = 0; ct < NCT; ++ct) {
    float acc[IPW][CPT];
#pragma unroll
    for (int i = 0; i < IPW; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = 0.0f;
    for (int kt = 0; kt < n_kt; ++kt, ++q) {
      const int k0 = kt * kStageRows, k1 = min(k_dim, k0 + kStageRows);
      // the gate words of this tile are loaded here and read after the
      // barrier, so their loads are in flight while the stage lands
      int word[IPW][kStageRows / 32];
#pragma unroll
      for (int i = 0; i < IPW; ++i)
#pragma unroll
        for (int u = 0; u < kStageRows / 32; ++u) {
          const int kc = k0 + 32 * u;
          word[i][u] = on[i] && kc < k1
                       ? (occ[i] == nullptr ? 1 : occ[i][kc / bk]) : 0;
        }
      if (bulk) mbar_wait(&bar[q % kStages], (q / kStages) & 1);
      __syncthreads();
      issue(q + kStages - 1);
      const int8_t* s_msb = ring + (q % kStages) * kStage;
      const int8_t* s_lsb = s_msb + kStageRows * BN;
      const int8_t* s_x = s_lsb + kStageRows * BN;
#pragma unroll
      for (int i = 0; i < IPW; ++i) {
        if (warp == kItemWarps) break;   // the copy warp
        const int8_t* xs = s_x + (warp * IPW + i) * kStageRows;
#pragma unroll
        for (int u = 0; u < kStageRows / 32; ++u) {
          const int xv = word[i][u] != 0 && k0 + 32 * u + lane < k1
                         ? xs[32 * u + lane] : 0;
          const unsigned live = __ballot_sync(kFull, xv != 0);
          if (kBits && ct == 0 && live != 0u)
            bits.w[i] |= 1u << ((k0 + 32 * u) / bk);
          mac_add_rows_staged<CPT>(acc[i], live, xv, s_msb + 32 * u * BN,
                                   s_lsb + 32 * u * BN, ratio, lane);
        }
      }
    }
    epi(ct, acc);
  }
  return bits;
}

}  // namespace fm
