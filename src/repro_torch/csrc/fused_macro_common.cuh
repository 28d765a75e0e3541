// Device code shared by the fused macro kernels (fused_macro_seq_kwn.cu,
// fused_macro_seq_nld.cu, fused_macro_multi_seq_kwn.cu) and the composed
// chain's stages (ternary_mac.cu, nlq_lut.cu, kwn_topk.cu, lif_step.cu):
// the counter PRNG
// and the Fig. 7 noise model, the event-driven twin-cell MAC, the ramp
// conversion, the KWN priority sweep and the LIF update.
//
// Every function reproduces the JAX reference's rounding: the kernels are
// built with -fmad=false, and the reference's fused multiply-adds are
// written out as fmaf.  The plain PyTorch versions are in
// repro_torch/kernels/ref.py, repro_torch/core/lif.py,
// repro_torch/core/ctrprng.py and repro_torch/core/f32math.py.

#pragma once

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
// MAC, ramp, KWN and LIF.  Column c of a row's width lives on lane c % 32,
// register slot c / 32.
// ---------------------------------------------------------------------------

// Adds the weight rows of the inputs set in `live` (a ballot over 32 input
// rows starting at the rows `msb`/`lsb` point to; lane b holds input b's
// value in `xv`) to the accumulator.  `ld` is the planes' row stride,
// `ncols` the number of columns to update.  Every partial is a small integer,
// exact in f32 in any order.
template <int CPL>
__device__ __forceinline__ void mac_add_rows(float (&acc)[CPL], unsigned live,
                                             int xv, const int8_t* msb,
                                             const int8_t* lsb, int ld,
                                             int ncols, float ratio,
                                             int lane) {
  while (live) {
    const int b = __ffs(live) - 1;
    live &= live - 1;
    const float s = (float)__shfl_sync(kFull, xv, b);
    const int8_t* mr = msb + (size_t)b * ld;
    const int8_t* lr = lsb + (size_t)b * ld;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      if (c < ncols) {
        const float w = ratio * (float)mr[c] + (float)lr[c];
        acc[j] = acc[j] + s * w;
      }
    }
  }
}

// The MAC of one row's events xr (k_dim ternary int8 values), gated by the
// row tile's occupancy words `occ` (n_k = k_dim / bk words, or null): a K
// tile whose word is 0 holds no event in any row of the tile and is not
// read.  Returns a bit per K tile that held an event of this row.
template <int CPL>
__device__ __forceinline__ unsigned mac_events(
    float (&acc)[CPL], const int8_t* xr, const int32_t* occ, int k_dim,
    int bk, const int8_t* msb, const int8_t* lsb, int ld, int ncols,
    float ratio, int lane) {
  unsigned bits = 0;
  const int n_k = k_dim / bk;
  for (int kt = 0; kt < n_k; ++kt) {
    if (occ != nullptr && occ[kt] == 0) continue;
    for (int k0 = kt * bk; k0 < (kt + 1) * bk; k0 += 32) {
      const int xv = xr[k0 + lane];
      const unsigned live = __ballot_sync(kFull, xv != 0);
      if (live) bits |= 1u << kt;
      mac_add_rows<CPL>(acc, live, xv, msb + (size_t)k0 * ld,
                        lsb + (size_t)k0 * ld, ld, ncols, ratio, lane);
    }
  }
  return bits;
}

// Ramp conversion: the number of boundaries strictly below x.
__device__ __forceinline__ int ramp_code(float x, const float* bounds,
                                         int n_codes) {
  int cd = 0;
  for (int i = 0; i < n_codes - 1; ++i) cd += x > bounds[i];
  return cd;
}

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

}  // namespace fm
