// Fused seq-KWN macro kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/fused_macro.py::_seq_kwn_kernel
// (entry fused_macro_seq, mode "kwn").  Per time step and batch row:
// twin-cell ternary MAC -> ramp codes -> optional Fig. 7 counter noise ->
// KWN descending priority sweep with early stop -> LUT x scale x mask x gain
// -> LIF with SNL, the membrane carried across T.
//
// What bounds it on the card: by the roofline, bytes.  At the serving shape
// (64 rows, K=512, N=128, 8 steps a round, 5 % events) one launch moves
// about 1.25 MB (the dense SNL noise in, spikes and mask out), 0.37 us at
// 3.35 TB/s, and the MAC the events need is about 5 M operations, under
// 0.1 us of CUDA-core time (chip_smoke.py computes both from its inputs).
// In practice neither is reached: the work is a serial chain of T dependent
// steps per row (the membrane), so latency bounds it: launch overhead plus
// T x (MAC + head + LIF) per row.
//
// What the design does about that: one warp owns one batch row for the whole
// sequence, so the membrane, the MAC accumulator and the winner mask live in
// registers (32 lanes x up to 32 columns each) and no step needs a block-wide
// barrier.  The MAC is event-driven: a warp ballots 32 inputs at a time and
// adds only the weight rows of the inputs that fired, and a K tile whose
// occupancy word is 0 (the host activity map) is not even read; a CTA's four
// rows lie inside one row tile of the plan, so that word is a conservative
// gate.  The KWN sweep is a warp ballot per code level in column order, which
// is the priority encoder's admission order.  Wider grids (splitting columns
// across warps) and CUDA graphs over rounds are left to later work.
//
// Bitwise parity with the reference: every MAC partial is a small integer
// (exact in f32 in any order); the kernel is built with -fmad=false, and the
// reference's fused multiply-adds (the LIF update, the noise offset, the INL
// term, the log polynomial) are written out as fmaf.  The noise path uses the
// same Threefry-2x32-20 words and reproduces the reference's f32 log (Cephes
// with FMAs) and the C library's double-precision sinf/cosf, with IEEE
// sqrtf and division; see repro_torch/core/f32math.py for the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerCta = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kTagIma = 0x494D4101u;
constexpr uint32_t kTagSnl = 0x534E4C01u;
constexpr float kTwoPiF = 0x1.921fb6p+2f;

}  // namespace

extern "C" {

// Mirrored by repro_torch/kernels/fused_macro.py::_Params.
struct FmskParams {
  const int8_t* x;         // (T, M, K) ternary events
  const int8_t* msb;       // (K, N) twin-cell MSB plane
  const int8_t* lsb;       // (K, N) twin-cell LSB plane
  const float* bounds;     // (n_codes - 1) ramp thresholds
  const float* levels;     // (n_codes) LUT
  const float* scale;      // (N) per-column weight scale
  const float* v0;         // (M, N) initial membrane
  const float* noise;      // (T, M, N) SNL noise, or null (counter stream)
  const int32_t* activity; // (T, M / bm, K / bk) occupancy, or null
  const int32_t* row_ctl;  // (M, 3) [seed, step_offset, row_id]
  float* mac;              // (T, M, N) raw MAC, or null
  float* v_out;            // (M, N)
  float* spikes;           // (T, M, N)
  float* mask;             // (T, M, N)
  int32_t* steps;          // (T, M)
  int t_steps, m, k_dim, n, n_valid, k, n_codes, bm, bk, use_snl, noisy;
  float ratio, drive_gain, beta, v_th1, v_th2, v_reset, v_lim, snl_amp;
  float offset_lsb, sigma_lsb, inl_lsb, in_lo, in_span;
};

}  // extern "C"

namespace {

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
// The kernel: one warp per batch row, CPL columns per lane (c = lane + 32 j).
// ---------------------------------------------------------------------------

template <int CPL>
__global__ void __launch_bounds__(32 * kRowsPerCta)
fmsk_kernel(const FmskParams p) {
  extern __shared__ float sh[];
  float* s_bounds = sh;
  float* s_levels = sh + p.n_codes;
  for (int i = threadIdx.x; i < p.n_codes; i += blockDim.x) {
    if (i < p.n_codes - 1) s_bounds[i] = p.bounds[i];
    s_levels[i] = p.levels[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerCta + (threadIdx.x >> 5);
  if (row >= p.m) return;
  const int n = p.n;
  const int n_i = p.m / p.bm, n_k = p.k_dim / p.bk;
  const int tile_i = row / p.bm;
  const uint32_t seed = (uint32_t)p.row_ctl[row * 3 + 0];
  const int32_t step0 = p.row_ctl[row * 3 + 1];
  const uint32_t rid = (uint32_t)p.row_ctl[row * 3 + 2];
  const unsigned lanes_below = (1u << lane) - 1u;
  const NoiseModel nm = {p.offset_lsb, p.sigma_lsb, p.inl_lsb, p.in_lo,
                         p.in_span, p.n_codes};

  float v[CPL], sc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < n ? p.v0[(size_t)row * n + c] : 0.0f;
    sc[j] = c < n ? p.scale[c] : 0.0f;
  }

  for (int t = 0; t < p.t_steps; ++t) {
    // --- twin-cell ternary MAC, event-driven and activity-gated ----------
    float acc[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[j] = 0.0f;
    const int8_t* xr = p.x + ((size_t)t * p.m + row) * p.k_dim;
    for (int kt = 0; kt < n_k; ++kt) {
      if (p.activity != nullptr &&
          p.activity[((size_t)t * n_i + tile_i) * n_k + kt] == 0)
        continue;
      for (int k0 = kt * p.bk; k0 < (kt + 1) * p.bk; k0 += 32) {
        const int xv = xr[k0 + lane];
        unsigned live = __ballot_sync(kFull, xv != 0);
        while (live) {
          const int b = __ffs(live) - 1;
          live &= live - 1;
          const float s = (float)__shfl_sync(kFull, xv, b);
          const int8_t* mr = p.msb + (size_t)(k0 + b) * n;
          const int8_t* lr = p.lsb + (size_t)(k0 + b) * n;
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            const int c = lane + 32 * j;
            if (c < n) {
              const float w = p.ratio * (float)mr[c] + (float)lr[c];
              acc[j] = acc[j] + s * w;
            }
          }
        }
      }
    }

    // --- ramp codes (+ Fig. 7 counter noise), padded columns -> -1 --------
    int code[CPL];
    int top = -1;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      int cd = -1;
      if (c < n && c < p.n_valid) {
        cd = 0;
        for (int i = 0; i < p.n_codes - 1; ++i) cd += acc[j] > s_bounds[i];
        if (p.noisy)
          cd = noisy_code(cd, acc[j], seed, (uint32_t)(step0 + t), rid,
                          (uint32_t)c, nm);
      }
      code[j] = cd;
      top = max(top, cd);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      top = max(top, __shfl_xor_sync(kFull, top, off));

    // --- KWN: descending ramp, priority encoder in column order -----------
    bool win[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) win[j] = false;
    int found = 0, steps = -1;
    for (int level = top; level >= 0 && found < p.k; --level) {
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int room = p.k - found;
        const bool hit = code[j] == level;
        const unsigned b = __ballot_sync(kFull, hit);
        if (hit && __popc(b & lanes_below) < room) win[j] = true;
        found += min(__popc(b), max(room, 0));
      }
      if (found >= p.k) steps = p.n_codes - 1 - level;
    }
    if (steps < 0) steps = p.n_codes - 1;

    // --- LUT drive and LIF (Eq. 1) -------------------------------------
    const size_t base = ((size_t)t * p.m + row) * n;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      if (c >= n) continue;
      const float maskf = win[j] ? 1.0f : 0.0f;
      const float recon = code[j] >= 0 ? s_levels[code[j]] : 0.0f;
      const float drive = recon * sc[j] * maskf * p.drive_gain;
      float nz = 0.0f;
      if (p.noise != nullptr) {
        nz = p.noise[base + c];
      } else if (p.use_snl && p.snl_amp != 0.0f) {
        nz = p.snl_amp * counter_sign(seed, (uint32_t)(step0 + t), rid,
                                      (uint32_t)c);
      }
      float vn = maskf > 0.0f ? fmaf(p.beta, v[j], drive) : v[j];
      if (p.use_snl && vn > p.v_th2 && vn < p.v_th1) vn = vn + nz;
      vn = fminf(fmaxf(vn, -p.v_lim), p.v_lim);
      const float spike = vn >= p.v_th1 ? 1.0f : 0.0f;
      v[j] = spike > 0.0f ? p.v_reset : vn;
      p.spikes[base + c] = spike;
      p.mask[base + c] = maskf;
      if (p.mac != nullptr) p.mac[base + c] = acc[j];
    }
    if (lane == 0) p.steps[(size_t)t * p.m + row] = steps;
  }
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    if (c < n) p.v_out[(size_t)row * n + c] = v[j];
  }
}

template <int CPL>
cudaError_t launch(const FmskParams& p, cudaStream_t stream) {
  const dim3 grid((p.m + kRowsPerCta - 1) / kRowsPerCta);
  const size_t smem = 2 * sizeof(float) * (size_t)p.n_codes;
  fmsk_kernel<CPL><<<grid, 32 * kRowsPerCta, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fmsk_launch(const FmskParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cpl = (p->n + 31) / 32;
  cudaError_t err;
  if (p->m == 0 || p->t_steps == 0) return 0;
  if (cpl <= 1) err = launch<1>(*p, s);
  else if (cpl <= 2) err = launch<2>(*p, s);
  else if (cpl <= 4) err = launch<4>(*p, s);
  else if (cpl <= 8) err = launch<8>(*p, s);
  else if (cpl <= 16) err = launch<16>(*p, s);
  else if (cpl <= 32) err = launch<32>(*p, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
