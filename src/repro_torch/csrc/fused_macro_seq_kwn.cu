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
// That device code, the MAC, the KWN sweep and the LIF update are shared with
// the NLD and stacked kernels (fused_macro_common.cuh).

#include "fused_macro_common.cuh"

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

using namespace fm;

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
  const NoiseModel nm = {p.offset_lsb, p.sigma_lsb, p.inl_lsb, p.in_lo,
                         p.in_span, p.n_codes};
  const LifParams lp = {p.beta, p.v_th1, p.v_th2, p.v_reset, p.v_lim};

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
    const int32_t* occ = p.activity == nullptr ? nullptr
        : p.activity + ((size_t)t * n_i + tile_i) * n_k;
    mac_events<CPL>(acc, xr, occ, p.k_dim, p.bk, p.msb, p.lsb, n, n, p.ratio,
                    lane);

    // --- ramp codes (+ Fig. 7 counter noise), padded columns -> -1 --------
    int code[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      int cd = -1;
      if (c < n && c < p.n_valid) {
        cd = ramp_code(acc[j], s_bounds, p.n_codes);
        if (p.noisy)
          cd = noisy_code(cd, acc[j], seed, (uint32_t)(step0 + t), rid,
                          (uint32_t)c, nm);
      }
      code[j] = cd;
    }

    // --- KWN: descending ramp, priority encoder in column order -----------
    bool win[CPL];
    const int steps = kwn_sweep<CPL>(code, win, p.k, p.n_codes, lane);

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
      float spike;
      v[j] = lif_update(v[j], drive, maskf > 0.0f, nz, p.use_snl, lp, &spike);
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
