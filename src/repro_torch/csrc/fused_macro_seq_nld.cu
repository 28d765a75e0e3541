// Fused seq-NLD macro kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/fused_macro.py::_seq_nld_kernel
// (entry fused_macro_seq, mode "nld").  Per time step and batch row: the
// twin-cell ternary MAC over J branch-major column planes -> mac * scale ->
// the activation ramp's codes -> optional Fig. 7 counter noise -> the
// activation LUT -> the soma combine sum_j act_j * w_dend_j -> x drive_gain
// -> a dense LIF update without SNL, the membrane carried across T.
//
// What bounds it on the card: by the roofline, bytes.  At the DVS-Gesture
// serving shape (64 rows, K=512, J=2 branches of 128 neurons, 8 steps a
// round, 5 % events) one launch reads the events, the two int8 planes and
// the membrane and writes spikes, mask, steps and membrane, about a MB; the
// MAC the events need is a few M operations (chip_smoke.py computes both
// from its inputs).  As in the KWN kernel, neither is reached: T dependent
// steps per row (the membrane) make it latency-bound.
//
// What the design does about that: one warp owns one batch row for the whole
// sequence.  The kernel walks the J branches one after another; branch j's
// column p and neuron p sit on the same lane and register slot (p % 32,
// p / 32), so the soma combine is lane-local and the membrane stays in
// registers, whatever the per-branch width.  The MAC is event-driven (a warp
// ballot over 32 inputs, only the weight rows of the inputs that fired) and
// gated by the host occupancy map; the events are re-read once per branch
// (from L1).  Mask (all ones) and ADC steps (always the full ramp) are
// constants of the NLD head: the wrapper fills them, the kernel writes
// neither.
//
// Bitwise parity with the reference: the MAC partials are small integers;
// mac * scale is one f32 product (built with -fmad=false, nothing is
// contracted into it); the soma sum is the fused multiply-add chain XLA
// emits for jnp.sum(act3 * w_dend, axis=-2): the branch-0 product, then
// fmaf(act_j, w_dend_j, sum) in branch order; then * drive_gain (rounded)
// and fmaf(beta, v, drive).  The counter noise keys on the logical column
// j * logical_n + p, so padding never moves a draw.

#include "fused_macro_common.cuh"

extern "C" {

// Mirrored by repro_torch/kernels/fused_macro.py::_NldParams.
struct FmsnParams {
  const int8_t* x;         // (T, M, K) ternary events
  const int8_t* msb;       // (K, J*N) twin-cell MSB plane, branch-major
  const int8_t* lsb;       // (K, J*N) twin-cell LSB plane
  const float* bounds;     // (n_codes - 1) activation-ramp thresholds
  const float* levels;     // (n_codes) activation LUT
  const float* scale;      // (J*N) per-(branch, column) weight scale
  const float* w_dend;     // (J, N) soma combine weights
  const float* v0;         // (M, N) initial membrane
  const int32_t* activity; // (T, M / bm, K / bk) occupancy, or null
  const int32_t* row_ctl;  // (M, 3) [seed, step_offset, row_id]
  float* mac;              // (T, M, J*N) raw MAC, or null
  float* v_out;            // (M, N)
  float* spikes;           // (T, M, N)
  int t_steps, m, k_dim, n, n_branches, logical_n, n_codes, bm, bk, noisy;
  float ratio, drive_gain, beta, v_th1, v_reset, v_lim;
  float offset_lsb, sigma_lsb, inl_lsb, in_lo, in_span;
};

}  // extern "C"

namespace {

using namespace fm;

// One warp per batch row, NPL neurons per lane (p = lane + 32 jp).
template <int NPL>
__global__ void __launch_bounds__(32 * kRowsPerCta)
fmsn_kernel(const FmsnParams p) {
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
  const int nc = p.n_branches * n;
  const int n_i = p.m / p.bm, n_k = p.k_dim / p.bk;
  const int tile_i = row / p.bm;
  const uint32_t seed = (uint32_t)p.row_ctl[row * 3 + 0];
  const int32_t step0 = p.row_ctl[row * 3 + 1];
  const uint32_t rid = (uint32_t)p.row_ctl[row * 3 + 2];
  const NoiseModel nm = {p.offset_lsb, p.sigma_lsb, p.inl_lsb, p.in_lo,
                         p.in_span, p.n_codes};
  const LifParams lp = {p.beta, p.v_th1, p.v_th1, p.v_reset, p.v_lim};

  float v[NPL];
#pragma unroll
  for (int jp = 0; jp < NPL; ++jp) {
    const int c = lane + 32 * jp;
    v[jp] = c < n ? p.v0[(size_t)row * n + c] : 0.0f;
  }

  for (int t = 0; t < p.t_steps; ++t) {
    const int8_t* xr = p.x + ((size_t)t * p.m + row) * p.k_dim;
    const int32_t* occ = p.activity == nullptr ? nullptr
        : p.activity + ((size_t)t * n_i + tile_i) * n_k;
    float soma[NPL];
#pragma unroll
    for (int jp = 0; jp < NPL; ++jp) soma[jp] = 0.0f;
    for (int b = 0; b < p.n_branches; ++b) {
      // --- branch b's MAC, event-driven and activity-gated ---------------
      float acc[NPL];
#pragma unroll
      for (int jp = 0; jp < NPL; ++jp) acc[jp] = 0.0f;
      mac_events<NPL>(acc, xr, occ, p.k_dim, p.bk, p.msb + (size_t)b * n,
                      p.lsb + (size_t)b * n, nc, n, p.ratio, lane);
      // --- mac * scale -> activation ramp (+ noise) -> LUT -> soma -------
#pragma unroll
      for (int jp = 0; jp < NPL; ++jp) {
        const int c = lane + 32 * jp;
        if (c >= n) continue;
        const int col = b * n + c;
        if (p.mac != nullptr)
          p.mac[((size_t)t * p.m + row) * nc + col] = acc[jp];
        const float xf = acc[jp] * p.scale[col];
        int cd = ramp_code(xf, s_bounds, p.n_codes);
        if (p.noisy)
          cd = noisy_code(cd, xf, seed, (uint32_t)(step0 + t), rid,
                          (uint32_t)(b * p.logical_n + c), nm);
        const float act = s_levels[cd];
        const float wd = p.w_dend[col];
        soma[jp] = b == 0 ? act * wd : fmaf(act, wd, soma[jp]);
      }
    }

    // --- dense LIF update, no SNL (Eq. 2) ------------------------------
    const size_t base = ((size_t)t * p.m + row) * n;
#pragma unroll
    for (int jp = 0; jp < NPL; ++jp) {
      const int c = lane + 32 * jp;
      if (c >= n) continue;
      const float drive = soma[jp] * p.drive_gain;
      float spike;
      v[jp] = lif_update(v[jp], drive, true, 0.0f, false, lp, &spike);
      p.spikes[base + c] = spike;
    }
  }
#pragma unroll
  for (int jp = 0; jp < NPL; ++jp) {
    const int c = lane + 32 * jp;
    if (c < n) p.v_out[(size_t)row * n + c] = v[jp];
  }
}

template <int NPL>
cudaError_t launch(const FmsnParams& p, cudaStream_t stream) {
  const dim3 grid((p.m + kRowsPerCta - 1) / kRowsPerCta);
  const size_t smem = 2 * sizeof(float) * (size_t)p.n_codes;
  fmsn_kernel<NPL><<<grid, 32 * kRowsPerCta, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fmsn_launch(const FmsnParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int npl = (p->n + 31) / 32;
  cudaError_t err;
  if (p->m == 0 || p->t_steps == 0) return 0;
  if (p->n_branches < 1) return (int)cudaErrorInvalidValue;
  if (npl <= 1) err = launch<1>(*p, s);
  else if (npl <= 2) err = launch<2>(*p, s);
  else if (npl <= 4) err = launch<4>(*p, s);
  else if (npl <= 8) err = launch<8>(*p, s);
  else if (npl <= 16) err = launch<16>(*p, s);
  else if (npl <= 32) err = launch<32>(*p, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
