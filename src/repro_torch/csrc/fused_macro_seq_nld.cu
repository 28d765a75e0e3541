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
// the membrane and writes spikes and membrane, about a MB; the MAC the
// events need is a few M operations (chip_smoke.py computes both from its
// inputs).  In practice latency bounds it: the TPU kernel walks T in a
// sequential grid, and a port of that shape (one warp a row for all T steps,
// J event-driven MACs a step from global memory) leaves the card M / 4 CTAs
// of T dependent steps each.
//
// What the design does about it: only the LIF update needs the previous
// step, so the launch is two kernels back to back on one stream.
//
//   A. fmsn_head, parallel over all T x M (step, row) items and the J x N
//      columns: one warp an item, kItemWarps items and one column tile of
//      32 CPT columns (128 from J x N = 128 up) a CTA, and a copy warp that
//      streams the tile's plane columns and the CTA's event rows through a
//      shared-memory ring by the TMA unit on mbarriers (staged_mac in
//      fused_macro_common.cuh).  A plane tile is one copy through a 2D
//      tensor map: 128 columns of wider planes cost what contiguous ones
//      do, where one bulk copy a 128-byte row held the head to the copy
//      unit's rate.  Rows that are not 16-byte multiples (J x N = 100) take
//      the plain-copy path.  The MAC is event-driven from shared memory and
//      keeps the activity gate.  No state crosses a
//      column (there is no sweep), so the column tiles are CTAs of their own
//      and any width fits.  Then, per (branch, column): the MAC telemetry,
//      mac * scale, the activation ramp, the counter noise on the logical
//      column j * logical_n + p, and the LUT, into a (T, M, J x N) f32
//      scratch of activations the wrapper allocates (0.5 MB at the serving
//      round, 2 MB at T=30: it stays in L2).
//   B. fmsn_lif, the recurrence: one thread a (row, neuron) walks t with
//      the membrane in a register.  The soma sum needs neuron p's J
//      branches, which sit in J different column tiles (and on one lane only
//      when the per-branch width is a multiple of 32: plan_tiles keeps
//      n_pad = n whenever J x N <= 128, so J=2, N=50 straddles lanes), so it
//      is done here and not in the head: the activations of kLifChunk steps
//      are loaded a chunk ahead (kLifBranches branches in registers, the
//      rest as they are needed) and summed by the fused multiply-add chain
//      after the chunk before, so only the LIF update is serial.  Combining
//      the branches in the head through shared memory would make each CTA
//      hold every branch of its columns, so the column tiles could not be
//      CTAs of their own.
// Mask (all ones) and ADC steps (always the full ramp) are constants of the
// NLD head: the LIF writes them beside the spikes.
//
// Bitwise parity with the reference: the MAC partials are small integers;
// mac * scale is one f32 product (built with -fmad=false, nothing is
// contracted into it); the activations go through the scratch as the f32
// they are; the soma sum is the fused multiply-add chain XLA emits for
// jnp.sum(act3 * w_dend, axis=-2): the branch-0 product, then
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
  float* mask;             // (T, M, N): all ones
  int32_t* steps;          // (T, M): all n_codes - 1
  float* act;              // (T, M, J*N) scratch: the head's activations
  int t_steps, m, k_dim, n, n_branches, logical_n, n_codes, bm, bk, noisy;
  float ratio, drive_gain, beta, v_th1, v_reset, v_lim;
  float offset_lsb, sigma_lsb, inl_lsb, in_lo, in_span;
};

}  // extern "C"

namespace {

using namespace fm;

constexpr int kLifThreads = 64;    // M*N threads: spread over more SMs
constexpr int kLifChunk = 8;       // steps whose operands phase B loads at once
constexpr int kLifBranches = 4;    // branches a chunk holds in registers

// ---------------------------------------------------------------------------
// Phase A: CTA -> kItemWarps items x one tile of BN = 32 CPT columns of the
// J*N; warp -> item t * M + row.
// ---------------------------------------------------------------------------

template <int CPT>
__global__ void __launch_bounds__(kMacThreads, 2)
fmsn_head(const FmsnParams p,
          const __grid_constant__ CUtensorMap tm_msb,
          const __grid_constant__ CUtensorMap tm_lsb, int bulk) {
  constexpr int BN = 32 * CPT;
  extern __shared__ __align__(16) int8_t smem[];
  float* s_bounds = reinterpret_cast<float*>(
      smem + staged_mac_smem(BN, kItemWarps));
  float* s_levels = s_bounds + p.n_codes;
  for (int i = threadIdx.x; i < p.n_codes; i += blockDim.x) {
    if (i < p.n_codes - 1) s_bounds[i] = p.bounds[i];
    s_levels[i] = p.levels[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int items = p.t_steps * p.m, first = blockIdx.x * kItemWarps;
  const int item = first + (threadIdx.x >> 5);
  const bool live = (threadIdx.x >> 5) < kItemWarps && item < items;
  const int n = p.n, nc = p.n_branches * n, c_base = blockIdx.y * BN;
  const int t = live ? item / p.m : 0, row = item - t * p.m;
  const int n_i = p.m / p.bm, n_k = p.k_dim / p.bk;
  const bool on[1] = {live};
  const int32_t* occ[1] = {
      live && p.activity != nullptr
          ? p.activity + ((size_t)t * n_i + row / p.bm) * n_k : nullptr};
  const uint32_t seed = live ? (uint32_t)p.row_ctl[row * 3 + 0] : 0u;
  const int32_t step0 = live ? p.row_ctl[row * 3 + 1] : 0;
  const uint32_t rid = live ? (uint32_t)p.row_ctl[row * 3 + 2] : 0u;
  const NoiseModel nm = {p.offset_lsb, p.sigma_lsb, p.inl_lsb, p.in_lo,
                         p.in_span, p.n_codes};
  const size_t base = (size_t)item * nc;
  float sc[CPT];   // loaded now, read after the MAC
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int c = c_base + lane + 32 * j;
    sc[j] = live && c < nc ? p.scale[c] : 0.0f;
  }

  // --- MAC -> mac * scale -> activation ramp (+ noise) -> LUT ------------
  staged_mac<CPT, 1, 1>(
      smem, p.msb, p.lsb, &tm_msb, &tm_lsb, p.k_dim, nc, c_base,
      bulk != 0, p.x + (size_t)first * p.k_dim,
      min(kItemWarps, items - first), on, occ, p.bk, p.ratio,
      [&](int, float (&acc)[1][CPT]) {
        float xf[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) xf[j] = acc[0][j] * sc[j];
        int code[CPT];
        ramp_codes<CPT>(xf, code, s_bounds, p.n_codes);
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = c_base + lane + 32 * j;
          if (!live || c >= nc) continue;
          if (p.mac != nullptr) p.mac[base + c] = acc[0][j];
          int cd = code[j];
          if (p.noisy) {
            const int b = c / n;
            cd = noisy_code(cd, xf[j], seed, (uint32_t)(step0 + t), rid,
                            (uint32_t)(b * p.logical_n + (c - b * n)), nm);
          }
          p.act[base + c] = s_levels[cd];
        }
      });
}

// ---------------------------------------------------------------------------
// Phase B: thread -> (row, neuron), the soma sum and the membrane across T.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kLifThreads) fmsn_lif(const FmsnParams p) {
  const int idx = blockIdx.x * kLifThreads + threadIdx.x;
  const int n = p.n, nb = p.n_branches;
  if (idx >= p.m * n) return;
  const int row = idx / n, c = idx - row * n;
  const size_t nc = (size_t)nb * n;
  const LifParams lp = {p.beta, p.v_th1, p.v_th1, p.v_reset, p.v_lim};
  float wd[kLifBranches];
#pragma unroll
  for (int b = 0; b < kLifBranches; ++b)
    wd[b] = b < nb ? p.w_dend[(size_t)b * n + c] : 0.0f;
  // branch b of neuron c at step t
  auto at = [&](int t, int b) {
    return ((size_t)t * p.m + row) * nc + (size_t)b * n + c;
  };
  // the soma sums of kLifChunk steps.  The first kLifBranches branches'
  // activations are loaded into registers a chunk ahead and summed after
  // the current chunk's updates, so their loads are in flight meanwhile;
  // further branches are loaded as they are summed.
  float raw[kLifBranches][kLifChunk];
  auto load = [&](int t0) {
#pragma unroll
    for (int b = 0; b < kLifBranches; ++b)
#pragma unroll
      for (int i = 0; i < kLifChunk; ++i)
        raw[b][i] = b < nb && t0 + i < p.t_steps ? p.act[at(t0 + i, b)]
                                                 : 0.0f;
  };
  auto sum = [&](int t0, float (&soma)[kLifChunk]) {
#pragma unroll
    for (int i = 0; i < kLifChunk; ++i) soma[i] = raw[0][i] * wd[0];
#pragma unroll
    for (int b = 1; b < kLifBranches; ++b)
      if (b < nb)
#pragma unroll
        for (int i = 0; i < kLifChunk; ++i)
          soma[i] = fmaf(raw[b][i], wd[b], soma[i]);
    for (int b = kLifBranches; b < nb; ++b) {
      const float w = p.w_dend[(size_t)b * n + c];
#pragma unroll
      for (int i = 0; i < kLifChunk; ++i)
        if (t0 + i < p.t_steps) soma[i] = fmaf(p.act[at(t0 + i, b)], w,
                                               soma[i]);
    }
  };
  float v = p.v0[idx];
  float soma[kLifChunk];
  load(0);
  sum(0, soma);
  for (int t0 = 0; t0 < p.t_steps; t0 += kLifChunk) {
    load(t0 + kLifChunk);
#pragma unroll
    for (int i = 0; i < kLifChunk; ++i) {
      const int t = t0 + i;
      if (t >= p.t_steps) break;
      float spike;
      v = lif_update(v, soma[i] * p.drive_gain, true, 0.0f, false, lp,
                     &spike);
      const size_t e = ((size_t)t * p.m + row) * n + c;
      p.spikes[e] = spike;
      p.mask[e] = 1.0f;
      if (c == 0) p.steps[(size_t)t * p.m + row] = p.n_codes - 1;
    }
    sum(t0 + kLifChunk, soma);
  }
  p.v_out[idx] = v;
}

template <int CPT>
cudaError_t launch(const FmsnParams& p, cudaStream_t stream) {
  constexpr int BN = 32 * CPT;
  static size_t smem_set = 48 * 1024;   // the default dynamic limit
  const size_t smem = staged_mac_smem(BN, kItemWarps)
                      + 2 * sizeof(float) * (size_t)p.n_codes;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fmsn_head<CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const int items = p.t_steps * p.m, nc = p.n_branches * p.n;
  const dim3 grid((items + kItemWarps - 1) / kItemWarps, (nc + BN - 1) / BN);
  CUtensorMap tm[2] = {};
  bool bulk = false;
  cudaError_t err = stage_by_tma(tm, &bulk, p.msb, p.lsb, p.k_dim, nc, BN,
                                 p.x);
  if (err != cudaSuccess) return err;
  fmsn_head<CPT><<<grid, kMacThreads, smem, stream>>>(p, tm[0], tm[1], bulk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fmsn_lif<<<(p.m * p.n + kLifThreads - 1) / kLifThreads, kLifThreads, 0,
             stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fmsn_launch(const FmsnParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->m == 0 || p->t_steps == 0 || p->n == 0) return 0;
  if (p->n_branches < 1) return (int)cudaErrorInvalidValue;
  const int nc = p->n_branches * p->n;
  cudaError_t err;
  if (nc <= 32) err = launch<1>(*p, s);
  else if (nc <= 64) err = launch<2>(*p, s);
  else err = launch<4>(*p, s);
  return (int)err;
}
