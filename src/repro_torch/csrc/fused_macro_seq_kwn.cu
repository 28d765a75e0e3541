// Fused seq-KWN macro kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/fused_macro.py::_seq_kwn_kernel
// (entry fused_macro_seq, mode "kwn").  Per time step and batch row:
// twin-cell ternary MAC -> ramp codes -> optional Fig. 7 counter noise ->
// KWN descending priority sweep with early stop -> LUT x scale x mask x gain
// -> LIF with SNL, the membrane carried across T.  With a vtrace pointer (the
// silicon-training forward, train_trace in the reference) it also writes the
// saturated membrane before the reset at every step; serving passes null.
//
// What bounds it on the card: by the roofline, bytes.  At the serving shape
// (64 rows, K=512, N=128, 8 steps a round, 5 % events) one launch moves
// about 1.25 MB (the dense SNL noise in, spikes and mask out), 0.37 us at
// 3.35 TB/s, and the MAC the events need is about 5 M operations, under
// 0.1 us of CUDA-core time (chip_smoke.py computes both from its inputs).
// In practice latency bounds it: the TPU kernel walks T in a sequential
// grid with the MAC accumulator in VMEM, and a port of that shape (one warp
// a row for all T steps) leaves the card M / 4 CTAs, each walking T
// dependent steps of MAC, ramp, noise, sweep and LIF.
//
// What the design does about it: only the LIF update needs the previous
// step, so the launch is two kernels back to back on one stream.
//
//   A. fmsk_head, the head, parallel over all T x M (step, row) items: one
//      warp an item, kItemWarps items a CTA, and a copy warp.  The copy
//      warp streams the (K, N) weight planes and the CTA's event rows
//      through a kStages-stage shared-memory ring by bulk copies (TMA) on
//      mbarriers, two 128-row tiles ahead of the MAC (staged_mac in
//      fused_macro_common.cuh; 99 KB at N >= 128, two CTAs an SM), so each
//      byte is read from L2 once per CTA and no event waits on a global
//      load.  The MAC is event-driven from shared memory and keeps the
//      activity gate (a chunk whose occupancy word is 0 is not read): at 5 %
//      events it touches a twentieth of the rows an int8 tensor-core
//      product would, and it adds the events in ascending K with the
//      rounding of mac_events, so its bits are the earlier kernel's for
//      every ratio (integer ratios give exact small integers: the plain
//      version's x @ w).  The per-event loop loads its plane bytes without
//      a column branch and converts them without I2F; the ramp loads each
//      boundary once for all of a lane's columns.  A layer wider than 128
//      columns is walked as column tiles of 128 (the planes at MAX_COLS =
//      1024 are 1 MB, past shared memory); the warp keeps every column's
//      code in registers across the tiles, so the KWN sweep still spans the
//      whole row in column order.  Then the Fig. 7 counter noise and the
//      counter SNL signs (keyed on seed, step, row, column: no membrane),
//      the sweep with its early-stop count, and the LUT drive.  The drive
//      (f32) and the SNL signs (int8) go to (T, M, N) scratch the wrapper
//      allocates (1.25 MB at the training shape: it stays in L2), with the
//      mask, steps and MAC telemetry.
//   B. fmsk_lif, the recurrence: one thread a (row, column) walks t with
//      the membrane in a register.  Drive, mask and SNL noise (the dense
//      operand, or amp x the head's signs) are loaded into registers
//      kLifChunk steps at a time, a chunk ahead of their arithmetic, so
//      only the fmaf / clip / compare chain is serial; it writes spikes,
//      the training trace and v_out.
//
// Registers (-Xptxas -v, chip_smoke.py phase 2): no spills at any width.
// The widest heads keep 16 or 32 codes and winner flags a lane, so they
// are built for one CTA an SM's register file (__launch_bounds__ with one
// block at CPL >= 16), the rest for two.
//
// Bitwise parity with the reference: every MAC partial is a small integer
// (exact in f32 in any order); the kernel is built with -fmad=false, and the
// reference's fused multiply-adds (the LIF update, the noise offset, the INL
// term, the log polynomial) are written out as fmaf.  The noise path uses the
// same Threefry-2x32-20 words and reproduces the reference's f32 log (Cephes
// with FMAs) and the C library's double-precision sinf/cosf, with IEEE
// sqrtf and division; see repro_torch/core/f32math.py for the plain version.
// The drive goes through the scratch as the f32 it is, so splitting the
// launch moves no bit.  That device code, the KWN sweep and the LIF update
// are shared with the NLD and stacked kernels (fused_macro_common.cuh).

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
  float* vtrace;           // (T, M, N) saturated pre-reset membrane, or null
  float* drive;            // (T, M, N) scratch: the head's LUT drive
  int8_t* snl;             // (T, M, N) scratch: counter SNL signs, or null
  int t_steps, m, k_dim, n, n_valid, k, n_codes, bm, bk, use_snl, noisy;
  float ratio, drive_gain, beta, v_th1, v_th2, v_reset, v_lim, snl_amp;
  float offset_lsb, sigma_lsb, inl_lsb, in_lo, in_span;
};

}  // extern "C"

namespace {

using namespace fm;

constexpr int kLifThreads = 64;    // M*N threads: spread over more SMs
constexpr int kLifChunk = 8;     // steps whose operands phase B loads at once

// ---------------------------------------------------------------------------
// Phase A: warp -> item t * M + row; CPL columns per lane (c = lane + 32 j),
// staged as NCT column tiles of CPT per lane.
// ---------------------------------------------------------------------------

template <int CPL>
__global__ void __launch_bounds__(kMacThreads, CPL >= 16 ? 1 : 2)
fmsk_head(const FmskParams p, int bulk) {
  constexpr int CPT = CPL < 4 ? CPL : 4;
  constexpr int NCT = CPL / CPT;
  extern __shared__ __align__(16) int8_t smem[];
  float* s_bounds = reinterpret_cast<float*>(
      smem + staged_mac_smem(32 * CPT, kItemWarps));
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
  const int n = p.n;
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
  const size_t base = (size_t)item * n;
  float sc[CPL];   // loaded now, read by the drive at the end
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    sc[j] = live && c < n ? p.scale[c] : 0.0f;
  }

  // --- MAC, then ramp codes (+ Fig. 7 counter noise); padding -> -1 -----
  int code[CPL];
  staged_mac<CPT, NCT, 1>(
      smem, p.msb, p.lsb, p.k_dim, n, 0, bulk != 0,
      p.x + (size_t)first * p.k_dim,
      min(kItemWarps, items - first), on, occ, p.bk, p.ratio,
      [&](int ct, float (&acc)[1][CPT]) {
        int ideal[CPT];
        ramp_codes<CPT>(acc[0], ideal, s_bounds, p.n_codes);
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = lane + 32 * (ct * CPT + j);
          int cd = -1;
          if (live && c < n && c < p.n_valid) {
            cd = ideal[j];
            if (p.noisy)
              cd = noisy_code(cd, acc[0][j], seed, (uint32_t)(step0 + t), rid,
                              (uint32_t)c, nm);
          }
          code[ct * CPT + j] = cd;
          if (live && c < n) {
            if (p.mac != nullptr) p.mac[base + c] = acc[0][j];
            if (p.snl != nullptr)
              p.snl[base + c] = (int8_t)counter_sign(
                  seed, (uint32_t)(step0 + t), rid, (uint32_t)c);
          }
        }
      });
  if (!live) return;

  // --- KWN: descending ramp, priority encoder in column order -----------
  bool win[CPL];
  const int steps = kwn_sweep<CPL>(code, win, p.k, p.n_codes, lane);

  // --- LUT drive ---------------------------------------------------------
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    if (c >= n) continue;
    const float maskf = win[j] ? 1.0f : 0.0f;
    const float recon = code[j] >= 0 ? s_levels[code[j]] : 0.0f;
    p.drive[base + c] = recon * sc[j] * maskf * p.drive_gain;
    p.mask[base + c] = maskf;
  }
  if (lane == 0) p.steps[item] = steps;
}

// ---------------------------------------------------------------------------
// Phase B: thread -> (row, column), the membrane across T (Eq. 1).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kLifThreads) fmsk_lif(const FmskParams p) {
  const int idx = blockIdx.x * kLifThreads + threadIdx.x;
  if (idx >= p.m * p.n) return;
  const LifParams lp = {p.beta, p.v_th1, p.v_th2, p.v_reset, p.v_lim};
  const size_t plane = (size_t)p.m * p.n;
  // operands that do not depend on the membrane, loaded into registers
  // and not read until their step: chunk t0 + kLifChunk is in flight while
  // chunk t0 is computed
  struct Chunk {
    float drive[kLifChunk], maskf[kLifChunk], nz[kLifChunk];
    int sign[kLifChunk];
  };
  auto load = [&](int t0, Chunk& ck) {
#pragma unroll
    for (int i = 0; i < kLifChunk; ++i) {
      const int t = t0 + i;
      const size_t e = t * plane + idx;
      const bool in = t < p.t_steps;
      ck.drive[i] = in ? p.drive[e] : 0.0f;
      ck.maskf[i] = in ? p.mask[e] : 0.0f;
      ck.nz[i] = in && p.noise != nullptr ? p.noise[e] : 0.0f;
      ck.sign[i] = in && p.snl != nullptr ? p.snl[e] : 0;
    }
  };
  float v = p.v0[idx];
  Chunk cur;
  load(0, cur);
  for (int t0 = 0; t0 < p.t_steps; t0 += kLifChunk) {
    Chunk next;
    load(t0 + kLifChunk, next);
#pragma unroll
    for (int i = 0; i < kLifChunk; ++i) {
      const int t = t0 + i;
      if (t >= p.t_steps) break;
      const size_t e = t * plane + idx;
      const float nz = p.snl != nullptr ? p.snl_amp * (float)cur.sign[i]
                                        : cur.nz[i];
      const float vc = lif_clip(v, cur.drive[i], cur.maskf[i] > 0.0f, nz,
                                p.use_snl, lp);
      const float spike = vc >= lp.v_th1 ? 1.0f : 0.0f;
      v = spike > 0.0f ? lp.v_reset : vc;
      if (p.vtrace != nullptr) p.vtrace[e] = vc;
      p.spikes[e] = spike;
    }
    cur = next;
  }
  p.v_out[idx] = v;
}

template <int CPL>
cudaError_t launch(const FmskParams& p, cudaStream_t stream) {
  constexpr int CPT = CPL < 4 ? CPL : 4;
  static size_t smem_set = 48 * 1024;   // the default dynamic limit
  const size_t smem = staged_mac_smem(32 * CPT, kItemWarps)
                      + 2 * sizeof(float) * (size_t)p.n_codes;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fmsk_head<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const int items = p.t_steps * p.m;
  fmsk_head<CPL><<<(items + kItemWarps - 1) / kItemWarps, kMacThreads,
                   smem, stream>>>(p, planes_bulk(p.msb, p.lsb, p.x, p.n));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n == 0) return err;
  fmsk_lif<<<(p.m * p.n + kLifThreads - 1) / kLifThreads, kLifThreads, 0,
             stream>>>(p);
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
