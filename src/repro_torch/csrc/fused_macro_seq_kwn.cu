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
// step, so the launch is two kernels back to back on one stream, the KWN
// layer of fused_macro_kwn_layer.cuh (shared with the stacked kernel):
//
//   A. kwn_head, the head, parallel over all T x M (step, row) items: one
//      warp an item, kItemWarps items a CTA, and a copy warp.  The copy
//      warp streams the (K, N) weight planes (a tile one copy through a 2D
//      tensor map, whatever N) and the CTA's event rows (a bulk copy a row)
//      through a kStages-stage shared-memory ring by the TMA unit on
//      mbarriers, two 128-row tiles ahead of the MAC (staged_mac in
//      fused_macro_common.cuh; 99 KB at N >= 128, two CTAs an SM), so each
//      byte is read from L2 once per CTA and no event waits on a global
//      load.  The MAC is event-driven from shared memory and keeps the
//      activity gate (a chunk whose occupancy word is 0 is not read): at 5 %
//      events it touches a twentieth of the rows an int8 tensor-core
//      product would, and it adds the events in ascending K with the
//      reference's rounding, so its bits are the plain version's for
//      every ratio (integer ratios give exact small integers: the plain
//      version's x @ w).  The per-event loop loads its plane bytes without
//      a column branch and converts them without I2F; the ramp loads each
//      boundary once for all of a lane's columns.  A layer wider than 128
//      columns is walked as column tiles of 128 (the planes at MAX_COLS =
//      1024 are 1 MB, past shared memory); the warp keeps every column's
//      code in registers across the tiles, so the KWN sweep still spans the
//      whole row in column order.  Then the Fig. 7 counter noise and the
//      counter SNL signs (keyed on the row's seed, step and row id, column:
//      no membrane), the sweep with its early-stop count, and the LUT drive.
//      The drive (f32) and the SNL signs (int8) go to (T, M, N) scratch the
//      wrapper allocates (1.25 MB at the training shape: it stays in L2),
//      with the mask, steps and MAC telemetry.
//   B. kwn_lif, the recurrence: one thread a (row, column) walks t with
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
// launch moves no bit.  The noise code, the KWN sweep and the LIF update
// are shared with the NLD kernel (fused_macro_common.cuh).

#include "fused_macro_kwn_layer.cuh"

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

extern "C" int fmsk_launch(const FmskParams* p, void* stream) {
  using namespace fm;
  if (p->m == 0 || p->t_steps == 0) return 0;
  KwnHead h = {};
  h.x = p->x;
  h.msb = p->msb;
  h.lsb = p->lsb;
  h.bounds = p->bounds;
  h.levels = p->levels;
  h.scale = p->scale;
  h.activity = p->activity;
  h.row_ctl = p->row_ctl;
  h.mac = p->mac;
  h.drive = p->drive;
  h.snl = p->snl;
  h.mask = p->mask;
  h.steps = p->steps;
  h.t_steps = p->t_steps;
  h.m = p->m;
  h.k_dim = p->k_dim;
  h.n = p->n;
  h.n_valid = p->n_valid;
  h.k = p->k;
  h.n_codes = p->n_codes;
  h.bm = p->bm;
  h.bk = p->bk;
  h.noisy = p->noisy;
  h.ratio = p->ratio;
  h.drive_gain = p->drive_gain;
  h.nm = {p->offset_lsb, p->sigma_lsb, p->inl_lsb, p->in_lo, p->in_span,
          p->n_codes};
  KwnLif b = {};
  b.drive = p->drive;
  b.mask = p->mask;
  b.noise = p->noise;
  b.snl = p->snl;
  b.v0 = p->v0;
  b.v_out = p->v_out;
  b.spikes = p->spikes;
  b.vtrace = p->vtrace;
  b.t_steps = p->t_steps;
  b.m = p->m;
  b.n = p->n;
  b.use_snl = p->use_snl;
  b.snl_amp = p->snl_amp;
  b.lp = {p->beta, p->v_th1, p->v_th2, p->v_reset, p->v_lim};
  return (int)launch_kwn_layer<false>(h, b,
                                      static_cast<cudaStream_t>(stream));
}
