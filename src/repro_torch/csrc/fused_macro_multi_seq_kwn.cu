// Stacked multi-layer KWN macro kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/fused_macro.py::_multi_seq_kwn_kernel (entry
// fused_macro_multi_seq).  Per time step and batch row, L KWN layers one
// after another: the twin-cell ternary MAC -> ramp codes (+ Fig. 7 counter
// noise) -> KWN priority sweep -> LUT drive -> LIF with SNL; layer l's spikes
// are layer l+1's input.  Every layer's membrane is carried across T.
//
// What bounds it on the card: by the roofline, bytes.  At the DVS-Gesture
// stack (64 rows, K=512, two 128-column layers, 30 steps) one launch reads
// the events, the layers' int8 planes, membranes and SNL noise and writes
// the last layer's spikes and mask, the membranes and the per-layer
// telemetry, about 3 MB (chip_smoke.py computes the bytes and the MAC count
// from its inputs).  In practice latency bounds it: the TPU kernel walks T
// in a sequential grid with every layer in VMEM, and a port of that shape
// (one warp a row for all T x L dependent layer steps, every membrane in
// registers) leaves the card M / 4 CTAs, and cannot hold a wide stack.
//
// What the design does about it: layer l+1 at step t needs only layer l's
// spikes at step t and its own membrane, and in each layer only the LIF
// update needs the previous step.  So the launch is 2L kernels back to back
// on one stream, layer by layer, as the seq-KWN forward's two
// (fused_macro_seq_kwn.cu):
//
//   A. the head of layer l (kwn_head<CPL> of fused_macro_kwn_layer.cuh,
//      shared with the seq-KWN forward), parallel over all T x M (step, row)
//      items: one warp an item, kItemWarps items a CTA and a copy warp that
//      streams the layer's (k_dim, n) planes (a tile one copy through a 2D
//      tensor map) and the CTA's input rows (a bulk copy a row) through a
//      shared-memory ring by the TMA unit on mbarriers (staged_mac in
//      fused_macro_common.cuh).  The input is the events (layer 0, gated by
//      the host occupancy map) or layer l-1's spikes, an int8 (T, M, n_{l-1})
//      scratch with unpadded rows: a deep width that is not a multiple of 16
//      (20, 200) is staged by plain copies, as are planes of such a width.
//      Padding the rows to 16 bytes for the TMA path measured the same
//      (PERF.md).  The MAC writes a bit per K tile that held an input that
//      fired (the reference counts occupied K tiles per (step, row tile); a
//      warp sees one row, so the wrapper ORs the rows of each tile).  Then,
//      keyed on (ctl[l], ctl[L] + t, absolute row, column): ramp codes with
//      the counter noise, the KWN sweep over the whole row in column order
//      (a lane keeps CPL codes, up to MAX_COLS = 1024 columns a layer), the
//      LUT drive and the counter SNL signs, into (T, M, n) scratch the
//      wrapper allocates (reused by every layer), with the mask, the ADC
//      steps and the tile bits; it zeroes the row's spike count.
//   B. kwn_lif of layer l: one thread a (row, column) walks t with the
//      membrane in a register; drive, mask and SNL noise are loaded
//      kLifChunk steps ahead, so only the fmaf / clip / compare chain is
//      serial.  It writes the spike scratch the next head reads (the last
//      layer: spikes), every layer's v_out, and the row spike counts: one
//      atomicAdd of 1 a spike, small integers in f32, so exact in any
//      order.
// No layer's membrane is held across layers, so the width is bounded by the
// sweep's 32 codes a lane per layer, not by the stack.
//
// Bitwise parity: as the single-layer KWN kernel (fused_macro_seq_kwn.cu).
// The drive goes through the scratch as the f32 it is, so splitting the
// launch moves no bit.

#include "fused_macro_kwn_layer.cuh"

extern "C" {

constexpr int kMaxLayers = 4;

// Mirrored by repro_torch/kernels/fused_macro.py::_Layer.
struct FmmkLayer {
  const int8_t* msb;    // (k_dim, n) twin-cell MSB plane
  const int8_t* lsb;    // (k_dim, n) twin-cell LSB plane
  const float* bounds;  // (n_codes - 1) ramp thresholds
  const float* levels;  // (n_codes) LUT
  const float* scale;   // (n) per-column weight scale
  const float* v0;      // (M, n) initial membrane
  const float* noise;   // (T, M, n) SNL noise, or null (counter stream)
  float* v_out;         // (M, n)
  float* mask;          // (T, M, n) winners: output (last layer) or scratch
  int8_t* spk;          // (T, M, n) spike scratch for the next layer, or null
  int k_dim, n, k, bk;  // input rows, columns, winners, occupancy K tile
};

// Mirrored by repro_torch/kernels/fused_macro.py::_MultiParams.
struct FmmkParams {
  const int8_t* x;          // (T, M, K0) ternary events
  const int32_t* activity;  // (T, M / bm, K0 / bk0) layer-0 occupancy
  const int32_t* ctl;       // (L + 1) per-layer seeds, then the step offset
  float* spikes;            // (T, M, n_L) last layer
  int32_t* steps;           // (L, T, M) ADC steps
  float* counts;            // (L, T, M) row spike counts
  int32_t* tile_bits;       // (L, T, M) bit kk: input K tile kk held an event
  float* drive;             // (T, M, n) scratch: the head's LUT drive
  int8_t* snl;              // (T, M, n) scratch: counter SNL signs, or null
  FmmkLayer layers[kMaxLayers];
  int n_layers, t_steps, m, bm;
  int n_codes;              // the ramp size, the same in every layer
  int use_snl, noisy;
  float ratio, drive_gain, beta, v_th1, v_th2, v_reset, v_lim, snl_amp;
  float offset_lsb, sigma_lsb, inl_lsb, in_lo, in_span;
};

}  // extern "C"

extern "C" int fmmk_launch(const FmmkParams* p, void* stream) {
  using namespace fm;
  if (p->m == 0 || p->t_steps == 0) return 0;
  if (p->n_layers < 1 || p->n_layers > kMaxLayers)
    return (int)cudaErrorInvalidValue;
  const int items = p->t_steps * p->m;
  for (int l = 0; l < p->n_layers; ++l) {
    const FmmkLayer& ly = p->layers[l];
    if (ly.n < 1) return (int)cudaErrorInvalidValue;
    const bool last = l == p->n_layers - 1;
    KwnHead h = {};
    h.x = l == 0 ? p->x : p->layers[l - 1].spk;
    h.msb = ly.msb;
    h.lsb = ly.lsb;
    h.bounds = ly.bounds;
    h.levels = ly.levels;
    h.scale = ly.scale;
    // layer 0 is gated by the host occupancy map; a deeper layer's chunk
    // of 32 spikes that holds none is skipped by its ballot
    h.activity = l == 0 ? p->activity : nullptr;
    h.seed = p->ctl + l;
    h.step_offset = p->ctl + p->n_layers;
    h.drive = p->drive;
    h.snl = p->snl;
    h.mask = ly.mask;
    h.steps = p->steps + (size_t)l * items;
    h.tile_bits = p->tile_bits + (size_t)l * items;
    h.counts = p->counts + (size_t)l * items;
    h.t_steps = p->t_steps;
    h.m = p->m;
    h.k_dim = ly.k_dim;
    h.n = ly.n;
    h.n_valid = ly.n;
    h.k = ly.k;
    h.n_codes = p->n_codes;
    h.bm = p->bm;
    h.bk = ly.bk;
    h.noisy = p->noisy;
    h.ratio = p->ratio;
    h.drive_gain = p->drive_gain;
    h.nm = {p->offset_lsb, p->sigma_lsb, p->inl_lsb, p->in_lo, p->in_span,
            p->n_codes};
    KwnLif b = {};
    b.drive = p->drive;
    b.mask = ly.mask;
    b.noise = ly.noise;
    b.snl = p->snl;
    b.v0 = ly.v0;
    b.v_out = ly.v_out;
    b.spikes = last ? p->spikes : nullptr;
    b.spk = last ? nullptr : ly.spk;
    b.counts = h.counts;
    b.t_steps = p->t_steps;
    b.m = p->m;
    b.n = ly.n;
    b.use_snl = p->use_snl;
    b.snl_amp = p->snl_amp;
    b.lp = {p->beta, p->v_th1, p->v_th2, p->v_reset, p->v_lim};
    const cudaError_t err = launch_kwn_layer<true>(
        h, b, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
