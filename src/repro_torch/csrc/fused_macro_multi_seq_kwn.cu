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
// from its inputs).  As in the single-layer kernels, the serial chain of
// T x L dependent layer steps per row makes it latency-bound instead.
//
// What the design does about that: one warp owns one batch row for all L
// layers and all T steps.  Each layer's membrane lives in registers (L x CPL
// floats a lane, CPL = the widest layer's columns per lane).  A layer's
// spikes never leave registers: one __ballot_sync per 32 columns turns them
// into the next layer's event bitmask, and the next layer's MAC adds the
// weight rows of the set bits (the inter-layer spike tensor never reaches
// device memory).  Layer 0 is event-driven on the host occupancy map; layers
// l > 0 skip the K tiles in which the previous layer did not fire.  The
// reference counts occupied K tiles per (step, row tile); a warp sees one
// row, so the kernel writes a bit per (layer, step, row, K tile) and the
// wrapper ORs the rows of each tile (kernels/fused_macro.py).  A stack that
// needs more than 32 register columns a lane (L x CPL) is refused by the
// wrapper with a ValueError; there is no fallback.
//
// Bitwise parity: as the single-layer KWN kernel (fused_macro_common.cuh).
// The counters of layer l are (ctl[l], ctl[L] + t, absolute row, column).

#include "fused_macro_common.cuh"

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
  int k_dim, n, k, bk;  // input rows, columns, winners, occupancy K tile
};

// Mirrored by repro_torch/kernels/fused_macro.py::_MultiParams.
struct FmmkParams {
  const int8_t* x;          // (T, M, K0) ternary events
  const int32_t* activity;  // (T, M / bm, K0 / bk0) layer-0 occupancy
  const int32_t* ctl;       // (L + 1) per-layer seeds, then the step offset
  float* spikes;            // (T, M, n_L) last layer
  float* mask;              // (T, M, n_L) last layer
  int32_t* steps;           // (L, T, M) ADC steps
  float* counts;            // (L, T, M) row spike counts
  int32_t* tile_bits;       // (L, T, M) bit kk: input K tile kk held an event
  FmmkLayer layers[kMaxLayers];
  int n_layers, t_steps, m, bm;
  int n_codes;              // the ramp size, the same in every layer
  int use_snl, noisy;
  float ratio, drive_gain, beta, v_th1, v_th2, v_reset, v_lim, snl_amp;
  float offset_lsb, sigma_lsb, inl_lsb, in_lo, in_span;
};

}  // extern "C"

namespace {

using namespace fm;

// One warp per batch row; L layers of at most 32 CPL columns each.
template <int L, int CPL>
__global__ void __launch_bounds__(32 * kRowsPerCta)
fmmk_kernel(const FmmkParams p) {
  // shared memory: each layer's ramp (bounds, then levels), then each
  // layer's column scales
  extern __shared__ float sh[];
  const int nc2 = 2 * p.n_codes;
  float* s_scale = sh + L * nc2;
  {
    int off = 0;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      for (int i = threadIdx.x; i < p.n_codes; i += blockDim.x) {
        if (i < p.n_codes - 1) sh[l * nc2 + i] = p.layers[l].bounds[i];
        sh[l * nc2 + p.n_codes + i] = p.layers[l].levels[i];
      }
      for (int i = threadIdx.x; i < p.layers[l].n; i += blockDim.x)
        s_scale[off + i] = p.layers[l].scale[i];
      off += p.layers[l].n;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerCta + (threadIdx.x >> 5);
  if (row >= p.m) return;
  const int m = p.m;
  const int n_i = m / p.bm, n_k0 = p.layers[0].k_dim / p.layers[0].bk;
  const int tile_i = row / p.bm;
  const int32_t step0 = p.ctl[L];
  const NoiseModel nm = {p.offset_lsb, p.sigma_lsb, p.inl_lsb, p.in_lo,
                         p.in_span, p.n_codes};
  const LifParams lp = {p.beta, p.v_th1, p.v_th2, p.v_reset, p.v_lim};

  float v[L][CPL];
#pragma unroll
  for (int l = 0; l < L; ++l) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      const int n = p.layers[l].n;
      v[l][j] = c < n ? p.layers[l].v0[(size_t)row * n + c] : 0.0f;
    }
  }

  for (int t = 0; t < p.t_steps; ++t) {
    const uint32_t step = (uint32_t)(step0 + t);
    unsigned sb[CPL];           // the previous layer's spikes, as ballots
    int scale_off = 0;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const int n = p.layers[l].n, k_dim = p.layers[l].k_dim;
      const int bk = p.layers[l].bk;
      const int8_t* msb = p.layers[l].msb;
      const int8_t* lsb = p.layers[l].lsb;
      const float* s_bounds = sh + l * nc2;
      const float* s_levels = s_bounds + p.n_codes;
      const uint32_t seed = (uint32_t)p.ctl[l];
      // --- MAC: events (layer 0) or the previous layer's spikes ---------
      float acc[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[j] = 0.0f;
      unsigned bits = 0;
      if (l == 0) {
        const int8_t* xr = p.x + ((size_t)t * m + row) * k_dim;
        bits = mac_events<CPL>(
            acc, xr, p.activity + ((size_t)t * n_i + tile_i) * n_k0, k_dim,
            bk, msb, lsb, n, n, p.ratio, lane);
      } else {
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          if (32 * j >= k_dim || sb[j] == 0) continue;
          bits |= 1u << ((32 * j) / bk);
          mac_add_rows<CPL>(acc, sb[j], 1, msb + (size_t)32 * j * n,
                            lsb + (size_t)32 * j * n, n, n, p.ratio, lane);
        }
      }

      // --- ramp codes (+ Fig. 7 counter noise) and the KWN sweep --------
      int code[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        int cd = -1;
        if (c < n) {
          cd = ramp_code(acc[j], s_bounds, p.n_codes);
          if (p.noisy)
            cd = noisy_code(cd, acc[j], seed, step, (uint32_t)row,
                            (uint32_t)c, nm);
        }
        code[j] = cd;
      }
      bool win[CPL];
      const int steps =
          kwn_sweep<CPL>(code, win, p.layers[l].k, p.n_codes, lane);

      // --- LUT drive and LIF (Eq. 1); spikes to the next layer ----------
      int count = 0;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        float spike = 0.0f;
        if (c < n) {
          const float maskf = win[j] ? 1.0f : 0.0f;
          const float recon = code[j] >= 0 ? s_levels[code[j]] : 0.0f;
          const float drive =
              recon * s_scale[scale_off + c] * maskf * p.drive_gain;
          float nz = 0.0f;
          if (p.layers[l].noise != nullptr) {
            nz = p.layers[l].noise[((size_t)t * m + row) * n + c];
          } else if (p.use_snl && p.snl_amp != 0.0f) {
            nz = p.snl_amp * counter_sign(seed, step, (uint32_t)row,
                                          (uint32_t)c);
          }
          v[l][j] = lif_update(v[l][j], drive, maskf > 0.0f, nz, p.use_snl,
                               lp, &spike);
          if (l == L - 1) {
            const size_t o = ((size_t)t * m + row) * n + c;
            p.spikes[o] = spike;
            p.mask[o] = maskf;
          }
        }
        sb[j] = __ballot_sync(kFull, spike > 0.0f);
        count += __popc(sb[j]);
      }
      if (lane == 0) {
        const size_t o = ((size_t)l * p.t_steps + t) * m + row;
        p.steps[o] = steps;
        p.counts[o] = (float)count;
        p.tile_bits[o] = (int32_t)bits;
      }
      scale_off += n;
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      const int n = p.layers[l].n;
      if (c < n) p.layers[l].v_out[(size_t)row * n + c] = v[l][j];
    }
  }
}

template <int L, int CPL>
cudaError_t launch(const FmmkParams& p, cudaStream_t stream) {
  int cols = 0;
  for (int l = 0; l < L; ++l) cols += p.layers[l].n;
  const dim3 grid((p.m + kRowsPerCta - 1) / kRowsPerCta);
  const size_t smem = sizeof(float) * (2 * (size_t)L * p.n_codes + cols);
  fmmk_kernel<L, CPL><<<grid, 32 * kRowsPerCta, smem, stream>>>(p);
  return cudaGetLastError();
}

// The smallest CPL >= cpl with L * CPL <= 32 register columns a lane.
template <int L, int CPL>
cudaError_t dispatch(const FmmkParams& p, int cpl, cudaStream_t stream) {
  if constexpr (L * CPL > 32) {
    return cudaErrorInvalidValue;
  } else {
    if (cpl <= CPL) return launch<L, CPL>(p, stream);
    return dispatch<L, CPL * 2>(p, cpl, stream);
  }
}

}  // namespace

extern "C" int fmmk_launch(const FmmkParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->m == 0 || p->t_steps == 0) return 0;
  int widest = 0;
  for (int l = 0; l < p->n_layers && l < kMaxLayers; ++l)
    widest = max(widest, p->layers[l].n);
  const int cpl = (widest + 31) / 32;
  switch (p->n_layers) {
    case 1: return (int)dispatch<1, 1>(*p, cpl, s);
    case 2: return (int)dispatch<2, 1>(*p, cpl, s);
    case 3: return (int)dispatch<3, 1>(*p, cpl, s);
    case 4: return (int)dispatch<4, 1>(*p, cpl, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
