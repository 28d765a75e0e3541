// A KWN layer as two kernels on one stream, shared by the seq-KWN forward
// (fused_macro_seq_kwn.cu) and each layer of the stacked kernel
// (fused_macro_multi_seq_kwn.cu): kwn_head, parallel over all T x M
// (step, row) items, and kwn_lif, one thread a (row, column) walking T.
// Only the LIF needs the previous step.  The drive goes from head to LIF
// through scratch as the f32 it is, so the split moves no bit.

#pragma once

#include "fused_macro_common.cuh"

namespace fm {

// Item t * m + row; per-item arrays are (T, M), per-element ones (T, M, n).

constexpr int kLifThreads = 64;   // M*N threads: spread over more SMs
constexpr int kLifChunk = 8;      // steps whose operands a LIF loads at once

struct KwnHead {
  const int8_t* x;          // (T, M, k_dim) ternary inputs
  const int8_t* msb;        // (k_dim, n) twin-cell MSB plane
  const int8_t* lsb;        // (k_dim, n) twin-cell LSB plane
  const float* bounds;      // (n_codes - 1) ramp thresholds
  const float* levels;      // (n_codes) LUT
  const float* scale;       // (n) per-column weight scale
  const int32_t* activity;  // (T, M / bm, k_dim / bk) occupancy, or null
  const int32_t* row_ctl;   // (M, 3) [seed, step_offset, row_id], or null:
  const int32_t* seed;      //   then *seed and *step_offset for every row,
  const int32_t* step_offset;   // the row id its index
  float* mac;               // raw MAC, or null
  float* drive;             // LUT drive (scratch)
  int8_t* snl;              // counter SNL signs (scratch), or null
  float* mask;              // winners
  int32_t* steps;           // (T, M) ADC steps
  int32_t* tile_bits;       // (T, M) bit kk: K tile kk held an input (stack)
  float* counts;            // (T, M) row spike counts, zeroed here (stack)
  int t_steps, m, k_dim, n, n_valid, k, n_codes, bm, bk, noisy;
  float ratio, drive_gain;
  NoiseModel nm;
};

struct KwnLif {
  const float* drive;       // the head's
  const float* mask;        // the head's
  const float* noise;       // dense SNL noise, or null
  const int8_t* snl;        // the head's counter SNL signs, or null
  const float* v0;          // (M, n) initial membrane
  float* v_out;             // (M, n)
  float* spikes;            // f32 spikes (stack: or null)
  int8_t* spk;              // int8 spikes, the next layer's input (stack),
                            //   or null
  float* vtrace;            // saturated pre-reset membrane, or null (not
                            //   the stack)
  float* counts;            // (T, M) row spike counts, added to (stack)
  int t_steps, m, n, use_snl;
  float snl_amp;
  LifParams lp;
};

namespace {

// Warp -> item; CPL columns a lane (c = lane + 32 j), staged as NCT column
// tiles of CPT a lane.  The MAC, then ramp codes with the Fig. 7 counter
// noise and the counter SNL signs (keyed on seed, step, row id, column: no
// membrane), the KWN sweep over the whole row in column order (a lane keeps
// every column's code across the tiles), and the LUT drive.  A layer of
// the stack (kStack) also writes each item's tile bits (the occupancy) and
// zeroes its spike count.
template <int CPL, bool kStack>
__global__ void __launch_bounds__(kMacThreads, CPL >= 16 ? 1 : 2)
kwn_head(const KwnHead p, const __grid_constant__ CUtensorMap tm_msb,
         const __grid_constant__ CUtensorMap tm_lsb, int bulk) {
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
  const bool on[1] = {live};
  const int32_t* occ[1] = {
      live && p.activity != nullptr
          ? p.activity + ((size_t)t * (p.m / p.bm) + row / p.bm)
                * (p.k_dim / p.bk) : nullptr};
  const int32_t* ctl = live && p.row_ctl != nullptr ? p.row_ctl + row * 3
                                                    : nullptr;
  const uint32_t seed = ctl != nullptr ? (uint32_t)ctl[0]
                        : live ? (uint32_t)*p.seed : 0u;
  const uint32_t step = (uint32_t)((ctl != nullptr ? ctl[1]
                                    : live ? *p.step_offset : 0) + t);
  const uint32_t rid = ctl != nullptr ? (uint32_t)ctl[2] : (uint32_t)row;
  const size_t base = (size_t)item * n;
  float sc[CPL];   // loaded now, read by the drive at the end
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    sc[j] = live && c < n ? p.scale[c] : 0.0f;
  }

  // --- MAC, then ramp codes (+ Fig. 7 counter noise); padding -> -1 -----
  int code[CPL];
  const TileBits<1> bits = staged_mac<CPT, NCT, 1, kStack>(
      smem, p.msb, p.lsb, &tm_msb, &tm_lsb, p.k_dim, n, 0, bulk != 0,
      p.x + (size_t)first * p.k_dim, min(kItemWarps, items - first), on,
      occ, p.bk, p.ratio,
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
              cd = noisy_code(cd, acc[0][j], seed, step, rid, (uint32_t)c,
                              p.nm);
          }
          code[ct * CPT + j] = cd;
          if (live && c < n) {
            if (p.mac != nullptr) p.mac[base + c] = acc[0][j];
            if (p.snl != nullptr)
              p.snl[base + c] =
                  (int8_t)counter_sign(seed, step, rid, (uint32_t)c);
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
  if (lane == 0) {
    p.steps[item] = steps;
    if (kStack) p.tile_bits[item] = (int32_t)bits.w[0];
    if (kStack) p.counts[item] = 0.0f;   // the LIF adds
  }
}

// Thread -> (row, column), the membrane across T (Eq. 1).  Drive, mask and
// SNL noise (the dense operand, or amp x the head's signs) are loaded into
// registers kLifChunk steps ahead of their arithmetic, so only the fmaf /
// clip / compare chain is serial.  In a layer of the stack (kStack) a row's
// spike count gets one atomicAdd of 1 a spike: small integers in f32, exact
// in any order.  The outputs are fixed at compile time where they can be,
// so the seq-KWN forward's chain carries no branch or atomic it never takes.
template <bool kStack>
__global__ void __launch_bounds__(kLifThreads) kwn_lif(const KwnLif p) {
  const int idx = blockIdx.x * kLifThreads + threadIdx.x;
  if (idx >= p.m * p.n) return;
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
                                p.use_snl, p.lp);
      const bool fire = vc >= p.lp.v_th1;
      v = fire ? p.lp.v_reset : vc;
      if (!kStack && p.vtrace != nullptr) p.vtrace[e] = vc;
      if (!kStack || p.spikes != nullptr)
        p.spikes[e] = fire ? 1.0f : 0.0f;
      if (kStack) {
        if (p.spk != nullptr) p.spk[e] = fire ? 1 : 0;
        if (fire) atomicAdd(&p.counts[(size_t)t * p.m + idx / p.n], 1.0f);
      }
    }
    cur = next;
  }
  p.v_out[idx] = v;
}

template <int CPL, bool kStack>
cudaError_t launch_kwn_head(const KwnHead& p, cudaStream_t stream) {
  constexpr int CPT = CPL < 4 ? CPL : 4;
  static size_t smem_set = 48 * 1024;   // the default dynamic limit
  const size_t smem = staged_mac_smem(32 * CPT, kItemWarps)
                      + 2 * sizeof(float) * (size_t)p.n_codes;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kwn_head<CPL, kStack>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const int items = p.t_steps * p.m;
  CUtensorMap tm[2] = {};
  bool bulk = false;
  const cudaError_t err = stage_by_tma(tm, &bulk, p.msb, p.lsb, p.k_dim, p.n,
                                       32 * CPT, p.x);
  if (err != cudaSuccess) return err;
  kwn_head<CPL, kStack><<<(items + kItemWarps - 1) / kItemWarps,
                             kMacThreads, smem, stream>>>(p, tm[0], tm[1],
                                                          bulk);
  return cudaGetLastError();
}

// One KWN layer of up to MAX_COLS = 1024 columns (32 codes a lane in the
// sweep), of the seq-KWN forward or (kStack) of the stack: its head, then
// its LIF.
template <bool kStack>
cudaError_t launch_kwn_layer(const KwnHead& head, const KwnLif& lif,
                             cudaStream_t stream) {
  const int cpl = (head.n + 31) / 32;
  cudaError_t err;
  if (cpl <= 1) err = launch_kwn_head<1, kStack>(head, stream);
  else if (cpl <= 2) err = launch_kwn_head<2, kStack>(head, stream);
  else if (cpl <= 4) err = launch_kwn_head<4, kStack>(head, stream);
  else if (cpl <= 8) err = launch_kwn_head<8, kStack>(head, stream);
  else if (cpl <= 16) err = launch_kwn_head<16, kStack>(head, stream);
  else if (cpl <= 32) err = launch_kwn_head<32, kStack>(head, stream);
  else err = cudaErrorInvalidValue;
  if (err != cudaSuccess || head.n == 0) return err;
  kwn_lif<kStack><<<(lif.m * lif.n + kLifThreads - 1) / kLifThreads,
                    kLifThreads, 0, stream>>>(lif);
  return cudaGetLastError();
}

}  // namespace

}  // namespace fm
