// Surrogate backward of the fused seq-KWN macro for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/fused_macro_grad.py::_seq_kwn_bwd_kernel (entry
// fused_macro_seq_grad): the time-reversed BPTT pass of the silicon-training
// forward (fused_macro_seq_kwn.cu with its vtrace output).  Given the
// forward's residuals (membrane trace, winner masks, the MAC or the weight
// planes to recompute it) and the cotangents of the spike stack and the final
// membrane, it returns dW = sum_t x_t^T g_mac_t (K, N) and dv0 (M, N).
//
// The work factors into two passes, launched back to back on one stream:
//
//   A. the reverse-time chain.  The recurrence is elementwise per (row,
//      column), so one warp owns one row and 32 columns (lane = column) and
//      walks t = T-1 ... 0 with the membrane cotangent g_v in a register:
//      SuperSpike through the spike, the reset's cut, the rail cut
//      |vt| < v_lim, the carry (winners leak by beta, the rest hold), and
//      g_mac = g_v2 (m + kwn_relax (1 - m)) scale drive_gain [ramp window].
//      It writes g_mac (T, M, N) and dv0.  Without a MAC residual (remat) it
//      recomputes the row's MAC with the forward's event-driven MAC
//      (fused_macro_common.cuh), exact small integers, so both policies give
//      the same bits.
//   B. the contraction dW[k, c] = sum_r x[r, k] g_mac[r, c] over the T*M rows,
//      event-driven (x is ternary: an event adds or subtracts g_mac).  A CTA
//      owns 16 rows of K for 32 columns; each of its 16 warps sums a fixed
//      contiguous slice of the rows into registers, then the CTA adds the 16
//      partials in warp order.  No floating-point atomics: dW is the same
//      bits from run to run, under both MAC policies, and with or without the
//      activity map (a (step, row tile) whose word is 0 holds no event and is
//      skipped whole).
//
// Padded columns need no mask: their scale is 0, so their g_mac and dW are 0.
// The noisy forward needs no noise input here: the Fig. 7 draws and the SNL
// shape only the residuals.
//
// What bounds it on the card: by the roofline, bytes.  At the training shape
// (T=30, M=64, K=512, N=128) the residual policy reads x and four (T, M, N)
// f32 stacks and writes dW and dv0, about 5.24 MB, 1.57 us at 3.35 TB/s; the
// contraction the events need is 2 x nnz(x) x N operations, a fraction of a
// microsecond of CUDA-core time (chip_smoke.py computes both from its
// inputs).  In practice pass A is a serial chain of T dependent steps per
// warp and pass B a serial walk over T*M/16 rows per warp, so latency bounds
// both; tensor cores, TMA and a split over more warps are left to later work.
//
// Bit parity with the plain version (repro_torch/kernels/ref.py,
// fused_macro_seq_grad_ref): the chain is written in its operation order,
// built with -fmad=false (no contraction) and an IEEE quotient (__fdiv_rn),
// so dv0 is 0 ULP; dW is a sum in another order than its matrix product.

#include "fused_macro_common.cuh"

extern "C" {

// Mirrored by repro_torch/kernels/fused_macro_grad.py::_BwdParams.
struct FmskBwdParams {
  const int8_t* x;          // (T, M, K) ternary events, K % 32 == 0
  const float* scale;       // (N) per-column weight scale (padding 0)
  const float* g_spk;       // (T, M, N) cotangent of the spike stack
  const float* g_vfin;      // (M, N) cotangent of the final membrane
  const float* vtrace;      // (T, M, N) saturated pre-reset membrane
  const float* mask;        // (T, M, N) winner masks
  const float* mac;         // (T, M, N) MAC residual, or null (remat)
  const int8_t* msb;        // (K, N) twin-cell planes (remat), or null
  const int8_t* lsb;
  const int32_t* activity;  // (T, M / bm) row-tile occupancy, or null
  float* g_mac;             // (T, M, N) scratch: pass A -> pass B
  float* dw;                // (K, N)
  float* dv0;               // (M, N)
  int t_steps, m, k_dim, n, bm;
  float ratio, drive_gain, beta, v_th1, v_lim, kwn_relax, surrogate_beta,
      ste_lo, ste_hi;
};

}  // extern "C"

namespace {

using namespace fm;

constexpr int kDwRows = 16;    // K rows a pass-B CTA owns
constexpr int kDwWarps = 16;   // row slices a pass-B CTA sums, one per warp
static_assert(kDwRows == kDwWarps, "the final add gives each thread one dW");

// Pass A: warp w -> row w / nb, columns 32 (w % nb) + lane.
__global__ void __launch_bounds__(32 * kRowsPerCta)
fmskb_chain(const FmskBwdParams p) {
  const int lane = threadIdx.x & 31;
  const int nb = (p.n + 31) / 32;
  const int w = blockIdx.x * kRowsPerCta + (threadIdx.x >> 5);
  if (w >= p.m * nb) return;
  const int row = w / nb, c0 = 32 * (w % nb), c = c0 + lane;
  const bool col = c < p.n;
  const int n_i = p.m / p.bm, tile_i = row / p.bm;
  const float sc = col ? p.scale[c] : 0.0f;
  float g_v = col ? p.g_vfin[(size_t)row * p.n + c] : 0.0f;

  for (int t = p.t_steps - 1; t >= 0; --t) {
    const size_t base = ((size_t)t * p.m + row) * p.n;
    float acc[1] = {0.0f};
    if (p.mac == nullptr) {   // remat: the forward's MAC, exact integers
      const int32_t* occ = p.activity == nullptr ? nullptr
          : p.activity + (size_t)t * n_i + tile_i;
      mac_events<1>(acc, p.x + ((size_t)t * p.m + row) * p.k_dim, occ,
                    p.k_dim, p.k_dim, p.msb + c0, p.lsb + c0, p.n, p.n - c0,
                    p.ratio, lane);
    }
    if (!col) continue;
    const float vt = p.vtrace[base + c];
    const float mt = p.mask[base + c];
    const float mac = p.mac != nullptr ? p.mac[base + c] : acc[0];
    const float spk = vt >= p.v_th1 ? 1.0f : 0.0f;
    const float d = 1.0f + fabsf(p.surrogate_beta * (vt - p.v_th1));
    const float sg = __fdiv_rn(p.surrogate_beta, d * d);   // SuperSpike
    const float g_vclip = g_v * (1.0f - spk) + p.g_spk[base + c] * sg;
    const float g_v2 = g_vclip * (fabsf(vt) < p.v_lim ? 1.0f : 0.0f);
    g_v = g_v2 * (mt * p.beta + (1.0f - mt));
    const float gate = mt + p.kwn_relax * (1.0f - mt);
    const float in_ramp = mac >= p.ste_lo && mac <= p.ste_hi ? 1.0f : 0.0f;
    p.g_mac[base + c] = g_v2 * gate * sc * p.drive_gain * in_ramp;
  }
  if (col) p.dv0[(size_t)row * p.n + c] = g_v;
}

// Pass B: CTA (kb, cb) -> dW rows [16 kb, 16 kb + 16), columns 32 cb + lane.
__global__ void __launch_bounds__(32 * kDwWarps)
fmskb_dw(const FmskBwdParams p) {
  __shared__ float part[kDwWarps][kDwRows][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * kDwRows;
  const int c = blockIdx.y * 32 + lane;
  const bool col = c < p.n;
  const long long rows = (long long)p.t_steps * p.m;
  const int r0 = (int)(rows * warp / kDwWarps);
  const int r1 = (int)(rows * (warp + 1) / kDwWarps);
  const int n_i = p.m / p.bm;
  float acc[kDwRows];
#pragma unroll
  for (int i = 0; i < kDwRows; ++i) acc[i] = 0.0f;

  for (int r = r0; r < r1; ++r) {
    if (p.activity != nullptr) {
      const int t = r / p.m;
      if (p.activity[(size_t)t * n_i + (r - t * p.m) / p.bm] == 0) continue;
    }
    const uint4 xw =
        *reinterpret_cast<const uint4*>(p.x + (size_t)r * p.k_dim + k0);
    if ((xw.x | xw.y | xw.z | xw.w) == 0u) continue;
    const float g = col ? p.g_mac[(size_t)r * p.n + c] : 0.0f;
    const uint32_t words[4] = {xw.x, xw.y, xw.z, xw.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int xv = (int)(int8_t)((words[q] >> (8 * b)) & 0xffu);
        if (xv != 0) acc[4 * q + b] = acc[4 * q + b] + (float)xv * g;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kDwRows; ++i) part[warp][i][lane] = acc[i];
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kDwWarps; ++w) s = s + part[w][warp][lane];
  if (col) p.dw[(size_t)(k0 + warp) * p.n + c] = s;
}

}  // namespace

extern "C" int fmskb_launch(const FmskBwdParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->n == 0 || p->k_dim % 32 != 0) return (int)cudaErrorInvalidValue;
  const int nb = (p->n + 31) / 32;
  const int warps = p->m * nb;
  if (warps > 0) {
    fmskb_chain<<<(warps + kRowsPerCta - 1) / kRowsPerCta,
                  32 * kRowsPerCta, 0, s>>>(*p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (p->k_dim > 0) {
    fmskb_dw<<<dim3(p->k_dim / kDwRows, nb), 32 * kDwWarps, 0, s>>>(*p);
  }
  return (int)cudaGetLastError();
}
