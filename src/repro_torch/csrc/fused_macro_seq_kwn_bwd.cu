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
// What bounds it on the card: by the roofline, bytes.  At the training shape
// (T=30, M=64, K=512, N=128) the residual policy reads x and four (T, M, N)
// f32 stacks and writes dW and dv0, about 5.24 MB, 1.57 us at 3.35 TB/s; the
// contraction the events need is 2 x nnz(x) x N operations, a fraction of a
// microsecond of CUDA-core time (chip_smoke.py computes both from its
// inputs).  In practice latency bounds it: the TPU kernel walks T in a
// sequential grid with the MAC in VMEM, and a port of that shape recomputes
// the MAC inside the serial chain (remat) and walks T*M/16 rows per warp in
// the contraction, each behind a dependent global load.
//
// What the design does about it: only the membrane cotangent g_v is carried
// over T, so the work is four kernels back to back on one stream, and only
// the second is serial.
//
//   R. fmskb_mac (remat only): the MAC of every (step, row) item, one
//      parallel pass with the forward's staged MAC (staged_mac in
//      fused_macro_common.cuh: planes and events through a TMA ring in
//      shared memory, events in ascending K with the forward's rounding),
//      into a (T, M, N) scratch.  So remat gives the residual's bits.  A
//      (step, row tile) whose activity word is 0 holds no event and is not
//      read.
//   A. fmskb_chain, the reverse-time chain: one thread a (row, column) walks
//      t = T-1 ... 0 with g_v in a register: SuperSpike through the spike,
//      the reset's cut, the rail cut |vt| < v_lim, the carry (winners leak
//      by beta, the rest hold), and g_mac = g_v2 (m + kwn_relax (1 - m))
//      scale drive_gain [ramp window].  It loads vtrace, mask, g_spk and
//      the MAC into registers kChainChunk steps at a time, a chunk ahead of
//      their arithmetic, which keeps the reference's operation order.  It
//      writes g_mac to a (T, M, ldg) scratch (rows padded to 16 bytes for
//      the bulk copies) and dv0.
//   B. fmskb_dw_part, the contraction over the R = T*M rows in n_slices
//      fixed row slices: a CTA owns 64 K rows (8 a warp) x 128 columns (4 a
//      lane) of one slice and streams 32 rows at a time of x and g_mac
//      through a two-stage shared-memory ring by bulk copies (TMA) on
//      mbarriers.  Event-driven: a warp skips a row whose 8 event bytes are
//      all 0 (one 8-byte shared load, four rows at a time), and adds x g_mac
//      for the row's 8 bytes, in row order.
//   C. fmskb_dw_sum: dW = the slices' partials added in slice order.
//
// No floating-point atomics: dW is the same bits on every launch, under both
// MAC policies (the same g_mac), and with or without the activity map (a row
// it marks quiet holds no event).  Padded columns need no mask: their scale
// is 0, so their g_mac and dW are 0.  The noisy forward needs no noise input
// here: the Fig. 7 draws and the SNL shape only the residuals.
//
// Bit parity with the plain version (repro_torch/kernels/ref.py,
// fused_macro_seq_grad_ref): the chain is written in its operation order,
// built with -fmad=false (no contraction) and an IEEE quotient (__fdiv_rn),
// so dv0 is 0 ULP; dW is a sum in another order than its matrix product
// (within rtol 1e-5 / atol 1e-6).  Tensor cores are not used: an exact f32
// contraction on them needs g_mac split into three bf16 products, and the
// event-driven sum on the CUDA cores touches a twentieth of x at 5 % events.

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
  float* g_mac;             // (T, M, ldg) scratch: pass A -> pass B
  float* dw;                // (K, N)
  float* dv0;               // (M, N)
  float* mac_s;             // (T, M, N) scratch: the remat MAC, or null
  float* part;              // (n_slices, K, N) scratch: pass B's partials
  int t_steps, m, k_dim, n, bm, ldg, n_slices;
  float ratio, drive_gain, beta, v_th1, v_lim, kwn_relax, surrogate_beta,
      ste_lo, ste_hi;
};

}  // extern "C"

namespace {

using namespace fm;

constexpr int kRematItems = 2;   // items a warp of the remat pass holds
constexpr int kChainThreads = 64;   // M*N threads: spread over more SMs
constexpr int kChainChunk = 8;   // steps whose operands pass A loads at once
constexpr int kDwRows = 64;      // K rows of a pass-B CTA: 8 a warp
constexpr int kDwCols = 128;     // columns of a pass-B CTA: 4 a lane
constexpr int kDwChunk = 32;     // T*M rows staged at a time
constexpr int kDwWarps = 8;
static_assert(kDwRows == 8 * kDwWarps, "a warp owns 8 K rows");

// Pass R: warp w of CTA b -> items (b kItemWarps + w) kRematItems + i,
// columns of tile blockIdx.y.  The launch bounds name one block an SM:
// given the block size alone, ptxas held the kernel to 32 registers and
// spilled.
__global__ void __launch_bounds__(kMacThreads, 1)
fmskb_mac(const FmskBwdParams p,
          const __grid_constant__ CUtensorMap tm_msb,
          const __grid_constant__ CUtensorMap tm_lsb, int bulk) {
  extern __shared__ __align__(16) int8_t ring[];
  const int lane = threadIdx.x & 31;
  constexpr int kItems = kItemWarps * kRematItems;
  const int cta = blockIdx.x * kItems;
  const int first = cta + (threadIdx.x >> 5) * kRematItems;
  const bool item_warp = (threadIdx.x >> 5) < kItemWarps;
  const int items = p.t_steps * p.m, n_i = p.m / p.bm;
  const int c_base = blockIdx.y * 128;
  bool on[kRematItems];
  const int32_t* occ[kRematItems];
#pragma unroll
  for (int i = 0; i < kRematItems; ++i) {
    const int it = first + i, t = it / p.m;
    on[i] = item_warp && it < items
        && (p.activity == nullptr
            || p.activity[(size_t)t * n_i + (it - t * p.m) / p.bm] != 0);
    occ[i] = nullptr;
  }
  staged_mac<4, 1, kRematItems>(
      ring, p.msb, p.lsb, &tm_msb, &tm_lsb, p.k_dim, p.n, c_base,
      bulk != 0, p.x + (size_t)cta * p.k_dim, min(kItems, items - cta), on,
      occ, p.k_dim, p.ratio, [&](int, float (&acc)[kRematItems][4]) {
#pragma unroll
        for (int i = 0; i < kRematItems; ++i) {
          if (!item_warp || first + i >= items) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c_base + lane + 32 * j;
            if (c < p.n) p.mac_s[(size_t)(first + i) * p.n + c] = acc[i][j];
          }
        }
      });
}

// Pass A: thread -> (row, column), g_v across reversed T.
__global__ void __launch_bounds__(kChainThreads)
fmskb_chain(const FmskBwdParams p) {
  const int idx = blockIdx.x * kChainThreads + threadIdx.x;
  if (idx >= p.m * p.n) return;
  const int row = idx / p.n, c = idx - row * p.n;
  const float* mac = p.mac != nullptr ? p.mac : p.mac_s;
  const size_t plane = (size_t)p.m * p.n;
  const float sc = p.scale[c];
  float g_v = p.g_vfin[idx];
  // operands that do not depend on g_v: chunk t1 in flight while the chunk
  // after it (in time) is computed
  auto load = [&](int t1, float (&vt)[kChainChunk],
                  float (&mt)[kChainChunk], float (&gs)[kChainChunk],
                  float (&mc)[kChainChunk]) {
#pragma unroll
    for (int i = 0; i < kChainChunk; ++i) {
      const int t = t1 - i;
      vt[i] = mt[i] = gs[i] = mc[i] = 0.0f;
      if (t >= 0) {
        const size_t e = t * plane + idx;
        vt[i] = p.vtrace[e];
        mt[i] = p.mask[e];
        gs[i] = p.g_spk[e];
        mc[i] = mac[e];
      }
    }
  };
  float vt[kChainChunk], mt[kChainChunk], gs[kChainChunk], mc[kChainChunk];
  load(p.t_steps - 1, vt, mt, gs, mc);
  for (int t1 = p.t_steps - 1; t1 >= 0; t1 -= kChainChunk) {
    float vt_n[kChainChunk], mt_n[kChainChunk], gs_n[kChainChunk],
        mc_n[kChainChunk];
    load(t1 - kChainChunk, vt_n, mt_n, gs_n, mc_n);
#pragma unroll
    for (int i = 0; i < kChainChunk; ++i) {
      const int t = t1 - i;
      if (t < 0) break;
      const float spk = vt[i] >= p.v_th1 ? 1.0f : 0.0f;
      const float d = 1.0f + fabsf(p.surrogate_beta * (vt[i] - p.v_th1));
      const float sg = __fdiv_rn(p.surrogate_beta, d * d);   // SuperSpike
      const float g_vclip = g_v * (1.0f - spk) + gs[i] * sg;
      const float g_v2 = g_vclip * (fabsf(vt[i]) < p.v_lim ? 1.0f : 0.0f);
      g_v = g_v2 * (mt[i] * p.beta + (1.0f - mt[i]));
      const float gate = mt[i] + p.kwn_relax * (1.0f - mt[i]);
      const float in_ramp =
          mc[i] >= p.ste_lo && mc[i] <= p.ste_hi ? 1.0f : 0.0f;
      p.g_mac[((size_t)t * p.m + row) * p.ldg + c] =
          g_v2 * gate * sc * p.drive_gain * in_ramp;
    }
#pragma unroll
    for (int i = 0; i < kChainChunk; ++i) {
      vt[i] = vt_n[i];
      mt[i] = mt_n[i];
      gs[i] = gs_n[i];
      mc[i] = mc_n[i];
    }
  }
  p.dv0[idx] = g_v;
}

// Pass B: CTA (kb, cb, s) -> partial dW rows [64 kb, 64 kb + 64), columns
// 128 cb + lane + 32 j, over the rows of slice s.
__global__ void __launch_bounds__(32 * kDwWarps)
fmskb_dw_part(const FmskBwdParams p) {
  __shared__ __align__(16) int8_t s_x[2][kDwChunk][kDwRows];
  __shared__ __align__(16) float s_g[2][kDwChunk][kDwCols];
  __shared__ bool s_on[2][kDwChunk];   // the row's activity word is not 0
  __shared__ uint64_t bars[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * kDwRows, c0 = blockIdx.y * kDwCols;
  const long long rows = (long long)p.t_steps * p.m;
  const int r0 = (int)(rows * blockIdx.z / p.n_slices);
  const int r1 = (int)(rows * (blockIdx.z + 1) / p.n_slices);
  const int kw = min(kDwRows, p.k_dim - k0);       // 64 or 32 bytes
  const int cols4 = (min(kDwCols, p.n - c0) + 3) & ~3;
  const bool k_live = 8 * warp < kw;
  const int n_i = p.m / p.bm;
  // chunk ch into stage ch & 1 by bulk copies from warp 0 (called after a
  // barrier that every read of the stage's previous chunk precedes)
  auto issue = [&](int ch) {
    const int rb = r0 + ch * kDwChunk;
    if (rb >= r1 || warp != 0) return;
    const int nr = min(kDwChunk, r1 - rb);
    uint64_t* b = &bars[ch & 1];
    if (lane == 0) mbar_expect(b, (uint32_t)(nr * (kw + 4 * cols4)));
    __syncwarp();
    bulk_tile(&s_x[ch & 1][0][0], kDwRows, p.x + (size_t)rb * p.k_dim + k0,
              p.k_dim, nr, kw, b, lane);
    bulk_tile(reinterpret_cast<int8_t*>(&s_g[ch & 1][0][0]), 4 * kDwCols,
              reinterpret_cast<const int8_t*>(p.g_mac + (size_t)rb * p.ldg
                                              + c0),
              4 * (size_t)p.ldg, nr, 4 * cols4, b, lane);
  };
  // the activity word of row threadIdx.x of chunk ch (loaded before the
  // chunk ahead of it is computed, stored as a flag after)
  auto word = [&](int ch) {
    const int r = r0 + ch * kDwChunk + threadIdx.x, t = r / p.m;
    return threadIdx.x >= kDwChunk || r >= r1 ? 0
        : p.activity == nullptr ? 1
        : p.activity[(size_t)t * n_i + (r - t * p.m) / p.bm];
  };
  auto flag = [&](int ch, int w) {
    if (threadIdx.x < kDwChunk) s_on[ch & 1][threadIdx.x] = w != 0;
  };
  float acc[8][4];
#pragma unroll
  for (int b = 0; b < 8; ++b)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[b][j] = 0.0f;
  const int n_ch = (r1 - r0 + kDwChunk - 1) / kDwChunk;
  if (threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    fence_mbar_init();
  }
  __syncthreads();
  issue(0);
  flag(0, word(0));
  for (int ch = 0; ch < n_ch; ++ch) {
    mbar_wait(&bars[ch & 1], (ch >> 1) & 1);
    __syncthreads();
    issue(ch + 1);
    const int w_next = word(ch + 1);
    const int b2 = ch & 1, nr = min(kDwChunk, r1 - r0 - ch * kDwChunk);
    for (int r4 = 0; k_live && r4 < nr; r4 += 4) {
      // four rows' event bytes at once, then the rows in order
      uint2 xw[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int rr = r4 + u;
        xw[u] = rr < nr && s_on[b2][rr]
            ? *reinterpret_cast<const uint2*>(&s_x[b2][rr][8 * warp])
            : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if ((xw[u].x | xw[u].y) == 0u) continue;
        float g[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) g[j] = s_g[b2][r4 + u][lane + 32 * j];
        const uint32_t words[2] = {xw[u].x, xw[u].y};
        // every byte of the row, without a branch: a ternary x times g is
        // exact, so fmaf rounds as the add does, and x = 0 adds a zero
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const float xv = i8_to_f32(
              (int)(int8_t)((words[b / 4] >> (8 * (b % 4))) & 0xffu));
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[b][j] = fmaf(xv, g[j], acc[b][j]);
        }
      }
    }
    flag(ch + 1, w_next);
  }
  float* part = p.part + (size_t)blockIdx.z * p.k_dim * p.n;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const int k = k0 + 8 * warp + b;
    if (k >= p.k_dim) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < p.n) part[(size_t)k * p.n + c] = acc[b][j];
    }
  }
}

// Pass C: dW = the slices' partials, added in slice order.
__global__ void __launch_bounds__(256) fmskb_dw_sum(const FmskBwdParams p) {
  const int idx = blockIdx.x * 256 + threadIdx.x;
  const size_t kn = (size_t)p.k_dim * p.n;
  if (idx >= kn) return;
  float s = 0.0f;
  for (int sl = 0; sl < p.n_slices; ++sl) s = s + p.part[sl * kn + idx];
  p.dw[idx] = s;
}

}  // namespace

extern "C" int fmskb_launch(const FmskBwdParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->n == 0 || p->k_dim % 32 != 0 || p->ldg % 4 != 0 || p->ldg < p->n
      || p->n_slices < 1)
    return (int)cudaErrorInvalidValue;
  const int items = p->t_steps * p->m;
  const int nb = (p->n + 127) / 128;
  cudaError_t err = cudaSuccess;
  if (p->mac == nullptr && items > 0) {
    static size_t smem_set = 48 * 1024;   // the default dynamic limit
    const size_t smem = staged_mac_smem(128, kItemWarps * kRematItems);
    if (smem > smem_set) {
      err = cudaFuncSetAttribute(
          fmskb_mac, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      smem_set = smem;
    }
    const int per_cta = kItemWarps * kRematItems;
    CUtensorMap tm[2] = {};
    bool bulk = false;
    err = stage_by_tma(tm, &bulk, p->msb, p->lsb, p->k_dim, p->n, 128, p->x);
    if (err != cudaSuccess) return (int)err;
    fmskb_mac<<<dim3((items + per_cta - 1) / per_cta, nb), kMacThreads,
                smem, s>>>(*p, tm[0], tm[1], bulk);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (p->m > 0) {
    fmskb_chain<<<(p->m * p->n + kChainThreads - 1) / kChainThreads,
                  kChainThreads, 0, s>>>(*p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (p->k_dim > 0) {
    fmskb_dw_part<<<dim3((p->k_dim + kDwRows - 1) / kDwRows, nb,
                         p->n_slices), 32 * kDwWarps, 0, s>>>(*p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int kn = p->k_dim * p->n;
    fmskb_dw_sum<<<(kn + 255) / 256, 256, 0, s>>>(*p);
  }
  return (int)cudaGetLastError();
}
