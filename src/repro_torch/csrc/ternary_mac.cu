// Twin-cell ternary MAC for Hopper (sm_90a): the first stage of the composed
// chain.
//
// Replaces the Pallas TPU kernel repro/kernels/ternary_mac.py::
// _ternary_mac_kernel (entry ternary_mac; ops.ternary_mac).  x (M, K) int8
// ternary events against the twin-cell planes msb / lsb (K, N) int8 ternary:
// out = x @ (ratio * msb + lsb), (M, N) f32.
//
// What bounds it on the card: by the roofline, bytes.  At the chain's step
// shape (M=64, K=512, N=128, 5 % events) it reads 32 KB of events and
// 128 KB of planes and writes 32 KB: 196,608 B, 0.06 us at 3.35 TB/s; the
// products the events need are a few hundred thousand int8 operations.  In
// practice latency bounds it: the weight rows of the inputs that fired are
// read one after another.
//
// What the design does about that: the fused kernels' event-driven MAC
// (fused_macro_common.cuh), in integers.  One warp owns a row and 128
// columns (4 a lane, c = col0 + lane + 32 j; the grid's second axis walks
// wider layers); it ballots 32 inputs at a time and adds only the plane rows
// of the inputs that fired, so the work follows the events, and a K tile of
// zeros costs one coalesced 32-byte load.  Ragged M, K and N are masked in
// the kernel, so the wrapper pads nothing.  A dense product at a large batch
// would want int8 mma.sync (s8 x s8 -> s32) on the tensor cores instead:
// later work.  (A first version tiled the dense product in shared memory;
// with 8 CTAs at this shape it took 39 us on the card.)
//
// Bitwise parity with the reference: x * msb and x * lsb are small integers,
// so both int32 accumulators are exact; the result is fmaf(ratio, acc_msb,
// acc_lsb), one rounding (the plain version repro_torch/kernels/ref.py::
// ternary_mac_ref computes the same fused multiply-add).  For an integral
// ratio that is the reference's f32 product exactly while |MAC| < 2^24.

#include "fused_macro_common.cuh"

extern "C" {

// Mirrored by repro_torch/kernels/ternary_mac.py::_Params.
struct TmacParams {
  const int8_t* x;     // (M, K)
  const int8_t* msb;   // (K, N)
  const int8_t* lsb;   // (K, N)
  float* out;          // (M, N)
  int m, k_dim, n;
  float ratio;
};

}  // extern "C"

namespace {

using fm::kFull;
using fm::kRowsPerCta;

constexpr int kCpl = 4;               // columns per lane
constexpr int kWarpCols = 32 * kCpl;  // columns per warp

__global__ void __launch_bounds__(32 * kRowsPerCta) tmac_kernel(
    const TmacParams p) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerCta + (threadIdx.x >> 5);
  if (row >= p.m) return;
  const int col0 = blockIdx.y * kWarpCols;
  int am[kCpl], al[kCpl];
#pragma unroll
  for (int j = 0; j < kCpl; ++j) am[j] = al[j] = 0;
  const int8_t* xr = p.x + (size_t)row * p.k_dim;
  for (int k0 = 0; k0 < p.k_dim; k0 += 32) {
    const int xv = k0 + lane < p.k_dim ? xr[k0 + lane] : 0;
    unsigned live = __ballot_sync(kFull, xv != 0);
    while (live) {
      const int b = __ffs(live) - 1;
      live &= live - 1;
      const int s = __shfl_sync(kFull, xv, b);
      const int8_t* mr = p.msb + (size_t)(k0 + b) * p.n;
      const int8_t* lr = p.lsb + (size_t)(k0 + b) * p.n;
#pragma unroll
      for (int j = 0; j < kCpl; ++j) {
        const int c = col0 + lane + 32 * j;
        if (c < p.n) {
          am[j] += s * (int)mr[c];
          al[j] += s * (int)lr[c];
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kCpl; ++j) {
    const int c = col0 + lane + 32 * j;
    if (c < p.n)
      p.out[(size_t)row * p.n + c] =
          fmaf(p.ratio, (float)am[j], (float)al[j]);
  }
}

}  // namespace

extern "C" int tmac_launch(const TmacParams* p, void* stream) {
  if (p->m == 0 || p->n == 0) return 0;
  const dim3 grid((p->m + kRowsPerCta - 1) / kRowsPerCta,
                  (p->n + kWarpCols - 1) / kWarpCols);
  tmac_kernel<<<grid, 32 * kRowsPerCta, 0,
                static_cast<cudaStream_t>(stream)>>>(*p);
  return (int)cudaGetLastError();
}
