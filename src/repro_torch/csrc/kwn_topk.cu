// KWN descending-ramp top-K with early stop for Hopper (sm_90a): the third
// stage of the composed chain.
//
// Replaces the Pallas TPU kernel repro/kernels/kwn_topk.py::_kwn_kernel
// (entry kwn_topk; ops.kwn_topk).  mac (M, N) f32 -> ramp codes against the
// boundaries -> the descending priority-encoder sweep: mask (M, N) f32, 1
// for the K winners (descending code, ties in column order), and adc_steps
// (M, 1) int32, the sweep step at which the K-th winner crossed.
//
// What bounds it on the card: bytes.  At the chain's step shape (64 x 128)
// it reads 32 KB and writes 33 KB, 0.02 us at 3.35 TB/s.  A launch of this
// size is bound by the launch itself.
//
// What the design does about that: one warp per row, lane l holding columns
// l + 32 j (CPL = ceil(N / 32) of them, chosen per launch; padded columns get
// code -1 and never win), the codebook in shared memory.  The sweep is the
// fused kernels' (fm::kwn_sweep): one ballot per level in column order,
// which is the priority encoder's admission order.  It starts at the row's
// top code and stops at the K-th winner instead of sweeping all n_codes
// levels as the TPU kernel does; the mask and the step count are the same.
// The one difference is K = 0: the TPU kernel has K winners at its first
// step and reports 0, where the helper reports n_codes - 1, so K <= 0 is
// answered here without a sweep.  K >= N admits every column with
// n_codes - 1 steps, as the TPU kernel does.

#include "fused_macro_common.cuh"

extern "C" {

// Mirrored by repro_torch/kernels/kwn_topk.py::_Params.
struct KwnParams {
  const float* mac;      // (M, N)
  const float* bounds;   // (n_codes - 1)
  float* mask;           // (M, N)
  int32_t* steps;        // (M)
  int m, n, k, n_codes;
};

}  // extern "C"

namespace {

using namespace fm;

template <int CPL>
__global__ void __launch_bounds__(32 * kRowsPerCta) kwn_kernel(
    const KwnParams p) {
  extern __shared__ float s_bounds[];
  for (int i = threadIdx.x; i < p.n_codes - 1; i += blockDim.x)
    s_bounds[i] = p.bounds[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerCta + (threadIdx.x >> 5);
  if (row >= p.m) return;
  const float* mr = p.mac + (size_t)row * p.n;
  int code[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    code[j] = c < p.n ? ramp_code(mr[c], s_bounds, p.n_codes) : -1;
  }
  bool win[CPL];
  int steps = kwn_sweep<CPL>(code, win, p.k, p.n_codes, lane);
  if (p.k <= 0) steps = 0;
  float* out = p.mask + (size_t)row * p.n;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int c = lane + 32 * j;
    if (c < p.n) out[c] = win[j] ? 1.0f : 0.0f;
  }
  if (lane == 0) p.steps[row] = steps;
}

template <int CPL>
cudaError_t launch(const KwnParams& p, cudaStream_t stream) {
  const dim3 grid((p.m + kRowsPerCta - 1) / kRowsPerCta);
  const size_t smem = sizeof(float) * (size_t)(p.n_codes > 1 ? p.n_codes - 1
                                                             : 1);
  kwn_kernel<CPL><<<grid, 32 * kRowsPerCta, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int kwn_launch(const KwnParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cpl = (p->n + 31) / 32;
  if (p->m == 0 || p->n == 0) return 0;
  cudaError_t err;
  if (cpl <= 1) err = launch<1>(*p, s);
  else if (cpl <= 2) err = launch<2>(*p, s);
  else if (cpl <= 4) err = launch<4>(*p, s);
  else if (cpl <= 8) err = launch<8>(*p, s);
  else if (cpl <= 16) err = launch<16>(*p, s);
  else if (cpl <= 32) err = launch<32>(*p, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
