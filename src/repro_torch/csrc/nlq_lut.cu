// NLQ ramp conversion and LUT map-back for Hopper (sm_90a): the second
// stage of the composed chain.
//
// Replaces the Pallas TPU kernel repro/kernels/nlq_lut.py::_nlq_kernel
// (entry nlq_convert; ops.nlq_convert).  x (M, N) f32 against the ramp's
// boundaries (n_codes - 1) f32: codes = the number of boundaries strictly
// below x (the ripple counter), (M, N) int32, and recon = levels[code],
// (M, N) f32.  The TPU kernel's one-hot contraction exists to keep a gather
// off its vector unit; every other term of that sum is a zero, so it is
// exactly the gather done here.
//
// What bounds it on the card: bytes.  At the chain's step shape (64 x 128)
// it reads 32 KB and writes 64 KB, 0.03 us at 3.35 TB/s; the 254 K compares
// are nothing.  A launch of this size is bound by the launch itself.
//
// What the design does about that: one thread per element, the codebook in
// shared memory (read once per CTA), the ramp compare of the fused kernels
// (fm::ramp_code in fused_macro_common.cuh), coalesced loads and stores.
// Bitwise parity is by construction: compares and a table read.

#include "fused_macro_common.cuh"

extern "C" {

// Mirrored by repro_torch/kernels/nlq_lut.py::_Params.
struct NlqParams {
  const float* x;        // (total)
  const float* bounds;   // (n_codes - 1)
  const float* levels;   // (n_codes)
  int32_t* codes;        // (total)
  float* recon;          // (total)
  long long total;
  int n_codes;
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) nlq_kernel(const NlqParams p) {
  extern __shared__ float sh[];
  float* s_bounds = sh;
  float* s_levels = sh + p.n_codes;
  for (int i = threadIdx.x; i < p.n_codes; i += blockDim.x) {
    if (i < p.n_codes - 1) s_bounds[i] = p.bounds[i];
    s_levels[i] = p.levels[i];
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.total) return;
  const int code = fm::ramp_code(p.x[i], s_bounds, p.n_codes);
  p.codes[i] = code;
  p.recon[i] = s_levels[code];
}

}  // namespace

extern "C" int nlq_launch(const NlqParams* p, void* stream) {
  if (p->total == 0) return 0;
  const long long blocks = (p->total + kThreads - 1) / kThreads;
  const size_t smem = 2 * sizeof(float) * (size_t)p->n_codes;
  nlq_kernel<<<(unsigned)blocks, kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(*p);
  return (int)cudaGetLastError();
}
