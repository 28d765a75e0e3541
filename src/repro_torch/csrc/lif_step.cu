// Elementwise LIF step with SNL for Hopper (sm_90a): the last stage of the
// composed chain.
//
// Replaces the Pallas TPU kernel repro/kernels/lif_step.py::_lif_kernel
// (entry lif_step_fused; ops.lif_step).  v, drive, mask, noise (M, N) f32 ->
// v_out, spikes (M, N) f32: winners (mask > 0) leak and integrate as one
// fused multiply-add fma(beta, v, drive), the rest hold; with SNL a membrane
// in (v_th2, v_th1) takes the noise; clip to +-v_lim; spike at v_th1; reset.
//
// What bounds it on the card.  At the chain's step shape (64 x 128) the
// launch: it reads 128 KB and writes 64 KB, 196,608 B, 0.06 us at 3.35
// TB/s and about ten flops an element, far below what any launch costs on
// the card (a one-element zero_ takes about 1 us of device time).  At a
// large shape (8192 x 1024: 201 MB, 60.1 us, beyond the 50 MB L2) bytes,
// and nothing else.
//
// What the design does about that: one pass, each input read once and each
// output written once, four elements a thread through 16-byte loads and
// stores when every pointer is 16-byte aligned (the wrapper checks), one
// element a thread otherwise; four loads in flight a thread and 2,048
// threads an SM keep enough bytes in flight for the memory rate.  The
// update is the fused kernels' own (fm::lif_update in
// fused_macro_common.cuh).  At the large shape this design takes about 0.9
// of the byte bound and at the step shape about the launch floor
// (chip_smoke.py on an H100, PERF.md), which leaves another design at most
// a tenth to gain; so it stays as it is.
//
// Bitwise parity with the reference: the TPU kernel's body is compiled by
// XLA, which contracts beta * v + drive into a fused multiply-add; the
// kernel is built with -fmad=false and writes that one as fmaf, so the
// membranes are 0 ULP from the plain version (kernels/ref.py::lif_step_ref).

#include "fused_macro_common.cuh"

extern "C" {

// Mirrored by repro_torch/kernels/lif_step.py::_Params.
struct LifStepParams {
  const float* v;       // (total)
  const float* drive;   // (total)
  const float* mask;    // (total)
  const float* noise;   // (total)
  float* v_out;         // (total)
  float* spikes;        // (total)
  long long total;
  int use_snl;
  int vec4;             // every pointer 16-byte aligned (the wrapper checks)
  float beta, v_th1, v_th2, v_reset, v_lim;
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void lif_one(const LifStepParams& p,
                                        const fm::LifParams& lp, float v,
                                        float drive, float mask, float nz,
                                        float* v_out, float* spike) {
  *v_out = fm::lif_update(v, drive, mask > 0.0f, nz, p.use_snl != 0, lp,
                          spike);
}

__global__ void __launch_bounds__(kThreads) lif_kernel_vec4(
    const LifStepParams p) {
  const fm::LifParams lp = {p.beta, p.v_th1, p.v_th2, p.v_reset, p.v_lim};
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (4 * i >= p.total) return;
  if (4 * i + 3 < p.total) {
    const float4 v = reinterpret_cast<const float4*>(p.v)[i];
    const float4 d = reinterpret_cast<const float4*>(p.drive)[i];
    const float4 m = reinterpret_cast<const float4*>(p.mask)[i];
    const float4 z = reinterpret_cast<const float4*>(p.noise)[i];
    float4 vo, so;
    lif_one(p, lp, v.x, d.x, m.x, z.x, &vo.x, &so.x);
    lif_one(p, lp, v.y, d.y, m.y, z.y, &vo.y, &so.y);
    lif_one(p, lp, v.z, d.z, m.z, z.z, &vo.z, &so.z);
    lif_one(p, lp, v.w, d.w, m.w, z.w, &vo.w, &so.w);
    reinterpret_cast<float4*>(p.v_out)[i] = vo;
    reinterpret_cast<float4*>(p.spikes)[i] = so;
    return;
  }
  for (long long e = 4 * i; e < p.total; ++e)
    lif_one(p, lp, p.v[e], p.drive[e], p.mask[e], p.noise[e], &p.v_out[e],
            &p.spikes[e]);
}

__global__ void __launch_bounds__(kThreads) lif_kernel(const LifStepParams p) {
  const fm::LifParams lp = {p.beta, p.v_th1, p.v_th2, p.v_reset, p.v_lim};
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= p.total) return;
  lif_one(p, lp, p.v[e], p.drive[e], p.mask[e], p.noise[e], &p.v_out[e],
          &p.spikes[e]);
}

}  // namespace

extern "C" int lif_launch(const LifStepParams* p, void* stream) {
  if (p->total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = p->vec4 != 0;
  const long long per = vec4 ? 4 : 1;
  const long long threads = (p->total + per - 1) / per;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  if (vec4)
    lif_kernel_vec4<<<blocks, kThreads, 0, s>>>(*p);
  else
    lif_kernel<<<blocks, kThreads, 0, s>>>(*p);
  return (int)cudaGetLastError();
}
