// KWN descending-ramp top-K with early stop for Hopper (sm_90a): the third
// stage of the composed chain, a select with a fixed cost.
//
// Replaces the Pallas TPU kernel repro/kernels/kwn_topk.py::_kwn_kernel
// (entry kwn_topk; ops.kwn_topk).  mac (M, N) f32 -> ramp codes against the
// boundaries -> the descending priority-encoder sweep: mask (M, N) f32, 1
// for the K winners (descending code, ties in column order), and adc_steps
// (M, 1) int32, the sweep step at which the K-th winner crossed.
//
// What bounds it on the card: bytes.  At the chain's step shape (64 x 128)
// it reads 32 KB and writes 33 KB, 0.02 us at 3.35 TB/s.  A launch of this
// size is bound by the launch itself and by the round trips in series
// inside it.
//
// What the design does about that: one warp per row, two rows a CTA (32
// CTAs at M = 64).
// * One round trip: a row's MAC loads are issued first, 16 bytes a lane
//   where the row allows it (lane l then holds columns 128 j + 4 l + q),
//   and the CTA stages the codebook in shared memory while they are in
//   flight.  The codes are the batched count of boundaries strictly below
//   each value (fm::ramp_codes: each boundary loaded once for all of a
//   lane's columns), so any boundary order gives the reference's codes.
// * A select whose cost does not depend on the data: the K-th winner's
//   code tau is the largest v with at least K codes >= v, found bit by bit
//   from the top in ceil(log2 n_codes) warp-wide counts (__reduce_add_sync),
//   in place of a ballot per ramp level from the row's top code down.  The
//   last candidate that fails is tau + 1, so its count is the winners above
//   tau; ties at tau are admitted in column order by one prefix popc of a
//   ballot per register slot.  (Two bits a round, three counts at once,
//   was no faster on the card.)
// * The mask goes out in 16-byte stores where the row allows it.
//
// Semantics, the TPU kernel's exactly: steps = n_codes - 1 - tau; K <= 0
// admits none and reports step 0 (the TPU sweep has K winners at its first
// step); fewer than K columns that can win (K >= N among them) admits every
// column with n_codes - 1 steps; padded columns (code -1) never win.  The
// priority sweep of the fused kernels (fm::kwn_sweep, shared with #1 and
// #4) is not used here.

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

using fm::kFull;

constexpr int kRows = 2;   // rows (warps) a CTA

// The number of the lane's codes >= c, summed over the warp.
template <int CPL>
__device__ __forceinline__ int count_ge(const int (&code)[CPL], int c) {
  unsigned s = 0;
#pragma unroll
  for (int j = 0; j < CPL; ++j) s += code[j] >= c;
  return (int)__reduce_add_sync(kFull, s);
}

// Slot j = VEC h + q of a lane holds column 32 VEC h + VEC lane + q: VEC
// consecutive columns a lane in each of CPL / VEC chunks, so chunk-major,
// then lane, then q is column order.
template <int CPL, int VEC>
__global__ void __launch_bounds__(32 * kRows) kwn_kernel(const KwnParams p) {
  static_assert(CPL % VEC == 0, "whole chunks");
  constexpr int CH = CPL / VEC;
  extern __shared__ float s_bounds[];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRows + (threadIdx.x >> 5);
  const bool live = row < p.m;
  const float* mr = p.mac + (size_t)row * p.n;
  float v[CPL];
#pragma unroll
  for (int h = 0; h < CH; ++h) {
    const int c = 32 * VEC * h + VEC * lane;
    if constexpr (VEC == 4) {
      const float4 f = live && c < p.n
          ? *reinterpret_cast<const float4*>(mr + c)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      v[VEC * h] = f.x;
      v[VEC * h + 1] = f.y;
      v[VEC * h + 2] = f.z;
      v[VEC * h + 3] = f.w;
    } else {
      v[h] = live && c < p.n ? mr[c] : 0.0f;
    }
  }
  for (int i = threadIdx.x; i < p.n_codes - 1; i += blockDim.x)
    s_bounds[i] = p.bounds[i];
  __syncthreads();
  if (!live) return;
  int code[CPL];
  fm::ramp_codes<CPL>(v, code, s_bounds, p.n_codes);
#pragma unroll
  for (int j = 0; j < CPL; ++j)
    if (32 * VEC * (j / VEC) + VEC * lane + j % VEC >= p.n) code[j] = -1;

  // tau bit by bit from the top; the last candidate that fails is tau + 1
  // (the lowest zero bit of tau above its trailing ones, set), so its count
  // is the number of winners above tau (none fails: tau + 1 is past the
  // top code, and none are above)
  int tau = 0, room = 0, steps = 0;
  if (p.k > 0) {
    const int valid = count_ge<CPL>(code, 0);
    const int bits = 32 - __clz(p.n_codes - 1);
    int above = 0;
    for (int b = bits - 1; b >= 0; --b) {
      const int c = tau | (1 << b);
      const int cnt = count_ge<CPL>(code, c);
      if (cnt >= p.k) tau = c;
      else above = cnt;
    }
    if (valid < p.k) {   // every column that can win
      tau = 0;
      room = p.n;
      steps = p.n_codes - 1;
    } else {
      room = p.k - above;
      steps = p.n_codes - 1 - tau;
    }
  }
  const unsigned lanes_below = (1u << lane) - 1u;
  float* out = p.mask + (size_t)row * p.n;
  int before = 0;   // ties at tau in earlier columns of other lanes' chunks
#pragma unroll
  for (int h = 0; h < CH; ++h) {
    unsigned tie[VEC];
    int below = 0;
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      tie[q] = __ballot_sync(kFull, code[VEC * h + q] == tau);
      below += __popc(tie[q] & lanes_below);
    }
    float w[VEC];
    int mine = before + below;
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      const int cd = code[VEC * h + q];
      const bool is_tie = cd == tau;
      w[q] = p.k > 0 && (cd > tau || (is_tie && mine < room)) ? 1.0f : 0.0f;
      mine += is_tie;
      before += __popc(tie[q]);
    }
    const int c = 32 * VEC * h + VEC * lane;
    if (c < p.n) {
      if constexpr (VEC == 4)
        *reinterpret_cast<float4*>(out + c) = make_float4(w[0], w[1], w[2],
                                                          w[3]);
      else
        out[c] = w[0];
    }
  }
  if (lane == 0) p.steps[row] = steps;
}

template <int CPL, int VEC>
cudaError_t launch(const KwnParams& p, cudaStream_t stream) {
  const dim3 grid((p.m + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * (size_t)(p.n_codes > 1 ? p.n_codes - 1
                                                             : 1);
  kwn_kernel<CPL, VEC><<<grid, 32 * kRows, smem, stream>>>(p);
  return cudaGetLastError();
}

// 16-byte rows (VEC 4) when the row length and both pointers allow them.
template <int CPL>
cudaError_t launch_cpl(const KwnParams& p, cudaStream_t stream) {
  if constexpr (CPL >= 4) {
    if (p.n % 4 == 0
        && ((uintptr_t)p.mac | (uintptr_t)p.mask) % 16 == 0)
      return launch<CPL, 4>(p, stream);
  }
  return launch<CPL, 1>(p, stream);
}

}  // namespace

extern "C" int kwn_launch(const KwnParams* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cpl = (p->n + 31) / 32;
  if (p->m == 0 || p->n == 0) return 0;
  if (p->n_codes < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (cpl <= 1) err = launch_cpl<1>(*p, s);
  else if (cpl <= 2) err = launch_cpl<2>(*p, s);
  else if (cpl <= 4) err = launch_cpl<4>(*p, s);
  else if (cpl <= 8) err = launch_cpl<8>(*p, s);
  else if (cpl <= 16) err = launch_cpl<16>(*p, s);
  else if (cpl <= 32) err = launch_cpl<32>(*p, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
