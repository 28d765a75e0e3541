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
// What bounds it on the card.  At the chain's step shape (64 x 128) the
// launch: it reads 32 KB and writes 64 KB, 0.03 us at 3.35 TB/s, far below
// what any launch costs, so what can be cut is the latency in series
// inside it: round trips to memory, a barrier, dependent lookups.  At a
// large shape (8192 x 1024: 100.7 MB, 30 us, beyond the 50 MB L2) bytes,
// if the count keeps up: a linear count is n_codes - 1 compares and loads
// an element (31 at the model's 5-bit codebook, 63 at 6 bits), and that
// would set the pace instead.
//
// What the design does about it:
// * One round trip.  A thread's four values are loaded first (one 16-byte
//   vector when x, codes and recon are all 16-byte aligned, else four
//   strided 4-byte loads), and the codebook is loaded while they are in
//   flight.  Up to 64 codes (the model's 5 and 6 bits) every warp keeps
//   the codebook in registers, lane l holding boundaries and levels l and
//   l + 32, and reads it by shuffles: no shared memory and no barrier.  A
//   larger codebook is staged in shared memory by the CTA.
// * The count.  The warp (or the CTA) checks that the boundaries are
//   non-decreasing and hold no NaN: b[i] <= b[i + 1] for each, the last
//   held to +inf, a NaN failing the compare.  Then the code is a
//   branch-free binary search, ceil(log2 n_codes) steps of x > b[mid] over
//   the boundaries padded with +inf to a power of two; an unsorted
//   codebook takes the linear count, one loop over the boundaries, each
//   read once for all of a thread's values.  On a non-decreasing array
//   x > b[i] holds on a prefix of i, so both give the number of boundaries
//   strictly below x; a NaN x fails every compare and lands at 0 in both.
//   A subnormal x is flushed to a zero of its sign first, as XLA on the
//   CPU compares it (fm::flush_subnormal).
//   The search is the faster count at both shapes (PERF.md, "PR 20"): at
//   the large shape the linear count's n_codes - 1 broadcasts an element,
//   not the bytes, set the pace; at the step shape they lie in series
//   inside a launch that is all latency.
// * recon = levels[code] by a shuffle (or from shared memory); codes and
//   recon go out in 16-byte stores.
// Bitwise parity by construction: compares and a table read.

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

using fm::kFull;

constexpr int kThreads = 128;
constexpr int kPer = 4;              // values a thread
constexpr int kRegCodes = 64;        // codebooks held in registers

// Value j of a thread: with VEC element 4 t + j of the CTA's span (one
// 16-byte vector), else element t + 128 j (coalesced 4-byte accesses).
template <bool VEC>
__device__ __forceinline__ long long elem(long long base, int j) {
  return VEC ? base + kPer * threadIdx.x + j
             : base + threadIdx.x + j * kThreads;
}

// REG: the codebook in each warp's registers (n_codes <= kRegCodes); else
// in shared memory, 2^bits boundaries padded with +inf, then the levels.
template <bool VEC, bool REG>
__global__ void __launch_bounds__(kThreads) nlq_kernel(const NlqParams p,
                                                       int bits) {
  extern __shared__ float sh[];
  float* s_bounds = sh;
  float* s_levels = sh + (1 << bits);
  const int lane = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * kThreads * kPer;
  const bool whole = VEC && elem<VEC>(base, kPer - 1) < p.total;

  float x[kPer];
  if (whole) {
    const float4 f =
        *reinterpret_cast<const float4*>(p.x + elem<VEC>(base, 0));
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long e = elem<VEC>(base, j);
      x[j] = e < p.total ? p.x[e] : 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) x[j] = fm::flush_subnormal(x[j]);

  // the codebook, loaded while the values are in flight
  const int nb = p.n_codes - 1;
  const float inf = __int_as_float(0x7f800000);
  float b_lo = inf, b_hi = inf, l_lo = 0.0f, l_hi = 0.0f;
  bool sorted;
  if constexpr (REG) {
    if (lane < nb) b_lo = p.bounds[lane];
    if (lane + 32 < nb) b_hi = p.bounds[lane + 32];
    if (lane < p.n_codes) l_lo = p.levels[lane];
    if (lane + 32 < p.n_codes) l_hi = p.levels[lane + 32];
    const float hi_first = __shfl_sync(kFull, b_hi, 0);
    float next_lo = __shfl_down_sync(kFull, b_lo, 1);
    float next_hi = __shfl_down_sync(kFull, b_hi, 1);
    if (lane == 31) {
      next_lo = hi_first;
      next_hi = inf;
    }
    sorted = !__any_sync(kFull, !(b_lo <= next_lo && b_hi <= next_hi));
  } else {
    int unsorted = 0;
    for (int i = threadIdx.x; i < max(1 << bits, p.n_codes); i += kThreads) {
      const float b = i < nb ? p.bounds[i] : inf;
      const float next = i + 1 < nb ? p.bounds[i + 1] : inf;
      const float level = i < p.n_codes ? p.levels[i] : 0.0f;
      unsorted |= !(b <= next);
      if (i < (1 << bits) - 1) s_bounds[i] = b;
      if (i < p.n_codes) s_levels[i] = level;
    }
    sorted = !__syncthreads_or(unsorted);
  }

  // boundary i < 2^bits - 1 (every lane of the warp asks at once)
  auto bound = [&](int i) -> float {
    if constexpr (REG) {
      const float lo = __shfl_sync(kFull, b_lo, i & 31);
      if (bits <= 5) return lo;
      const float hi = __shfl_sync(kFull, b_hi, i & 31);
      return i < 32 ? lo : hi;
    } else {
      return s_bounds[i];
    }
  };

  int code[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) code[j] = 0;
  if (sorted) {
    // the prefix on which x > b[i] holds, from the top bit down
    for (int s = bits - 1; s >= 0; --s) {
      const int step = 1 << s;
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        code[j] += x[j] > bound(code[j] + step - 1) ? step : 0;
    }
  } else {
    // i is the same in every lane: each boundary is one broadcast
    for (int i = 0; i < nb; ++i) {
      const float b = bound(i);
#pragma unroll
      for (int j = 0; j < kPer; ++j) code[j] += x[j] > b;
    }
  }

  float recon[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if constexpr (REG) {
      const float lo = __shfl_sync(kFull, l_lo, code[j] & 31);
      const float hi =
          p.n_codes > 32 ? __shfl_sync(kFull, l_hi, code[j] & 31) : lo;
      recon[j] = code[j] < 32 ? lo : hi;
    } else {
      recon[j] = s_levels[code[j]];
    }
  }

  if (whole) {
    const long long e = elem<VEC>(base, 0);
    *reinterpret_cast<int4*>(p.codes + e) =
        make_int4(code[0], code[1], code[2], code[3]);
    *reinterpret_cast<float4*>(p.recon + e) =
        make_float4(recon[0], recon[1], recon[2], recon[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long e = elem<VEC>(base, j);
      if (e < p.total) {
        p.codes[e] = code[j];
        p.recon[e] = recon[j];
      }
    }
  }
}

template <bool VEC>
void launch(const NlqParams& p, int bits, bool reg, unsigned blocks,
            cudaStream_t s) {
  if (reg) {
    nlq_kernel<VEC, true><<<blocks, kThreads, 0, s>>>(p, bits);
  } else {
    const size_t smem = sizeof(float) * ((size_t(1) << bits) + p.n_codes);
    nlq_kernel<VEC, false><<<blocks, kThreads, smem, s>>>(p, bits);
  }
}

}  // namespace

extern "C" int nlq_launch(const NlqParams* p, void* stream) {
  if (p->total == 0) return 0;
  // ceil(log2 n_codes): the search's steps.  A codebook of more than
  // kRegCodes codes takes (2^bits + n_codes) floats of dynamic shared
  // memory, with no opt-in above 48 KB: such a launch is refused and the
  // wrapper raises.
  const int bits = p->n_codes > 1 ? 32 - __builtin_clz(p->n_codes - 1) : 0;
  const bool reg = p->n_codes <= kRegCodes;
  const unsigned blocks =
      (unsigned)((p->total + kThreads * kPer - 1) / (kThreads * kPer));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (((uintptr_t)p->x | (uintptr_t)p->codes | (uintptr_t)p->recon) % 16
      == 0)
    launch<true>(*p, bits, reg, blocks, s);
  else
    launch<false>(*p, bits, reg, blocks, s);
  return (int)cudaGetLastError();
}
