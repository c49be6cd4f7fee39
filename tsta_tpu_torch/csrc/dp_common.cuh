// Device code shared by the DP kernels (psa_dp.cu, poa_dp.cu).
//
// Both kernels split a row of the DP into column strips, one per thread,
// and resolve the row's F dependency in closed form:
//   F(j) = o + j*e + max(seed, max_{k<j} (C(k) - k*e)),
// which needs, per strip, the exclusive prefix max of the strip maxima to
// its left.  block_excl_max computes it with warp shuffles and one warp
// over the warp totals in shared memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tsta {

// Large-negative guard that cannot overflow int32 when gap terms are added
// to it a few times (not INT_MIN).
constexpr int kNeg = -(1 << 28);
constexpr unsigned kFull = 0xffffffffu;

// max(seed, v of every thread of the block with a lower index).  s_warp
// holds 2 * kThreads / 32 ints.  Contains two __syncthreads(), so every
// thread of the block must call it.
template <int kThreads>
__device__ __forceinline__ int block_excl_max(int v, int seed, int* s_warp) {
  constexpr int kWarps = kThreads / 32;
  static_assert(kWarps <= 32, "one warp scans the warp totals");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int u = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc = max(inc, u);
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s_warp[lane] : kNeg;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int u = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w = max(w, u);
    }
    if (lane < kWarps) s_warp[kWarps + lane] = w;
  }
  __syncthreads();
  int excl = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) excl = kNeg;
  const int before = warp > 0 ? s_warp[kWarps + warp - 1] : kNeg;
  return max(seed, max(excl, before));
}

}  // namespace tsta
