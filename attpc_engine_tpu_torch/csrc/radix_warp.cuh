// Warp-level helpers of the radix passes shared by sort_cluster.cu (K3)
// and merge_cluster.cu (K5).

#pragma once

#include <cuda_runtime.h>

namespace {

// Lanes of the warp whose `digit` equals this lane's, among the lanes where
// `valid` holds (0 where it does not). Every lane of the warp must call it.
__device__ __forceinline__ unsigned match_digit(unsigned digit, bool valid) {
  const unsigned peers = __match_any_sync(0xffffffffu, valid ? digit : 256u);
  return valid ? peers : 0u;
}

// Inclusive sum of `v` over the lanes up to this one; the whole warp calls.
__device__ __forceinline__ unsigned warp_inclusive_sum(unsigned v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

}  // namespace
