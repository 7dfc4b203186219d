// The live route's row plan, shared by sort_cluster.cu (the cluster routes
// and the wide route's chunk sort) and merge_rows.cu (the wide route's
// merge passes). detector/sort_cuda.py's `live_sites` counts rows by its
// routes; tests/merge_cases.py's `live_plan` emulates its launches.

#pragma once

#include <stdint.h>

namespace {

// elements a CTA of the cluster kernel holds (two 8-byte buffers of them
// and the digit tables fill a block's shared memory): sort_cuda.CTA_CAPACITY
constexpr int kLiveChunk = 13360;
// the widest prefix a cluster sorts whole: 8 CTAs. Wider prefixes take the
// wide route: on the first 384 events of the chain's benchmark
// configuration ([384, 819200], prefixes 0.18 of the row) the live route
// took 5.358 ms with clusters of up to 16 CTAs, 4.777 with up to 8 and
// 4.951 with up to 4; on c16dd's ([384, 192000]) 0.889, 0.898 and 0.798
// (NVIDIA H100 80GB HBM3, 700 W). A 16-CTA cluster holds only 7-8 of the
// card's 132 SMs' worth of clusters at once and scatters 15/16 of each
// pass through distributed shared memory; one-CTA chunks fill every SM
// and the merge passes cost a read and a write of the prefix each.
constexpr int64_t kLiveClusterLanes = 8 * (int64_t)kLiveChunk;

// Row `row`'s prefix, held to [0, width] so that no launch reads or
// writes past its row whatever the caller passed.
__device__ __forceinline__ int64_t live_prefix(const int32_t* lanes,
                                               int64_t row, int64_t width) {
  const int64_t v = lanes[row];
  return v < 0 ? 0 : (v > width ? width : v);
}

// Merge passes of a wide row whose prefix holds `lanes` elements: its
// chunks of kLiveChunk lanes are joined in pairs until one run spans the
// prefix, ceil(log2(chunks)) passes.
__host__ __device__ __forceinline__ int live_merge_passes(int64_t lanes) {
  const int64_t chunks = (lanes + kLiveChunk - 1) / kLiveChunk;
  int passes = 0;
  while (((int64_t)1 << passes) < chunks) ++passes;
  return passes;
}

}  // namespace
