// K5, tail: the per-event merge after the first row sort.
//
// Replaces, with K3 (sort_cluster.cu) as its first sort, the Pallas kernel
// attpc_engine_tpu/detector/sort_pallas.py `_merge_kernel` (called by
// merge_runs_fused_pallas). The caller sorts pack64(key, charge) rows with
// K3, which is the (key, charge) order of the Pallas network because the
// charges are nonnegative; this kernel does the rest of the Pallas kernel
// in one launch, one block per event row:
//
// - the inclusive f32 prefix of the sorted charges, associated exactly as
//   the Pallas kernel associates it (`_cumsum_flat`): the row is viewed as
//   [S, 128]; a Hillis-Steele scan along the 128 lanes of each segment
//   (c[s,l] += l >= d ? c[s,l-d] : 0 for d = 1 .. 64), then an exclusive
//   Hillis-Steele scan of the segment totals (x[s] = s >= 1 ? c[s-1,127]
//   : 0, then x[s] += s >= d ? x[s-d] : 0 for d = 1, 2, ...), and
//   c[s,l] + x[s]. Every addition adds the same two operands as the TPU
//   kernel, including the additions of 0.0, so the bits agree;
// - the run-end mask on key >> rank_bits, sentinel lanes excluded
//   (`_run_last_flat`), and n_uniq, counted before capping;
// - the compaction of the run ends into `cap` slots, (INT32_MAX, 0.0) in
//   the rest. Run-end keys are distinct and ascending and every other lane
//   of the Pallas second sort is (INT32_MAX, 0.0), so compaction in row
//   order gives exactly that sort's output; the integer scan that places
//   the slots may associate in any way.
//
// Lanes at or beyond the row width W are zero charges in the TPU kernel's
// power-of-two padding; they only add 0.0 after every real lane, so the
// scan runs over ceil(W / 128) segments.
//
// What bounds it on the card: bytes. At the flagship batch it reads the
// sorted [384, 102400] int64 rows (315 MB) and writes [384, 12288] keys
// and sums (38 MB). This simple design reads each row twice (once for the
// segment totals, once for the output) and holds only the segment totals
// (4 B per 128 lanes) in shared memory; the lane scans run in shared
// memory, 8 segments at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 1024;
constexpr int kSegsPerChunk = kThreads / kLanes;
constexpr int kMaxSegments = 4096;  // two float buffers of 16 KB
constexpr int32_t kSentinel = INT32_MAX;

__device__ __forceinline__ int32_t key_of(long long g) {
  return (int32_t)(g >> 32);
}

__device__ __forceinline__ float charge_of(long long g) {
  return __int_as_float((int)(unsigned)(g & 0xFFFFFFFFLL));
}

// Inclusive Hillis-Steele scan of `v` along the 128 lanes of the thread's
// segment (lane = threadIdx.x % 128). Every thread of the block calls it.
__device__ __forceinline__ float lane_scan(float v, float* buf, int lane) {
  for (int d = 1; d < kLanes; d <<= 1) {
    buf[threadIdx.x] = v;
    __syncthreads();
    float add = lane >= d ? buf[threadIdx.x - d] : 0.0f;
    __syncthreads();
    v = v + add;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
merge_tail_kernel(const long long* __restrict__ sorted, int64_t width,
                  int32_t* __restrict__ key2, float* __restrict__ c2,
                  int32_t* __restrict__ n_uniq, int cap, int rank_bits) {
  extern __shared__ float seg_buf[];  // 2 * n_seg floats
  __shared__ float lane_buf[kThreads];
  __shared__ int warp_sum[kThreads / 32];
  __shared__ int carry;

  const int64_t row = blockIdx.x;
  const long long* g = sorted + row * width;
  int32_t* key_out = key2 + row * (int64_t)cap;
  float* c_out = c2 + row * (int64_t)cap;
  const int n_seg = (int)((width + kLanes - 1) / kLanes);
  const int lane = threadIdx.x % kLanes;
  const int seg_in_chunk = threadIdx.x / kLanes;

  // 1. segment totals, shifted by one: x[s] = s >= 1 ? c[s-1, 127] : 0
  float* x = seg_buf;
  float* y = seg_buf + n_seg;
  if (threadIdx.x == 0) x[0] = 0.0f;
  for (int base = 0; base < n_seg; base += kSegsPerChunk) {
    const int seg = base + seg_in_chunk;
    const int64_t i = (int64_t)seg * kLanes + lane;
    float q = i < width ? charge_of(g[i]) : 0.0f;
    float c = lane_scan(q, lane_buf, lane);
    if (lane == kLanes - 1 && seg + 1 < n_seg) x[seg + 1] = c;
  }
  __syncthreads();

  // 2. Hillis-Steele over the segments (double-buffered)
  for (int d = 1; d < n_seg; d <<= 1) {
    for (int s = threadIdx.x; s < n_seg; s += blockDim.x) {
      y[s] = x[s] + (s >= d ? x[s - d] : 0.0f);
    }
    __syncthreads();
    float* t = x;
    x = y;
    y = t;
  }

  // 3. prefix, run ends and compaction, in row order
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int wl = threadIdx.x % 32;
  for (int base = 0; base < n_seg; base += kSegsPerChunk) {
    const int seg = base + seg_in_chunk;
    const int64_t i = (int64_t)seg * kLanes + lane;
    long long gv = i < width ? g[i] : 0;
    float c = lane_scan(i < width ? charge_of(gv) : 0.0f, lane_buf, lane);
    bool last = false;
    if (i < width) {
      c = c + x[seg];
      int32_t h = key_of(gv);
      if (h != kSentinel) {
        last = i == width - 1 ||
               (h >> rank_bits) != (key_of(g[i + 1]) >> rank_bits);
      }
    }
    unsigned ballot = __ballot_sync(0xFFFFFFFFu, last);
    int before = __popc(ballot & ((1u << wl) - 1u));
    if (wl == 0) warp_sum[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      int v = warp_sum[wl];
      for (int d = 1; d < 32; d <<= 1) {
        int u = __shfl_up_sync(0xFFFFFFFFu, v, d);
        if (wl >= d) v += u;
      }
      warp_sum[wl] = v;  // inclusive over warps
    }
    __syncthreads();
    int slot = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + before;
    if (last && slot < cap) {
      key_out[slot] = key_of(gv);
      c_out[slot] = c;
    }
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sum[kThreads / 32 - 1];
    __syncthreads();
  }

  const int n = carry;
  for (int s = min(n, cap) + threadIdx.x; s < cap; s += blockDim.x) {
    key_out[s] = kSentinel;
    c_out[s] = 0.0f;
  }
  if (threadIdx.x == 0) n_uniq[row] = n;
}

}  // namespace

// sorted [rows, width] int64 (pack64 rows, ascending) -> key2 [rows, cap]
// int32, c2 [rows, cap] f32, n_uniq [rows] int32. Returns the cudaError_t
// of the launch, or cudaErrorInvalidValue for a width above
// 128 * kMaxSegments or a cap above the width.
extern "C" int attpc_merge_tail(const void* sorted, void* key2, void* c2,
                                void* n_uniq, int rows, int64_t width,
                                int cap, int rank_bits, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (width <= 0 || width > (int64_t)kLanes * kMaxSegments || cap < 0 ||
      cap > width) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_seg = (int)((width + kLanes - 1) / kLanes);
  const size_t smem = 2 * (size_t)n_seg * sizeof(float);
  merge_tail_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      (const long long*)sorted, width, (int32_t*)key2, (float*)c2,
      (int32_t*)n_uniq, cap, rank_bits);
  return (int)cudaGetLastError();
}
