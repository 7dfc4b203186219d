// Run-end compaction: the per-event merge of the sorts path after its
// first row sort.
//
// Replaces no separate TPU kernel: in the JAX package's sorts path
// (attpc_engine_tpu/detector/deposition.py `_merge_runs`) it is the second
// call of the Pallas sort (sort_pallas.py `_sort_kernel`) and the XLA
// passes around it: the run-end mask, the charge prefix (jnp.cumsum), the
// masks and the n_uniq count. The caller sorts the pack64(key, charge)
// rows [E, W] with K3; this kernel reads them as they are and writes
//
// - n_uniq [E] int32: the lanes whose key is not KEY_SENTINEL and whose
//   key >> rank_bits differs from the next lane's (or that end the row),
//   counted before capping;
// - key2 [E, cap] int32 and c2 [E, cap] f32: those run ends in row order,
//   each with the inclusive f32 prefix of the sorted charges at its lane,
//   in the first cap slots, and (KEY_SENTINEL, 0.0) in the rest. Run-end
//   keys are distinct and ascending and every other lane of the second
//   sort is (KEY_SENTINEL, 0.0), so this is that sort's output; the
//   integer scan that places the slots may associate in any way.
//
// The prefix associates exactly as deposition._prefix_sum (XLA's CPU
// cumsum): level 0 is the row, level L+1 the totals of level L's blocks of
// 16, each block summed left to right with the level's zero padding; a
// level of at most 16 values is prefixed left to right, and every lower
// level's element is its block's left-to-right prefix plus the upper
// level's prefix at the previous block (0.0 for the first). Every
// addition adds the same two operands as the plain version, the additions
// of 0.0 included, so the bits agree.
//
// What bounds it on the card: bytes. It must read the sorted rows once (8
// B a lane; [384, 819200] is 2.52 GB, 0.75 ms at 3.35 TB/s) and write the
// cap slots (8 B each). This simple design reads the rows twice, in three
// launches and with no grid-wide sync:
//
// 1. totals (one CTA a tile of 4,096 = 16^3 lanes): the 16 lanes of each
//    level-1 block summed by one thread, the 16 level-1 totals of each
//    segment of 256 lanes (a level-2 element) by one thread; the segment
//    totals and the tile's run-end count go to scratch;
// 2. carry (one CTA a row): the exclusive scan of the tiles' run-end
//    counts (n_uniq is its total), the padding slots, and the prefix of
//    the segment totals through every upper level, in scratch;
// 3. write (one CTA a tile): the tile read again; each lane's prefix is
//    its level-1 block's left-to-right prefix plus the block's carry
//    (built from the segment's level-1 totals, the previous segment's
//    total and the segment prefix), and its run ends go to their slots.
//
// A CTA loads its tile with coalesced 8-byte loads into shared memory,
// laid out as one padded row of 16 lanes a thread, so that each thread
// reads its block's lanes without bank conflicts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 16;                 // _prefix_sum's sequential block
constexpr int kThreads = 256;              // one level-1 block a thread
constexpr int kTile = kThreads * kBlock;   // 4,096 lanes
constexpr int kSegment = kBlock * kBlock;  // 256 lanes: a level-2 element
constexpr int kSegsPerTile = kTile / kSegment;
constexpr int kPitch = kBlock + 1;         // a thread's padded shared row
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 16;
constexpr int32_t kSentinel = INT32_MAX;

__device__ __forceinline__ int32_t key_of(long long g) {
  return (int32_t)(g >> 32);
}

__device__ __forceinline__ float charge_of(long long g) {
  return __int_as_float((int)(unsigned)(g & 0xFFFFFFFFLL));
}

// Exclusive scan of v over the block's threads in thread order; *total
// gets the sum. Every thread of the block calls it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total,
                                                    int* warp_sum) {
  const int wl = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xFFFFFFFFu, inc, d);
    if (wl >= d) inc += u;
  }
  if (wl == 31) warp_sum[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int s = warp_sum[w];
    before += w < warp ? s : 0;
    all += s;
  }
  __syncthreads();
  *total = all;
  return before + inc - v;
}

// Loads lanes [tile0, tile0 + kTile) of the row g into shared memory, lane
// l at q_s / k_s[(l / 16) * kPitch + l % 16]: its charge (0.0 past the
// row's end) and its key where the lane ends a run, else KEY_SENTINEL.
// Returns the number of run ends among the lanes this thread loaded.
__device__ __forceinline__ int load_tile(const long long* __restrict__ g,
                                         int64_t width, int64_t tile0,
                                         int rank_bits, float* q_s,
                                         int32_t* k_s) {
  constexpr long long kDead = (long long)kSentinel << 32;
  const int wl = threadIdx.x & 31;
  long long v[kBlock];
#pragma unroll
  for (int k = 0; k < kBlock; ++k) {
    const int64_t i = tile0 + k * kThreads + threadIdx.x;
    v[k] = i < width ? g[i] : kDead;
  }
  int ends = 0;
#pragma unroll
  for (int k = 0; k < kBlock; ++k) {
    const int l = k * kThreads + threadIdx.x;
    const int64_t i = tile0 + l;
    const int32_t h = key_of(v[k]);
    int32_t next = __shfl_down_sync(0xFFFFFFFFu, h, 1);
    if (wl == 31) next = i + 1 < width ? key_of(g[i + 1]) : kSentinel;
    const bool last = i < width && h != kSentinel &&
                      (i + 1 == width || (h >> rank_bits) != (next >> rank_bits));
    const int at = (l / kBlock) * kPitch + l % kBlock;
    q_s[at] = charge_of(v[k]);
    k_s[at] = last ? h : kSentinel;
    ends += last;
  }
  return ends;
}

// Left-to-right sum of n values of a (n >= 1).
__device__ __forceinline__ float sum_left(const float* a, int n) {
  float acc = a[0];
  for (int k = 1; k < n; ++k) acc = acc + a[k];
  return acc;
}

__global__ void __launch_bounds__(kThreads)
compact_runs_totals_kernel(const long long* __restrict__ rows, int64_t width,
                           int rank_bits, float* __restrict__ seg_total,
                           int32_t* __restrict__ tile_ends) {
  __shared__ float q_s[kThreads * kPitch];
  __shared__ int32_t k_s[kThreads * kPitch];
  __shared__ float t1_s[kThreads];
  __shared__ int warp_sum[kWarps];
  const int64_t row = blockIdx.y;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int ends = load_tile(rows + row * width, width, (int64_t)tile * kTile,
                             rank_bits, q_s, k_s);
  __syncthreads();
  t1_s[threadIdx.x] = sum_left(q_s + threadIdx.x * kPitch, kBlock);
  int total;
  block_exclusive_scan(ends, &total, warp_sum);  // its syncs publish t1_s
  if (threadIdx.x < kSegsPerTile) {
    seg_total[(row * n_tiles + tile) * kSegsPerTile + threadIdx.x] =
        sum_left(t1_s + threadIdx.x * kBlock, kBlock);
  }
  if (threadIdx.x == 0) tile_ends[row * n_tiles + tile] = total;
}

__global__ void __launch_bounds__(kThreads)
compact_runs_carry_kernel(const float* seg_total, int n_tiles, int n_seg,
                          float* seg_prefix, int prefix_stride,
                          int32_t* tile_ends, int32_t* key2, float* c2,
                          int32_t* n_uniq, int cap) {
  // no __restrict__: the levels are read back after other threads wrote
  // them
  __shared__ int warp_sum[kWarps];
  const int64_t row = blockIdx.x;

  // 1. the tiles' first slots and n_uniq; the padding slots
  int32_t* ends = tile_ends + row * n_tiles;
  int carry = 0;
  for (int base = 0; base < n_tiles; base += kThreads) {
    const int t = base + threadIdx.x;
    int total;
    const int before = block_exclusive_scan(t < n_tiles ? ends[t] : 0, &total,
                                            warp_sum);
    if (t < n_tiles) ends[t] = carry + before;
    carry += total;
  }
  for (int s = min(carry, cap) + threadIdx.x; s < cap; s += kThreads) {
    key2[row * cap + s] = kSentinel;
    c2[row * cap + s] = 0.0f;
  }
  if (threadIdx.x == 0) n_uniq[row] = carry;

  // 2. the segment totals (level 2) prefixed as _prefix_sum, levels in
  // place: level l's n[l] values at a + off[l]
  const float* in = seg_total + row * (int64_t)n_tiles * kSegsPerTile;
  float* a = seg_prefix + row * (int64_t)prefix_stride;
  int off[kMaxLevels], n[kMaxLevels];
  int top = 0;
  off[0] = 0;
  n[0] = n_seg;
  while (n[top] > kBlock) {
    const int m = n[top];
    const int blocks = (m + kBlock - 1) / kBlock;
    for (int b = threadIdx.x; b < blocks; b += kThreads) {
      float acc = 0.0f;
      for (int k = 0; k < kBlock; ++k) {
        const int i = b * kBlock + k;
        const float x = i < m ? in[i] : 0.0f;
        acc = k == 0 ? x : acc + x;
        if (i < m) a[off[top] + i] = acc;
      }
      a[off[top] + m + b] = acc;
    }
    __syncthreads();
    off[top + 1] = off[top] + m;
    n[top + 1] = blocks;
    ++top;
    in = a + off[top];
  }
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int i = 0; i < n[top]; ++i) {
      acc = i == 0 ? in[i] : acc + in[i];
      a[off[top] + i] = acc;
    }
  }
  __syncthreads();
  for (int l = top - 1; l >= 0; --l) {
    for (int i = threadIdx.x; i < n[l]; i += kThreads) {
      const int b = i / kBlock;
      a[off[l] + i] = a[off[l] + i] + (b == 0 ? 0.0f : a[off[l + 1] + b - 1]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
compact_runs_write_kernel(const long long* __restrict__ rows, int64_t width,
                          int rank_bits, const float* __restrict__ seg_total,
                          const float* __restrict__ seg_prefix,
                          int prefix_stride,
                          const int32_t* __restrict__ tile_first,
                          int32_t* __restrict__ key2, float* __restrict__ c2,
                          int cap) {
  __shared__ float q_s[kThreads * kPitch];
  __shared__ int32_t k_s[kThreads * kPitch];
  __shared__ float t1_s[kThreads];
  __shared__ int warp_sum[kWarps];
  const int64_t row = blockIdx.y;
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  load_tile(rows + row * width, width, (int64_t)tile * kTile, rank_bits, q_s,
            k_s);
  __syncthreads();

  // this thread's level-1 block b1: its lanes' left-to-right prefix
  const float* q = q_s + threadIdx.x * kPitch;
  const int32_t* kk = k_s + threadIdx.x * kPitch;
  float c[kBlock];
  int ends = 0;
  c[0] = q[0];
#pragma unroll
  for (int k = 1; k < kBlock; ++k) c[k] = c[k - 1] + q[k];
#pragma unroll
  for (int k = 0; k < kBlock; ++k) ends += kk[k] != kSentinel;
  t1_s[threadIdx.x] = c[kBlock - 1];
  int total;
  int slot = tile_first[row * n_tiles + tile] +
             block_exclusive_scan(ends, &total, warp_sum);  // publishes t1_s

  const int64_t b1 = (int64_t)tile * kThreads + threadIdx.x;
  if (width > kBlock && b1 * kBlock < width) {
    // the carry of block b1: level 1's prefix at b1 - 1 (0.0 for b1 = 0),
    // which is that block's left-to-right prefix inside its segment plus,
    // where level 1 has more than 16 values, the segment prefix at the
    // segment before
    const int p = threadIdx.x % kBlock;
    const int64_t seg = b1 / kBlock;
    const float* pre = seg_prefix + row * (int64_t)prefix_stride;
    float carry = 0.0f;
    if (b1 > 0) {
      const int64_t s = p > 0 ? seg : seg - 1;  // the segment of b1 - 1
      const float inner =
          p > 0 ? sum_left(t1_s + (threadIdx.x - p), p)
                : seg_total[row * (int64_t)n_tiles * kSegsPerTile + s];
      carry = width > kSegment ? inner + (s == 0 ? 0.0f : pre[s - 1]) : inner;
    }
#pragma unroll
    for (int k = 0; k < kBlock; ++k) c[k] = c[k] + carry;
  }

#pragma unroll
  for (int k = 0; k < kBlock; ++k) {
    const int32_t h = kk[k];
    if (h != kSentinel) {
      if (slot < cap) {
        key2[row * cap + slot] = h;
        c2[row * cap + slot] = c[k];
      }
      ++slot;
    }
  }
}

}  // namespace

// Scratch floats of the segment prefix of one row of n_seg segments: every
// level of the carry kernel's recursion (the wrapper allocates rows times
// this).
extern "C" int attpc_compact_runs_prefix_stride(int n_seg) {
  int total = n_seg;
  for (int m = n_seg; m > kBlock; total += m) m = (m + kBlock - 1) / kBlock;
  return total;
}

// sorted [rows, width] int64 (pack64 rows, ascending) -> key2 [rows, cap]
// int32, c2 [rows, cap] f32, n_uniq [rows] int32, through the scratch
// seg_total [rows, tiles * 16] f32, seg_prefix [rows, prefix_stride] f32
// and tile_ends [rows, tiles] int32, tiles = ceil(width / 4096). Returns
// the cudaError_t of the launches, or cudaErrorInvalidValue for a shape
// the grid cannot take or a cap above the width.
extern "C" int attpc_compact_runs(const void* sorted, void* key2, void* c2,
                                  void* n_uniq, void* seg_total,
                                  void* seg_prefix, void* tile_ends, int rows,
                                  int64_t width, int cap, int rank_bits,
                                  void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  const int64_t tiles = (width + kTile - 1) / kTile;
  if (width <= 0 || rows > 65535 || tiles * kSegsPerTile > INT32_MAX ||
      cap < 0 || cap > width || rank_bits < 0 || rank_bits > 30) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_tiles = (int)tiles;
  const int n_seg = (int)((width + kSegment - 1) / kSegment);
  const int stride = attpc_compact_runs_prefix_stride(n_seg);
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(n_tiles, rows);
  compact_runs_totals_kernel<<<grid, kThreads, 0, s>>>(
      (const long long*)sorted, width, rank_bits, (float*)seg_total,
      (int32_t*)tile_ends);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  compact_runs_carry_kernel<<<rows, kThreads, 0, s>>>(
      (const float*)seg_total, n_tiles, n_seg, (float*)seg_prefix, stride,
      (int32_t*)tile_ends, (int32_t*)key2, (float*)c2, (int32_t*)n_uniq, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  compact_runs_write_kernel<<<grid, kThreads, 0, s>>>(
      (const long long*)sorted, width, rank_bits, (const float*)seg_total,
      (const float*)seg_prefix, stride, (const int32_t*)tile_ends,
      (int32_t*)key2, (float*)c2, cap);
  return (int)cudaGetLastError();
}
