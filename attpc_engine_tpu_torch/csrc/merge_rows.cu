// K3, wide route, phase B: merge passes over rows of sorted runs.
//
// Replaces, with the cluster kernel of sort_cluster.cu as its phase A, the
// Pallas kernel attpc_engine_tpu/detector/sort_pallas.py `_sort_kernel`
// (sort_pairs_pallas, and sort_i64_pallas through it) for rows wider than
// 16 CTAs' shared memory holds (213,760 elements). Such rows come from the
// later budget doublings of run_simulation's overflow retry: the merge
// sorts at point budget 4,096 and more, the convert sort past five
// doublings of the uniq budget. The wrapper, detector/sort_cuda.py, cuts
// each row into c (a power of two) chunks, sorts every chunk with the
// cluster kernel, and then runs log2(c) passes of this file: each pass
// merges adjacent pairs of sorted runs of every row from one buffer into
// the other, so the runs double until one spans the row.
//
// What bounds it on the card: bytes through device memory. Each pass
// reads and writes every row once, so the route moves each row through
// device memory 1 + log2(c) times, where the bitonic network it replaces
// made 21 passes over rows padded to a power of two.
//
// A pass is merge path (Green, McColl and Bader, "GPU merge path", 2012):
//  1. partition: one thread per tile boundary binary-searches its diagonal
//     of the pair's merge matrix in device memory, giving how many of the
//     first d outputs come from the left run A (the rest from B);
//  2. merge: a CTA owns kTile consecutive outputs of one pair. It loads
//     the slices of A and B that the two diagonals bound into shared
//     memory with 16-byte loads, each thread searches its own diagonal in
//     shared memory and merges its kItems outputs serially in registers,
//     and the CTA stores the tile through shared memory, coalesced.
//
// Order is signed int64 (the convert keys are negative, the merge
// elements nonnegative pack64 pairs). Ties: A[i] <= B[j] takes A, in the
// partition search, the per-thread search and the serial merge alike.
// Equal elements are identical bit patterns, so any cut of the merge path
// inside a run of equal elements gives the same row: the rows are
// bit-exact against torch.sort however long the runs of duplicates.
//
// The live route's merge passes (attpc_merge_rows_live, the kernels'
// `<true>` variants): the merge sort's rows whose prefix is wider than 8
// CTAs hold are sorted over it, [0, lanes[r]) (sort_cluster.cu's head). The
// chunk sort left each listed row's prefix as sorted chunks of 13,360
// lanes in the buffer from which its own ceil(log2(chunks)) passes end in
// `rows`; pass j takes the listed rows that have more than j passes, with
// the row's prefix as its width, and reads and writes only that prefix.
// The partition threads cover every slot of the split table, those past
// the listed rows returning at once; the tile kernel runs as many CTAs as
// the card holds at once, each looping over the listed rows' tiles.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sort_live.cuh"

namespace {

constexpr int kThreads = 256;
// odd, so the kItems-element slices of a half-warp's threads start on
// distinct banks when the outputs go through shared memory
constexpr int kItems = 15;
constexpr int kTile = kThreads * kItems;  // outputs of one CTA
constexpr int kPartitionThreads = 256;

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// The pair `pair` of a row whose sorted runs are `run` long: A starts at
// `a` and holds na elements, B follows it with nb (0 for an odd last run).
__device__ __forceinline__ void pair_bounds(int64_t pair, int64_t run,
                                            int64_t width, int64_t* a,
                                            int64_t* na, int64_t* nb) {
  *a = 2 * pair * run;
  *na = lmin(run, width - *a);
  *nb = lmax(0, lmin(run, width - *a - *na));
}

// Merge path split of diagonal d: how many of the first d outputs of
// merging A[0, na) and B[0, nb) come from A, where A[i] <= B[j] takes A.
__device__ __forceinline__ int64_t split(const long long* a, int64_t na,
                                         const long long* b, int64_t nb,
                                         int64_t d) {
  int64_t lo = lmax(0, d - nb), hi = lmin(d, na);
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// n elements from device memory to shared memory; 16-byte loads from the
// first 16-byte aligned element on.
__device__ void load_slice(long long* s, const long long* __restrict__ g,
                           int n) {
  const int head = min(n, (int)(((uintptr_t)g >> 3) & 1));
  const int pairs = (n - head) >> 1;
  const longlong2* g2 = reinterpret_cast<const longlong2*>(g + head);
  for (int k = threadIdx.x; k < pairs; k += blockDim.x) {
    const longlong2 v = g2[k];
    s[head + 2 * k] = v.x;
    s[head + 2 * k + 1] = v.y;
  }
  if (threadIdx.x == 0) {
    if (head) s[0] = g[0];
    if ((n - head) & 1) s[n - 1] = g[n - 1];
  }
}

// n elements from shared memory to device memory; 16-byte stores from the
// first 16-byte aligned element on.
__device__ void store_slice(long long* __restrict__ g, const long long* s,
                            int n) {
  const int head = min(n, (int)(((uintptr_t)g >> 3) & 1));
  const int pairs = (n - head) >> 1;
  longlong2* g2 = reinterpret_cast<longlong2*>(g + head);
  for (int k = threadIdx.x; k < pairs; k += blockDim.x) {
    g2[k] = make_longlong2(s[head + 2 * k], s[head + 2 * k + 1]);
  }
  if (threadIdx.x == 0) {
    if (head) g[0] = s[0];
    if ((n - head) & 1) g[n - 1] = s[n - 1];
  }
}

// The wide rows of a live pass and their two buffers.
struct LivePass {
  long long* rows;     // [.., width]: where each row's last pass ends
  long long* scratch;  // [.., width]: the other buffer
  const int32_t* lanes;  // each row's prefix
  const int32_t* wide;   // how many rows are listed, then they
  int pass;
};

// The live pass's view of list slot `slot`: false if the row has no pass
// `pass` or pair `pair` lies past its prefix; else its prefix, and its
// source and destination rows.
__device__ __forceinline__ bool live_row(const LivePass& live, int64_t slot,
                                         int64_t width, int64_t run,
                                         int64_t pair, int64_t* w,
                                         const long long** src,
                                         long long** dst) {
  const int64_t row = live.wide[1 + slot];
  *w = live_prefix(live.lanes, row, width);
  const int passes = live_merge_passes(*w);
  if (live.pass >= passes || 2 * pair * run >= *w) return false;
  const bool from_scratch = (passes - live.pass) & 1;
  *src = (from_scratch ? live.scratch : live.rows) + row * width;
  *dst = (from_scratch ? live.rows : live.scratch) + row * width;
  return true;
}

// splits[(row * n_pairs + pair) * (tiles + 1) + q]: the split of diagonal
// min(q * kTile, na + nb) of the pair, q = 0 .. tiles. Live: `row` is a
// slot of the list and src is not read.
template <bool kLive>
__global__ void merge_partition_kernel(const long long* __restrict__ src,
                                       int* __restrict__ splits, int rows,
                                       int64_t width, int64_t run,
                                       int64_t n_pairs, int64_t tiles,
                                       LivePass live) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t per_row = n_pairs * (tiles + 1);
  if (kLive) rows = live.wide[0];
  if (g >= rows * per_row) return;
  const int64_t row = g / per_row;
  const int64_t pair = (g - row * per_row) / (tiles + 1);
  const int64_t q = g - row * per_row - pair * (tiles + 1);
  const long long* rs = src + row * width;
  int64_t w = width;
  if constexpr (kLive) {
    long long* unused;
    if (!live_row(live, row, width, run, pair, &w, &rs, &unused)) return;
  }
  int64_t a, na, nb;
  pair_bounds(pair, run, w, &a, &na, &nb);
  const long long* ra = rs + a;
  splits[g] = (int)split(ra, na, ra + na, nb, lmin(q * kTile, na + nb));
}

// Tile q of pair `pair` of a row of `width` elements: outputs [d0, d1) of
// the pair, d0 = q * kTile, from rs to rd; sp: the pair's split table.
// Every thread of the block calls it.
__device__ __forceinline__ void merge_tile(const long long* rs, long long* rd,
                                           const int* sp, int64_t width,
                                           int64_t run, int64_t pair,
                                           int64_t q, long long* s) {
  int64_t a, na, nb;
  pair_bounds(pair, run, width, &a, &na, &nb);
  const int64_t d0 = lmin(q * kTile, na + nb);
  const int64_t d1 = lmin(d0 + kTile, na + nb);
  if (d0 >= d1) return;  // past the end of a short last pair
  const int64_t i0 = sp[q], i1 = sp[q + 1];
  const int la = (int)(i1 - i0), n = (int)(d1 - d0), lb = n - la;
  const long long* ra = rs + a;
  load_slice(s, ra + i0, la);
  load_slice(s + la, ra + na + (d0 - i0), lb);
  __syncthreads();

  // this thread's outputs [k0, k0 + kItems) of the tile, in registers
  const int k0 = threadIdx.x * kItems;
  const long long* sb = s + la;
  long long v[kItems];
  if (k0 < n) {
    int ia = (int)split(s, la, sb, lb, k0);
    int jb = k0 - ia;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool has_a = ia < la, has_b = jb < lb;
      const long long x = has_a ? s[ia] : 0, y = has_b ? sb[jb] : 0;
      const bool take_a = has_a && (!has_b || x <= y);
      v[k] = take_a ? x : y;
      ia += take_a;
      jb += !take_a;
    }
  }
  __syncthreads();  // every thread has read the slices
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (k0 + k < n) s[k0 + k] = v[k];
  }
  __syncthreads();
  store_slice(rd + a + d0, s, n);
}

// Generic: one CTA per tile q of pair `pair` of row `row`. Live: the CTAs
// loop over the tiles of the listed rows' pairs (src and dst not read).
template <bool kLive>
__global__ void __launch_bounds__(kThreads)
merge_tile_kernel(const long long* __restrict__ src,
                  long long* __restrict__ dst, const int* __restrict__ splits,
                  int64_t width, int64_t run, int64_t n_pairs,
                  int64_t tiles, LivePass live) {
  __shared__ __align__(16) long long s[kTile];
  const int64_t per_row = n_pairs * tiles;
  if constexpr (!kLive) {
    const int64_t row = blockIdx.x / per_row;
    const int64_t pair = (blockIdx.x - row * per_row) / tiles;
    const int64_t q = blockIdx.x - row * per_row - pair * tiles;
    merge_tile(src + row * width, dst + row * width,
               splits + (row * n_pairs + pair) * (tiles + 1), width, run,
               pair, q, s);
  } else {
    const int64_t items = (int64_t)live.wide[0] * per_row;
    for (int64_t b = blockIdx.x; b < items; b += gridDim.x) {
      const int64_t slot = b / per_row;
      const int64_t pair = (b - slot * per_row) / tiles;
      const int64_t q = b - slot * per_row - pair * tiles;
      int64_t w;
      const long long* rs;
      long long* rd;
      if (!live_row(live, slot, width, run, pair, &w, &rs, &rd)) continue;
      __syncthreads();  // the previous tile's store has read s
      merge_tile(rs, rd, splits + (slot * n_pairs + pair) * (tiles + 1), w,
                 run, pair, q, s);
    }
  }
}

struct Plan {
  int64_t n_pairs, tiles, n_splits, blocks;
};

Plan plan(int rows, int64_t width, int64_t run) {
  Plan p;
  p.n_pairs = (width + 2 * run - 1) / (2 * run);
  p.tiles = (2 * run + kTile - 1) / kTile;
  p.n_splits = (int64_t)rows * p.n_pairs * (p.tiles + 1);
  p.blocks = (int64_t)rows * p.n_pairs * p.tiles;
  return p;
}

}  // namespace

// int32 entries of the split table that a pass over [rows, width] with
// runs of `run` needs (the first pass of a sort needs the most).
extern "C" int64_t attpc_merge_rows_splits(int rows, int64_t width,
                                           int64_t run) {
  if (rows <= 0 || width <= 0 || run <= 0) return 0;
  return plan(rows, width, run).n_splits;
}

// One merge pass: src [rows, width], whose rows are sorted runs of `run`
// elements (the last run of a row may be shorter), -> dst [rows, width],
// whose rows are sorted runs of 2 * run. `splits` holds splits_len int32
// entries (attpc_merge_rows_splits). Returns the first cudaError_t met.
extern "C" int attpc_merge_rows_pass(const void* src, void* dst,
                                     void* splits, int64_t splits_len,
                                     int rows, int64_t width, int64_t run,
                                     void* stream) {
  if (rows <= 0 || width <= 0) return (int)cudaSuccess;
  if (run <= 0 || run >= width || src == dst) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan p = plan(rows, width, run);
  if (p.n_splits > splits_len || 2 * run > 0x7fffffffLL ||
      p.blocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned part_blocks =
      (unsigned)((p.n_splits + kPartitionThreads - 1) / kPartitionThreads);
  merge_partition_kernel<false><<<part_blocks, kPartitionThreads, 0, st>>>(
      (const long long*)src, (int*)splits, rows, width, run, p.n_pairs,
      p.tiles, LivePass{});
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_tile_kernel<false><<<(unsigned)p.blocks, kThreads, 0, st>>>(
      (const long long*)src, (long long*)dst, (const int*)splits, width, run,
      p.n_pairs, p.tiles, LivePass{});
  return (int)cudaGetLastError();
}

// int32 entries of the split table that the live route's merge passes over
// [rows, width] need: the most any pass needs, since runs of 13360 << j
// leave a short last pair and a later pass can need more than the first.
// 0 where no prefix can pass kLiveClusterLanes (no wide route).
extern "C" int64_t attpc_merge_rows_live_splits(int rows, int64_t width) {
  if (rows <= 0 || width <= kLiveClusterLanes) return 0;
  int64_t most = 0;
  for (int j = 0; j < live_merge_passes(width); ++j) {
    const int64_t n = plan(rows, width, (int64_t)kLiveChunk << j).n_splits;
    most = n > most ? n : most;
  }
  return most;
}

// The live route's merge passes over rows [rows, width] (sort_cluster.cu's
// attpc_sort_rows_live, whose chunk sort must precede them on the same
// stream, with the same rows, scratch, lanes and list): pass j = 0 .. for
// each listed row with more than j passes, until every row's prefix is
// one sorted run in `rows`. `splits` holds splits_len int32 entries
// (attpc_merge_rows_live_splits). Returns the first cudaError_t met.
extern "C" int attpc_merge_rows_live(void* rows_buf, void* scratch,
                                     const void* lanes, const void* wide,
                                     void* splits, int64_t splits_len,
                                     int rows, int64_t width, void* stream) {
  if (rows <= 0 || width <= kLiveClusterLanes) return (int)cudaSuccess;
  if (scratch == nullptr || wide == nullptr || rows_buf == scratch) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, merge_tile_kernel<true>, kThreads, 0);
  }
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  LivePass live{(long long*)rows_buf, (long long*)scratch,
                (const int32_t*)lanes, (const int32_t*)wide, 0};
  const int passes = live_merge_passes(width);
  for (live.pass = 0; live.pass < passes; ++live.pass) {
    const int64_t run = (int64_t)kLiveChunk << live.pass;
    const Plan p = plan(rows, width, run);
    if (p.n_splits > splits_len || 2 * run > 0x7fffffffLL ||
        p.blocks > 0x7fffffffLL) {
      return (int)cudaErrorInvalidValue;
    }
    const unsigned part_blocks =
        (unsigned)((p.n_splits + kPartitionThreads - 1) / kPartitionThreads);
    merge_partition_kernel<true><<<part_blocks, kPartitionThreads, 0, st>>>(
        nullptr, (int*)splits, rows, width, run, p.n_pairs, p.tiles, live);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    merge_tile_kernel<true>
        <<<(unsigned)(p.blocks < resident ? p.blocks : resident), kThreads, 0,
           st>>>(nullptr, nullptr, (const int*)splits, width, run, p.n_pairs,
                 p.tiles, live);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
