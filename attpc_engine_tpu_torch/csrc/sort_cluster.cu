// K3, cluster route: row-wise ascending sort of int64 [E, W] as an LSD
// radix sort of each row inside one thread-block cluster.
//
// Replaces the Pallas kernel attpc_engine_tpu/detector/sort_pallas.py
// `_sort_kernel` (sort_pairs_pallas, and sort_i64_pallas through it) for
// rows that fit the shared memory of 16 CTAs. Wider rows take the wide
// route: this kernel sorts each of their chunks as a segment of its own
// (`per_row` segments a row, the last one `last_width` wide), and the
// merge passes of merge_rows.cu join the sorted chunks (the wrapper,
// detector/sort_cuda.py, chooses by width before any launch). Equal
// elements are identical bit patterns, so the output is bit-exact whatever
// the algorithm.
//
// What bounds it on the card: bytes through device memory. At the merge
// shape [384, 102400] the row is read once and written once: 629 MB, 0.188
// ms at 3.35 TB/s. The bitonic route moved each row through device memory
// ten times and did O(n log^2 n) compare-exchanges with a barrier after
// each of 153 stages. Here a cluster of n_cta CTAs (1, 2, 4, 8 or 16) owns
// one row: CTA r loads the contiguous chunk [r*c, (r+1)*c) of the row into
// its shared memory, all eight passes of 8-bit digits run in shared and
// distributed shared memory, and the last buffer is stored straight to the
// output. No scratch in device memory, no padding to a power of two.
//
// Order: bit 63 is flipped on load and on store, so signed order is
// unsigned order (the convert keys are negative, the merge elements
// nonnegative pack64 pairs).
//
// Each pass:
//  1. rank: each warp takes its consecutive run of the CTA's chunk into
//     registers (kItems elements a lane, 32 at a time); lanes with the
//     same 8-bit digit find each other with __match_any_sync, and the
//     lowest of them adds the group's size to the warp's 16-bit count of
//     that digit, whose old value plus the lane's place in the group is
//     the element's rank among the warp's elements of its digit;
//  2. offsets: after cluster.sync, each CTA reads every CTA's digit totals
//     through distributed shared memory and sets, for each digit, the
//     first destination of its elements: digit-major, then CTA rank, then
//     warp, then rank. That order is the elements' order within the row,
//     so every pass is stable, as an LSD sort needs;
//  3. scatter: each CTA first writes its elements in digit order into its
//     own first buffer (every element is in registers by then), then copies
//     them in that order to their destinations i: slot i % c of CTA i / c's
//     second buffer. Runs of one digit go to consecutive slots, so
//     neighbouring lanes write neighbouring remote addresses. With one CTA
//     the first step writes the second buffer and there is no copy.
//     cluster.sync; the buffers swap;
//  4. skip: a pass whose digit takes one value over the whole row is the
//     identity, decided from the cluster-wide totals so every CTA agrees.
// A CTA touches another's shared memory only between the first and the
// last cluster.sync of the kernel, so none exits while others read it.
//
// The live route (`radix_cluster_kernel<true>`, attpc_sort_rows_live): the
// default step's merge sort. Its rows are `pack64(key, charge)` of the
// deposit's pixels, and lane i of row r lies at or past lanes[r] = min(
// n_points, point_budget) * 100 only if it is the sentinel element
// pack64(KEY_SENTINEL, 0.0) = 0x7FFFFFFF00000000 (empty point slots;
// off-grid pixels inside the prefix are sentinels too). Every sentinel is
// the same bits and larger than every other element (live keys are below
// 2^31 - 1), so the sorted row is the prefix's other elements sorted, then
// sentinels: the same bits as sorting the whole row, for work in
// proportion to the live lanes. Each row is sorted in place:
//  - load: CTA m of the row's cluster reads its even share of the prefix,
//    [m * L, (m + 1) * L), L = ceil(lanes / n_cta), and keeps only the
//    lanes that are not the sentinel (as K5's merge_cluster.cu does);
//  - passes: the same eight passes, on the N live elements alone; pass 0
//    spreads them evenly over the CTAs (CTA m then holds sorted positions
//    [m * cl, (m + 1) * cl), cl = max(2, ceil(N / n_cta))), since the
//    live lanes crowd the front of the prefix and a CTA's load is not its
//    share;
//  - store: the sorted live lanes to [0, N) of the row and the sentinel to
//    [N, lanes); [lanes, W) is left as the deposit wrote it.
// Routes, each row by its own prefix, on the card: the smallest cluster of
// 1, 2, 4 or 8 CTAs whose CTAs hold the prefix (cluster k takes the rows
// with k/2 * 13,360 < lanes <= k * 13,360), else the wide route over the
// prefix: one CTA a chunk of 13,360 lanes, then the merge passes of
// merge_rows.cu (attpc_merge_rows_live) over [0, lanes). Why clusters stop
// at 8 CTAs: sort_live.cuh. The host launches every route that a row of
// width W could need, each over every row (one cluster a row); a cluster
// whose row is not on its route returns at once, so the host needs no
// count and makes no sync (the empty launches cost 0.11-0.16 ms a batch).
// The route-1 launch also lists the wide rows for the wide launches,
// which loop over that list (as many CTAs as the card holds at once)
// instead of launching one CTA per possible chunk. What bounds the live
// route is the same bytes, now of the prefix: its lanes read once and
// written once; in practice its passes, whose cost follows the live lanes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_warp.cuh"
#include "sort_live.cuh"

namespace cg = cooperative_groups;

// Built with -DATTPC_SORT_PHASES (tools/profile_torch_step.py --sort-phases),
// thread 0 of each of the first kPhaseCtas CTAs records clock64() at the
// phase boundaries: 0 at the start, 1 + 5p .. 5 + 5p in pass p (start,
// ranked, totals visible, offsets set, scattered), 41 after the last pass
// and 42 after the store. The default build records nothing.
#ifdef ATTPC_SORT_PHASES
constexpr int kPhaseCtas = 384 * 16;
constexpr int kPhaseSlots = 48;
__device__ long long attpc_phase_clock[kPhaseCtas * kPhaseSlots];
#define PHASE(slot)                                                  \
  do {                                                               \
    if (threadIdx.x == 0 && blockIdx.x < kPhaseCtas)                 \
      attpc_phase_clock[blockIdx.x * kPhaseSlots + (slot)] = clock64(); \
  } while (0)
extern "C" int attpc_sort_phases(void* host, size_t bytes) {
  return (int)cudaMemcpyFromSymbol(host, attpc_phase_clock, bytes);
}
#else
#define PHASE(slot) \
  do {              \
  } while (0)
#endif

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kDigits = 256;
constexpr int kPasses = 8;
constexpr unsigned long long kSign = 1ull << 63;
// shared memory after the two element buffers of `chunk` elements each:
// per-warp 16-bit digit counts, this CTA's digit totals, the digit
// offsets into the row, and 32 words of `misc`
constexpr int kFixedBytes = kWarps * kDigits * 2 + 2 * kDigits * 4 + 128;
constexpr int kMaxShared = 232448;  // a block's dynamic shared memory
constexpr int kMaxCluster = 16;
constexpr int kMaxChunk = (kMaxShared - kFixedBytes) / 16;
// elements a lane holds in registers during a pass
constexpr int kItems = ((kMaxChunk + kWarps - 1) / kWarps + 31) / 32;
// the merge rows' sentinel element, pack64(KEY_SENTINEL, 0.0)
constexpr unsigned long long kSentinel = 0x7fffffff00000000ull;
// words of `misc`: the warp sums of the two digit scans at [0, 16), then
constexpr int kSkip = 16;   // the pass is the identity
constexpr int kCount = 17;  // live lanes this CTA loaded
constexpr int kRowLive = 18;  // live lanes of the row, N
static_assert(kLiveChunk <= kMaxChunk && kLiveChunk % 2 == 0,
              "a CTA holds kLiveChunk elements");

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// The shared memory of a CTA after its two element buffers.
struct Tables {
  unsigned short* whist;  // per-warp 16-bit digit counts
  unsigned* ctot;         // this CTA's digit totals
  unsigned* delta;        // local slot -> place in the row, by digit
  unsigned* misc;
};

// What a launch of the live route sorts (the file's head).
struct Live {
  unsigned long long* rows;     // [n_rows, width], sorted in place
  unsigned long long* scratch;  // [n_rows, width]: the wide route's second
  const int32_t* lanes;         // [n_rows]: each row's prefix
  int32_t* wide;                // [1 + n_rows]: how many wide rows, then they
  int n_rows;
  int lo, hi;  // route mode: the rows with lo < lanes <= hi
  int chunks;  // wide mode (> 0): chunk slots a row, kLiveChunk lanes each
  int enlist;  // route mode: list the rows wider than kLiveClusterLanes
};

// n elements from device memory to shared memory, bit 63 flipped; 16-byte
// loads from the first 16-byte aligned element on.
__device__ void load_chunk(unsigned long long* s,
                           const unsigned long long* __restrict__ g, int n) {
  const int head = min(n, (int)(((uintptr_t)g >> 3) & 1));
  const int pairs = (n - head) >> 1;
  const ulonglong2* g2 = reinterpret_cast<const ulonglong2*>(g + head);
  for (int k = threadIdx.x; k < pairs; k += blockDim.x) {
    const ulonglong2 v = g2[k];
    s[head + 2 * k] = v.x ^ kSign;
    s[head + 2 * k + 1] = v.y ^ kSign;
  }
  if (threadIdx.x == 0) {
    if (head) s[0] = g[0] ^ kSign;
    if ((n - head) & 1) s[n - 1] = g[n - 1] ^ kSign;
  }
}

// The elements among the n at g that are not the sentinel, bit 63 flipped,
// to s[*counter ...] in no order: four 16-byte loads a thread in flight,
// then one shared atomic a warp. Every thread of the block calls it.
__device__ void load_live(unsigned long long* s,
                          const unsigned long long* g, int n,
                          unsigned* counter) {
  constexpr int kPairs = 4;
  const int lane = threadIdx.x & 31;
  const int head = min(n, (int)(((uintptr_t)g >> 3) & 1));
  const int pairs = (n - head) >> 1;
  const ulonglong2* g2 = reinterpret_cast<const ulonglong2*>(g + head);
  for (int base = 0; base < pairs; base += kPairs * kThreads) {
    unsigned long long v[2 * kPairs];
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int k = base + j * kThreads + threadIdx.x;
      ulonglong2 x = make_ulonglong2(kSentinel, kSentinel);
      if (k < pairs) x = g2[k];
      v[2 * j] = x.x;
      v[2 * j + 1] = x.y;
    }
    unsigned cnt = 0;
#pragma unroll
    for (int j = 0; j < 2 * kPairs; ++j) cnt += v[j] != kSentinel;
    const unsigned incl = warp_inclusive_sum(cnt, lane);
    unsigned first = 0;
    if (lane == 31 && incl) first = atomicAdd(counter, incl);
    unsigned p = __shfl_sync(0xffffffffu, first, 31) + incl - cnt;
#pragma unroll
    for (int j = 0; j < 2 * kPairs; ++j) {
      if (v[j] != kSentinel) s[p++] = v[j] ^ kSign;
    }
  }
  // the element before the first aligned one and the one after the last pair
  if (threadIdx.x < 32) {
    const bool mine = (lane == 0 && head) || (lane == 1 && ((n - head) & 1));
    const unsigned long long x =
        mine ? g[lane == 0 ? 0 : n - 1] : kSentinel;
    const bool live = x != kSentinel;
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    unsigned first = 0;
    if (lane == 0 && ballot) first = atomicAdd(counter, __popc(ballot));
    first = __shfl_sync(0xffffffffu, first, 0);
    if (live) s[first + __popc(ballot & ((1u << lane) - 1))] = x ^ kSign;
  }
}

// n elements from shared memory to device memory, bit 63 flipped back.
__device__ void store_chunk(unsigned long long* __restrict__ g,
                            const unsigned long long* s, int n) {
  const int head = min(n, (int)(((uintptr_t)g >> 3) & 1));
  const int pairs = (n - head) >> 1;
  ulonglong2* g2 = reinterpret_cast<ulonglong2*>(g + head);
  for (int k = threadIdx.x; k < pairs; k += blockDim.x) {
    g2[k] = make_ulonglong2(s[head + 2 * k] ^ kSign,
                            s[head + 2 * k + 1] ^ kSign);
  }
  if (threadIdx.x == 0) {
    if (head) g[0] = s[0] ^ kSign;
    if ((n - head) & 1) g[n - 1] = s[n - 1] ^ kSign;
  }
}

// The sentinel element to g[0, n).
__device__ void fill_sentinel(unsigned long long* g, int64_t n) {
  if (n <= 0) return;
  const int64_t head = min64(n, (int64_t)(((uintptr_t)g >> 3) & 1));
  const int64_t pairs = (n - head) >> 1;
  ulonglong2* g2 = reinterpret_cast<ulonglong2*>(g + head);
  for (int64_t k = threadIdx.x; k < pairs; k += blockDim.x) {
    g2[k] = make_ulonglong2(kSentinel, kSentinel);
  }
  if (threadIdx.x == 0) {
    if (head) g[0] = kSentinel;
    if ((n - head) & 1) g[n - 1] = kSentinel;
  }
}

// The eight LSD passes over the elements the cluster holds, this CTA's n
// of them at buf[0, n), `chunk` the stride of its two buffers. Generic
// (kLive false): the cluster holds a segment of `width` elements, CTA r
// positions [r * chunk, r * chunk + n) of it before and after, with
// cl == chunk. Live: the N = sum of n elements the CTAs loaded, in no
// order; pass 0 spreads them so that CTA r holds sorted positions
// [r * cl, (r + 1) * cl), cl = max(2, ceil(N / n_cta)), n becoming its
// count of them, and sets n_live = N. Returns the buffer (0 or 1) that
// holds the sorted elements.
template <bool kLive>
__device__ __forceinline__ int lsd_passes(unsigned long long* buf,
                                          const Tables& t, int chunk, int& n,
                                          int64_t width, int& n_live,
                                          int& cl) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned n_cta = cluster.num_blocks();
  const unsigned rank_in_cluster = cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below_lane = (1u << lane) - 1;
  unsigned short* wh = t.whist + warp * kDigits;
  unsigned* wh2 = reinterpret_cast<unsigned*>(wh);  // two counts a word
  unsigned* wsum = t.misc;  // warp sums of the two digit scans
  // pos / cl == __umulhi(pos, magic) for pos < 2^18, cl < 2^14
  unsigned magic = (unsigned)((0x100000000ull + cl - 1) / cl);
  unsigned long long key[kItems];
  unsigned rank[(kItems + 1) / 2];  // 16-bit ranks, two a register
  int cur = 0;
  // warp `warp` ranks elements [lo, hi) of the n this CTA holds
  int run = (chunk + kWarps - 1) / kWarps;

  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 8 * pass;
    const unsigned long long* src = buf + cur * chunk;
    if (kLive) run = (n + kWarps - 1) / kWarps;
    const int lo = min(warp * run, n), hi = min(lo + run, n);
    for (int k = lane; k < kDigits / 2; k += 32) wh2[k] = 0;
    if (tid == 0) t.misc[kSkip] = 0;
    __syncthreads();  // the chunk is loaded (pass 0), counts are zero
    PHASE(1 + 5 * pass);

    // 1. each lane's elements into registers, each ranked among the
    // warp's earlier elements of its digit; the warp's digit counts
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (k % 2 == 0) rank[k / 2] = 0;
      if (lo + 32 * k < hi) {  // the same for the whole warp
        const int i = lo + 32 * k + lane;
        const bool valid = i < hi;
        key[k] = valid ? src[i] : 0ull;
        const unsigned d = (unsigned)(key[k] >> shift) & 255u;
        const unsigned peers = match_digit(d, valid);
        const int leader = __ffs(peers) - 1;
        unsigned before = 0;
        if (valid && leader == lane) {
          const unsigned half = (d & 1u) * 16;
          before = (atomicAdd(wh2 + (d >> 1), (unsigned)__popc(peers) << half)
                    >> half) & 0xffffu;
        }
        before = __shfl_sync(0xffffffffu, before, leader & 31);
        rank[k / 2] |= (before + __popc(peers & below_lane)) << (16 * (k % 2));
      }
    }
    __syncthreads();
    PHASE(2 + 5 * pass);

    // this CTA's digit totals and their exclusive scan
    unsigned cta_total = 0, local_incl = 0;
    if (tid < kDigits) {
      for (int w = 0; w < kWarps; ++w) cta_total += t.whist[w * kDigits + tid];
      t.ctot[tid] = cta_total;
      local_incl = warp_inclusive_sum(cta_total, lane);
      if (lane == 31) wsum[warp] = local_incl;
    }
    cluster.sync();  // every CTA's totals (and, in pass 0, counts) visible
    PHASE(3 + 5 * pass);

    // 2. destinations: the counts become each warp's first local slot of
    // the digit (digit-major, then warp); `delta` maps a local slot of
    // digit d to its place in the row (digit, then CTA rank)
    unsigned total = 0, below = 0, local_first = 0, global_incl = 0;
    if (tid < kDigits) {
      local_first = local_incl - cta_total;
      for (int w = 0; w < warp; ++w) local_first += wsum[w];
      unsigned s = local_first;
      for (int w = 0; w < kWarps; ++w) {
        const unsigned v = t.whist[w * kDigits + tid];
        t.whist[w * kDigits + tid] = (unsigned short)s;
        s += v;
      }
      for (unsigned r = 0; r < n_cta; ++r) {
        const unsigned v = *cluster.map_shared_rank(t.ctot + tid, r);
        total += v;
        if (r < rank_in_cluster) below += v;
      }
      // live: pass 0 always scatters, as it spreads the elements
      if (kLive ? pass > 0 && (int)total == n_live
                : (int64_t)total == width) {
        t.misc[kSkip] = 1;
      }
      global_incl = warp_inclusive_sum(total, lane);
      if (lane == 31) wsum[8 + warp] = global_incl;
    } else if (kLive && pass == 0 && tid == kDigits) {
      unsigned sum = 0;
      for (unsigned r = 0; r < n_cta; ++r) {
        sum += *cluster.map_shared_rank(t.misc + kCount, r);
      }
      t.misc[kRowLive] = sum;
    }
    __syncthreads();
    if (tid < kDigits) {
      unsigned first = global_incl - total + below;
      for (int w = 0; w < warp; ++w) first += wsum[8 + w];
      t.delta[tid] = first - local_first;
    }
    __syncthreads();
    // read before the next pass's reset, which follows the cluster.sync
    const bool skipped = t.misc[kSkip];
    if (kLive && pass == 0) {
      n_live = (int)t.misc[kRowLive];
      // at least 2, so that magic fits 32 bits
      cl = max(2, (n_live + (int)n_cta - 1) / (int)n_cta);
      magic = (unsigned)((0x100000000ull + cl - 1) / cl);
    }
    PHASE(4 + 5 * pass);

    // 3. scatter (4. skipped where one digit holds the whole row): first
    // into digit order within the CTA, then in runs of equal digits to
    // their places in the row, so that neighbouring lanes write
    // neighbouring remote slots. With one CTA the local order is the
    // row's order and the first step writes the destination buffer.
    if (!skipped) {
      unsigned long long* dst = buf + (cur ^ 1) * chunk;
      unsigned long long* local = n_cta == 1 ? dst : buf + cur * chunk;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if (lo + 32 * k + lane < hi) {
          const unsigned d = (unsigned)(key[k] >> shift) & 255u;
          local[wh[d] + ((rank[k / 2] >> (16 * (k % 2))) & 0xffffu)] = key[k];
        }
      }
      if (n_cta > 1) {
        __syncthreads();  // the chunk is in digit order
        for (int j = tid; j < n; j += kThreads) {
          const unsigned long long x = local[j];
          const unsigned pos = t.delta[(unsigned)(x >> shift) & 255u] + j;
          const unsigned r = __umulhi(pos, magic);
          *cluster.map_shared_rank(dst + (pos - r * (unsigned)cl), r) = x;
        }
      }
    }
    PHASE(5 + 5 * pass);
    // the scatter is complete and no CTA reads the totals any more
    cluster.sync();
    if (!skipped) {
      cur ^= 1;
      if (kLive) n = max(0, min(cl, n_live - (int)rank_in_cluster * cl));
    }
  }
  return cur;
}

// One launch of the live route (the file's head). Route mode: a cluster a
// row, sorting the prefix of the rows with live.lo < lanes <= live.hi in
// place. Wide mode (live.chunks > 0, one-CTA clusters): the CTAs loop over
// the chunks of the rows listed in live.wide, each chunk [c * kLiveChunk,
// min((c + 1) * kLiveChunk, lanes)) sorted into the buffer from which the
// row's merge passes end in live.rows.
__device__ __forceinline__ void sort_live(unsigned long long* buf,
                                          const Tables& t, int chunk,
                                          int64_t width, const Live& live) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = (int)cluster.num_blocks();
  const int me = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int64_t n_items = live.chunks > 0
                              ? (int64_t)live.wide[0] * live.chunks
                              : (int64_t)live.n_rows;
  for (int64_t item = blockIdx.x / n_cta; item < n_items;
       item += gridDim.x / n_cta) {
    int64_t row, s0, s1;
    unsigned long long* dst = live.rows;
    if (live.chunks > 0) {
      row = live.wide[1 + item / live.chunks];
      const int64_t lanes = live_prefix(live.lanes, row, width);
      s0 = (item % live.chunks) * kLiveChunk;
      if (s0 >= lanes) continue;
      s1 = min64(s0 + kLiveChunk, lanes);
      if (live_merge_passes(lanes) & 1) dst = live.scratch;
    } else {
      row = item;
      const int64_t lanes = live_prefix(live.lanes, row, width);
      if (live.enlist && me == 0 && tid == 0 && lanes > kLiveClusterLanes) {
        live.wide[1 + atomicAdd(live.wide, 1)] = (int32_t)row;
      }
      if (lanes <= live.lo || lanes > live.hi) continue;
      s0 = 0;
      s1 = lanes;
    }
    const int64_t len = s1 - s0, at = row * width + s0;
    const int load = (int)((len + n_cta - 1) / n_cta);
    const int64_t start = (int64_t)me * load;
    __syncthreads();  // the previous item's store has read the buffers
    if (tid == 0) t.misc[kCount] = 0;
    __syncthreads();
    PHASE(0);
    load_live(buf, live.rows + at + start,
              (int)max64(0, min64(load, len - start)),
              t.misc + kCount);
    __syncthreads();
    int n = (int)t.misc[kCount], n_live = 0, cl = chunk;
    const int cur = lsd_passes<true>(buf, t, chunk, n, 0, n_live, cl);
    PHASE(41);
    store_chunk(dst + at + (int64_t)me * cl, buf + cur * chunk, n);
    // the sentinels of [N, len), an even share a CTA
    const int64_t rest = len - n_live, per = (rest + n_cta - 1) / n_cta;
    const int64_t f0 = min64(rest, me * per), f1 = min64(rest, f0 + per);
    fill_sentinel(dst + at + n_live + f0, f1 - f0);
    PHASE(42);
  }
}

// Generic (kLive false): one cluster per segment: grid = rows * per_row *
// n_cta, cluster dims (n_cta, 1, 1). Segment p of row r starts at r *
// stride + p * width and holds `width` elements, the last of a row
// `last_width` (<= width). `chunk` is even and chunk * n_cta >= width. A
// whole row is the segment with per_row = 1 and stride = last_width =
// width. Live (kLive true): `live` says what the launch sorts (sort_live);
// `width` is the rows' width, `chunk` >= every CTA's share of a prefix,
// and in, stride, per_row and last_width are not read.
template <bool kLive>
__global__ void __launch_bounds__(kThreads, 1)
radix_cluster_kernel(const unsigned long long* __restrict__ in,
                     unsigned long long* __restrict__ out, int64_t width,
                     int chunk, int64_t stride, int per_row,
                     int64_t last_width, Live live) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  // the two element buffers: buf[0, chunk) and buf[chunk, 2 * chunk)
  unsigned long long* const buf = reinterpret_cast<unsigned long long*>(smem);
  Tables t;
  t.whist = reinterpret_cast<unsigned short*>(smem + 16 * (size_t)chunk);
  t.ctot = reinterpret_cast<unsigned*>(t.whist + kWarps * kDigits);
  t.delta = t.ctot + kDigits;
  t.misc = t.delta + kDigits;
  if constexpr (kLive) {
    sort_live(buf, t, chunk, width, live);
  } else {
    const unsigned n_cta = cluster.num_blocks();
    const int64_t segment = blockIdx.x / n_cta;
    const int64_t row = segment / per_row;
    const int part = (int)(segment - row * per_row);
    const int64_t base = row * stride + (int64_t)part * width;
    if (part == per_row - 1) width = last_width;

    PHASE(0);
    const int64_t start = (int64_t)cluster.block_rank() * chunk;
    const int64_t rest = width - start;
    int n = rest <= 0 ? 0 : (rest < chunk ? (int)rest : chunk);
    load_chunk(buf, in + base + start, n);
    int n_live = 0, cl = chunk;
    const int cur = lsd_passes<false>(buf, t, chunk, n, width, n_live,
                                      cl);
    PHASE(41);
    store_chunk(out + base + start, buf + cur * chunk, n);
    PHASE(42);
  }
}

template <bool kLive>
cudaError_t prepare(int n_cta, int chunk, size_t* smem) {
  *smem = 16 * (size_t)chunk + kFixedBytes;
  if (n_cta < 1 || n_cta > kMaxCluster || chunk < 2 || (chunk & 1) ||
      *smem > (size_t)kMaxShared) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      radix_cluster_kernel<kLive>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(radix_cluster_kernel<kLive>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              n_cta > 8 ? 1 : 0);
}

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    unsigned blocks, int n_cta, size_t smem,
                    cudaStream_t st) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)n_cta;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// One launch of radix_cluster_kernel<kLive> over `blocks` CTAs in
// clusters of n_cta.
template <bool kLive>
cudaError_t launch(unsigned blocks, int n_cta, int chunk,
                   const unsigned long long* in, unsigned long long* out,
                   int64_t width, int64_t stride, int per_row,
                   int64_t last_width, const Live& live, cudaStream_t st) {
  size_t smem;
  cudaError_t err = prepare<kLive>(n_cta, chunk, &smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, blocks, n_cta, smem, st);
  err = cudaLaunchKernelEx(&cfg, radix_cluster_kernel<kLive>, in, out, width,
                           chunk, stride, per_row, last_width, live);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// in [rows, stride] -> out [rows, stride]: each of the per_row segments
// of a row (the first per_row - 1 of `width` elements, the last of
// `last_width`, back to back from the row's start) sorted ascending as
// signed int64, one cluster of n_cta CTAs per segment, each holding
// `chunk` (even, chunk * n_cta >= width) elements. Whole rows are
// per_row = 1, stride = last_width = width. Returns the first cudaError_t.
extern "C" int attpc_sort_rows_cluster(const void* in, void* out, int rows,
                                       int64_t width, int n_cta, int chunk,
                                       int64_t stride, int per_row,
                                       int64_t last_width, void* stream) {
  if (rows <= 0 || width <= 0) return (int)cudaSuccess;
  if ((int64_t)n_cta * chunk < width || per_row < 1 || last_width < 1 ||
      last_width > width ||
      stride < (int64_t)(per_row - 1) * width + last_width ||
      (int64_t)rows * per_row * n_cta > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch<false>(
      (unsigned)rows * (unsigned)per_row * (unsigned)n_cta, n_cta, chunk,
      (const unsigned long long*)in, (unsigned long long*)out, width, stride,
      per_row, last_width, Live{}, (cudaStream_t)stream);
}

// rows [n_rows, width] int64, each row sorted ascending in place on its
// prefix [0, lanes[r]), every lane at or past which must be the sentinel
// element pack64(KEY_SENTINEL, 0.0), and no element above it (the file's
// head). Where width > kLiveClusterLanes, scratch [n_rows, width] int64 and
// wide [1 + n_rows] int32 are the wide route's (else unused, may be null),
// wide_ctas the one-CTA clusters the card holds at once, and
// attpc_merge_rows_live (merge_rows.cu) must follow on the same stream.
// Launches the cluster routes that a row of `width` could need and, for
// wider rows, the wide route's chunk sort. Returns the first cudaError_t.
extern "C" int attpc_sort_rows_live(void* rows, void* scratch,
                                    const void* lanes, void* wide,
                                    int n_rows, int64_t width, int wide_ctas,
                                    void* stream) {
  if (n_rows <= 0 || width <= 0) return (int)cudaSuccess;
  const bool has_wide = width > kLiveClusterLanes;
  if ((int64_t)n_rows * kMaxCluster > 0x7fffffffLL || width > 0x7fffffffLL ||
      (has_wide && (scratch == nullptr || wide == nullptr || wide_ctas < 1))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (has_wide) {
    err = cudaMemsetAsync(wide, 0, sizeof(int32_t), st);
    if (err != cudaSuccess) return (int)err;
  }
  Live live{(unsigned long long*)rows, (unsigned long long*)scratch,
            (const int32_t*)lanes, (int32_t*)wide, n_rows, 0, 0, 0, 0};
  for (int n_cta = 1; (int64_t)n_cta * kLiveChunk <= kLiveClusterLanes;
       n_cta *= 2) {
    live.lo = n_cta == 1 ? 0 : n_cta / 2 * kLiveChunk;
    live.hi = n_cta * kLiveChunk;
    if (live.lo >= width) break;
    live.enlist = n_cta == 1 && has_wide;
    const int64_t span = width < live.hi ? width : live.hi;
    int chunk = (int)((span + n_cta - 1) / n_cta);
    chunk = chunk < 2 ? 2 : chunk + (chunk & 1);
    err = launch<true>((unsigned)n_rows * (unsigned)n_cta, n_cta, chunk,
                       nullptr, nullptr, width, width, 1, width, live, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (!has_wide) return (int)cudaSuccess;
  live.lo = live.hi = live.enlist = 0;
  live.chunks = (int)((width + kLiveChunk - 1) / kLiveChunk);
  const int64_t items = (int64_t)n_rows * live.chunks;
  return (int)launch<true>(
      (unsigned)(items < wide_ctas ? items : wide_ctas), 1, kLiveChunk,
      nullptr, nullptr, width, width, 1, width, live, st);
}

// How many clusters of n_cta CTAs with `chunk` elements each the card can
// hold at once (0: such a cluster cannot be scheduled).
extern "C" int attpc_sort_rows_cluster_occupancy(int n_cta, int chunk,
                                                 int* clusters) {
  size_t smem;
  cudaError_t err = prepare<false>(n_cta, chunk, &smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, (unsigned)n_cta, n_cta, smem, 0);
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, radix_cluster_kernel<false>, &cfg);
}
