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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_warp.cuh"

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
// offsets into the row, the warp sums of two digit scans and the skip flag
constexpr int kFixedBytes = kWarps * kDigits * 2 + 2 * kDigits * 4 + 128;
constexpr int kMaxShared = 232448;  // a block's dynamic shared memory
constexpr int kMaxCluster = 16;
constexpr int kMaxChunk = (kMaxShared - kFixedBytes) / 16;
// elements a lane holds in registers during a pass
constexpr int kItems = ((kMaxChunk + kWarps - 1) / kWarps + 31) / 32;

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

// One cluster per segment: grid = rows * per_row * n_cta, cluster dims
// (n_cta, 1, 1). Segment p of row r starts at r * stride + p * width and
// holds `width` elements, the last of a row `last_width` (<= width).
// `chunk` is even and chunk * n_cta >= width. A whole row is the segment
// with per_row = 1 and stride = last_width = width.
__global__ void __launch_bounds__(kThreads, 1)
radix_cluster_kernel(const unsigned long long* __restrict__ in,
                     unsigned long long* __restrict__ out, int64_t width,
                     int chunk, int64_t stride, int per_row,
                     int64_t last_width) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned n_cta = cluster.num_blocks();
  const unsigned rank_in_cluster = cluster.block_rank();
  const int64_t segment = blockIdx.x / n_cta;
  const int64_t row = segment / per_row;
  const int part = (int)(segment - row * per_row);
  const int64_t base = row * stride + (int64_t)part * width;
  if (part == per_row - 1) width = last_width;

  // the two element buffers: buf[0, chunk) and buf[chunk, 2 * chunk)
  unsigned long long* const buf = reinterpret_cast<unsigned long long*>(smem);
  unsigned short* whist =
      reinterpret_cast<unsigned short*>(smem + 16 * (size_t)chunk);
  unsigned* ctot = reinterpret_cast<unsigned*>(whist + kWarps * kDigits);
  unsigned* delta = ctot + kDigits;
  unsigned* wsum = delta + kDigits;  // warp sums of the two digit scans
  int* skip = reinterpret_cast<int*>(wsum + 16);

  PHASE(0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t start = (int64_t)rank_in_cluster * chunk;
  const int64_t rest = width - start;
  const int n = rest <= 0 ? 0 : (rest < chunk ? (int)rest : chunk);
  load_chunk(buf, in + base + start, n);

  // warp `warp` ranks elements [lo, hi) of the chunk, kItems per lane
  const int run = (chunk + kWarps - 1) / kWarps;
  const int lo = min(warp * run, n), hi = min(lo + run, n);
  const unsigned below_lane = (1u << lane) - 1;
  unsigned short* wh = whist + warp * kDigits;
  unsigned* wh2 = reinterpret_cast<unsigned*>(wh);  // two counts a word
  // pos / chunk == __umulhi(pos, magic) for pos < 2^18, chunk < 2^14
  const unsigned magic = (unsigned)((0x100000000ull + chunk - 1) / chunk);
  unsigned long long key[kItems];
  unsigned rank[(kItems + 1) / 2];  // 16-bit ranks, two a register
  int cur = 0;

  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 8 * pass;
    const unsigned long long* src = buf + cur * chunk;
    for (int k = lane; k < kDigits / 2; k += 32) wh2[k] = 0;
    if (tid == 0) *skip = 0;
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
      for (int w = 0; w < kWarps; ++w) cta_total += whist[w * kDigits + tid];
      ctot[tid] = cta_total;
      local_incl = warp_inclusive_sum(cta_total, lane);
      if (lane == 31) wsum[warp] = local_incl;
    }
    cluster.sync();  // every CTA's totals are visible
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
        const unsigned v = whist[w * kDigits + tid];
        whist[w * kDigits + tid] = (unsigned short)s;
        s += v;
      }
      for (unsigned r = 0; r < n_cta; ++r) {
        const unsigned v = *cluster.map_shared_rank(ctot + tid, r);
        total += v;
        if (r < rank_in_cluster) below += v;
      }
      if ((int64_t)total == width) *skip = 1;
      global_incl = warp_inclusive_sum(total, lane);
      if (lane == 31) wsum[8 + warp] = global_incl;
    }
    __syncthreads();
    if (tid < kDigits) {
      unsigned first = global_incl - total + below;
      for (int w = 0; w < warp; ++w) first += wsum[8 + w];
      delta[tid] = first - local_first;
    }
    __syncthreads();
    // read before the next pass's reset, which follows the cluster.sync
    const bool skipped = *skip;
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
          const unsigned pos = delta[(unsigned)(x >> shift) & 255u] + j;
          const unsigned r = __umulhi(pos, magic);
          *cluster.map_shared_rank(dst + (pos - r * (unsigned)chunk), r) = x;
        }
      }
    }
    PHASE(5 + 5 * pass);
    // the scatter is complete and no CTA reads the totals any more
    cluster.sync();
    if (!skipped) cur ^= 1;
  }
  PHASE(41);
  store_chunk(out + base + start, buf + cur * chunk, n);
  PHASE(42);
}

cudaError_t prepare(int n_cta, int chunk, size_t* smem) {
  *smem = 16 * (size_t)chunk + kFixedBytes;
  if (n_cta < 1 || n_cta > kMaxCluster || chunk < 2 || (chunk & 1) ||
      *smem > (size_t)kMaxShared) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      radix_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)*smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(radix_cluster_kernel,
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
  size_t smem;
  cudaError_t err = prepare(n_cta, chunk, &smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr,
                 (unsigned)rows * (unsigned)per_row * (unsigned)n_cta, n_cta,
                 smem, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&cfg, radix_cluster_kernel,
                           (const unsigned long long*)in,
                           (unsigned long long*)out, width, chunk, stride,
                           per_row, last_width);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of n_cta CTAs with `chunk` elements each the card can
// hold at once (0: such a cluster cannot be scheduled).
extern "C" int attpc_sort_rows_cluster_occupancy(int n_cta, int chunk,
                                                 int* clusters) {
  size_t smem;
  cudaError_t err = prepare(n_cta, chunk, &smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, (unsigned)n_cta, n_cta, smem, 0);
  return (int)cudaOccupancyMaxActiveClusters(clusters, radix_cluster_kernel,
                                             &cfg);
}
