// K5, cluster route: the whole per-event merge of one row in one launch.
//
// Replaces the Pallas kernel attpc_engine_tpu/detector/sort_pallas.py
// `_merge_kernel` (merge_runs_fused_pallas) for rows of at most 16 x 13,360
// lanes: packed [E, W] int32 keys and qv [E, W] f32 charges in; key2
// [E, cap] int32, c2 [E, cap] f32 and n_uniq [E] int32 out. Wider rows keep
// the two-launch route (pack64, K3 and merge_fused.cu); the wrapper,
// detector/merge_cuda.py, chooses by width before any launch.
//
// What bounds it on the card: bytes. At the flagship batch it reads the
// [384, 102400] keys and charges (315 MB) and writes the [384, 12288]
// compacted slots (38 MB): 0.105 ms at 3.35 TB/s. The two-launch route
// packs the rows into int64 in device memory, sorts them there (K3 reads
// and writes them) and reads the sorted rows twice more for the tail. Here
// one thread-block cluster of n_cta CTAs (1, 2, 4, 8 or 16) owns a row and
// keeps it in shared memory from the load to the last output slot:
//
// 1. Load: CTA r reads lanes [r*L, (r+1)*L) of the row, L = ceil(W/n_cta),
//    with 16-byte loads, and keeps only the live ones (key != KEY_SENTINEL)
//    as the 64-bit element (key << 32 | bits(charge)) ^ 2^63, the pack64
//    element with K3's sign flip. A dead lane sorts after every live one,
//    adds to the prefix only after the last live lane and is never a run
//    end, so the outputs depend on the live lanes alone. Their order inside
//    a CTA is free: equal elements are identical bits.
// 2. Sort: the eight LSD passes of 8-bit digits of sort_cluster.cu (rank
//    with __match_any_sync, digit totals through distributed shared memory,
//    a stable scatter into the peers' second buffers). After the first
//    pass's totals the row's live count N is known; from then on CTA r
//    holds sorted positions [r*cl, (r+1)*cl), cl = ceil(N/n_cta) rounded up
//    to a multiple of 128, so rank and scatter cost what the live lanes
//    cost and no 128-lane segment of the prefix straddles two CTAs. Pass 0
//    always scatters (it spreads the lanes); a later pass whose digit takes
//    one value over the N live elements is the identity and is skipped.
// 3. Tail, on chip: the inclusive f32 prefix of the sorted charges,
//    associated exactly as the Pallas kernel's `_cumsum_flat` (a
//    Hillis-Steele scan along the 128 lanes of each segment, one warp a
//    segment with four lanes' values a thread; then an exclusive
//    Hillis-Steele scan of the segment totals over as many steps as the
//    Pallas row's power-of-two width gives, run by every CTA on the totals
//    of all, read through distributed shared memory; every addition adds
//    the same two operands as the TPU kernel, so the bits agree); the run
//    ends on key >> rank_bits (the last lane of a CTA reads the next CTA's
//    first; after the last live lane comes the sentinel); each CTA's count
//    of run ends exchanged so every CTA knows its first slot; the run ends
//    written in row order to the slots below cap, and (KEY_SENTINEL, 0.0)
//    in slots [min(n_uniq, cap), cap). Run-end keys are distinct and
//    ascending, so this is the Pallas kernel's second sort.
//
// Shared memory per CTA: two buffers of `chunk` elements (chunk =
// ceil(W/n_cta) rounded up to 128, at most 13,440), per-warp 16-bit digit
// counts of 28 warps and the digit tables. After the last pass the buffer
// the sort does not end in holds the lane scans, the segment totals and
// the segment scan. A CTA touches another's shared memory only between
// the first and the last cluster.sync, so none exits while others read it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_warp.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 896;
constexpr int kWarps = kThreads / 32;
constexpr int kDigits = 256;
constexpr int kPasses = 8;
constexpr int kLanes = 128;
constexpr unsigned long long kSign = 1ull << 63;
constexpr int32_t kSentinel = INT32_MAX;
constexpr unsigned kFull = 0xffffffffu;
// after the two element buffers: per-warp 16-bit digit counts, this CTA's
// digit totals, the digit offsets into the row, and 64 words of `misc`
constexpr int kFixedBytes = kWarps * kDigits * 2 + 2 * kDigits * 4 + 256;
constexpr int kMaxShared = 232448;  // a block's dynamic shared memory
constexpr int kMaxCluster = 16;
constexpr int kMaxChunk = (kMaxShared - kFixedBytes) / 16 / kLanes * kLanes;
// elements a lane holds in registers during a pass
constexpr int kItems = ((kMaxChunk + kWarps - 1) / kWarps + 31) / 32;
// words of `misc`: warp sums of the two digit scans at [0, 16), then
constexpr int kSkip = 16;   // the pass is the identity
constexpr int kCount = 17;  // live lanes this CTA loaded
constexpr int kLive = 18;   // live lanes of the row, N
constexpr int kRuns = 19;   // run ends this CTA holds
constexpr int kBase = 20;   // run ends in the CTAs before this one
constexpr int kTotal = 21;  // run ends of the row, n_uniq
constexpr int kWarpRuns = 32;  // [32, 32 + kWarps): run ends before each warp

__device__ __forceinline__ unsigned long long element(int32_t key, float q) {
  return (((unsigned long long)(uint32_t)key << 32) | __float_as_uint(q)) ^
         kSign;
}

__device__ __forceinline__ int32_t key_of(unsigned long long x) {
  return (int32_t)((x ^ kSign) >> 32);
}

__device__ __forceinline__ float charge_of(unsigned long long x) {
  return __uint_as_float((unsigned)(x & 0xffffffffull));
}

// `cnt` live elements of this warp go to s[*counter ...]: one shared atomic
// a warp; returns the first slot of this lane's elements.
__device__ __forceinline__ unsigned claim(unsigned cnt, int lane,
                                          unsigned* counter) {
  const unsigned incl = warp_inclusive_sum(cnt, lane);
  unsigned first = 0;
  if (lane == 31 && incl) first = atomicAdd(counter, incl);
  return __shfl_sync(kFull, first, 31) + incl - cnt;
}

// The live lanes among the n lanes at (pk, q) into s[0, *counter): 16-byte
// loads from the first 16-byte aligned lane on where pk and q share their
// alignment, 4-byte loads for the rest. Every thread of the block calls it.
__device__ void load_live(unsigned long long* s, const int32_t* __restrict__ pk,
                          const float* __restrict__ q, int n,
                          unsigned* counter) {
  const int lane = threadIdx.x & 31;
  const bool vec = ((((uintptr_t)pk) ^ ((uintptr_t)q)) & 15) == 0;
  const int head =
      vec ? min(n, (int)(((16 - ((uintptr_t)pk & 15)) & 15) >> 2)) : n;
  const int quads = (n - head) >> 2;
  const int4* pk4 = reinterpret_cast<const int4*>(pk + head);
  const float4* q4 = reinterpret_cast<const float4*>(q + head);
  for (int base = 0; base < quads; base += kThreads) {
    const int k = base + threadIdx.x;
    int4 kv = make_int4(kSentinel, kSentinel, kSentinel, kSentinel);
    float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < quads) {
      kv = pk4[k];
      qv = q4[k];
    }
    const unsigned cnt = (kv.x != kSentinel) + (kv.y != kSentinel) +
                         (kv.z != kSentinel) + (kv.w != kSentinel);
    unsigned p = claim(cnt, lane, counter);
    if (kv.x != kSentinel) s[p++] = element(kv.x, qv.x);
    if (kv.y != kSentinel) s[p++] = element(kv.y, qv.y);
    if (kv.z != kSentinel) s[p++] = element(kv.z, qv.z);
    if (kv.w != kSentinel) s[p] = element(kv.w, qv.w);
  }
  // the lanes before the first aligned one and after the last whole quad
  const int tail = head + 4 * quads;
  const int rest = head + (n - tail);
  for (int base = 0; base < rest; base += kThreads) {
    const int j = base + threadIdx.x;
    const int i = j < head ? j : tail + (j - head);
    int32_t key = kSentinel;
    float c = 0.f;
    if (j < rest) {
      key = pk[i];
      c = q[i];
    }
    const bool live = key != kSentinel;
    const unsigned p = claim(live, lane, counter);
    if (live) s[p] = element(key, c);
  }
}

// One cluster of n_cta CTAs per row: grid = rows * n_cta, cluster dims
// (n_cta, 1, 1). `load` = ceil(width / n_cta); `chunk` >= load, a multiple
// of 128; `n_seg_full` = the Pallas row's lanes / 128.
__global__ void __launch_bounds__(kThreads, 1)
merge_cluster_kernel(const int32_t* __restrict__ packed,
                     const float* __restrict__ qv, int width, int load,
                     int chunk, int n_seg_full, int32_t* __restrict__ key2,
                     float* __restrict__ c2, int32_t* __restrict__ n_uniq,
                     int cap, int rank_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = (int)cluster.num_blocks();
  const int me = (int)cluster.block_rank();
  const int64_t row = blockIdx.x / n_cta;

  unsigned long long* const buf = reinterpret_cast<unsigned long long*>(smem);
  unsigned short* whist =
      reinterpret_cast<unsigned short*>(smem + 16 * (size_t)chunk);
  unsigned* ctot = reinterpret_cast<unsigned*>(whist + kWarps * kDigits);
  unsigned* delta = ctot + kDigits;
  unsigned* misc = delta + kDigits;
  unsigned* wsum = misc;  // warp sums of the two digit scans

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below_lane = (1u << lane) - 1;

  // 1. load the live lanes of [me * load, (me + 1) * load)
  if (tid == 0) misc[kCount] = 0;
  __syncthreads();
  {
    const int start = me * load;
    const int n_in = max(0, min(load, width - start));
    const int64_t at = row * (int64_t)width + start;
    load_live(buf, packed + at, qv + at, n_in, misc + kCount);
  }
  __syncthreads();
  int n = (int)misc[kCount];  // elements this CTA holds

  // 2. the LSD passes
  unsigned short* wh = whist + warp * kDigits;
  unsigned* wh2 = reinterpret_cast<unsigned*>(wh);  // two counts a word
  unsigned long long key[kItems];
  unsigned rank[(kItems + 1) / 2];  // 16-bit ranks, two a register
  int cur = 0, n_live = 0, cl = kLanes;
  unsigned magic = 0;

  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 8 * pass;
    const unsigned long long* src = buf + cur * chunk;
    // warp `warp` ranks elements [lo, hi) of the n this CTA holds
    const int run = (n + kWarps - 1) / kWarps;
    const int lo = min(warp * run, n), hi = min(lo + run, n);
    for (int k = lane; k < kDigits / 2; k += 32) wh2[k] = 0;
    if (tid == 0) misc[kSkip] = 0;
    __syncthreads();  // the chunk is loaded (pass 0), counts are zero

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
        before = __shfl_sync(kFull, before, leader & 31);
        rank[k / 2] |= (before + __popc(peers & below_lane)) << (16 * (k % 2));
      }
    }
    __syncthreads();

    // this CTA's digit totals and their exclusive scan
    unsigned cta_total = 0, local_incl = 0;
    if (tid < kDigits) {
      for (int w = 0; w < kWarps; ++w) cta_total += whist[w * kDigits + tid];
      ctot[tid] = cta_total;
      local_incl = warp_inclusive_sum(cta_total, lane);
      if (lane == 31) wsum[warp] = local_incl;
    }
    cluster.sync();  // every CTA's totals (and, in pass 0, counts) visible

    // destinations: the counts become each warp's first local slot of the
    // digit (digit-major, then warp); `delta` maps a local slot of digit d
    // to its place in the row (digit, then CTA rank)
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
      for (int r = 0; r < n_cta; ++r) {
        const unsigned v = *cluster.map_shared_rank(ctot + tid, r);
        total += v;
        if (r < me) below += v;
      }
      if (pass > 0 && (int)total == n_live) misc[kSkip] = 1;
      global_incl = warp_inclusive_sum(total, lane);
      if (lane == 31) wsum[8 + warp] = global_incl;
    } else if (pass == 0 && tid == kDigits) {
      unsigned sum = 0;
      for (int r = 0; r < n_cta; ++r) {
        sum += *cluster.map_shared_rank(misc + kCount, r);
      }
      misc[kLive] = sum;
    }
    __syncthreads();
    if (tid < kDigits) {
      unsigned first = global_incl - total + below;
      for (int w = 0; w < warp; ++w) first += wsum[8 + w];
      delta[tid] = first - local_first;
    }
    __syncthreads();
    // read before the next pass's reset, which follows the cluster.sync
    const bool skipped = misc[kSkip];
    if (pass == 0) {
      // spread the N live elements: CTA r holds [r * cl, (r + 1) * cl)
      n_live = (int)misc[kLive];
      const int per = (n_live + n_cta - 1) / n_cta;
      cl = max(kLanes, (per + kLanes - 1) / kLanes * kLanes);
      // pos / cl == __umulhi(pos, magic) for pos < 2^18, cl < 2^14
      magic = (unsigned)((0x100000000ull + cl - 1) / cl);
    }

    // scatter: first into digit order within the CTA, then in runs of
    // equal digits to their places in the row. With one CTA the local
    // order is the row's order and the first step writes the destination.
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
          *cluster.map_shared_rank(dst + (pos - r * (unsigned)cl), r) = x;
        }
      }
    }
    // the scatter is complete and no CTA reads the totals any more
    cluster.sync();
    if (!skipped) {
      cur ^= 1;
      n = max(0, min(cl, n_live - me * cl));
    }
  }

  // 3. the tail: this CTA holds sorted positions [me * cl, me * cl + n)
  const unsigned long long* sorted = buf + cur * chunk;
  float* cbuf = reinterpret_cast<float*>(buf + (cur ^ 1) * chunk);
  float* segtot = cbuf + chunk;        // chunk / 128 segment totals
  float* xa = segtot + chunk / kLanes;  // two buffers of the segment scan
  const int s_live = (n_live + kLanes - 1) / kLanes;
  float* xb = xa + s_live;
  const int spc = cl / kLanes;  // segments a CTA
  const bool has_next = me + 1 < n_cta && n_live > (me + 1) * cl;

  // lane scans, one warp a segment: v[j] is lane j * 32 + `lane`
  const int n_seg = (n + kLanes - 1) / kLanes;
  for (int s = warp; s < n_seg; s += kWarps) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = s * kLanes + j * 32 + lane;
      v[j] = i < n ? charge_of(sorted[i]) : 0.0f;
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      float u[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) u[j] = __shfl_sync(kFull, v[j], (lane - d) & 31);
#pragma unroll
      for (int j = 3; j >= 0; --j) {
        const float add = lane >= d ? u[j] : (j > 0 ? u[j - 1] : 0.0f);
        v[j] = v[j] + add;
      }
    }
    v[3] = v[3] + v[2];  // d = 32
    v[2] = v[2] + v[1];
    v[1] = v[1] + v[0];
    v[0] = v[0] + 0.0f;
    v[3] = v[3] + v[1];  // d = 64
    v[2] = v[2] + v[0];
    v[1] = v[1] + 0.0f;
    v[0] = v[0] + 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = s * kLanes + j * 32 + lane;
      if (i < n) cbuf[i] = v[j];
    }
    if (lane == 31) segtot[s] = v[3];
  }

  // run ends: warp `warp` takes positions [wlo, whi); the key after the
  // CTA's last is the next CTA's first, or the sentinel after the last
  // live lane
  const int32_t next_first =
      has_next ? key_of(*cluster.map_shared_rank(sorted, me + 1)) : kSentinel;
  auto run_end = [&](int i) {
    const int32_t h = key_of(sorted[i]);
    const int32_t nx = i + 1 < n ? key_of(sorted[i + 1]) : next_first;
    return (h >> rank_bits) != (nx >> rank_bits);
  };
  const int wrun = (n + kWarps - 1) / kWarps;
  const int wlo = min(warp * wrun, n), whi = min(wlo + wrun, n);
  unsigned runs = 0;
  for (int i0 = wlo; i0 < whi; i0 += 32) {
    const int i = i0 + lane;
    runs += __popc(__ballot_sync(kFull, i < whi && run_end(i)));
  }
  if (lane == 0) misc[kWarpRuns + warp] = runs;
  __syncthreads();
  if (tid == 0) {
    unsigned s = 0;
    for (int w = 0; w < kWarps; ++w) {
      const unsigned c = misc[kWarpRuns + w];
      misc[kWarpRuns + w] = s;
      s += c;
    }
    misc[kRuns] = s;
  }
  cluster.sync();  // segment totals and run counts visible

  // the segment scan over the row's live segments: x[g] = the total of
  // segment g - 1 (0 for g = 0), then Hillis-Steele over the Pallas row's
  // n_seg_full segments (a step adds 0.0 below its distance)
  for (int g = tid; g < s_live; g += kThreads) {
    float t = 0.0f;
    if (g >= 1) {
      t = *cluster.map_shared_rank(segtot + (g - 1) % spc, (g - 1) / spc);
    }
    xa[g] = t;
  }
  if (tid == kThreads - 1) {
    unsigned base = 0, total = 0;
    for (int r = 0; r < n_cta; ++r) {
      const unsigned v = *cluster.map_shared_rank(misc + kRuns, r);
      if (r < me) base += v;
      total += v;
    }
    misc[kBase] = base;
    misc[kTotal] = total;
  }
  __syncthreads();
  for (int d = 1; d < n_seg_full; d <<= 1) {
    for (int g = tid; g < s_live; g += kThreads) {
      xb[g] = xa[g] + (g >= d ? xa[g - d] : 0.0f);
    }
    __syncthreads();
    float* t = xa;
    xa = xb;
    xb = t;
  }

  // the run ends to their slots, in row order
  const int64_t out = row * (int64_t)cap;
  const int g0 = me * spc;
  unsigned slot0 = misc[kBase] + misc[kWarpRuns + warp];
  for (int i0 = wlo; i0 < whi; i0 += 32) {
    const int i = i0 + lane;
    const bool last = i < whi && run_end(i);
    const unsigned ballot = __ballot_sync(kFull, last);
    const unsigned slot = slot0 + __popc(ballot & below_lane);
    if (last && slot < (unsigned)cap) {
      key2[out + slot] = key_of(sorted[i]);
      c2[out + slot] = cbuf[i] + xa[g0 + i / kLanes];
    }
    slot0 += __popc(ballot);
  }
  // (KEY_SENTINEL, 0.0) in [min(n_uniq, cap), cap), split over the CTAs
  const unsigned total = misc[kTotal];
  const int f0 = (int)min(total, (unsigned)cap);
  const int per = (cap - f0 + n_cta - 1) / n_cta;
  const int f_lo = f0 + me * per, f_hi = min(cap, f_lo + per);
  for (int s = f_lo + tid; s < f_hi; s += kThreads) {
    key2[out + s] = kSentinel;
    c2[out + s] = 0.0f;
  }
  if (me == 0 && tid == 0) n_uniq[row] = (int32_t)total;
  cluster.sync();  // no CTA exits while another reads its shared memory
}

cudaError_t prepare(int n_cta, int chunk, size_t* smem) {
  *smem = 16 * (size_t)chunk + kFixedBytes;
  if (n_cta < 1 || n_cta > kMaxCluster || chunk < kLanes ||
      chunk % kLanes || chunk > kMaxChunk) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      merge_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)*smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(merge_cluster_kernel,
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

// packed [rows, width] int32 (KEY_SENTINEL on dead lanes), qv [rows, width]
// f32 nonnegative -> key2 [rows, cap] int32, c2 [rows, cap] f32, n_uniq
// [rows] int32, one cluster of n_cta CTAs a row, each holding `chunk`
// elements (a multiple of 128 with chunk * n_cta >= width); `n_seg_full`
// is max(256, next_pow2(width)) / 128. Returns the first cudaError_t.
extern "C" int attpc_merge_cluster(const void* packed, const void* qv,
                                   void* key2, void* c2, void* n_uniq,
                                   int rows, int width, int n_cta, int chunk,
                                   int n_seg_full, int cap, int rank_bits,
                                   void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  const int load = n_cta > 0 ? (width + n_cta - 1) / n_cta : 0;
  if (width <= 0 || width > (1 << 18) || load > chunk || cap < 0 ||
      cap > width || n_seg_full < 2 ||
      (int64_t)rows * n_cta > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  size_t smem;
  cudaError_t err = prepare(n_cta, chunk, &smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, (unsigned)rows * (unsigned)n_cta, n_cta, smem,
                 (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&cfg, merge_cluster_kernel, (const int32_t*)packed,
                           (const float*)qv, width, load, chunk, n_seg_full,
                           (int32_t*)key2, (float*)c2, (int32_t*)n_uniq, cap,
                           rank_bits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of n_cta CTAs with `chunk` elements each the card can
// hold at once (0: such a cluster cannot be scheduled).
extern "C" int attpc_merge_cluster_occupancy(int n_cta, int chunk,
                                             int* clusters) {
  size_t smem;
  cudaError_t err = prepare(n_cta, chunk, &smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, (unsigned)n_cta, n_cta, smem, 0);
  return (int)cudaOccupancyMaxActiveClusters(clusters, merge_cluster_kernel,
                                             &cfg);
}
