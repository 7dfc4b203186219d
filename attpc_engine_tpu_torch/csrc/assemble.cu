// The Spyral assembly: packed rows -> per-event z order -> eight f64
// columns, one CTA per event.
//
// No TPU kernel is replaced: on the TPU this stage ran on the host (the
// JAX package's DetectorSimulator.assemble_spyral_ordered,
// attpc_engine_tpu/detector/simulator.py:675, and its C++ library
// native/spyral_io.cpp:110 sio_assemble_batch), because the TPU's host
// link could not carry the f64 rows. This kernel computes the same
// function, bit for bit, on the card; its plain version is
// attpc_engine_tpu_torch/detector/assemble.py assemble_plain.
//
// Per event e (rows [lo, lo + n) of the pooled packed rows, lo the sum of
// the counts before it), in two phases separated by one barrier:
//
// A. The TB wiggle. numpy's Generator(Philox(key=[seed, event])).random(n)
//    gives row i output lane i % 4 of Philox4x64-10 block i / 4, run on
//    the 256-bit counter i / 4 + 1 (numpy increments the counter before
//    each block) with the key taken verbatim, as (u64 >> 11) * 2^-53. A
//    thread computes one block, so four rows, and stores each row's
//    wiggled tb, tb_int + wiggle, in the f64 scratch. It also notes any
//    row whose integer tb exceeds its predecessor's.
// B. The order and the columns. The order is np.argsort(-tbf, stable)
//    within the event. The convert sort hands each event's rows over in
//    descending integer tb; then a row's place is its run's first index
//    plus the rows of its equal-tb run that precede it (greater tbf, or
//    equal tbf at a lower index): a row of an earlier run has tbf >=
//    tb_int + 1 >= this row's, at a lower index, and a row of a later run
//    has tbf <= this row's tb_int, at a higher index, also where a wiggle
//    rounds tb_int + w up to tb_int + 1. An event whose integer tbs are
//    not descending (phase A's note) counts over the whole event instead:
//    the full stable sort, as the C++ library's fallback gives. Each
//    thread then computes its rows' eight columns and writes them to
//    their place.
//
// The columns repeat sio_assemble_batch's IEEE operations in its order,
// each rounded on its own with the __d*_rn intrinsics (and the library is
// built with -fmad=false besides): thr = 4095 / max(q, 1e-300), idx =
// upper_bound(resp_asc, thr) over the response in shared memory, integral
// = q * prefix[idx] + 4095 * (n_resp - idx), amp = min(q * resp_max,
// 4095), z = ((win - tbf) / (win - mm)) * length * 1000.
//
// What bounds it on the card: bytes. It reads 8 B a row and writes 72 B
// (the f64 row and its int64 label) plus the 8-B scratch written and read
// back; the rank counts read rows of the run that L1 holds. An event's
// CTA is its unit of work, so the batch's 384 events fill 384 CTAs of 256
// threads, all resident at once on 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxResp = 1024;

constexpr uint64_t kM0 = 0xD2E7470EE14C6C93ULL;
constexpr uint64_t kM1 = 0xCA5A826395121157ULL;
constexpr uint64_t kW0 = 0x9E3779B97F4A7C15ULL;
constexpr uint64_t kW1 = 0xBB67AE8584CAA73BULL;

// Philox4x64-10 block `blk` of the stream keyed (k0, k1), as numpy's
// philox_next draws it: the 256-bit counter holds blk + 1.
__device__ __forceinline__ void philox_block(uint64_t blk, uint64_t k0,
                                             uint64_t k1, uint64_t out[4]) {
  uint64_t c0 = blk + 1;
  uint64_t c1 = c0 == 0 ? 1 : 0;  // the carry of blk = 2^64 - 1
  uint64_t c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint64_t lo0 = kM0 * c0, hi0 = __umul64hi(kM0, c0);
    const uint64_t lo1 = kM1 * c2, hi1 = __umul64hi(kM1, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  out[0] = c0;
  out[1] = c1;
  out[2] = c2;
  out[3] = c3;
}

__device__ __forceinline__ int tb_of(const int32_t* packed, int64_t row) {
  return packed[2 * row + 1] >> 22;
}

__global__ void __launch_bounds__(kThreads)
assemble_kernel(const int32_t* __restrict__ packed, int64_t rows,
                const int32_t* __restrict__ counts,
                const int64_t* __restrict__ event_ids, uint64_t seed,
                const double* __restrict__ wiggle,
                const double* __restrict__ pad_cx,
                const double* __restrict__ pad_cy,
                const double* __restrict__ pad_sizes, int n_pads,
                const double* __restrict__ resp_asc,
                const double* __restrict__ resp_prefix, int n_resp,
                double resp_max, double windows_edge, double z_denom,
                double length_m, double* tbf,
                double* __restrict__ out_spyral,
                int64_t* __restrict__ out_labels) {
  __shared__ double s_asc[kMaxResp];
  __shared__ double s_prefix[kMaxResp + 1];
  __shared__ long long s_warp[kThreads / 32];
  const int e = blockIdx.x;
  const int tid = threadIdx.x;

  for (int j = tid; j < n_resp; j += kThreads) s_asc[j] = resp_asc[j];
  for (int j = tid; j <= n_resp; j += kThreads) s_prefix[j] = resp_prefix[j];

  // lo = counts[0] + ... + counts[e - 1]
  long long part = 0;
  for (int j = tid; j < e; j += kThreads) part += counts[j];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) part += __shfl_xor_sync(~0u, part, s);
  if ((tid & 31) == 0) s_warp[tid >> 5] = part;
  __syncthreads();
  long long lo = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) lo += s_warp[w];
  // rows past the pool are not written (the caller passes sum(counts) rows)
  const int64_t n_all = counts[e];
  const int64_t n = lo >= rows ? 0 : (n_all < rows - lo ? n_all : rows - lo);
  if (n <= 0) return;

  // A: wiggled tbs into the scratch; note any ascending integer tb
  const uint64_t event = static_cast<uint64_t>(event_ids[e]);
  int ascending = 0;
  for (int64_t blk = tid; 4 * blk < n; blk += kThreads) {
    uint64_t u[4] = {0, 0, 0, 0};
    if (wiggle == nullptr) philox_block(static_cast<uint64_t>(blk), seed,
                                        event, u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t i = 4 * blk + j;
      if (i >= n) break;
      const int tb = tb_of(packed, lo + i);
      if (i > 0 && tb > tb_of(packed, lo + i - 1)) ascending = 1;
      const double w = wiggle != nullptr
                           ? wiggle[lo + i]
                           : static_cast<double>(u[j] >> 11) *
                                 (1.0 / 9007199254740992.0);
      tbf[lo + i] = __dadd_rn(w, static_cast<double>(tb));
    }
  }
  const bool descending = __syncthreads_or(ascending) == 0;

  // B: each row's place in the event's stable descending order, then its
  // columns
  const double* t_ev = tbf + lo;
  for (int64_t i = tid; i < n; i += kThreads) {
    const double t = t_ev[i];
    int64_t rank = 0;
    if (descending) {
      const int tb = tb_of(packed, lo + i);
      int64_t k = i - 1;
      for (; k >= 0 && tb_of(packed, lo + k) == tb; --k)
        rank += t_ev[k] >= t;
      rank += k + 1;  // the run's first row
      for (k = i + 1; k < n && tb_of(packed, lo + k) == tb; ++k)
        rank += t_ev[k] > t;
    } else {
      for (int64_t k = 0; k < n; ++k)
        rank += (t_ev[k] > t) | ((t_ev[k] == t) & (k < i));
    }
    const int32_t qbits = packed[2 * (lo + i)];
    const int32_t meta = packed[2 * (lo + i) + 1];
    const int pad = (meta >> 8) & 0x3FFF;
    const double q = static_cast<double>(__int_as_float(qbits));
    const double thr = __ddiv_rn(4095.0, q < 1e-300 ? 1e-300 : q);
    int a = 0, b = n_resp;  // upper_bound: the first entry > thr
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (thr < s_asc[mid]) b = mid;
      else a = mid + 1;
    }
    double integral = __dmul_rn(q, s_prefix[a]);
    integral = __dadd_rn(integral,
                         __dmul_rn(4095.0, static_cast<double>(n_resp - a)));
    const double qa = __dmul_rn(q, resp_max);
    const double amp = 4095.0 < qa ? 4095.0 : qa;
    double z = __dsub_rn(windows_edge, t);
    z = __ddiv_rn(z, z_denom);
    z = __dmul_rn(z, length_m);
    z = __dmul_rn(z, 1000.0);
    const bool ok = pad < n_pads;
    const double nan = __longlong_as_double(0x7ff8000000000000LL);
    double* row = out_spyral + 8 * (lo + rank);
    row[0] = ok ? pad_cx[pad] : nan;
    row[1] = ok ? pad_cy[pad] : nan;
    row[2] = z;
    row[3] = amp;
    row[4] = integral;
    row[5] = static_cast<double>(pad);
    row[6] = t;
    row[7] = ok ? pad_sizes[pad] : nan;
    out_labels[lo + rank] = meta & 0xFF;
  }
}

}  // namespace

extern "C" int attpc_assemble_spyral(
    const int32_t* packed, int64_t rows, const int32_t* counts, int n_events,
    const int64_t* event_ids, uint64_t seed, const double* wiggle,
    const double* pad_cx, const double* pad_cy, const double* pad_sizes,
    int n_pads, const double* resp_asc, const double* resp_prefix,
    int n_resp, double resp_max, double windows_edge,
    double micromegas_edge, double length_m, double* tbf_scratch,
    double* out_spyral, int64_t* out_labels, cudaStream_t stream) {
  if (n_resp < 1 || n_resp > kMaxResp) return cudaErrorInvalidValue;
  if (n_events <= 0 || rows <= 0) return cudaSuccess;
  // win - mm once, as sio_assemble_batch computes it
  const double z_denom = windows_edge - micromegas_edge;
  assemble_kernel<<<n_events, kThreads, 0, stream>>>(
      packed, rows, counts, event_ids, seed, wiggle, pad_cx, pad_cy,
      pad_sizes, n_pads, resp_asc, resp_prefix, n_resp, resp_max,
      windows_edge, z_denom, length_m, tbf_scratch, out_spyral, out_labels);
  return cudaGetLastError();
}
