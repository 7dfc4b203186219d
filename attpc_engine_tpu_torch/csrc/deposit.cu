// K2, K6 and K7: pad lookups over the 10x10 diffusion mesh.
//
// K2 replaces the Pallas kernel attpc_engine_tpu/detector/deposit_pallas.py
// `_packed_kernel_2s` (called by packed_key_lookup_2s_pallas), and K6 the
// kernel `_packed_kernel` (called by packed_key_lookup_pallas). The two TPU
// kernels share one contract and differ only in machine mapping; so do
// these two. For deposit point p and mesh pixel (i, j), read the pad id of
// the 1-mm cell (ix[p, i], iy[p, j]) and emit
//   ((pad * 512 + tb) << rank_bits) | rank  ==  pad * (512 << rank_bits) + tbr[p]
// or `sentinel` where the cell is vetoed, a hole or off the plane. The
// caller has already aliased invalid pixels onto the table's sentinel
// padding (cell (559, 639)); indices are clamped here only to keep every
// read inside the table.
//
// K7 replaces `_lookup_kernel` (called by pad_lookup_pallas): the pad ids
// themselves, PAD_ID_SENTINEL (10240) where vetoed, with ix clipped into
// [0, 559] and iy into [0, 639] as pad_lookup_pallas clips them, so
// out-of-plane pixels alias onto edge cells; masking them is the caller's
// job.
//
// What bounds them on the card: bytes. Per output key they read about
// 0.8 B of indices (ix and iy are shared by 10 pixels each) and write 4 B,
// so at the flagship's 39.3 M keys they move ~190 MB. The 1.43 MB pad-id
// table is gathered one int32 a key and stays in the 50 MB L2. On a step's
// points neighbouring pixels share cells and table lines, and the count of
// load and store instructions a key sets the pace; on random cells each
// warp gather touches 32 sectors, and L2 traffic does. The TPU kernels'
// one-hot matrix products and bf16 planes only worked around the TPU's
// slow gathers.
//
// K2 and K7 are one kernel (`quad_lookup_kernel`, K7 without the key):
// each thread owns one quad of 4 consecutive keys of the [P, 10, 10]
// output, so that a warp stores 512 contiguous bytes with one 16-byte
// store a lane, every sector once. 100 keys a point make 25 quads, so no
// quad straddles two points: a quad is two pairs of horizontally adjacent
// keys, pair h of its point on x row h / 5 at y cells 2 (h % 5) and
// 2 (h % 5) + 1, and the quad whose first key is at y cell 8 straddles two
// x rows. A quad loads its indices once, through L1: one tbr, the x cells
// of its one or two rows and four y cells, 7 loads for 4 keys where one
// thread a key loaded 12, then four gathers and one store. All index
// arithmetic is 32-bit, with constant divisors: the wrappers refuse
// P * 100 >= 2^31. The kernel keeps no shared memory, which leaves the
// SM's 256 KB to L1 and the table's lines: staging each warp's gathers in
// shared memory, so that a gather reads 32 consecutive keys of some 4 x
// rows instead of one key of each of 32 quads over some 13, was slower on
// a step's points for its added shared-memory traffic. K6 keeps one thread
// per (point, x cell) row and stages each warp's keys in shared memory for
// 16-byte stores. The int32 table holds pad ids, no bit splitting.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNx = 560;
constexpr int kNy = 640;
constexpr int kPadSentinel = 10240;
constexpr int kMesh = 10;

constexpr int kQuadsPerPoint = kMesh * kMesh / 4;
constexpr int kThreads = 256;
// the keys of P points are indexed in int32
constexpr int64_t kMaxKeys = (int64_t)1 << 31;

// Thread q owns quad q of the output: keys 4 q .. 4 q + 3, pairs 2 m and
// 2 m + 1 of point q / 25, m = q % 25.
template <bool kKeys>
__global__ void __launch_bounds__(kThreads) quad_lookup_kernel(
    const int32_t* __restrict__ ix, const int32_t* __restrict__ iy,
    const int32_t* __restrict__ tbr, const int32_t* __restrict__ table,
    int32_t* __restrict__ out, int n_points, int pad_mult, int32_t sentinel) {
  const unsigned q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= (unsigned)n_points * kQuadsPerPoint) return;
  const unsigned p = q / kQuadsPerPoint;
  const unsigned h = 2 * (q - p * kQuadsPerPoint);  // first pair, even
  const unsigned ra = h / 5, ca = 2 * (h - 5 * ra);
  const unsigned rb = (h + 1) / 5, cb = 2 * (h + 1 - 5 * rb);
  const int32_t* px = ix + p * kMesh;
  const int32_t* py = iy + p * kMesh;
  const int xa = min(max(__ldg(&px[ra]), 0), kNx - 1) * kNy;
  const int xb = min(max(__ldg(&px[rb]), 0), kNx - 1) * kNy;
  int v[4] = {__ldg(&table[xa + min(max(__ldg(&py[ca]), 0), kNy - 1)]),
              __ldg(&table[xa + min(max(__ldg(&py[ca + 1]), 0), kNy - 1)]),
              __ldg(&table[xb + min(max(__ldg(&py[cb]), 0), kNy - 1)]),
              __ldg(&table[xb + min(max(__ldg(&py[cb + 1]), 0), kNy - 1)])};
  if (kKeys) {
    const int t = __ldg(&tbr[p]);
#pragma unroll
    for (int m = 0; m < 4; ++m)
      v[m] = v[m] < kPadSentinel ? v[m] * pad_mult + t : sentinel;
  }
  reinterpret_cast<int4*>(out)[q] = make_int4(v[0], v[1], v[2], v[3]);
}

// One thread per (point, x cell) row r = p * 10 + i: the row's ten keys.
// Each warp stages its 32 rows' 320 keys in shared memory and stores them
// as one contiguous run (out + r0 * 10, r0 a multiple of 32: 1,280-byte
// aligned from the tensor's base) with 16-byte stores. The last warp of
// the grid may hold fewer rows; n_rows = 10 P is even, so its keys, ten a
// row, still fill whole 16-byte quads.
__global__ void __launch_bounds__(kThreads) packed_key_lookup_rows_kernel(
    const int32_t* __restrict__ ix, const int32_t* __restrict__ iy,
    const int32_t* __restrict__ tbr, const int32_t* __restrict__ table,
    int32_t* __restrict__ out, int64_t n_rows, int pad_mult, int32_t sentinel) {
  __shared__ __align__(16) int32_t stage[kThreads * kMesh];
  const int lane = threadIdx.x & 31;
  const int64_t r0 = (int64_t)blockIdx.x * kThreads + (threadIdx.x & ~31);
  if (r0 >= n_rows) return;  // the whole warp
  int32_t* s = stage + (threadIdx.x & ~31) * kMesh;
  const int64_t r = r0 + lane;
  if (r < n_rows) {
    int64_t p = r / kMesh;
    int x = min(max(__ldg(&ix[r]), 0), kNx - 1);
    const int32_t* trow = table + x * kNy;
    int32_t t = __ldg(&tbr[p]);
#pragma unroll
    for (int j = 0; j < kMesh; ++j) {
      int y = min(max(__ldg(&iy[p * kMesh + j]), 0), kNy - 1);
      int pad = __ldg(&trow[y]);
      s[lane * kMesh + j] = pad < kPadSentinel ? pad * pad_mult + t : sentinel;
    }
  }
  __syncwarp();
  const int quads = (n_rows - r0 < 32 ? (int)(n_rows - r0) : 32) * kMesh / 4;
  const int4* s4 = reinterpret_cast<const int4*>(s);
  int4* o4 = reinterpret_cast<int4*>(out + r0 * kMesh);
  for (int k = lane; k < quads; k += 32) o4[k] = s4[k];
}

// Launch the quad kernel over n_points points (out 16-byte aligned).
template <bool kKeys>
int launch_quads(const void* ix, const void* iy, const void* tbr,
                 const void* table, void* out, int64_t n_points,
                 int pad_mult, int32_t sentinel, void* stream) {
  if (n_points <= 0) return (int)cudaSuccess;
  if (n_points * kMesh * kMesh >= kMaxKeys) return (int)cudaErrorInvalidValue;
  int blocks = (int)((n_points * kQuadsPerPoint + kThreads - 1) /
                     kThreads);
  quad_lookup_kernel<kKeys><<<blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const int32_t*)ix, (const int32_t*)iy, (const int32_t*)tbr,
      (const int32_t*)table, (int32_t*)out, (int)n_points, pad_mult,
      sentinel);
  return (int)cudaGetLastError();
}

}  // namespace

// ix, iy [P, 10] int32; tbr [P] int32; table [560, 640] int32;
// out [P, 10, 10] int32, 16-byte aligned; P * 100 < 2^31. Returns the
// cudaError_t of the launch.
extern "C" int attpc_packed_key_lookup(const void* ix, const void* iy,
                                       const void* tbr, const void* table,
                                       void* out, int64_t n_points,
                                       int rank_bits, int32_t sentinel,
                                       void* stream) {
  return launch_quads<true>(ix, iy, tbr, table, out, n_points,
                            512 << rank_bits, sentinel, stream);
}

// K6: arguments as attpc_packed_key_lookup.
extern "C" int attpc_packed_key_lookup_rows(const void* ix, const void* iy,
                                            const void* tbr, const void* table,
                                            void* out, int64_t n_points,
                                            int rank_bits, int32_t sentinel,
                                            void* stream) {
  int64_t n_rows = n_points * kMesh;
  if (n_rows <= 0) return (int)cudaSuccess;
  int64_t blocks = (n_rows + kThreads - 1) / kThreads;
  packed_key_lookup_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                                  (cudaStream_t)stream>>>(
      (const int32_t*)ix, (const int32_t*)iy, (const int32_t*)tbr,
      (const int32_t*)table, (int32_t*)out, n_rows, 512 << rank_bits,
      sentinel);
  return (int)cudaGetLastError();
}

// K7: ix, iy [P, 10] int32; table [560, 640] int32; out [P, 10, 10] int32
// pad ids, 16-byte aligned; P * 100 < 2^31. Returns the cudaError_t of the
// launch.
extern "C" int attpc_pad_lookup(const void* ix, const void* iy,
                                const void* table, void* out,
                                int64_t n_points, void* stream) {
  return launch_quads<false>(ix, iy, nullptr, table, out, n_points, 0, 0,
                             stream);
}
