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
// What bounds them on the card: bytes. Per output key K2 and K6 read about
// 0.8 B of indices (ix and iy are shared by 10 pixels each) and write 4 B,
// so at the flagship 39.3 M keys they move ~190 MB; K7 moves the same less
// tbr. The 1.43 MB pad-id table is read at random but stays in the 50 MB
// L2. The TPU kernels' one-hot matrix products and bf16 planes only worked
// around the TPU's slow gathers; here K2 runs one thread per output key
// (one cached gather, one coalesced store), and K6 and K7 one thread per
// (point, x cell) row (one ix, ten iy, ten gathers along one table row, ten
// consecutive outputs). K6 stages a warp's keys in shared memory and
// stores them with 16-byte stores, each sector written once; K7 stores its
// ten outputs one by one, so each store touches 40 sectors of which it
// fills 4 B. The int32 table holds pad ids, no bit splitting.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNx = 560;
constexpr int kNy = 640;
constexpr int kPadSentinel = 10240;
constexpr int kMesh = 10;

__global__ void packed_key_lookup_kernel(
    const int32_t* __restrict__ ix, const int32_t* __restrict__ iy,
    const int32_t* __restrict__ tbr, const int32_t* __restrict__ table,
    int32_t* __restrict__ out, int64_t n_out, int pad_mult, int32_t sentinel) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_out) return;
  int64_t p = idx / (kMesh * kMesh);
  int r = (int)(idx - p * (kMesh * kMesh));
  int i = r / kMesh;
  int j = r - i * kMesh;
  int x = min(max(__ldg(&ix[p * kMesh + i]), 0), kNx - 1);
  int y = min(max(__ldg(&iy[p * kMesh + j]), 0), kNy - 1);
  int pad = __ldg(&table[x * kNy + y]);
  out[idx] = pad < kPadSentinel ? pad * pad_mult + __ldg(&tbr[p]) : sentinel;
}

constexpr int kThreads = 256;

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

// The same row mapping, pad ids only.
__global__ void pad_lookup_kernel(const int32_t* __restrict__ ix,
                                  const int32_t* __restrict__ iy,
                                  const int32_t* __restrict__ table,
                                  int32_t* __restrict__ out, int64_t n_rows) {
  int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  int64_t p = r / kMesh;
  int x = min(max(__ldg(&ix[r]), 0), kNx - 1);
  const int32_t* trow = table + x * kNy;
  int32_t* o = out + r * kMesh;
#pragma unroll
  for (int j = 0; j < kMesh; ++j) {
    int y = min(max(__ldg(&iy[p * kMesh + j]), 0), kNy - 1);
    o[j] = __ldg(&trow[y]);
  }
}

}  // namespace

// ix, iy [P, 10] int32; tbr [P] int32; table [560, 640] int32;
// out [P, 10, 10] int32. Returns the cudaError_t of the launch.
extern "C" int attpc_packed_key_lookup(const void* ix, const void* iy,
                                       const void* tbr, const void* table,
                                       void* out, int64_t n_points,
                                       int rank_bits, int32_t sentinel,
                                       void* stream) {
  int64_t n_out = n_points * kMesh * kMesh;
  if (n_out <= 0) return (int)cudaSuccess;
  int64_t blocks = (n_out + kThreads - 1) / kThreads;
  packed_key_lookup_kernel<<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const int32_t*)ix, (const int32_t*)iy, (const int32_t*)tbr,
      (const int32_t*)table, (int32_t*)out, n_out, 512 << rank_bits,
      sentinel);
  return (int)cudaGetLastError();
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
// pad ids. Returns the cudaError_t of the launch.
extern "C" int attpc_pad_lookup(const void* ix, const void* iy,
                                const void* table, void* out,
                                int64_t n_points, void* stream) {
  int64_t n_rows = n_points * kMesh;
  if (n_rows <= 0) return (int)cudaSuccess;
  int64_t blocks = (n_rows + kThreads - 1) / kThreads;
  pad_lookup_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ix, (const int32_t*)iy, (const int32_t*)table,
      (int32_t*)out, n_rows);
  return (int)cudaGetLastError();
}
