// K2: pad lookup and merge-key packing for the 10x10 diffusion mesh.
//
// Replaces the Pallas kernel attpc_engine_tpu/detector/deposit_pallas.py
// `_packed_kernel_2s` (called by packed_key_lookup_2s_pallas), with the
// same contract: for deposit point p and mesh pixel (i, j), read the pad id
// of the 1-mm cell (ix[p, i], iy[p, j]) and emit
//   ((pad * 512 + tb) << rank_bits) | rank  ==  pad * (512 << rank_bits) + tbr[p]
// or `sentinel` where the cell is vetoed, a hole or off the plane. The
// caller has already aliased invalid pixels onto the table's sentinel
// padding (cell (559, 639)); indices are clamped here only to keep every
// read inside the table.
//
// What bounds it on the card: bytes. Per output key it reads about 0.8 B of
// indices (ix and iy are shared by 10 pixels each) and writes 4 B, so at
// the flagship 39.3 M keys it moves ~190 MB; the 1.43 MB pad-id table is
// read at random but stays in the 50 MB L2. The TPU kernel's one-hot matrix
// products and bf16 planes only worked around the TPU's slow gathers;
// here one thread per output key does one cached gather and one coalesced
// store. The int32 table holds pad ids, no bit splitting.

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
  const int threads = 256;
  int64_t blocks = (n_out + threads - 1) / threads;
  packed_key_lookup_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      (const int32_t*)ix, (const int32_t*)iy, (const int32_t*)tbr,
      (const int32_t*)table, (int32_t*)out, n_out, 512 << rank_bits,
      sentinel);
  return (int)cudaGetLastError();
}
