// K3, wide route: row-wise ascending sort of int64 [E, W] (bitonic network)
// for rows wider than the cluster route holds (csrc/sort_cluster.cu takes
// rows of up to 16 CTAs' shared memory, 213,760 elements; the wrapper,
// detector/sort_cuda.py, chooses by width before any launch). Such rows
// come from the later budget doublings of run_simulation's overflow retry.
//
// Replaces the Pallas kernel attpc_engine_tpu/detector/sort_pallas.py
// `_sort_kernel` (called by sort_pairs_pallas, and by sort_i64_pallas
// through it). The TPU kernel sorted (hi, lo) int32 pairs because Mosaic's
// int64 support is weak; here the pair is one int64, which the callers
// build as the TPU callers do (`pack64`: key << 32 | f32 bits, both halves
// non-negative, so int64 order is the pair order; the convert key is
// compared as a native signed int64). Rows are padded to a power of two
// with INT64_MAX. Equal elements are identical bit patterns, so the output
// is bit-exact whatever the network.
//
// What bounds it on the card: bytes moved through device memory. A row of
// 2^18 or more padded elements is 2 MB or more, too large for one SM's
// 227 KB of shared memory, and the network has log2(n)(log2(n)+1)/2
// compare-exchange stages. The design runs every stage whose partners lie
// within one 16,384-element (128 KB) tile inside shared memory: one kernel
// sorts each tile (105 stages, the direction of each tile chosen so the
// tiles form bitonic runs), and for each later phase one kernel per
// distance >= the tile size does a pass through a device-memory scratch,
// followed by one shared-memory kernel that finishes the phase's smaller
// distances.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16384;  // elements of one shared-memory tile (128 KB)
constexpr int kThreads = 1024;

__device__ __forceinline__ void compare_exchange(long long* s, int64_t i,
                                                 int64_t j, bool asc) {
  long long a = s[i];
  long long b = s[j];
  if ((a > b) == asc) {
    s[i] = b;
    s[j] = a;
  }
}

// Index of the lower element of pair `p` at XOR distance `d` (a power of
// two): insert a 0 bit at position log2(d).
__device__ __forceinline__ int64_t pair_low(int64_t p, int64_t d) {
  return ((p & ~(d - 1)) << 1) | (p & (d - 1));
}

// Loads one tile of a row (padding past in_w with INT64_MAX), runs the
// bitonic phases sz_first..sz_last over it with distances below the tile
// size, and stores the tile (columns below out_w). The sort direction of
// each compare-exchange follows the element's index in the whole row.
// `in` and `out` may be the same buffer: a block reads only its own tile
// before the first barrier and writes only that tile after the last.
__global__ void bitonic_tile_kernel(const long long* in,
                                    int64_t in_stride, int64_t in_w,
                                    long long* out,
                                    int64_t out_stride, int64_t out_w,
                                    int tile, int64_t sz_first,
                                    int64_t sz_last) {
  extern __shared__ long long s[];
  const int64_t row = blockIdx.y;
  const int64_t base = (int64_t)blockIdx.x * tile;
  const long long* src = in + row * in_stride;
  for (int k = threadIdx.x; k < tile; k += blockDim.x) {
    int64_t g = base + k;
    s[k] = g < in_w ? src[g] : (long long)INT64_MAX;
  }
  __syncthreads();
  for (int64_t sz = sz_first; sz <= sz_last; sz <<= 1) {
    int64_t d = sz >> 1;
    if (d > (tile >> 1)) d = tile >> 1;
    for (; d >= 1; d >>= 1) {
      for (int p = threadIdx.x; p < (tile >> 1); p += blockDim.x) {
        int64_t i = pair_low(p, d);
        compare_exchange(s, i, i + d, ((base + i) & sz) == 0);
      }
      __syncthreads();
    }
  }
  long long* dst = out + row * out_stride;
  for (int k = threadIdx.x; k < tile; k += blockDim.x) {
    int64_t g = base + k;
    if (g < out_w) dst[g] = s[k];
  }
}

// One compare-exchange stage at distance d >= the tile size, in place in
// device memory over rows of `total` elements.
__global__ void bitonic_global_kernel(long long* __restrict__ data,
                                      int64_t total, int64_t sz, int64_t d) {
  int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (total >> 1)) return;
  long long* row = data + (int64_t)blockIdx.y * total;
  int64_t i = pair_low(p, d);
  compare_exchange(row, i, i + d, (i & sz) == 0);
}

}  // namespace

// in [rows, width] -> out [rows, width], each row sorted ascending.
// `total` is width rounded up to a power of two, larger than one tile;
// `scratch` holds rows * total elements. Returns the first cudaError_t met.
extern "C" int attpc_sort_rows_i64(const void* in, void* out, void* scratch,
                                   int rows, int64_t width, int64_t total,
                                   void* stream) {
  if (rows <= 0 || width <= 0) return (int)cudaSuccess;
  if (total <= kTile || total < width || (total & (total - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kTile * sizeof(long long)));
  if (err != cudaSuccess) return (int)err;

  const long long* src = (const long long*)in;
  long long* dst = (long long*)out;
  long long* buf = (long long*)scratch;
  const size_t smem = kTile * sizeof(long long);
  dim3 tiles((unsigned)(total / kTile), rows);
  bitonic_tile_kernel<<<tiles, kThreads, smem, st>>>(
      src, width, width, buf, total, total, kTile, 2, kTile);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int gthreads = 256;
  dim3 pairs((unsigned)((total / 2 + gthreads - 1) / gthreads), rows);
  for (int64_t sz = 2 * (int64_t)kTile; sz <= total; sz <<= 1) {
    for (int64_t d = sz >> 1; d >= kTile; d >>= 1) {
      bitonic_global_kernel<<<pairs, gthreads, 0, st>>>(buf, total, sz, d);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    bool last = sz == total;
    bitonic_tile_kernel<<<tiles, kThreads, smem, st>>>(
        buf, total, total, last ? dst : buf, last ? width : total,
        last ? width : total, kTile, sz, sz);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
