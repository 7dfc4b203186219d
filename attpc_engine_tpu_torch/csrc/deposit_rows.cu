// The default step's deposit rows in one kernel: diffusion mesh, pad lookup,
// merge key and pixel charge, packed for the first merge sort.
//
// On the default step (merge="sorts", lookup="two_stage") this kernel takes
// the place of the TPU kernel attpc_engine_tpu/detector/deposit_pallas.py
// `_packed_kernel_2s` (K2, kept in deposit.cu with that kernel's int32
// contract for the other configurations) together with the XLA passes
// around it in attpc_engine_tpu/detector/deposition.py:437-503: the 10x10
// mesh of each deposit point, its pixel cells, the pad lookup and key
// packing, the pixel charges and their mask. Its plain version is
// attpc_engine_tpu_torch/detector/deposition.py `deposit_rows_plain`,
// and the kernel does that version's f32 operations in its order, each
// rounded on its own (explicit __fmul_rn / __fadd_rn, never contracted):
//
//   sigma = sqrt((ptbf * k) * inv_e)   k = f32(2 D vd), inv_e = 1 / f32(E)
//   s     = sigma > 0 ? sigma : 1
//   x_i   = sigma > 0 ? px + s * mesh[i] : px               (and y_j)
//   ix    = floor(x_i * 1000 - lo), aliased to 559 when off the grid or
//           the slot is empty; iy likewise to 639
//   key   = pad < 10240 ? pad * (512 << rank_bits) + tbr : 2^31 - 1
//   q     = key is the sentinel ? 0 : pne * (sigma > 0 ? pdf[i][j]
//                                               : (i, j) == (0, 0))
//   row   = (int64)key << 32 | bits(q)
//
// `/ E` is multiplied by the f32 reciprocal because that is what the plain
// version computes on the card: ATen's CUDA true division by a CPU scalar
// multiplies by the scalar's reciprocal (the CPU divides). mesh (MESH_1D)
// and pdf (_pdf_area()) are the plain version's f32 bits, passed by value
// in the kernel's parameters (440 B) and copied to shared memory by each
// block: a launch copies nothing from the host.
//
// What bounds it on the card: bytes. At the flagship batch (393,216 points)
// it reads ~21 B a point (8 MB) and writes 8 B a pixel, 315 MB: ~0.096 ms
// at 3.35 TB/s. The 1.43 MB pad-id table is gathered at random but stays in
// L2. One thread makes two neighbouring pixels (i, j), (i, j + 1) and
// stores them as one 16-byte vector, so a warp writes 512 contiguous
// bytes; the ten threads' worth of per-point loads hit L1. A grid-stride
// loop over as many blocks as the card holds at once pays the shared-memory
// prologue once per block.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kNx = 560;
constexpr int kNy = 640;
constexpr int kPadSentinel = 10240;
constexpr int32_t kKeySentinel = 0x7FFFFFFF;
constexpr int kMesh = 10;
constexpr int kPairs = kMesh * kMesh / 2;  // pixel pairs of one point
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2,048 threads, the SM's limit

struct RowsParams {
  float mesh[kMesh];         // the mesh offsets, sigma units
  float pdf[kMesh * kMesh];  // the pixel weights
  float k;       // f32(2 * diffusion * drift_velocity)
  float inv_e;   // 1 / f32(efield), rounded in f32
  float lo;      // grid_lo_mm
  int n_mm;      // grid_n_mm
  int pad_mult;  // 512 << rank_bits
};

__device__ __forceinline__ int cell(float v, const RowsParams& p) {
  return (int)floorf(__fsub_rn(__fmul_rn(v, 1000.0f), p.lo));
}

__device__ __forceinline__ unsigned long long row(int pad, int32_t tbr,
                                                  float q, int pad_mult) {
  int32_t key = pad < kPadSentinel ? pad * pad_mult + tbr : kKeySentinel;
  float qq = key != kKeySentinel ? q : 0.0f;
  return ((unsigned long long)(uint32_t)key << 32) | __float_as_uint(qq);
}

__global__ void __launch_bounds__(kThreads) deposit_rows_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ ptbf, const float* __restrict__ pne,
    const int32_t* __restrict__ tbr, const bool* __restrict__ taken,
    const int32_t* __restrict__ table, ulonglong2* __restrict__ out,
    int n_pairs, const __grid_constant__ RowsParams p) {
  __shared__ float s_mesh[kMesh];
  __shared__ float2 s_pdf[kPairs];
  if (threadIdx.x < kMesh) s_mesh[threadIdx.x] = p.mesh[threadIdx.x];
  if (threadIdx.x < kPairs) {
    s_pdf[threadIdx.x] =
        make_float2(p.pdf[2 * threadIdx.x], p.pdf[2 * threadIdx.x + 1]);
  }
  __syncthreads();
  for (int t = blockIdx.x * kThreads + threadIdx.x; t < n_pairs;
       t += gridDim.x * kThreads) {
    int pt = t / kPairs;
    int pair = t - pt * kPairs;  // pixels 2 * pair, 2 * pair + 1 of the point
    int i = pair / (kMesh / 2);
    int j = 2 * (pair - i * (kMesh / 2));
    float x0 = __ldg(&px[pt]);
    float y0 = __ldg(&py[pt]);
    float sigma = __fsqrt_rn(__fmul_rn(__fmul_rn(__ldg(&ptbf[pt]), p.k),
                                       p.inv_e));
    bool diff = sigma > 0.0f;  // false for sigma == 0 and NaN (tb_f < 0)
    float s = diff ? sigma : 1.0f;
    float x = diff ? __fadd_rn(x0, __fmul_rn(s, s_mesh[i])) : x0;
    float ya = diff ? __fadd_rn(y0, __fmul_rn(s, s_mesh[j])) : y0;
    float yb = diff ? __fadd_rn(y0, __fmul_rn(s, s_mesh[j + 1])) : y0;
    int ix = cell(x, p);
    int iya = cell(ya, p);
    int iyb = cell(yb, p);
    if (ix < 0 || ix >= p.n_mm || !taken[pt]) ix = kNx - 1;
    if (iya < 0 || iya >= p.n_mm) iya = kNy - 1;
    if (iyb < 0 || iyb >= p.n_mm) iyb = kNy - 1;
    // clamp into the table only to keep every read inside it, as K2 does
    ix = min(max(ix, 0), kNx - 1);
    iya = min(max(iya, 0), kNy - 1);
    iyb = min(max(iyb, 0), kNy - 1);
    const int32_t* trow = table + ix * kNy;
    int pad_a = __ldg(&trow[iya]);
    int pad_b = __ldg(&trow[iyb]);
    // sigma == 0: the point's whole charge on pixel (0, 0), 0 elsewhere
    float2 w = diff ? s_pdf[pair] : make_float2(pair == 0 ? 1.0f : 0.0f, 0.0f);
    float ne = __ldg(&pne[pt]);
    int32_t tb = __ldg(&tbr[pt]);
    out[t] = make_ulonglong2(row(pad_a, tb, __fmul_rn(ne, w.x), p.pad_mult),
                             row(pad_b, tb, __fmul_rn(ne, w.y), p.pad_mult));
  }
}

}  // namespace

// px, py, ptbf, pne [P] f32; tbr [P] int32; taken [P] bool; table [560, 640]
// int32 pad ids; mesh [10] and pdf [10, 10] f32 in host memory, read before
// the launch; out [P, 100] int64. Returns the cudaError_t of the launch.
extern "C" int attpc_deposit_rows(
    const void* px, const void* py, const void* ptbf, const void* pne,
    const void* tbr, const void* taken, const void* table, const void* mesh,
    const void* pdf, void* out, int64_t n_points, float k, float inv_e,
    float lo, int n_mm, int rank_bits, void* stream) {
  if (n_points <= 0) return (int)cudaSuccess;
  if (n_points > INT32_MAX / kPairs) return (int)cudaErrorInvalidValue;
  RowsParams p{};
  memcpy(p.mesh, mesh, sizeof(p.mesh));
  memcpy(p.pdf, pdf, sizeof(p.pdf));
  p.k = k;
  p.inv_e = inv_e;
  p.lo = lo;
  p.n_mm = n_mm;
  p.pad_mult = 512 << rank_bits;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  int n_pairs = (int)(n_points * kPairs);
  int64_t blocks = (n_pairs + kThreads - 1) / kThreads;
  if (blocks > (int64_t)n_sm * kBlocksPerSm) blocks = (int64_t)n_sm * kBlocksPerSm;
  deposit_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)px, (const float*)py, (const float*)ptbf,
      (const float*)pne, (const int32_t*)tbr, (const bool*)taken,
      (const int32_t*)table, (ulonglong2*)out, n_pairs, p);
  return (int)cudaGetLastError();
}
