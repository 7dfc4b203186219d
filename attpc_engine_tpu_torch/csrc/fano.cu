// The step's Fano stage in one kernel: Philox4x32-10 draws, Box-Muller and
// the Fano-smeared electron counts.
//
// It replaces no TPU kernel: the JAX package draws its Fano noise with
// jax.random in XLA (attpc_engine_tpu/detector/deposition.py:101-141). Its
// plain version is attpc_engine_tpu_torch/detector/deposition.py
// `generate_electrons(dke, fano_noise(...))`, which runs Philox in int64
// tensor passes (some 345 launches a batch), and the kernel gives that
// version's bits. Normal number j = (t % cs) * K + k of event g's stream,
// for step t and track k, is word j % 4 of Philox4x32-10 at key (seed low
// word, g & 0xFFFFFFFF) and counter (j / 4, t / cs, stream, seed high
// word); a counter's four words give four normals by Box-Muller,
//
//   u1 = ((w0 >> 8) + 1) * 2^-24    u2 = (w1 >> 8) * 2^-24
//   r  = sqrt(-2 * log(u1))         th = f32(2 pi) * u2
//   z0 = r * cos(th)                z1 = r * sin(th)
//
// and (w2, w3) give z2, z3 the same way. Then, for each deposit dke,
//
//   n = dke * f32(1e6 / w)   s = sqrt(f32(fano) * n)   e = (int)(n + s * z)
//
// truncated toward zero. Each f32 operation is rounded on its own, in the
// plain version's order (__fmul_rn, __fadd_rn, __fsqrt_rn), and logf, sinf
// and cosf are the IEEE library functions that PyTorch's CUDA kernels call.
// The scalars come in as the f32 values PyTorch converts them to.
//
// What bounds it on the card: bytes, one read of dke and one write of the
// counts, [T, E*K] 4 B each (123 MB at the chain's [10,000, 1,536], 0.037
// ms at 3.35 TB/s); the draws (~200 instructions a counter) are below
// that. One thread takes one counter of one event and chunk, threads of
// neighbouring events side by side, so a warp's loads and stores of one
// step are contiguous. A counter whose deposits are all exactly 0 (dead
// tracks and steps) draws nothing: its counts are 0 whatever the noise,
// which is finite (u1 is in (0, 1]).
//
// The words that change from batch to batch, the seed's two and the
// batch's first global event id, are read from a buffer on the card
// (`words`: seed low word, event id low word, seed high word), not passed
// as arguments: a CUDA graph of the step freezes a kernel's arguments, and
// the caller refills the buffer before each replay (DetectorSimulator.
// simulate_batch copies it to the card with the batch's inputs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr int kThreads = 256;

struct FanoParams {
  int n_steps;    // T
  int n_events;   // E
  int tracks;     // K
  int cs;         // steps a chunk
  int n_ctr;      // counters a chunk: ceil(cs * K / 4)
  uint32_t ctr2;  // the stream
  float c_w;      // f32(1e6 / w_value)
  float fano;     // f32(fano_factor)
  float two_pi;   // f32(2 pi)
};

__device__ __forceinline__ uint4 philox(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kW0;
    k1 += kW1;
  }
  return c;
}

__device__ __forceinline__ float2 box_muller(uint32_t a, uint32_t b,
                                             float two_pi) {
  float u1 = __fmul_rn((float)((a >> 8) + 1u), 0x1p-24f);
  float u2 = __fmul_rn((float)(b >> 8), 0x1p-24f);
  float r = __fsqrt_rn(__fmul_rn(-2.0f, logf(u1)));
  float th = __fmul_rn(two_pi, u2);
  return make_float2(__fmul_rn(r, cosf(th)), __fmul_rn(r, sinf(th)));
}

// the four normals of counter i of chunk c of event e; words: seed low
// word, global id of event 0 (low word), seed high word
__device__ __forceinline__ void normals(const FanoParams& p,
                                        const uint32_t* __restrict__ words,
                                        int e, int c, int i, float z[4]) {
  uint4 w = philox(
      make_uint4((uint32_t)i, (uint32_t)c, p.ctr2, __ldg(words + 2)),
      __ldg(words), __ldg(words + 1) + (uint32_t)e);
  float2 a = box_muller(w.x, w.y, p.two_pi);
  float2 b = box_muller(w.z, w.w, p.two_pi);
  z[0] = a.x;
  z[1] = a.y;
  z[2] = b.x;
  z[3] = b.y;
}

__device__ __forceinline__ int electrons(float d, float z,
                                         const FanoParams& p) {
  float n = __fmul_rn(d, p.c_w);
  float s = __fsqrt_rn(__fmul_rn(p.fano, n));
  return __float2int_rz(__fadd_rn(n, __fmul_rn(s, z)));
}

// Normal w of counter i is j = 4 i + w, at (step j / K, track j % K) of the
// chunk while j < cs * K.
__global__ void __launch_bounds__(kThreads) fano_kernel(
    const float* __restrict__ dke, int* __restrict__ out,
    const uint32_t* __restrict__ words, int n_threads, const FanoParams p) {
  int tid = blockIdx.x * kThreads + threadIdx.x;
  if (tid >= n_threads) return;
  int e = tid % p.n_events;
  int rest = tid / p.n_events;
  int i = rest % p.n_ctr;
  int c = rest / p.n_ctr;
  float d[4];
  int64_t at[4];
  bool live = false;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    int j = 4 * i + w;
    int tt = j / p.tracks;
    int t = c * p.cs + tt;
    at[w] = (tt < p.cs && t < p.n_steps)
                ? ((int64_t)t * p.n_events + e) * p.tracks + j % p.tracks
                : -1;
    d[w] = at[w] >= 0 ? __ldg(dke + at[w]) : 0.0f;
    live |= d[w] != 0.0f;
  }
  float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (live) normals(p, words, e, c, i, z);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    if (at[w] >= 0) out[at[w]] = electrons(d[w], z[w], p);
  }
}

}  // namespace

// dke [n_steps, n_events * tracks] f32, out the same shape int32; chunk_steps
// already cut to n_steps; words [3] uint32 on the card (seed low word,
// global id of event 0 low word, seed high word), read when the kernel
// runs. The threads, n_events x counters x chunks, and the elements must
// each be fewer than 2^31. Returns the cudaError_t of the launch.
extern "C" int attpc_fano_electrons(
    const void* dke, void* out, const void* words, int n_steps, int n_events,
    int tracks, int chunk_steps, uint32_t ctr2, float c_w, float fano,
    float two_pi, void* stream) {
  if (n_steps <= 0 || n_events <= 0 || tracks <= 0) return (int)cudaSuccess;
  if (chunk_steps <= 0 || chunk_steps > n_steps) {
    return (int)cudaErrorInvalidValue;
  }
  int64_t per_chunk = (int64_t)chunk_steps * tracks;
  int64_t n_ctr = (per_chunk + 3) / 4;
  int64_t n_chunks = (n_steps + chunk_steps - 1) / chunk_steps;
  int64_t n_threads = n_ctr * n_chunks * n_events;
  if (n_threads > INT32_MAX || (int64_t)n_steps * n_events * tracks >
                                   INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  FanoParams p{n_steps, n_events, tracks, chunk_steps, (int)n_ctr,
               ctr2,    c_w,      fano,   two_pi};
  unsigned blocks = (unsigned)((n_threads + kThreads - 1) / kThreads);
  fano_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dke, (int*)out, (const uint32_t*)words, (int)n_threads,
      p);
  return (int)cudaGetLastError();
}
