// Dependent-chain latencies of the instruction classes that K1's step
// (attpc_engine_tpu_torch/csrc/transport.cu) is made of, on the card it
// runs on. One thread times, with clock64(), chains of kChain links in
// which each link takes the previous one's result. A link is one or two
// PTX instructions; ptxas may merge some (two integer adds into one
// three-input IADD3), so tools/k1_critical_path.py counts the SASS
// instructions between each chain's two clock reads and solves for the
// latency of each class, the classes met in earlier chains taken as known.
// Build and run through that tool, or:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//        -o build/libsm90_latency_probe.so tools/sm90_latency_probe.cu
//
// attpc_latency_probe(out) fills out[k] with the cycles of chain k over its
// kChain links, in the order of attpc_latency_probe_name(k).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChain = 512;
constexpr int kProbes = 13;
const char* kNames[kProbes] = {
    "FADD", "FMUL", "FFMA", "FADD+FMNMX", "FADD+FSETP+FSEL", "FADD+MUFU.RCP",
    "FADD+MUFU.RSQ", "FADD+FRND", "IADD3", "IMAD", "F2I+IADD3", "I2FP+F2I",
    "LDS"};

#define CHAIN(body)                                        \
  do {                                                     \
    long long t0 = clock64();                              \
    _Pragma("unroll") for (int k = 0; k < kChain; ++k) {   \
      body;                                                \
    }                                                      \
    long long t1 = clock64();                              \
    cycles[n++] = (float)(t1 - t0) / kChain;               \
  } while (0)

__global__ void probe_kernel(float* out, float seed, int iseed) {
  __shared__ unsigned long long chase[64];
  if (threadIdx.x != 0) return;
  for (int k = 0; k < 64; ++k) {
    chase[k] = (unsigned long long)(((k * 7 + 3) % 64) * 8) +
               (unsigned long long)__cvta_generic_to_shared(chase);
  }
  __syncwarp();
  float cycles[kProbes];
  int n = 0;
  float x = seed, y = seed * 0.5f, z = seed * 0.25f;
  int i = iseed, j = iseed + 1, m = iseed + 2;
  CHAIN(asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(x) : "f"(y)));
  CHAIN(asm volatile("mul.rn.f32 %0, %0, %1;" : "+f"(x) : "f"(y)));
  CHAIN(asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(x) : "f"(y), "f"(z)));
  CHAIN(asm volatile("add.rn.f32 %0, %0, %1; min.f32 %0, %0, %2;"
                     : "+f"(x) : "f"(y), "f"(z)));
  CHAIN(asm volatile("{.reg .pred p; add.rn.f32 %0, %0, %1;"
                     " setp.lt.f32 p, %0, %2; selp.f32 %0, %0, %1, p;}"
                     : "+f"(x) : "f"(y), "f"(z)));
  CHAIN(asm volatile("add.rn.f32 %0, %0, %1; rcp.approx.ftz.f32 %0, %0;"
                     : "+f"(x) : "f"(y)));
  CHAIN(asm volatile("add.rn.f32 %0, %0, %1; rsqrt.approx.ftz.f32 %0, %0;"
                     : "+f"(x) : "f"(y)));
  CHAIN(asm volatile("add.rn.f32 %0, %0, %1; cvt.rmi.f32.f32 %0, %0;"
                     : "+f"(x) : "f"(y)));
  CHAIN(asm volatile("add.s32 %0, %0, %1;" : "+r"(i) : "r"(j)));
  CHAIN(asm volatile("mad.lo.s32 %0, %0, %1, %2;" : "+r"(i) : "r"(j), "r"(m)));
  CHAIN(asm volatile("{.reg .s32 r; cvt.rmi.s32.f32 r, %0; add.s32 r, r, %1;"
                     " mov.b32 %0, r;}"
                     : "+f"(x) : "r"(j)));
  CHAIN(asm volatile("{.reg .f32 f; cvt.rn.f32.s32 f, %0;"
                     " cvt.rmi.s32.f32 %0, f;}"
                     : "+r"(i)));
  unsigned long long a = chase[iseed & 63];
  CHAIN(asm volatile("ld.shared.u64 %0, [%0];" : "+l"(a)));
  for (int k = 0; k < kProbes; ++k) out[k] = cycles[k];
  // keep the chains' results alive
  out[kProbes] = x + (float)(i + (int)a);
}

}  // namespace

extern "C" int attpc_latency_probe_count() { return kProbes; }

extern "C" const char* attpc_latency_probe_name(int k) { return kNames[k]; }

// out: device memory of kProbes + 1 floats. Returns the cudaError_t.
extern "C" int attpc_latency_probe(void* out) {
  probe_kernel<<<1, 32>>>((float*)out, 1.0001f, 3);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceSynchronize();
}
