// Microbenchmarks of a chain of dependent f32 additions on one card, the
// bound of the staged rollout in csrc/linesearch_rollout.cu:
// - the latency of `add.rn.f32` on a register chain (one thread);
// - the rollout's own chain loop: addends read from shared memory a group
//   of 32 ahead, partial sums written back (one thread), in cycles a link;
// - the SM clock under the run, from clock64 against CUDA events.
// Build and run:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o fadd_chain_bench tools/fadd_chain_bench.cu
//   ./fadd_chain_bench
#include <cuda_runtime.h>

#include <cstdio>

constexpr int kLinks = 4096;  // additions a measured chain
constexpr int kGroup = 32;    // as csrc/linesearch_rollout.cu

__global__ void register_chain(const float* in, float* out, long long* cycles, int reps) {
  float c = in[0];
  const float d = in[1];
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int i = 0; i < 256; ++i) asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(c) : "f"(d));
  }
  const long long t1 = clock64();
  out[0] = c;
  *cycles = t1 - t0;
}

// the loop of `chain` in csrc/linesearch_rollout.cu, over kLinks addends
__global__ void smem_chain(const float* in, float* out, long long* cycles) {
  __shared__ __align__(16) float d[kLinks + kGroup], o[kLinks + kGroup];
  for (int i = threadIdx.x; i < kLinks + kGroup; i += blockDim.x) d[i] = in[i % 64];
  __syncthreads();
  if (threadIdx.x != 0) return;
  const float4* d4 = reinterpret_cast<const float4*>(d);
  float4* out4 = reinterpret_cast<float4*>(o);
  float c = 0.0f;
  float4 q[kGroup / 4], next[kGroup / 4];
  const long long t0 = clock64();
#pragma unroll
  for (int j = 0; j < kGroup / 4; ++j) q[j] = d4[j];
  for (int t4 = 0; 4 * t4 < kLinks; t4 += kGroup / 4) {
#pragma unroll
    for (int j = 0; j < kGroup / 4; ++j) next[j] = d4[t4 + kGroup / 4 + j];
#pragma unroll
    for (int j = 0; j < kGroup / 4; ++j) {
      float4 r;
      r.x = c;
      c = __fadd_rn(c, q[j].x);
      r.y = c;
      c = __fadd_rn(c, q[j].y);
      r.z = c;
      c = __fadd_rn(c, q[j].z);
      r.w = c;
      c = __fadd_rn(c, q[j].w);
      out4[t4 + j] = r;
      q[j] = next[j];
    }
  }
  const long long t1 = clock64();
  out[0] = c + o[kLinks - 1];
  *cycles = t1 - t0;
}

int main() {
  float *in, *out;
  long long* cyc;
  cudaMalloc(&in, 64 * sizeof(float));
  cudaMalloc(&out, sizeof(float));
  cudaMalloc(&cyc, sizeof(long long));
  float h[64];
  for (int i = 0; i < 64; ++i) h[i] = 1e-3f * (i + 1);
  cudaMemcpy(in, h, sizeof(h), cudaMemcpyHostToDevice);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  long long c;
  const int reps = 1 << 14;  // 4.2e6 additions, a few ms: long enough to read the clock
  register_chain<<<1, 32>>>(in, out, cyc, 16);  // warm-up
  cudaEventRecord(e0);
  register_chain<<<1, 32>>>(in, out, cyc, reps);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaMemcpy(&c, cyc, sizeof(c), cudaMemcpyDeviceToHost);
  printf("[fadd chain] register chain: %.3f cycles an add.rn.f32; SM clock under the run %.0f MHz\n",
         static_cast<double>(c) / (256.0 * reps), c / ms / 1e3);
  for (int i = 0; i < 3; ++i) {
    smem_chain<<<1, 256>>>(in, out, cyc);
    cudaMemcpy(&c, cyc, sizeof(c), cudaMemcpyDeviceToHost);
    printf("[fadd chain] the rollout's chain loop, %d links from shared memory: %.3f cycles a link\n",
           kLinks, static_cast<double>(c) / kLinks);
  }
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
