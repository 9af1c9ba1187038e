// Microbenchmarks of warp-level TF32 `mma.sync.m16n8k8` on one card: its
// rate with a given number of independent accumulator chains a warp and
// warps a block (one block on each of 132 SMs), and the cost of other
// instructions issued beside it (independent integer operations between
// the mma). Build and run:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_sync_bench tools/mma_sync_bench.cu
//   ./mma_sync_bench
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// per iteration: 8 mma over CHAINS accumulators, and ALU integer
// operations (an add and a xor each pair) on 16 independent registers
template <int CHAINS, int ALU>
__global__ void bench(float* out, uint32_t* out2, int iters, long long* cycles) {
  float acc[CHAINS][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x * 3, 7};
  uint32_t x[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) x[j] = threadIdx.x * (j + 1);
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      mma(acc[c % CHAINS], a, i + c, i);
#pragma unroll
      for (int j = 0; j < ALU / 16; ++j) x[(c * 7 + j) % 16] = (x[(c * 7 + j) % 16] + 0x1000u) ^ (i + j);
    }
  }
  const long long t1 = clock64();
  float s = 0.0f;
  uint32_t y = 0;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
#pragma unroll
  for (int j = 0; j < 16; ++j) y ^= x[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  out2[blockIdx.x * blockDim.x + threadIdx.x] = y;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = t1 - t0;
}

template <int CHAINS, int ALU>
void run(int warps) {
  float* out;
  uint32_t* out2;
  long long* cyc;
  cudaMalloc(&out, 132 * 1024 * 4);
  cudaMalloc(&out2, 132 * 1024 * 4);
  cudaMalloc(&cyc, 8);
  const int iters = 4096;
  bench<CHAINS, ALU><<<132, 32 * warps>>>(out, out2, iters, cyc);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  bench<CHAINS, ALU><<<132, 32 * warps>>>(out, out2, iters, cyc);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  long long c;
  cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost);
  const double mma_per_subpartition = 8.0 * iters * warps / 4;
  const double flops = 2.0 * 16 * 8 * 8 * 8 * iters * warps * 132;
  printf("[mma.sync] %2d warps a block, %d chains a warp, %3d integer ops per 8 mma: "
         "%.2f cycles per mma on a sub-partition, %.1f TFLOP/s, SM clock %.2f GHz\n",
         warps, CHAINS, ALU, c / mma_per_subpartition, flops / ms / 1e9, c / ms / 1e6);
  cudaFree(out);
  cudaFree(out2);
  cudaFree(cyc);
}

int main() {
  for (int w : {4, 8, 16}) {
    run<1, 0>(w);
    run<2, 0>(w);
    run<4, 0>(w);
    run<8, 0>(w);
  }
  for (int w : {4, 16}) {
    run<4, 32>(w);
    run<4, 64>(w);
    run<4, 128>(w);
  }
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
