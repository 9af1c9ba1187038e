// Microbenchmarks of warpgroup-level TF32 `wgmma.mma_async.m64nNk8` with A
// from registers and B from shared memory (no swizzle), as
// csrc/admm_box_wide.cu issues them, on one card (one block on each of 132
// SMs): the SM's cycles a wgmma with G wgmma on one accumulator between a
// `wgmma.fence` and a wait for all, 1, 2 or 4 warpgroups a block, N = 8,
// 16 or 32; and with a 16-byte global load issued before the fence and
// read after the wait (does the fence wait for it?). Build and run:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o wgmma_tf32_bench tools/wgmma_tf32_bench.cu
//   ./wgmma_tf32_bench
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

template <int N>
struct Mma;

template <>
struct Mma<8> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  }
};

template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  }
};

// per iteration: [a 16-byte load], fence, G wgmma on one accumulator (B
// cycling over 8 k-steps of shared memory), commit, wait for all, [the
// load's value folded into A]
template <int N, int G, bool LOAD>
__global__ void bench(const float4* src, float* out, int iters, long long* cycles) {
  __shared__ __align__(128) float b[8 * 8 * N];
  for (int i = threadIdx.x; i < 8 * 8 * N; i += blockDim.x) b[i] = 1.0f / (1 + i % 7);
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(b));
  const uint64_t desc = static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
                        (static_cast<uint64_t>(N) << 16) | (static_cast<uint64_t>(8) << 32);
  float d[N / 2] = {};
  uint32_t a[4] = {0x3f800000u, 0x3f000000u, 0x3e800000u, 0x3e000000u};
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if (LOAD) r = __ldg(src + ((static_cast<size_t>(i) * 128 + threadIdx.x) & ((1 << 20) - 1)));
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int g = 0; g < G; ++g) Mma<N>::run(d, a, desc + static_cast<uint64_t>((g % 8) * 2 * N));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < N / 2; ++j) asm volatile("" : "+f"(d[j])::"memory");
    if (LOAD) a[0] ^= __float_as_uint(r.x) & 1u;
  }
  const long long t1 = clock64();
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < N / 2; ++j) s += d[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = t1 - t0;
}

template <int N, int G, bool LOAD>
void run(int groups, const float4* src, float* out, long long* cyc) {
  const int iters = 4096;
  bench<N, G, LOAD><<<132, 128 * groups>>>(src, out, iters, cyc);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  bench<N, G, LOAD><<<132, 128 * groups>>>(src, out, iters, cyc);
  cudaEventRecord(e1);
  if (cudaGetLastError() != cudaSuccess) {
    printf("[wgmma tf32] m64n%dk8, %d warpgroup(s), %d wgmma a wait: launch failed\n", N, groups, G);
    return;
  }
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  long long c;
  cudaMemcpy(&c, cyc, 8, cudaMemcpyDeviceToHost);
  const double per_sm = static_cast<double>(iters) * G * groups;
  const double flops = 2.0 * 64 * N * 8 * per_sm * 132;
  printf("[wgmma tf32] m64n%dk8, %d warpgroup(s) a block, %2d wgmma a wait%s: %.1f SM cycles a "
         "wgmma (%.0f ideal at 495 TFLOP/s), %.1f TFLOP/s, SM clock %.2f GHz\n",
         N, groups, G, LOAD ? ", a global load pending at the fence" : "", c / per_sm,
         64.0 * N * 8 * 2 / (495e12 / 132 / (c / ms / 1e6) / 1e9), flops / ms / 1e9,
         c / ms / 1e6);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
}

int main() {
  float4* src;
  float* out;
  long long* cyc;
  cudaMalloc(&src, (1 << 20) * sizeof(float4));
  cudaMemset(src, 0, (1 << 20) * sizeof(float4));
  cudaMalloc(&out, 132 * 512 * sizeof(float));
  cudaMalloc(&cyc, 8);
  for (int groups : {1, 2, 4}) {
    run<32, 1, false>(groups, src, out, cyc);
    run<32, 3, false>(groups, src, out, cyc);
    run<32, 6, false>(groups, src, out, cyc);
    if (groups < 4) run<32, 24, false>(groups, src, out, cyc);  // 4 x 128 threads: too many registers
  }
  run<16, 6, false>(4, src, out, cyc);
  run<8, 6, false>(4, src, out, cyc);
  run<32, 6, true>(4, src, out, cyc);
  run<32, 6, true>(1, src, out, cyc);
  cudaFree(src);
  cudaFree(out);
  cudaFree(cyc);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
