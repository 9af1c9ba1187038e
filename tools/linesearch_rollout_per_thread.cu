// The per-thread design of csrc/linesearch_rollout.cu that the staged
// kernel replaced, kept as a timed variant for tools/rollout_variants.py:
// one thread a candidate, the state in registers, a loop over t, blocks of
// one warp. Each step waits on the whole previous state through sinf,
// cosf, asinf and sqrtf. Same arithmetic, same bits, same C entry point.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 32;  // one warp a block

struct CarFrontWheelStep {
  float dt, dist;
  float dist_sq;  // dist**2 rounded from double, as torch rounds the Python scalar

  // s <- step(s, u): s = [x, y, heading, v], u = [wheel angle, acceleration]
  __device__ __forceinline__ void operator()(float* s, const float* u) const {
    const float w = u[0], a = u[1];
    const float x = s[0], y = s[1], o = s[2], v = s[3];
    const float sw = sinf(w);
    const float f = __fmul_rn(dt, v);  // front-wheel rolling distance
    const float sf = __fmul_rn(sw, f);
    const float ins = __fsub_rn(dist_sq, __fmul_rn(sf, sf));
    // back-wheel rolling distance: (f cos w + dist) - sqrt(ins)
    const float b = __fsub_rn(__fadd_rn(__fmul_rn(f, cosf(w)), dist), sqrtf(ins));
    const float d_o = asinf(__fdiv_rn(sf, dist));
    s[0] = __fadd_rn(x, __fmul_rn(b, cosf(o)));
    s[1] = __fadd_rn(y, __fmul_rn(b, sinf(o)));
    s[2] = __fadd_rn(o, d_o);
    s[3] = __fadd_rn(v, __fmul_rn(a, dt));
  }
};

template <class Plant, int D, int M>
__global__ void __launch_bounds__(kThreads)
    linesearch_rollout_kernel(const float* __restrict__ x0s, const float* __restrict__ u,
                              float* __restrict__ xs, int R, int A, int N, Plant plant) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;  // over the R * A rows
  if (a >= R * A) return;
  const float* x0 = x0s + static_cast<size_t>(a / A) * D;
  const float* ua = u + static_cast<size_t>(a) * N * M;
  float* xa = xs + static_cast<size_t>(a) * N * D;

  float s[D];
#pragma unroll
  for (int i = 0; i < D; ++i) s[i] = x0[i];
  float next[M];
#pragma unroll
  for (int j = 0; j < M; ++j) next[j] = ua[j];

  for (int t = 0; t < N; ++t) {
    float ut[M];
#pragma unroll
    for (int j = 0; j < M; ++j) ut[j] = next[j];
    if (t + 1 < N) {
#pragma unroll
      for (int j = 0; j < M; ++j) next[j] = ua[(t + 1) * M + j];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) xa[t * D + i] = s[i];
    plant(s, ut);  // x_N is computed and dropped, as on the TPU
  }
}

template <class Plant, int D, int M>
int launch(const void* x0s, const void* u, void* xs, int R, int A, int N, Plant plant,
           cudaStream_t stream) {
  if (R < 1 || A < 1 || N < 1 || R > (0x7fffffff - kThreads) / A) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (R * A + kThreads - 1) / kThreads;
  linesearch_rollout_kernel<Plant, D, M><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(x0s), static_cast<const float*>(u), static_cast<float*>(xs), R,
      A, N, plant);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the launcher of csrc/linesearch_rollout.cu: x0s (R, 4), u (R, A, N, 2)
extern "C" int linesearch_rollout_car_front_wheel_launch(const void* x0s, const void* u, void* xs,
                                                         int R, int A, int N, float dt, float dist,
                                                         float dist_sq, void* stream) {
  return launch<CarFrontWheelStep, 4, 2>(x0s, u, xs, R, A, N,
                                         CarFrontWheelStep{dt, dist, dist_sq},
                                         static_cast<cudaStream_t>(stream));
}

extern "C" const char* linesearch_rollout_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
