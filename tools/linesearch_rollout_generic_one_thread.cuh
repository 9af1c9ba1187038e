// The generated rollout's first design (one thread a candidate), kept as the
// variant that csrc/linesearch_rollout_generic.cuh's staged design
// replaced; tools/rollout_variants.py builds it with a generated step and
// times the two in one run. Its entry points have the staged template's
// names, so each builds into a library of its own.
//
// Open-loop rollout of every line-search candidate through a generated step, for sm_90a.
//
// Replaces the Pallas TPU kernel `kernel` of
// `make_pallas_linesearch_rollout` (ilqr_admm_tpu/ops/pallas_rollout.py:90)
// for any plant's `step_cols`, as the Pallas kernel traces whatever step it
// is given. (CarFrontWheel keeps the staged kernel of
// csrc/linesearch_rollout.cu.) For each of R initial states x0s[r] (D,) and
// each of its A candidate control sequences u[r, a] (N, M):
//
//     xs[r, a, 0] = x0s[r],   xs[r, a, t + 1] = step(xs[r, a, t], u[r, a, t])   (t < N - 1)
//
// written to xs (R, A, N, D), the layout of csrc/linesearch_rollout.cu: R = 1
// is one line search, R > 1 a fleet's line searches in one launch (the
// Pallas call under `jax.vmap`). Candidate i = r * A + a starts from
// x0s[i / A]; every row is what a launch of its own gives, bit for bit.
//
// This file is a template, not a translation unit: ops/rollout_codegen.py
// traces the plant's step and emits `rollout_step` (one candidate's D
// states and M controls -> its next state, each operation as ATen's CUDA
// kernel computes it on f32, no FMA contraction) with ROLLOUT_D and
// ROLLOUT_M, and _build.build_rollouts writes that and this file into one
// .cu, compiled into a library of its own a step.
//
// Design: one thread a candidate, its state in registers (D <= 8), its
// controls read a step ahead (the next step's load in flight while this
// step computes), each state row stored as it is reached; 32 threads a
// block, so a fleet's candidates spread over the SMs. NaN states
// propagate as in torch: the step's arithmetic is the plain version's.
//
// What bounds it on an H100: not bytes (x0, u and xs are 0.6 MB at N = 500,
// A = 50: 0.2 us at 3.35 TB/s) nor operations, but each candidate's chain
// of steps: step t + 1 waits on step t's state. The least time is the
// step's longest loop-carried cycle of dependent operations times N - 1
// (CarSimple: one add a step, x[3] += dt u[1]). This design runs the whole
// step in series a step (its transcendentals included) and accepts the
// distance; staging the step from its graph, as csrc/linesearch_rollout.cu
// does for the car by hand, is the way to the bound (the staged template).

#include <cuda_runtime.h>

#include <cstddef>

#ifndef ROLLOUT_D
#error "define ROLLOUT_D, ROLLOUT_M and rollout_step before including this template"
#endif

namespace {

constexpr int kD = ROLLOUT_D;
constexpr int kM = ROLLOUT_M;
constexpr int kThreads = 32;
static_assert(kD >= 1 && kD <= 8 && kM >= 1 && kM <= 8, "the JAX contract: d, m <= 8");

// row[0..W) of a candidate's trajectory or controls, as float4 / float2
// where the row width allows (every row offset is then a multiple of it)
template <int W>
__device__ __forceinline__ void load_row(const float* __restrict__ src, float* v) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int j = 0; j < W / 4; ++j) {
      const float4 q = reinterpret_cast<const float4*>(src)[j];
      v[4 * j] = q.x, v[4 * j + 1] = q.y, v[4 * j + 2] = q.z, v[4 * j + 3] = q.w;
    }
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int j = 0; j < W / 2; ++j) {
      const float2 q = reinterpret_cast<const float2*>(src)[j];
      v[2 * j] = q.x, v[2 * j + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = src[j];
  }
}

template <int W>
__device__ __forceinline__ void store_row(float* __restrict__ dst, const float* v) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int j = 0; j < W / 4; ++j)
      reinterpret_cast<float4*>(dst)[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int j = 0; j < W / 2; ++j) reinterpret_cast<float2*>(dst)[j] = make_float2(v[2 * j], v[2 * j + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) dst[j] = v[j];
  }
}

__global__ void __launch_bounds__(kThreads)
    generic_rollout_kernel(const float* __restrict__ x0s, const float* __restrict__ u,
                           float* __restrict__ xs, int A, int N, int rows) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;  // < 2^32 for any rows
  if (i >= static_cast<unsigned>(rows)) return;
  const float* ui = u + static_cast<size_t>(i) * N * kM;
  float* xi = xs + static_cast<size_t>(i) * N * kD;
  const float* x0 = x0s + static_cast<size_t>(i / A) * kD;
  float x[kD], next[kD], ut[kM], un[kM];
#pragma unroll
  for (int k = 0; k < kD; ++k) x[k] = x0[k];
  load_row<kM>(ui, ut);
  for (int t = 0; t + 1 < N; ++t) {
    store_row<kD>(xi + static_cast<size_t>(t) * kD, x);
    load_row<kM>(ui + static_cast<size_t>(t + 1) * kM, un);  // the next step's controls
    rollout_step(x, ut, next);
#pragma unroll
    for (int k = 0; k < kD; ++k) x[k] = next[k];
#pragma unroll
    for (int k = 0; k < kM; ++k) ut[k] = un[k];
  }
  store_row<kD>(xi + static_cast<size_t>(N - 1) * kD, x);
}

}  // namespace

// x0s (R, D), u (R, A, N, M), xs (R, A, N, D); R * A threads.
extern "C" int linesearch_rollout_generic_launch(const void* x0s, const void* u, void* xs, int R,
                                                 int A, int N, void* stream) {
  if (R < 1 || A < 1 || N < 1 || R > 0x7fffffff / A) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = R * A;
  generic_rollout_kernel<<<(rows - 1) / kThreads + 1, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0s), static_cast<const float*>(u), static_cast<float*>(xs), A, N,
      rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* linesearch_rollout_generic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
