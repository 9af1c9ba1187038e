// Open-loop rollout of every line-search candidate through a generated step, staged, for sm_90a.
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
// Pallas call under `jax.vmap`). Block b rolls candidate b out from
// x0s[b / A], so every row is what a launch of its own gives, bit for bit.
//
// This file is a template, not a translation unit: ops/rollout_codegen.py
// traces the plant's step, plans it (`StagePlan`) and emits the staged
// program (ROLLOUT_D, ROLLOUT_M, ROLLOUT_PHASES, ROLLOUT_ARRAYS,
// ROLLOUT_CHAINS, `rollout_init`, `rollout_phase`, `rollout_write`: each
// operation as ATen's CUDA kernel computes it on f32, no FMA contraction),
// and _build.build_rollouts writes that and this file into one .cu,
// compiled into a library of its own a step.
//
// What bounds it on an H100: not bytes (x0, u and xs are 0.6 MB at N = 500,
// A = 50: 0.2 us at 3.35 TB/s) nor operations, but each candidate's chain
// of steps: the least time is the step's longest loop-carried cycle of
// dependent operations times N - 1 (CarSimple: one add a step, x[3] +=
// dt u[1]). Run a step at a time, each step would wait on the latency of
// the whole step, its transcendentals included (the one-thread design
// this replaced, tools/linesearch_rollout_generic_one_thread.cuh: 265
// cycles a step). But a step is a graph: the states that truly feed back
// on themselves form its strongly connected components, and everything
// else (controls, transcendentals, products) depends on the states of
// earlier components only, so it runs in parallel over t once those are
// known. The plan does what csrc/linesearch_rollout.cu does for the car by
// hand, for any step.
//
// Design: one block a candidate; the horizon in chunks of `chunk` steps,
// each staged value an array of shared memory (`row` = chunk + kPad
// floats: a chain reads up to 32 steps ahead), the states' arrays first,
// each state's value at t = 0 the carry from the last chunk. A chunk's
// phases, a block barrier after each:
//   - a pass (all threads, parallel over t): level 0's reads the controls
//     (coalesced) and computes the values that read no state; level L + 1's
//     the values that read states of levels <= L; a pass also writes the
//     states that are functions of earlier levels at t + 1;
//   - the chains of a level, one thread each (lane 0 of warps 0, 1, ...):
//     each runs its component's cycle over the chunk in series, its
//     staged inputs read G steps ahead into registers and its results
//     (each state at t before the step, the cycle's staged values) stored
//     G at a time as float4, as csrc/linesearch_rollout.cu's chain() does,
//     so that a link waits on its operations and not on a load or store;
//   - last (rollout_write), the chunk's rows of xs, coalesced.
// The chunk is as long as the horizon (a multiple of 32) up to kMaxChunk,
// and shorter where the arrays would not fit kMaxShared.

#include <cuda_runtime.h>

#include <cstddef>

#ifndef ROLLOUT_PHASES
#error "emit the staged program (ops/rollout_codegen.py) before including this template"
#endif

namespace {

constexpr int kD = ROLLOUT_D;
constexpr int kM = ROLLOUT_M;
constexpr int kPad = 32;                   // a chain's read-ahead past the chunk
constexpr int kMaxChunk = 1024;            // steps staged at a time
constexpr int kMaxShared = 232448;         // the H100's most shared memory a block
constexpr int kMaxThreads = 256;
static_assert(kD >= 1 && kD <= 8 && kM >= 1 && kM <= 8, "the JAX contract: d, m <= 8");
static_assert(32 * ROLLOUT_CHAINS <= kMaxThreads, "a level's chains run on warps of their own");

// The least threads a block takes: a warp for each chain of a level.
constexpr int kMinThreads = ROLLOUT_CHAINS > 1 ? 32 * ROLLOUT_CHAINS : 32;

struct Geometry {
  int threads, chunk;
  size_t smem;
};

__host__ Geometry geometry(int rows, int N, int threads) {
  int chunk = ((N + 31) / 32) * 32;
  if (chunk > kMaxChunk) chunk = kMaxChunk;
  const int fit = (kMaxShared / (4 * ROLLOUT_ARRAYS) - kPad) / 32 * 32;
  if (chunk > fit) chunk = fit;
  if (threads <= 0) threads = rows <= 264 ? kMaxThreads : 64;  // a fleet: smaller blocks
  if (threads < kMinThreads) threads = kMinThreads;
  return {threads, chunk, static_cast<size_t>(ROLLOUT_ARRAYS) * (chunk + kPad) * sizeof(float)};
}

__global__ void __launch_bounds__(kMaxThreads)
    staged_rollout_kernel(const float* __restrict__ x0s, const float* __restrict__ u,
                          float* __restrict__ xs, int A, int N, int chunk) {
  extern __shared__ float4 staged_shared[];
  float* s = reinterpret_cast<float*>(staged_shared);
  const int row = chunk + kPad, tid = threadIdx.x, threads = blockDim.x;
  const size_t b = blockIdx.x;
  const float* ub = u + b * N * kM;
  float* xb = xs + b * N * kD;
  rollout_init(s, row, x0s + (b / A) * kD, tid, threads);
  __syncthreads();
  for (int c0 = 0; c0 < N; c0 += chunk) {
    const int len = min(chunk, N - c0);
    const float* u_c = ub + static_cast<size_t>(c0) * kM;
#pragma unroll
    for (int p = 0; p < ROLLOUT_PHASES; ++p) {
      rollout_phase(p, s, row, u_c, len, tid, threads);
      __syncthreads();
    }
    rollout_write(s, row, xb + static_cast<size_t>(c0) * kD, len, tid, threads);
    __syncthreads();
  }
}

}  // namespace

// The launch's (threads a block, chunk, shared memory bytes) for R x A
// candidates over N steps; threads 0 is the default choice.
extern "C" void linesearch_rollout_generic_geometry(int R, int A, int N, int threads, int* out) {
  const Geometry g = geometry(R * A, N, threads);
  out[0] = g.threads, out[1] = g.chunk, out[2] = static_cast<int>(g.smem);
}

// x0s (R, D), u (R, A, N, M), xs (R, A, N, D); R * A blocks of `threads`
// (0: the default).
extern "C" int linesearch_rollout_generic_launch_threads(const void* x0s, const void* u, void* xs,
                                                         int R, int A, int N, int threads,
                                                         void* stream) {
  if (R < 1 || A < 1 || N < 1 || R > 0x7fffffff / A || threads < 0 || threads > kMaxThreads ||
      threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(R * A, N, threads);
  if (g.chunk < 32) return static_cast<int>(cudaErrorInvalidValue);  // the plan keeps it >= 192
  cudaError_t err = cudaFuncSetAttribute(staged_rollout_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(g.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  staged_rollout_kernel<<<R * A, g.threads, g.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0s), static_cast<const float*>(u), static_cast<float*>(xs), A, N,
      g.chunk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int linesearch_rollout_generic_launch(const void* x0s, const void* u, void* xs, int R,
                                                 int A, int N, void* stream) {
  return linesearch_rollout_generic_launch_threads(x0s, u, xs, R, A, N, 0, stream);
}

extern "C" const char* linesearch_rollout_generic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
