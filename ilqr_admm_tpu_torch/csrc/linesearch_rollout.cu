// Open-loop nonlinear rollout of every line-search candidate, for sm_90a.
//
// Replaces the Pallas TPU kernel `kernel` of
// `make_pallas_linesearch_rollout` (ilqr_admm_tpu/ops/pallas_rollout.py:90).
// For each of R initial states x0s[r] (D,) and each of its A candidate
// control sequences u[r, a] (N, M):
//
//     xs[r, a, 0] = x0s[r],   xs[r, a, t + 1] = step(xs[r, a, t], u[r, a, t])   (t < N - 1)
//
// written to xs (R, A, N, D); the final state x_N is not stored, as on the
// TPU. R = 1 is the single line search; R > 1 a fleet's line searches in
// one launch, the counterpart of the Pallas call under `jax.vmap`, which
// batches it over a grid axis. A block rolls out one candidate of one
// instance, so every row is bit for bit what a launch of its own gives.
//
// Limits: the grid is R * A blocks along x (at most 2^31 - 1, and the
// launcher takes R * A as an int); offsets into u and xs are size_t, so
// R * A * N * D has no 32-bit limit. A stays <= 128 an instance (the JAX
// contract, checked by the Python wrapper).
//
// The plant is compiled in: the step of CarFrontWheel
// (ilqr_admm_tpu/models/car.py:37-44), where the TPU kernel traced a
// Python `step_cols`. Its arithmetic is IEEE f32 in the order the plain
// torch step runs it: sinf/cosf/sqrtf/asinf (no fast math), and every
// product and sum through __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn, so that
// nvcc does not contract them into FMAs, which torch's separate elementwise
// launches never do. The result is bit-identical to the plain version on
// the card. NaNs propagate as in torch: a candidate whose sqrt argument
// goes negative, or whose asin argument leaves [-1, 1], gives NaN states.
//
// What bounds it on an H100: not bytes (x0, u and xs are 240 KB at N =
// 500, A = 20: 0.07 us at 3.35 TB/s) nor operations (~22 a step a
// candidate), but dependency chains. Run step by step, each step waits on
// the whole previous state through sinf, cosf, asinf and sqrtf, some 500
// cycles a step. But the car's step is triangular in the state
// [x, y, o, v], u = [w, a]:
//
//     v[t+1] = v[t] + a[t] dt                       (reads v only)
//     b[t], do[t] = f(w[t], v[t])                   (back-wheel distance, turn)
//     o[t+1] = o[t] + do[t]
//     x[t+1] = x[t] + b[t] cos(o[t]),  y[t+1] = y[t] + b[t] sin(o[t])
//
// so the only true chains are sequential f32 additions; every
// transcendental is independent across t once its chain input is known.
// The least time is then (N - 1) dependent adds (tools/rollout_variants.py
// measures the add's latency and the clock).
//
// Design: one block a candidate (of one instance), 256 threads, the horizon in chunks of
// kChunk steps staged in shared memory, with (x, y, o, v) carried from one
// chunk to the next. In each chunk:
//   1. all threads: w[t] and a[t] dt from the candidate's controls;
//   2. thread 0 runs the v chain, while warps 1-7 take sin and cos of w;
//   3. all threads: b[t] and do[t] from (w[t], v[t]);
//   4. thread 0 runs the o chain;
//   5. all threads: b[t] cos(o[t]) and b[t] sin(o[t]);
//   6. thread 0 runs the x chain and thread 32 (another warp) the y chain;
//   7. all threads: the chunk's rows of xs, (x, y, o, v) a step, coalesced.
// Each chain is one dependent FADD a step: its thread loads its addends
// from shared memory kGroup steps ahead (a group in registers while the
// next group's loads are in flight), so a link waits on the add and not
// on a load. The operations and their order are those of the plain
// version, so the bits are too.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;  // one block a candidate
constexpr int kChunk = 1024;   // steps staged in shared memory at a time
constexpr int kGroup = 32;     // steps a chain thread holds in registers
constexpr int kRow = kChunk + kGroup;  // a staged array, with room for one group's read-ahead

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

struct CarFrontWheel {
  float dt, dist;
  float dist_sq;  // dist**2 rounded from double, as torch rounds the Python scalar
};

// out[t] = c + d[0] + ... + d[t - 1] for t < len, summed in order; returns
// the sum of all len addends (exact when len is a multiple of kGroup, as
// every chunk but the last is). Reads up to kGroup past the last group.
__device__ __forceinline__ float chain(const float* __restrict__ d, float* __restrict__ out, int len,
                                       float c) {
  const float4* d4 = reinterpret_cast<const float4*>(d);
  float4* out4 = reinterpret_cast<float4*>(out);
  float4 q[kGroup / 4], next[kGroup / 4];
#pragma unroll
  for (int j = 0; j < kGroup / 4; ++j) q[j] = d4[j];
  for (int t4 = 0; 4 * t4 < len; t4 += kGroup / 4) {
#pragma unroll
    for (int j = 0; j < kGroup / 4; ++j) next[j] = d4[t4 + kGroup / 4 + j];
#pragma unroll
    for (int j = 0; j < kGroup / 4; ++j) {
      float4 r;
      r.x = c;
      c = add(c, q[j].x);
      r.y = c;
      c = add(c, q[j].y);
      r.z = c;
      c = add(c, q[j].z);
      r.w = c;
      c = add(c, q[j].w);
      out4[t4 + j] = r;
      q[j] = next[j];
    }
  }
  return c;
}

__global__ void __launch_bounds__(kThreads)
    car_front_wheel_rollout_kernel(const float* __restrict__ x0s, const float* __restrict__ u,
                                   float* __restrict__ xs, int A, int N, CarFrontWheel car) {
  __shared__ __align__(16) float staged[10][kRow];
  float *W = staged[0], *ADT = staged[1], *SW = staged[2], *CW = staged[3], *V = staged[4];
  float *B = staged[5], *DO = staged[6], *O = staged[7], *X = staged[8], *Y = staged[9];
  const int tid = threadIdx.x;
  const float2* ua = reinterpret_cast<const float2*>(u) + static_cast<size_t>(blockIdx.x) * N;
  float4* xa = reinterpret_cast<float4*>(xs) + static_cast<size_t>(blockIdx.x) * N;
  // the carries, from this candidate's instance: thread 0 holds x, o and
  // v, thread 32 holds y
  const float* x0 = x0s + static_cast<size_t>(blockIdx.x / A) * 4;
  float x = x0[0], y = x0[1], o = x0[2], v = x0[3];

  for (int c0 = 0; c0 < N; c0 += kChunk) {
    const int len = min(kChunk, N - c0);
    for (int t = tid; t < len; t += kThreads) {
      const float2 ut = ua[c0 + t];
      W[t] = ut.x;
      ADT[t] = mul(ut.y, car.dt);
    }
    __syncthreads();
    if (tid == 0) {
      v = chain(ADT, V, len, v);
    } else if (tid >= 32) {
      for (int t = tid - 32; t < len; t += kThreads - 32) {
        SW[t] = sinf(W[t]);
        CW[t] = cosf(W[t]);
      }
    }
    __syncthreads();
    for (int t = tid; t < len; t += kThreads) {
      const float f = mul(car.dt, V[t]);  // front-wheel rolling distance
      const float sf = mul(SW[t], f);
      const float ins = sub(car.dist_sq, mul(sf, sf));
      // back-wheel rolling distance: (f cos w + dist) - sqrt(ins)
      B[t] = sub(add(mul(f, CW[t]), car.dist), sqrtf(ins));
      DO[t] = asinf(__fdiv_rn(sf, car.dist));
    }
    __syncthreads();
    if (tid == 0) o = chain(DO, O, len, o);
    __syncthreads();
    for (int t = tid; t < len; t += kThreads) {
      const float ot = O[t];
      ADT[t] = mul(B[t], cosf(ot));
      SW[t] = mul(B[t], sinf(ot));
    }
    __syncthreads();
    if (tid == 0) x = chain(ADT, X, len, x);
    else if (tid == 32) y = chain(SW, Y, len, y);
    __syncthreads();
    for (int t = tid; t < len; t += kThreads) xa[c0 + t] = make_float4(X[t], Y[t], O[t], V[t]);
  }
}

}  // namespace

// x0s (R, 4), u (R, A, N, 2), xs (R, A, N, 4); R * A blocks.
extern "C" int linesearch_rollout_car_front_wheel_launch(const void* x0s, const void* u, void* xs,
                                                         int R, int A, int N, float dt, float dist,
                                                         float dist_sq, void* stream) {
  if (R < 1 || A < 1 || N < 1 || R > 0x7fffffff / A) return static_cast<int>(cudaErrorInvalidValue);
  car_front_wheel_rollout_kernel<<<R * A, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0s), static_cast<const float*>(u), static_cast<float*>(xs), A, N,
      CarFrontWheel{dt, dist, dist_sq});
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* linesearch_rollout_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
