// Fused box-constrained LQT-ADMM fleet, control bounds only, for sm_90a.
//
// Replaces the Pallas TPU kernel `_admm_kernel_u_only`
// (ilqr_admm_tpu/ops/pallas_admm.py:90). Each CUDA block owns one tile of
// `T` instances and runs the whole ADMM loop on it without leaving the SM:
//
//     s     = z - lambda                  (the regularization target)
//     u_hat = u_base + s @ W_u            (W_u = (Rr l_inv)^T, Nm x Nm)
//     z     = clip(alpha u_hat + (1 - alpha) z + lambda, lo, hi)
//     lambda= lambda + u_hat - z
//
// and, once after the loop, x = x_base + s @ W_x from the s that produced
// the last u_hat. Warm start z0 = u_base, lambda0 = 0.
//
// What bounds it on an H100: one solve at the bench size (B = 16384,
// Nm = 100, Nd = 200, 100 iterations) is 2 Nm^2 B iters = 3.3e10 f32
// FLOP against ~46 MB of iterate traffic (u_base and x_base in; x, u,
// z_u out), so it is compute bound: 0.49 ms at the 67 TFLOP/s f32
// CUDA-core peak against 14 us of HBM time. Inside the loop the limit
// is the rate at which the FMA units can be fed from shared memory.
//
// What the design does about it:
// - W_u (40 KB at Nm = 100) is staged in shared memory once per block;
//   the tile's s lives in shared memory, transposed (s[k][b]) and double
//   buffered, so each iteration needs one barrier; z, lambda, u_base and
//   u_hat live in registers for the whole solve.
// - Each thread owns a 4 x 4 (instances x controls) register tile, so
//   every k step is two 16-byte shared loads feeding 16 FMAs.
// - Products are plain f32 FMAs. The TPU kernel's bf16x3 / bf16x6 splits
//   existed only because Mosaic rejects Precision.HIGH; an f32 FMA is at
//   least as accurate, so `refresh_every` and `polish_iters` change only
//   the iteration count here (the host turns them into chunk counts).
// - Per-tile early exit: after each chunk the block reduces
//   max |u_hat - z| over its tile and leaves the main phase below
//   `stop_tol`; the tail (`polish`) iterations always run.
// - W_x is read from global memory (it stays in L2) once, after the loop.
// Tensor cores (3xTF32 wgmma) and TMA staging are left for later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRows = 4;  // instances per thread
constexpr int kCols = 4;  // control coordinates per thread
constexpr int kMaxThreads = 512;

struct TileState {
  float ub[kRows][kCols];   // u_base
  float z[kRows][kCols];    // projected iterate
  float lam[kRows][kCols];  // scaled dual
  float uh[kRows][kCols];   // last u_hat
  float lo[kCols];
  float hi[kCols];
};

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// One ADMM iteration for this thread's 4 x 4 tile: reads s from s_in,
// writes the next s = z - lambda to s_out.
__device__ __forceinline__ void admm_step(TileState& t, const float* __restrict__ Ws,
                                          const float* __restrict__ s_in,
                                          float* __restrict__ s_out, int Nm, int ldw,
                                          int T, int b0, int j0, float alpha,
                                          float one_minus_alpha) {
  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;

#pragma unroll 4
  for (int k = 0; k < Nm; ++k) {
    const float4 s4 = *reinterpret_cast<const float4*>(s_in + k * T + b0);
    const float4 w4 = *reinterpret_cast<const float4*>(Ws + k * ldw + j0);
    const float s[kRows] = {s4.x, s4.y, s4.z, s4.w};
    const float w[kCols] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(s[r], w[c], acc[r][c]);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float u = t.ub[r][c] + acc[r][c];
      float zn, ln;
      if (alpha == 1.0f) {
        const float v = u + t.lam[r][c];
        zn = clip(v, t.lo[c], t.hi[c]);
        ln = v - zn;
      } else {
        const float zr = alpha * u + one_minus_alpha * t.z[r][c];
        zn = clip(zr + t.lam[r][c], t.lo[c], t.hi[c]);
        ln = t.lam[r][c] + u - zn;
      }
      t.uh[r][c] = u;
      t.z[r][c] = zn;
      t.lam[r][c] = ln;
    }
  }

#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (j0 + c < Nm) {
      *reinterpret_cast<float4*>(s_out + (j0 + c) * T + b0) =
          make_float4(t.z[0][c] - t.lam[0][c], t.z[1][c] - t.lam[1][c],
                      t.z[2][c] - t.lam[2][c], t.z[3][c] - t.lam[3][c]);
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
admm_u_only_kernel(const float* __restrict__ u_base, const float* __restrict__ x_base,
                   const float* __restrict__ W_u, const float* __restrict__ W_x,
                   const float* __restrict__ lo, const float* __restrict__ hi,
                   float* __restrict__ x_out, float* __restrict__ u_out,
                   float* __restrict__ zu_out, int Nm, int Nd, int T, int chunk_len,
                   int n_chunks, int n_tail, float alpha, float one_minus_alpha,
                   float stop_tol) {
  extern __shared__ float4 smem_f4[];
  __shared__ unsigned int residual_bits;

  const int ldw = (Nm + kCols - 1) / kCols * kCols;
  float* Ws = reinterpret_cast<float*>(smem_f4);  // Nm x ldw, zero-padded columns
  float* s0 = Ws + Nm * ldw;                       // Nm x T, s transposed
  float* s1 = s0 + Nm * T;

  const int tid = threadIdx.x;
  const int n_cg = ldw / kCols;
  const int j0 = (tid % n_cg) * kCols;
  const int b0 = (tid / n_cg) * kRows;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * T + b0;

  for (int i = tid; i < Nm * ldw; i += blockDim.x) {
    const int k = i / ldw;
    const int j = i - k * ldw;
    Ws[i] = j < Nm ? W_u[static_cast<size_t>(k) * Nm + j] : 0.0f;
  }
  if (tid == 0) residual_bits = 0u;

  // padded columns get u_base = lo = hi = 0, so they stay at 0 throughout
  TileState t;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = j0 + c;
    t.lo[c] = j < Nm ? lo[j] : 0.0f;
    t.hi[c] = j < Nm ? hi[j] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = j0 + c;
      const float v = j < Nm ? u_base[(row0 + r) * Nm + j] : 0.0f;
      t.ub[r][c] = v;
      t.z[r][c] = v;
      t.lam[r][c] = 0.0f;
      t.uh[r][c] = v;
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (j0 + c < Nm) {
      *reinterpret_cast<float4*>(s0 + (j0 + c) * T + b0) =
          make_float4(t.ub[0][c], t.ub[1][c], t.ub[2][c], t.ub[3][c]);
    }
  }
  __syncthreads();

  int p = 0;     // buffer the next step reads
  int last = 0;  // buffer holding the s that produced t.uh
  for (int ch = 0; ch < n_chunks; ++ch) {
    for (int it = 0; it < chunk_len; ++it) {
      admm_step(t, Ws, p ? s1 : s0, p ? s0 : s1, Nm, ldw, T, b0, j0, alpha,
                one_minus_alpha);
      last = p;
      p ^= 1;
      __syncthreads();
    }
    if (stop_tol > 0.0f) {
      // max over non-negative floats as unsigned bits; a NaN residual
      // sorts above +inf and, like the JAX while_loop test, stops the tile
      unsigned int m = 0u;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (j0 + c < Nm) m = max(m, __float_as_uint(fabsf(t.uh[r][c] - t.z[r][c])));
      atomicMax(&residual_bits, m);
      __syncthreads();
      const float res = __uint_as_float(residual_bits);
      __syncthreads();
      if (tid == 0) residual_bits = 0u;
      if (!(res >= stop_tol)) break;
    }
  }
  for (int it = 0; it < n_tail; ++it) {
    admm_step(t, Ws, p ? s1 : s0, p ? s0 : s1, Nm, ldw, T, b0, j0, alpha,
              one_minus_alpha);
    last = p;
    p ^= 1;
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = j0 + c;
      if (j < Nm) {
        u_out[(row0 + r) * Nm + j] = t.uh[r][c];
        zu_out[(row0 + r) * Nm + j] = t.z[r][c];
      }
    }
  }

  // state trajectory from the s that produced the last u_hat
  const float* s_last = last ? s1 : s0;
  for (int i = tid; i < T * Nd; i += blockDim.x) {
    const int b = i / Nd;
    const int j = i - b * Nd;
    float acc = 0.0f;
    for (int k = 0; k < Nm; ++k)
      acc = fmaf(s_last[k * T + b], W_x[static_cast<size_t>(k) * Nd + j], acc);
    const size_t g = (static_cast<size_t>(blockIdx.x) * T + b) * Nd + j;
    x_out[g] = x_base[g] + acc;
  }
}

}  // namespace

extern "C" int admm_u_only_launch(const void* u_base, const void* x_base, const void* W_u,
                                  const void* W_x, const void* lo, const void* hi,
                                  void* x_out, void* u_out, void* zu_out, int batch,
                                  int Nm, int Nd, int T, int chunk_len, int n_chunks,
                                  int n_tail, float alpha, float one_minus_alpha,
                                  float stop_tol, void* stream) {
  if (Nm <= 0 || Nd <= 0 || T <= 0 || T % kRows != 0 || batch <= 0 || batch % T != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ldw = (Nm + kCols - 1) / kCols * kCols;
  const int threads = (T / kRows) * (ldw / kCols);
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (static_cast<size_t>(Nm) * ldw +
                                       2 * static_cast<size_t>(Nm) * T);
  cudaError_t err = cudaFuncSetAttribute(
      admm_u_only_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  admm_u_only_kernel<<<batch / T, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u_base), static_cast<const float*>(x_base),
      static_cast<const float*>(W_u), static_cast<const float*>(W_x),
      static_cast<const float*>(lo), static_cast<const float*>(hi),
      static_cast<float*>(x_out), static_cast<float*>(u_out), static_cast<float*>(zu_out),
      Nm, Nd, T, chunk_len, n_chunks, n_tail, alpha, one_minus_alpha, stop_tol);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* admm_u_only_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
