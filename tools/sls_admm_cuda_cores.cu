// The first design of csrc/sls_admm.cu, on the CUDA cores, kept as a
// timed variant for tools/sls_admm_variants.py (it takes W dense, not
// packed; the port does not build or call it).
//
// Fused robust SLS-ADMM scenario fleet, for sm_90a.
//
// Replaces the Pallas TPU kernel `_sls_admm_kernel`
// (ilqr_admm_tpu/ops/pallas_sls.py:99). The decision matrix of each
// instance is P1 column slabs of Nm rows ([du | Phi_u columns]). Each CUDA
// block owns one tile of `T` instances and runs the whole ADMM loop on it
// without leaving the SM:
//
//     s_k = Z_k - L_k                         (k = 0..P1-1)
//     U_k = U_base_k + s_k @ W                (W = (l_inv Rr)^T, Nm x Nm)
//     Z   = P(alpha U + (1 - alpha) Z + L)    (row by row, coupling the slabs)
//     L   = L + U - Z
//
// from Z = U_base, L = 0. P is the exact projection of each row onto the
// diamond w0 |du| + w1 |phi| <= bound (`Diamond`), or a fixed-count
// consensus ADMM onto an intersection of second-order cones
// (`Consensus<P1, NSETS, Q>`, the TPU kernel's trace-time constants passed
// by value in the kernel's parameters). After the loop, U is recomputed
// once from the s that produced the last iterate and written as
// (batch, Nm, P1).
//
// What bounds it on an H100: one bench solve (B = 1024, Nm = 100, P1 = 2,
// 200 iterations) is 2 P1 Nm^2 B iters = 8.2e9 f32 FLOP of products
// against ~1 MB of traffic (bounds in, U out; W and U_base are shared),
// so it is compute bound: 0.12 ms at the 67 TFLOP/s f32 CUDA-core peak.
// The diamond z-update adds ~30 flops a row; the consensus z-update adds
// ~60 flops a row per inner iteration, 30 inner iterations: about four
// times the product, so that mode is bound by the z-update's FP32 issue.
// At the bench batch there are only 1024 instances: a block of tile T has
// 12.5 T threads, so the card is filled by many small blocks, not by
// large ones.
//
// What the design does about it:
// - W (40 KB at Nm = 100) and U_base (P1 x Nm; it is instance-invariant)
//   are staged in shared memory once per block; the tile's s lives in
//   shared memory as s[k][b * P1 + p], double buffered, so each iteration
//   needs one barrier. Z and L live in registers for the whole solve.
// - A thread owns a 2 x 4 (instances x controls) tile in all P1 slabs, so
//   the z-update, which couples the slabs of one row, stays in the thread;
//   each k step of the product is two 16-byte shared loads feeding 16 FMAs.
// - The z-update and dual update use explicitly rounded f32 operations
//   (no FMA contraction), so they round as the plain torch version does;
//   only the products' summation order differs from it.
// - Per-tile early exit: at the last iteration of each chunk the block
//   reduces max(|U - Z|, |Z - Z_prev|) with an atomicMax on the float bits
//   (non-negative, so bit order is value order; a NaN stops the tile, as
//   the JAX while_loop test does).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRows = 2;  // instances per thread
constexpr int kCols = 4;  // control rows (of W) per thread
constexpr int kMaxThreads = 512;
constexpr float kEps = 1e-30f;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// jnp.sign: 0 for +-0, NaN for NaN
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// Exact projection of a row (a, b) onto {w0 |a| + w1 |b| <= r}.
struct Diamond {
  float w0, w1, den;  // den = w0^2 + w1^2, rounded from f64

  template <int P1>
  __device__ __forceinline__ void project(const float (&y)[P1], float r,
                                          float (&out)[P1]) const {
    static_assert(P1 == 2, "the diamond z-update couples exactly two slabs");
    const float aa = fabsf(y[0]);
    const float ab = fabsf(y[1]);
    const float s = add(mul(w0, aa), mul(w1, ab));
    const bool inside = s <= r;
    const float lam = dvd(sub(s, r), den);
    const float xa = sub(aa, mul(lam, w0));
    const float xb = sub(ab, mul(lam, w1));
    // if one soft-thresholded coordinate would go negative, it is clamped
    // to 0 and the other goes to the diamond's vertex
    const float na = xb < 0.0f ? dvd(r, w0) : (xa < 0.0f ? 0.0f : xa);
    const float nb = xb < 0.0f ? 0.0f : (xa < 0.0f ? dvd(r, w1) : xb);
    out[0] = inside ? y[0] : mul(sign_of(y[0]), na);
    out[1] = inside ? y[1] : mul(sign_of(y[1]), nb);
  }
};

// Consensus ADMM onto {phi : A_i phi + b_i in SOC, i < NSETS}, with
// b_i = b_fixed_i + bound * b_bound_i; the last of a set's Q rows is the
// cone's t. Zero coefficients are skipped, as in the TPU kernel.
template <int P1, int NSETS, int Q>
struct Consensus {
  static_assert(NSETS >= 1 && Q >= 2, "consensus needs a set with a cone of dimension >= 2");
  float a[NSETS][Q][P1];      // soc_A
  float rho_a[NSETS][Q][P1];  // cons_rho * soc_A
  float b_fixed[NSETS][Q];
  float b_bound[NSETS][Q];
  float l_inv[P1][P1];        // (I + cons_rho sum_i A_i^T A_i)^-1
  int n_iters;

  __device__ __forceinline__ void x_update(const float (&y)[P1], const float (&b)[NSETS][Q],
                                           const float (&z)[NSETS][Q],
                                           const float (&lmb)[NSETS][Q],
                                           float (&x)[P1]) const {
    float rx[P1];
#pragma unroll
    for (int k = 0; k < P1; ++k) {
      float acc = y[k];
#pragma unroll
      for (int i = 0; i < NSETS; ++i)
#pragma unroll
        for (int r = 0; r < Q; ++r)
          if (a[i][r][k] != 0.0f)
            acc = add(acc, mul(rho_a[i][r][k], sub(sub(z[i][r], b[i][r]), lmb[i][r])));
      rx[k] = acc;
    }
#pragma unroll
    for (int k = 0; k < P1; ++k) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < P1; ++j)
        if (l_inv[k][j] != 0.0f) acc = add(acc, mul(l_inv[k][j], rx[j]));
      x[k] = acc;
    }
  }

  __device__ __forceinline__ void project(const float (&y)[P1], float bound,
                                          float (&out)[P1]) const {
    float b[NSETS][Q], z[NSETS][Q], lmb[NSETS][Q];
#pragma unroll
    for (int i = 0; i < NSETS; ++i) {
#pragma unroll
      for (int r = 0; r < Q; ++r) {
        b[i][r] = b_bound[i][r] != 0.0f ? add(b_fixed[i][r], mul(b_bound[i][r], bound))
                                        : b_fixed[i][r];
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < P1; ++k)
          if (a[i][r][k] != 0.0f) acc = add(acc, mul(a[i][r][k], y[k]));
        z[i][r] = add(acc, b[i][r]);
        lmb[i][r] = 0.0f;
      }
    }
    for (int it = 0; it < n_iters; ++it) {
      float x[P1];
      x_update(y, b, z, lmb, x);
#pragma unroll
      for (int i = 0; i < NSETS; ++i) {
        float axb[Q], w[Q];
#pragma unroll
        for (int r = 0; r < Q; ++r) {
          float acc = b[i][r];
#pragma unroll
          for (int k = 0; k < P1; ++k)
            if (a[i][r][k] != 0.0f) acc = add(acc, mul(a[i][r][k], x[k]));
          axb[r] = acc;
          w[r] = add(acc, lmb[i][r]);
        }
        // SOC projection of [w_0..w_{Q-2} | t] onto ||w|| <= t
        float n2 = mul(w[0], w[0]);
#pragma unroll
        for (int r = 1; r < Q - 1; ++r) n2 = add(n2, mul(w[r], w[r]));
        const float n = sqrtf(n2);
        const float t = w[Q - 1];
        const bool inside = n <= t;
        const bool polar = n <= -t;
        const float scale = dvd(mul(0.5f, add(n, t)), add(n, kEps));
#pragma unroll
        for (int r = 0; r < Q; ++r) {
          float zn;
          if (r < Q - 1)
            zn = inside ? w[r] : (polar ? 0.0f : mul(scale, w[r]));
          else
            zn = inside ? t : (polar ? 0.0f : mul(0.5f, add(n, t)));
          lmb[i][r] = sub(add(lmb[i][r], axb[r]), zn);
          z[i][r] = zn;
        }
      }
    }
    // one final x-update, so the result reflects the last duals
    x_update(y, b, z, lmb, out);
  }
};

template <int P1>
struct Tile {
  float z[P1][kRows][kCols];    // projected iterate
  float lam[P1][kRows][kCols];  // scaled dual
  float bound[kRows];
};

// acc[p][r][c] = sum_k s[k][(b0 + r) P1 + p] W[k][j0 + c]
template <int P1>
__device__ __forceinline__ void product(float (&acc)[P1][kRows][kCols],
                                        const float* __restrict__ Ws,
                                        const float* __restrict__ s, int Nm, int ldw,
                                        int ldsp, int b0, int j0) {
  static_assert((kRows * P1) % 4 == 0, "a thread's s values are read as float4");
#pragma unroll
  for (int p = 0; p < P1; ++p)
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[p][r][c] = 0.0f;

#pragma unroll 4
  for (int k = 0; k < Nm; ++k) {
    float sv[kRows * P1];
    const float4* s4 = reinterpret_cast<const float4*>(s + k * ldsp + b0 * P1);
#pragma unroll
    for (int v = 0; v < kRows * P1 / 4; ++v) {
      const float4 x = s4[v];
      sv[4 * v] = x.x;
      sv[4 * v + 1] = x.y;
      sv[4 * v + 2] = x.z;
      sv[4 * v + 3] = x.w;
    }
    const float4 w4 = *reinterpret_cast<const float4*>(Ws + k * ldw + j0);
    const float w[kCols] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int p = 0; p < P1; ++p)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[p][r][c] = fmaf(sv[r * P1 + p], w[c], acc[p][r][c]);
  }
}

// One ADMM iteration for this thread's elements: reads s from s_in, writes
// the next s = Z - L to s_out. With `track`, returns the bits of this
// thread's max(|U - Z|, |Z - Z_prev|) over its valid elements.
template <int P1, class ZUpdate>
__device__ __forceinline__ unsigned int admm_step(Tile<P1>& t, const ZUpdate& zu,
                                                  const float* __restrict__ Ws,
                                                  const float* __restrict__ Ub,
                                                  const float* __restrict__ s_in,
                                                  float* __restrict__ s_out, int Nm, int ldw,
                                                  int ldsp, int b0, int j0, float alpha,
                                                  float one_minus_alpha, bool track) {
  float acc[P1][kRows][kCols];
  product<P1>(acc, Ws, s_in, Nm, ldw, ldsp, b0, j0);

  unsigned int m = 0u;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float u[P1], y[P1], zn[P1];
#pragma unroll
      for (int p = 0; p < P1; ++p) {
        u[p] = add(Ub[p * ldw + j0 + c], acc[p][r][c]);
        y[p] = add(add(mul(alpha, u[p]), mul(one_minus_alpha, t.z[p][r][c])), t.lam[p][r][c]);
      }
      zu.project(y, t.bound[r], zn);
#pragma unroll
      for (int p = 0; p < P1; ++p) {
        if (track && j0 + c < Nm) {
          m = max(m, __float_as_uint(fabsf(sub(u[p], zn[p]))));
          m = max(m, __float_as_uint(fabsf(sub(zn[p], t.z[p][r][c]))));
        }
        t.lam[p][r][c] = sub(add(t.lam[p][r][c], u[p]), zn[p]);
        t.z[p][r][c] = zn[p];
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (j0 + c < Nm) {
      float v[kRows * P1];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int p = 0; p < P1; ++p) v[r * P1 + p] = sub(t.z[p][r][c], t.lam[p][r][c]);
      float4* out = reinterpret_cast<float4*>(s_out + (j0 + c) * ldsp + b0 * P1);
#pragma unroll
      for (int q = 0; q < kRows * P1 / 4; ++q)
        out[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  }
  return m;
}

template <int P1, class ZUpdate>
__global__ void __launch_bounds__(kMaxThreads)
sls_admm_kernel(const float* __restrict__ bounds, const float* __restrict__ U_base,
                const float* __restrict__ W, float* __restrict__ U_out, int Nm, int T,
                int chunk_len, int n_chunks, float alpha, float one_minus_alpha,
                float stop_tol, ZUpdate zu) {
  extern __shared__ float4 smem_f4[];
  __shared__ unsigned int residual_bits;

  const int ldw = (Nm + kCols - 1) / kCols * kCols;
  const int ldsp = T * P1;
  float* Ws = reinterpret_cast<float*>(smem_f4);  // Nm x ldw, zero-padded columns
  float* Ub = Ws + Nm * ldw;                       // P1 x ldw, zero-padded
  float* s0 = Ub + P1 * ldw;                       // Nm x (T P1): s[k][b P1 + p]
  float* s1 = s0 + Nm * ldsp;

  const int tid = threadIdx.x;
  const int n_cg = ldw / kCols;
  const int j0 = (tid % n_cg) * kCols;
  const int b0 = (tid / n_cg) * kRows;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * T + b0;

  for (int i = tid; i < Nm * ldw; i += blockDim.x) {
    const int k = i / ldw;
    const int j = i - k * ldw;
    Ws[i] = j < Nm ? W[static_cast<size_t>(k) * Nm + j] : 0.0f;
  }
  for (int i = tid; i < P1 * ldw; i += blockDim.x) {
    const int p = i / ldw;
    const int j = i - p * ldw;
    Ub[i] = j < Nm ? U_base[p * Nm + j] : 0.0f;
  }
  if (tid == 0) residual_bits = 0u;

  // Z = U_base, L = 0, s = U_base; padded columns stay at 0 in s
  Tile<P1> t;
#pragma unroll
  for (int r = 0; r < kRows; ++r) t.bound[r] = bounds[row0 + r];
#pragma unroll
  for (int p = 0; p < P1; ++p) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = j0 + c;
      const float v = j < Nm ? U_base[p * Nm + j] : 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        t.z[p][r][c] = v;
        t.lam[p][r][c] = 0.0f;
      }
      if (j < Nm) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) s0[j * ldsp + (b0 + r) * P1 + p] = v;
      }
    }
  }
  __syncthreads();

  int p = 0;      // buffer the next step reads
  int last = -1;  // buffer holding the s that produced the last U
  for (int ch = 0; ch < n_chunks; ++ch) {
    unsigned int m = 0u;
    for (int it = 0; it < chunk_len; ++it) {
      const bool track = stop_tol > 0.0f && it == chunk_len - 1;
      m = admm_step<P1>(t, zu, Ws, Ub, p ? s1 : s0, p ? s0 : s1, Nm, ldw, ldsp, b0, j0,
                        alpha, one_minus_alpha, track);
      last = p;
      p ^= 1;
      __syncthreads();
    }
    if (stop_tol > 0.0f) {
      atomicMax(&residual_bits, m);
      __syncthreads();
      const float res = __uint_as_float(residual_bits);
      __syncthreads();
      if (tid == 0) residual_bits = 0u;
      if (!(res >= stop_tol)) break;
    }
  }

  // U from the s that produced the last iterate (U_base if none ran)
  float acc[P1][kRows][kCols];
  if (last >= 0) {
    product<P1>(acc, Ws, last ? s1 : s0, Nm, ldw, ldsp, b0, j0);
  } else {
#pragma unroll
    for (int q = 0; q < P1; ++q)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[q][r][c] = 0.0f;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = j0 + c;
      if (j < Nm) {
#pragma unroll
        for (int q = 0; q < P1; ++q) {
          const float u = last >= 0 ? add(Ub[q * ldw + j], acc[q][r][c]) : Ub[q * ldw + j];
          U_out[((row0 + r) * Nm + j) * P1 + q] = u;
        }
      }
    }
  }
}

template <int P1, class ZUpdate>
int launch(const void* bounds, const void* U_base, const void* W, void* U_out, int batch,
           int Nm, int T, int chunk_len, int n_chunks, float alpha, float one_minus_alpha,
           float stop_tol, const ZUpdate& zu, cudaStream_t stream) {
  const int ldw = (Nm + kCols - 1) / kCols * kCols;
  const int threads = (T / kRows) * (ldw / kCols);
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (static_cast<size_t>(Nm) * ldw + P1 * ldw +
                                       2 * static_cast<size_t>(Nm) * T * P1);
  cudaError_t err = cudaFuncSetAttribute(sls_admm_kernel<P1, ZUpdate>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sls_admm_kernel<P1, ZUpdate><<<batch / T, threads, smem, stream>>>(
      static_cast<const float*>(bounds), static_cast<const float*>(U_base),
      static_cast<const float*>(W), static_cast<float*>(U_out), Nm, T, chunk_len, n_chunks,
      alpha, one_minus_alpha, stop_tol, zu);
  return static_cast<int>(cudaGetLastError());
}

template <int P1, int NSETS, int Q>
Consensus<P1, NSETS, Q> unpack_consensus(const float* c, int n_iters) {
  // packed as soc_A, cons_rho * soc_A, b_fixed, b_bound, l_inv (row-major)
  Consensus<P1, NSETS, Q> zu;
  for (int i = 0; i < NSETS; ++i)
    for (int r = 0; r < Q; ++r)
      for (int k = 0; k < P1; ++k) zu.a[i][r][k] = *c++;
  for (int i = 0; i < NSETS; ++i)
    for (int r = 0; r < Q; ++r)
      for (int k = 0; k < P1; ++k) zu.rho_a[i][r][k] = *c++;
  for (int i = 0; i < NSETS; ++i)
    for (int r = 0; r < Q; ++r) zu.b_fixed[i][r] = *c++;
  for (int i = 0; i < NSETS; ++i)
    for (int r = 0; r < Q; ++r) zu.b_bound[i][r] = *c++;
  for (int k = 0; k < P1; ++k)
    for (int j = 0; j < P1; ++j) zu.l_inv[k][j] = *c++;
  zu.n_iters = n_iters;
  return zu;
}

}  // namespace

// z_update: 0 = diamond (coeffs = w0, w1, w0^2 + w1^2; p1 = 2), 1 = consensus
// (coeffs packed as in unpack_consensus). The instantiated consensus shapes
// (p1, n_sets, q) are listed in ops/fused_sls.py as CONSENSUS_SHAPES.
extern "C" int sls_admm_launch(const void* bounds, const void* U_base, const void* W,
                               void* U_out, int batch, int Nm, int T, int p1, int chunk_len,
                               int n_chunks, float alpha, float one_minus_alpha,
                               float stop_tol, int z_update, const void* coeffs, int n_sets,
                               int q, int n_cons_iters, void* stream) {
  if (Nm <= 0 || T <= 0 || T % kRows != 0 || batch <= 0 || batch % T != 0 ||
      chunk_len < 0 || n_chunks < 0 || n_cons_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* c = static_cast<const float*>(coeffs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (z_update == 0 && p1 == 2) {
    const Diamond zu{c[0], c[1], c[2]};
    return launch<2>(bounds, U_base, W, U_out, batch, Nm, T, chunk_len, n_chunks, alpha,
                     one_minus_alpha, stop_tol, zu, s);
  }
  if (z_update == 1 && p1 == 2 && n_sets == 2 && q == 3) {
    return launch<2>(bounds, U_base, W, U_out, batch, Nm, T, chunk_len, n_chunks, alpha,
                     one_minus_alpha, stop_tol, unpack_consensus<2, 2, 3>(c, n_cons_iters), s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* sls_admm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
