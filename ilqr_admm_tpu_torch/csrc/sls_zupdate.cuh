// The z-updates of the robust SLS-ADMM kernels, shared by csrc/sls_admm.cu
// (W staged in shared memory) and csrc/sls_admm_wide.cu (W streamed from
// L2): the projection of each row (the p1 slabs of one instance at one
// column) onto the row's set.
//
// - `Diamond`: the exact projection onto w0 |du| + w1 |phi| <= bound
//   (p1 = 2).
// - `Consensus<P1, NSETS, Q>`: a fixed-count consensus ADMM onto an
//   intersection of second-order cones, the TPU kernel's trace-time
//   constants passed by value in the kernel's parameters; compiled for
//   (p1, n_sets, q) = (2, 2, 3) and (3, 2, 4), the bench's shapes.
// - `General<H>`: the same consensus ADMM for any shape up to kMaxP1,
//   kMaxSets and kMaxQ, read at run time (p1 = 2 H - 1 or 2 H: the kernels'
//   layouts are built for H slab pairs). Its constants arrive by value in
//   the kernel's parameters (`GeneralParams<H>`) and are copied into
//   shared memory once a block (`stage`); a row's cone state lives in
//   local memory. Built for 8-instance tiles only (each build at 16 took
//   minutes of ptxas for a configuration nothing asks for).
//
// Every z-update uses explicitly rounded f32 operations (no FMA
// contraction) in the order of the plain torch version
// (ops/fused_sls.py::_consensus_project, _diamond_project_slabs), and
// skips zero coefficients as the TPU kernel does at trace time.

#pragma once

#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

constexpr float kEps = 1e-30f;

// the general consensus z-update's limits (ops/fused_sls.py CONSENSUS_MAX)
constexpr int kMaxP1 = 8;
constexpr int kMaxSets = 4;
constexpr int kMaxQ = 9;
constexpr int kMaxCoeffs =
    2 * kMaxSets * kMaxQ * kMaxP1 + 2 * kMaxSets * kMaxQ + kMaxP1 * kMaxP1;

__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// jnp.sign: 0 for +-0, NaN for NaN
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// The specialized z-updates take their constants from the kernel's
// parameters as they are
template <class ZU>
__device__ __forceinline__ const ZU& stage(const ZU& zu) {
  return zu;
}

// Exact projection of rows (a, b) onto {w0 |a| + w1 |b| <= r}.
struct Diamond {
  static constexpr int kP1 = 2;
  static constexpr int kRows = 0;  // projects all of a thread's rows at once
  float w0, w1, den;  // den = w0^2 + w1^2, rounded from f64

  __device__ __forceinline__ constexpr int slabs() const { return kP1; }

  // R rows of one instance, whose bound is r
  template <int R>
  __device__ __forceinline__ void project(const float (&y)[R][2], float r,
                                          float (&out)[R][2]) const {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float aa = fabsf(y[k][0]);
      const float ab = fabsf(y[k][1]);
      const float s = add(mul(w0, aa), mul(w1, ab));
      const bool inside = s <= r;
      const float lam = dvd(sub(s, r), den);
      const float xa = sub(aa, mul(lam, w0));
      const float xb = sub(ab, mul(lam, w1));
      // if one soft-thresholded coordinate would go negative, it is
      // clamped to 0 and the other goes to the diamond's vertex
      const float na = xb < 0.0f ? dvd(r, w0) : (xa < 0.0f ? 0.0f : xa);
      const float nb = xb < 0.0f ? 0.0f : (xa < 0.0f ? dvd(r, w1) : xb);
      out[k][0] = inside ? y[k][0] : mul(sign_of(y[k][0]), na);
      out[k][1] = inside ? y[k][1] : mul(sign_of(y[k][1]), nb);
    }
  }
};

// Consensus ADMM onto {phi : A_i phi + b_i in SOC, i < NSETS}, with
// b_i = b_fixed_i + bound * b_bound_i; the last of a set's Q rows is the
// cone's t. Zero coefficients are skipped, as in the TPU kernel.
template <int P1, int NSETS, int Q>
struct Consensus {
  static_assert(NSETS >= 1 && Q >= 2, "consensus needs a set with a cone of dimension >= 2");
  static constexpr int kP1 = P1;
  // rows whose inner iterations run side by side: two while a row's
  // consensus state (2 NSETS Q floats) is at most 12, else one, so that
  // registers stay bounded
  static constexpr int kRows = 2 * NSETS * Q <= 12 ? 2 : 1;
  float a[NSETS][Q][P1];      // soc_A
  float rho_a[NSETS][Q][P1];  // cons_rho * soc_A
  float b_fixed[NSETS][Q];
  float b_bound[NSETS][Q];
  float l_inv[P1][P1];        // (I + cons_rho sum_i A_i^T A_i)^-1
  int n_iters;

  __device__ __forceinline__ constexpr int slabs() const { return kP1; }

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

  // One inner iteration of one row: the x-update, then each set's SOC
  // projection and dual update.
  __device__ __forceinline__ void inner(const float (&y)[P1], const float (&b)[NSETS][Q],
                                        float (&z)[NSETS][Q], float (&lmb)[NSETS][Q]) const {
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

  // R rows of one instance (bound `bound`, so one set of cone offsets b),
  // kRows at a time: with two, a pair's inner iterations run side by side
  // in each pass of the loop, two independent chains (four spill on the
  // 128 registers a thread has)
  template <int R>
  __device__ __forceinline__ void project(const float (&y)[R][P1], float bound,
                                          float (&out)[R][P1]) const {
    static_assert(R % kRows == 0, "rows come in (column 2 t, column 2 t + 1) pairs");
#pragma unroll
    for (int k0 = 0; k0 < R; k0 += kRows) {
      float yp[kRows][P1], op[kRows][P1];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < P1; ++j) yp[r][j] = y[k0 + r][j];
      project_rows<kRows>(yp, bound, op);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < P1; ++j) out[k0 + r][j] = op[r][j];
    }
  }

  template <int R>
  __device__ __forceinline__ void project_rows(const float (&y)[R][P1], float bound,
                                               float (&out)[R][P1]) const {
    float b[NSETS][Q], z[R][NSETS][Q], lmb[R][NSETS][Q];
#pragma unroll
    for (int i = 0; i < NSETS; ++i)
#pragma unroll
      for (int r = 0; r < Q; ++r)
        b[i][r] = b_bound[i][r] != 0.0f ? add(b_fixed[i][r], mul(b_bound[i][r], bound))
                                        : b_fixed[i][r];
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int i = 0; i < NSETS; ++i)
#pragma unroll
        for (int r = 0; r < Q; ++r) {
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j < P1; ++j)
            if (a[i][r][j] != 0.0f) acc = add(acc, mul(a[i][r][j], y[k][j]));
          z[k][i][r] = add(acc, b[i][r]);
          lmb[k][i][r] = 0.0f;
        }
    for (int it = 0; it < n_iters; ++it) {
#pragma unroll
      for (int k = 0; k < R; ++k) inner(y[k], b, z[k], lmb[k]);
    }
    // one final x-update, so the result reflects the last duals
#pragma unroll
    for (int k = 0; k < R; ++k) x_update(y[k], b, z[k], lmb[k], out[k]);
  }
};

// The general consensus z-update as it runs: the constants in shared
// memory, packed as ops/fused_sls.py::kernel_z_update packs them (soc_A
// (n_sets, q, p1), cons_rho soc_A, b_fixed (n_sets, q), b_bound, l_inv
// (p1, p1)), the shape read at run time. A row at a time; the loops over
// the slabs are unrolled to 2 H with p1 guarding them, the loops over the
// sets' rows run over local memory.
template <int H>
struct General {
  static constexpr int kP1 = 2 * H;
  static constexpr int kRows = 1;
  const float* a;
  const float* rho_a;
  const float* b_fixed;
  const float* b_bound;
  const float* l_inv;
  int p1, n_sets, q, n_iters;

  __device__ __forceinline__ int slabs() const { return p1; }

  __device__ __forceinline__ void x_update(const float (&y)[kP1], const float* b,
                                           const float* z, const float* lmb,
                                           float (&x)[kP1]) const {
    const int nq = n_sets * q;
    float rx[kP1];
#pragma unroll
    for (int k = 0; k < kP1; ++k) {
      float acc = y[k];
      if (k < p1) {
        for (int iq = 0; iq < nq; ++iq)
          if (a[iq * p1 + k] != 0.0f)
            acc = add(acc, mul(rho_a[iq * p1 + k], sub(sub(z[iq], b[iq]), lmb[iq])));
      }
      rx[k] = acc;
    }
#pragma unroll
    for (int k = 0; k < kP1; ++k) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kP1; ++j) {
        if (k < p1 && j < p1) {
          const float c = l_inv[k * p1 + j];
          if (c != 0.0f) acc = add(acc, mul(c, rx[j]));
        }
      }
      x[k] = acc;
    }
  }

  // out of line: one copy a build, called for each row (inlined, the
  // kernels' unrolled epilogues made the builds take minutes)
  __device__ __noinline__ void row(const float (&y)[kP1], float bound, float (&out)[kP1]) const {
    float b[kMaxSets * kMaxQ], z[kMaxSets * kMaxQ], lmb[kMaxSets * kMaxQ];
    const int nq = n_sets * q;
    for (int iq = 0; iq < nq; ++iq) {
      b[iq] = b_bound[iq] != 0.0f ? add(b_fixed[iq], mul(b_bound[iq], bound)) : b_fixed[iq];
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kP1; ++k)
        if (k < p1 && a[iq * p1 + k] != 0.0f) acc = add(acc, mul(a[iq * p1 + k], y[k]));
      z[iq] = add(acc, b[iq]);
      lmb[iq] = 0.0f;
    }
    for (int it = 0; it < n_iters; ++it) {
      float x[kP1];
      x_update(y, b, z, lmb, x);
      for (int i = 0; i < n_sets; ++i) {
        float axb[kMaxQ], w[kMaxQ];
        for (int r = 0; r < q; ++r) {
          const int iq = i * q + r;
          float acc = b[iq];
#pragma unroll
          for (int k = 0; k < kP1; ++k)
            if (k < p1 && a[iq * p1 + k] != 0.0f) acc = add(acc, mul(a[iq * p1 + k], x[k]));
          axb[r] = acc;
          w[r] = add(acc, lmb[iq]);
        }
        // SOC projection of [w_0..w_{q-2} | t] onto ||w|| <= t
        float n2 = mul(w[0], w[0]);
        for (int r = 1; r < q - 1; ++r) n2 = add(n2, mul(w[r], w[r]));
        const float n = sqrtf(n2);
        const float t = w[q - 1];
        const bool inside = n <= t;
        const bool polar = n <= -t;
        const float scale = dvd(mul(0.5f, add(n, t)), add(n, kEps));
        for (int r = 0; r < q; ++r) {
          const int iq = i * q + r;
          float zn;
          if (r < q - 1)
            zn = inside ? w[r] : (polar ? 0.0f : mul(scale, w[r]));
          else
            zn = inside ? t : (polar ? 0.0f : mul(0.5f, add(n, t)));
          lmb[iq] = sub(add(lmb[iq], axb[r]), zn);
          z[iq] = zn;
        }
      }
    }
    // one final x-update, so the result reflects the last duals
    x_update(y, b, z, lmb, out);
  }

  template <int R>
  __device__ __forceinline__ void project(const float (&y)[R][kP1], float bound,
                                          float (&out)[R][kP1]) const {
#pragma unroll
    for (int r = 0; r < R; ++r) row(y[r], bound, out[r]);
  }
};

// The general z-update's constants and shape, by value in the kernel's
// parameters; `stage` copies the constants into shared memory (thread 0,
// at fixed offsets, before the kernel's first barrier) and returns the
// z-update that reads them there.
template <int H>
struct GeneralParams {
  static constexpr int kP1 = 2 * H;
  static constexpr bool kGeneral = true;  // built for 8-instance tiles only
  float c[kMaxCoeffs];
  int p1, n_sets, q, n_iters;
};

template <int H>
__device__ __forceinline__ General<H> stage(const GeneralParams<H>& zp) {
  __shared__ float coeffs[kMaxCoeffs];
  const int n = 2 * zp.n_sets * zp.q * zp.p1 + 2 * zp.n_sets * zp.q + zp.p1 * zp.p1;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kMaxCoeffs; ++i)
      if (i < n) coeffs[i] = zp.c[i];
  }
  const int aq = zp.n_sets * zp.q;
  General<H> zu;
  zu.a = coeffs;
  zu.rho_a = coeffs + aq * zp.p1;
  zu.b_fixed = coeffs + 2 * aq * zp.p1;
  zu.b_bound = zu.b_fixed + aq;
  zu.l_inv = zu.b_bound + aq;
  zu.p1 = zp.p1;
  zu.n_sets = zp.n_sets;
  zu.q = zp.q;
  zu.n_iters = zp.n_iters;
  return zu;
}

// Host side: the packed constants of ops/fused_sls.py::kernel_z_update as
// the z-update structs take them
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

template <int H>
GeneralParams<H> general_params(const float* c, int p1, int n_sets, int q, int n_iters) {
  GeneralParams<H> zp{};
  const int n = 2 * n_sets * q * p1 + 2 * n_sets * q + p1 * p1;
  for (int i = 0; i < n; ++i) zp.c[i] = c[i];
  zp.p1 = p1;
  zp.n_sets = n_sets;
  zp.q = q;
  zp.n_iters = n_iters;
  return zp;
}

// Whether ZP is the general z-update (compiled for 8-instance tiles only)
template <class ZP, class = void>
struct IsGeneral {
  static constexpr bool value = false;
};
template <class ZP>
struct IsGeneral<ZP, decltype(void(ZP::kGeneral))> {
  static constexpr bool value = ZP::kGeneral;
};

// Whether a consensus shape is one the general z-update takes
inline bool general_shape(int p1, int n_sets, int q) {
  return p1 >= 2 && p1 <= kMaxP1 && n_sets >= 1 && n_sets <= kMaxSets && q >= 2 && q <= kMaxQ;
}

}  // namespace
