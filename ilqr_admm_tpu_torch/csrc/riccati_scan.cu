// Blocked time-parallel LQT Riccati scan, for sm_90a.
//
// Replaces the Pallas TPU kernels `_scan_kernel` and `_join_kernel`
// (ilqr_admm_tpu/ops/pallas_riccati.py:145 and :171), and the XLA scan
// over the block totals between them (pallas_riccati.py:267-283).
//
// The elements e_t = (A, b, C, eta, J) of the conditional value functions
// (d x d matrices and d-vectors, d <= 4) compose associatively:
//
//     M   = (I + C1 J2)^{-1}
//     A   = A2 M A1              b = A2 M (b1 + C1 eta2) + b2
//     C   = A2 M C1 A2^T + C2    eta = (M A1)^T (eta2 - J2 b1) + eta1
//     J   = (M A1)^T J2 A1 + J1
//
// and the value functions are the suffixes e_t o ... o e_{N-1}. The N
// elements (padded with identities to nb * L) are cut into nb blocks of L
// consecutive steps; element t = b * L + j sits in lane b at step j of
// component slabs laid out (L, rows, nb), so lanes are the fastest axis.
//
// Both scans below are one pattern, `chunked_suffix`: the T threads of a
// group each own a chunk of ceil(n / T) consecutive elements; a thread
// folds its chunk (carry = e_i o carry, the earlier interval on the left,
// as the JAX package folds), the T chunk totals are scanned in log2(T)
// Hillis-Steele rounds into the suffix of the later chunks, and the
// thread walks its chunk again from that suffix, emitting each suffix.
// Its depth is 2 ceil(n / T) + log2(T) + 1 combines instead of n.
//
// Three kernels:
// - riccati_scan_kernel<D>: one warp a lane (a block each), the lane's L
//   steps in 32 chunks, the chunk totals scanned by warp shuffles; writes
//   every local suffix r[j] (all five components). At L = 79: chunks of
//   3, 11 combines deep instead of 79. Each thread first copies its
//   chunk's elements to shared memory with cp.async (where a lane's
//   elements fit in 96 KB), all its loads in flight at once.
// - riccati_level2_kernel<D>: one block of 128 threads turns the nb block
//   totals r[0] into their exclusive suffixes S_b = r_{b+1}[0] o ... o
//   r_{nb-1}[0], the chunk totals scanned through shared memory. Only
//   (eta, J) of S_b are written: the join reads nothing else of it. A
//   kernel of its own, rather than a prologue of the join: done in plain
//   torch it is about log2(nb) rounds of a combine of some 40 launches
//   each, and as a prologue every join block would have to repeat it or
//   wait for one block; as its own launch the join stays one thread an
//   element.
// - riccati_join_kernel<D>: one thread an element (j, b), no loop:
//   (eta, J) of r[j] o S_b. The TPU kernel loops over j in each lane; on
//   this card the L * nb joins are independent, so they are spread over
//   threads.
//
// The inverse is the adjugate of the max-abs-scaled matrix, as
// `_inv_slab` / `inv_small` compute it (the same cancellation structure,
// so the same accuracy envelope, relative error ~ eps * cond(I + C1 J2)),
// with 1/(det s) formed once; every d x d product is unrolled at compile
// time (D is a template parameter).
//
// What bounds it on an H100: at N = 10,000, nb = 128 (L = 79) the scan
// reads and writes 10,112 x 56 floats (2.26 MB each way) and the join
// reads them again and writes 0.81 MB: a few microseconds of HBM time,
// and about 14 MFLOP of combines, a fraction of a microsecond at the f32
// CUDA-core peak. What the scan takes instead is its dependency chain:
// a combine is ~1 us of dependent arithmetic (the adjugate inverse and a
// dozen d x d products), and one thread a lane ran L = 79 of them in a
// row, with only nb / 32 = 4 warps on the card. The chunked warp scan cuts
// the chain to 2 ceil(L / 32) + 6 combines and spreads the lanes over nb
// warps; the combine itself stays in one thread's registers.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kScanThreads = 32;    // one warp a lane and a block, so the warps spread over SMs
constexpr int kJoinThreads = 128;
constexpr int kLevel2Threads = 128;
constexpr size_t kScanStageBytes = 96 * 1024;  // a lane's elements, staged up to this size

template <int D>
struct Elem {
  float A[D * D];
  float b[D];
  float C[D * D];
  float eta[D];
  float J[D * D];
};

template <int D>
__host__ __device__ constexpr int elem_floats() {
  return 3 * D * D + 2 * D;
}

template <int D>
__device__ __forceinline__ Elem<D> identity() {
  Elem<D> e;
#pragma unroll
  for (int i = 0; i < D * D; ++i) {
    e.A[i] = (i % (D + 1) == 0) ? 1.0f : 0.0f;
    e.C[i] = 0.0f;
    e.J[i] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    e.b[i] = 0.0f;
    e.eta[i] = 0.0f;
  }
  return e;
}

// out = P Q (row-major D x D)
template <int D>
__device__ __forceinline__ void mm(const float* P, const float* Q, float* out) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float acc = P[i * D] * Q[j];
#pragma unroll
      for (int k = 1; k < D; ++k) acc = fmaf(P[i * D + k], Q[k * D + j], acc);
      out[i * D + j] = acc;
    }
}

// out = P^T Q
template <int D>
__device__ __forceinline__ void mtm(const float* P, const float* Q, float* out) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float acc = P[i] * Q[j];
#pragma unroll
      for (int k = 1; k < D; ++k) acc = fmaf(P[k * D + i], Q[k * D + j], acc);
      out[i * D + j] = acc;
    }
}

// out = P Q^T
template <int D>
__device__ __forceinline__ void mmt(const float* P, const float* Q, float* out) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float acc = P[i * D] * Q[j * D];
#pragma unroll
      for (int k = 1; k < D; ++k) acc = fmaf(P[i * D + k], Q[j * D + k], acc);
      out[i * D + j] = acc;
    }
}

// out = P v
template <int D>
__device__ __forceinline__ void mv(const float* P, const float* v, float* out) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float acc = P[i * D] * v[0];
#pragma unroll
    for (int k = 1; k < D; ++k) acc = fmaf(P[i * D + k], v[k], acc);
    out[i] = acc;
  }
}

// out = P^T v
template <int D>
__device__ __forceinline__ void mtv(const float* P, const float* v, float* out) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float acc = P[i] * v[0];
#pragma unroll
    for (int k = 1; k < D; ++k) acc = fmaf(P[k * D + i], v[k], acc);
    out[i] = acc;
  }
}

// Determinant of the (D-1) x (D-1) minor of M without row r and column c.
// r and c are compile-time constants once the callers' loops unroll.
template <int D>
__device__ __forceinline__ float minor_det(const float* M, int r, int c) {
  auto e = [&](int i, int j) { return M[(i + (i >= r)) * D + (j + (j >= c))]; };
  if constexpr (D == 2) {
    return e(0, 0);
  } else if constexpr (D == 3) {
    return e(0, 0) * e(1, 1) - e(0, 1) * e(1, 0);
  } else {
    return e(0, 0) * (e(1, 1) * e(2, 2) - e(1, 2) * e(2, 1)) -
           e(0, 1) * (e(1, 0) * e(2, 2) - e(1, 2) * e(2, 0)) +
           e(0, 2) * (e(1, 0) * e(2, 1) - e(1, 1) * e(2, 0));
  }
}

// out = M^{-1} by the adjugate of M / max|M|, as `inv_small` computes it.
template <int D>
__device__ __forceinline__ void inv_small(const float* M, float* out) {
  if constexpr (D == 1) {
    out[0] = 1.0f / M[0];
  } else {
    float s = fabsf(M[0]);
#pragma unroll
    for (int i = 1; i < D * D; ++i) s = fmaxf(s, fabsf(M[i]));
    const float rs = 1.0f / s;
    float Mh[D * D];
#pragma unroll
    for (int i = 0; i < D * D; ++i) Mh[i] = M[i] * rs;
    float adj[D * D];  // adj[c * D + r] = (-1)^(r + c) minor(r, c)
#pragma unroll
    for (int c = 0; c < D; ++c)
#pragma unroll
      for (int r = 0; r < D; ++r) {
        const float m = minor_det<D>(Mh, r, c);
        adj[c * D + r] = ((r + c) & 1) ? -m : m;
      }
    float det = Mh[0] * adj[0];
#pragma unroll
    for (int j = 1; j < D; ++j) det = fmaf(Mh[j], adj[j * D], det);
    const float scale = 1.0f / (det * s);
#pragma unroll
    for (int i = 0; i < D * D; ++i) out[i] = adj[i] * scale;
  }
}

// M = (I + C1 J2)^{-1} and MA1 = M A1: the part of a combine that the
// join shares with the full one.
template <int D>
__device__ __forceinline__ void combine_head(const Elem<D>& e1, const float* J2, float* M,
                                             float* MA1) {
  float T[D * D];
  mm<D>(e1.C, J2, T);
#pragma unroll
  for (int i = 0; i < D; ++i) T[i * (D + 1)] += 1.0f;
  inv_small<D>(T, M);
  mm<D>(M, e1.A, MA1);
}

// (eta, J) of e1 o e2, from (eta2, J2) of e2 and MA1 = M A1.
template <int D>
__device__ __forceinline__ void combine_value(const Elem<D>& e1, const float* eta2,
                                              const float* J2, const float* MA1, float* eta,
                                              float* J) {
  float w[D], t[D];
  mv<D>(J2, e1.b, t);
#pragma unroll
  for (int i = 0; i < D; ++i) w[i] = eta2[i] - t[i];
  mtv<D>(MA1, w, eta);
#pragma unroll
  for (int i = 0; i < D; ++i) eta[i] += e1.eta[i];
  float J2A1[D * D];
  mm<D>(J2, e1.A, J2A1);
  mtm<D>(MA1, J2A1, J);
#pragma unroll
  for (int i = 0; i < D * D; ++i) J[i] += e1.J[i];
}

// e1 o e2 (e1 the earlier interval).
template <int D>
__device__ __forceinline__ Elem<D> combine(const Elem<D>& e1, const Elem<D>& e2) {
  float M[D * D], MA1[D * D];
  combine_head<D>(e1, e2.J, M, MA1);
  Elem<D> out;
  combine_value<D>(e1, e2.eta, e2.J, MA1, out.eta, out.J);
  float A2M[D * D];
  mm<D>(e2.A, M, A2M);
  mm<D>(A2M, e1.A, out.A);
  float v[D];
  mv<D>(e1.C, e2.eta, v);
#pragma unroll
  for (int i = 0; i < D; ++i) v[i] += e1.b[i];
  mv<D>(A2M, v, out.b);
#pragma unroll
  for (int i = 0; i < D; ++i) out.b[i] += e2.b[i];
  float A2MC1[D * D];
  mm<D>(A2M, e1.C, A2MC1);
  mmt<D>(A2MC1, e2.A, out.C);
#pragma unroll
  for (int i = 0; i < D * D; ++i) out.C[i] += e2.C[i];
  return out;
}

struct Slabs {
  const float* A;
  const float* b;
  const float* C;
  const float* eta;
  const float* J;
};

struct OutSlabs {
  float* A;
  float* b;
  float* C;
  float* eta;
  float* J;
};

// Element at step j of lane `lane`: component row r at (j * rows + r) * nb + lane.
template <int D>
__device__ __forceinline__ Elem<D> load(const Slabs& s, int j, int lane, int nb) {
  Elem<D> e;
  const size_t m0 = static_cast<size_t>(j) * D * D * nb + lane;
  const size_t v0 = static_cast<size_t>(j) * D * nb + lane;
#pragma unroll
  for (int i = 0; i < D * D; ++i) {
    e.A[i] = s.A[m0 + static_cast<size_t>(i) * nb];
    e.C[i] = s.C[m0 + static_cast<size_t>(i) * nb];
    e.J[i] = s.J[m0 + static_cast<size_t>(i) * nb];
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    e.b[i] = s.b[v0 + static_cast<size_t>(i) * nb];
    e.eta[i] = s.eta[v0 + static_cast<size_t>(i) * nb];
  }
  return e;
}

template <int D>
__device__ __forceinline__ void store(const OutSlabs& s, const Elem<D>& e, int j, int lane,
                                      int nb) {
  const size_t m0 = static_cast<size_t>(j) * D * D * nb + lane;
  const size_t v0 = static_cast<size_t>(j) * D * nb + lane;
#pragma unroll
  for (int i = 0; i < D * D; ++i) {
    s.A[m0 + static_cast<size_t>(i) * nb] = e.A[i];
    s.C[m0 + static_cast<size_t>(i) * nb] = e.C[i];
    s.J[m0 + static_cast<size_t>(i) * nb] = e.J[i];
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    s.b[v0 + static_cast<size_t>(i) * nb] = e.b[i];
    s.eta[v0 + static_cast<size_t>(i) * nb] = e.eta[i];
  }
}

// Suffixes of e_0 .. e_{n-1} by the T threads of a group, thread t owning
// chunk t (empty past the end: it holds the identity). load(i) gives e_i;
// later(c), called by every thread of the group with its chunk total c,
// returns the suffix of the chunks after t (the identity for the last);
// emit(i, x) takes x = e_i o ... o e_{n-1} (INCLUSIVE) or e_{i+1} o ...
// o e_{n-1}.
template <int D, bool INCLUSIVE, class Load, class Later, class Emit>
__device__ __forceinline__ void chunked_suffix(int n, int t, int T, const Load& load,
                                               const Later& later, const Emit& emit) {
  const int chunk = (n + T - 1) / T;
  const int lo = min(t * chunk, n);
  const int hi = min(lo + chunk, n);
  // 1. this thread's chunk total e_lo o ... o e_{hi-1}
  Elem<D> c = identity<D>();
  for (int i = hi - 1; i >= lo; --i) c = combine<D>(load(i), c);
  // 2. the suffix of the later chunks' totals
  Elem<D> x = later(c);
  // 3. from there, walk the chunk backwards
  for (int i = hi - 1; i >= lo; --i) {
    if constexpr (INCLUSIVE) {
      x = combine<D>(load(i), x);
      emit(i, x);
    } else {
      emit(i, x);
      if (i > lo) x = combine<D>(load(i), x);
    }
  }
}

template <int D>
__device__ __forceinline__ Elem<D> shfl_down(const Elem<D>& e, int o) {
  Elem<D> out;
#pragma unroll
  for (int i = 0; i < D * D; ++i) {
    out.A[i] = __shfl_down_sync(0xFFFFFFFFu, e.A[i], o);
    out.C[i] = __shfl_down_sync(0xFFFFFFFFu, e.C[i], o);
    out.J[i] = __shfl_down_sync(0xFFFFFFFFu, e.J[i], o);
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    out.b[i] = __shfl_down_sync(0xFFFFFFFFu, e.b[i], o);
    out.eta[i] = __shfl_down_sync(0xFFFFFFFFu, e.eta[i], o);
  }
  return out;
}

// cp.async: a float from global to shared memory without passing through
// registers; the thread waits for its copies with cp_async_wait_all
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Element at step j of lane `lane` copied to dst, component-major (A, b, C,
// eta, J) as `unstage` reads it
template <int D>
__device__ __forceinline__ void stage(const Slabs& s, int j, int lane, int nb, float* dst) {
  const size_t m0 = static_cast<size_t>(j) * D * D * nb + lane;
  const size_t v0 = static_cast<size_t>(j) * D * nb + lane;
  const float* comps[5] = {s.A + m0, s.b + v0, s.C + m0, s.eta + v0, s.J + m0};
  const int rows[5] = {D * D, D, D * D, D, D * D};
#pragma unroll
  for (int c = 0; c < 5; ++c)
#pragma unroll
    for (int i = 0; i < rows[c]; ++i) cp_async_f32(dst++, comps[c] + static_cast<size_t>(i) * nb);
}

template <int D>
__device__ __forceinline__ Elem<D> unstage(const float* src) {
  Elem<D> e;
#pragma unroll
  for (int i = 0; i < D * D; ++i) e.A[i] = *src++;
#pragma unroll
  for (int i = 0; i < D; ++i) e.b[i] = *src++;
#pragma unroll
  for (int i = 0; i < D * D; ++i) e.C[i] = *src++;
#pragma unroll
  for (int i = 0; i < D; ++i) e.eta[i] = *src++;
#pragma unroll
  for (int i = 0; i < D * D; ++i) e.J[i] = *src++;
  return e;
}

// One warp a lane: the lane's L steps in 32 chunks, the chunk totals
// scanned in five rounds of shuffles (after the round with offset o, a
// thread's total covers chunks t .. t + 2o - 1). With `staged`, each
// thread first copies its chunk's elements to shared memory with cp.async,
// all in flight at once, so the fold and the walk read them there rather
// than waiting on a scattered load from L2 before each combine.
template <int D>
__global__ void __launch_bounds__(kScanThreads)
riccati_scan_kernel(Slabs in, OutSlabs out, int L, int nb, int staged) {
  extern __shared__ float sh[];
  constexpr int F = elem_floats<D>();
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  if (staged) {
    const int chunk = (L + kScanThreads - 1) / kScanThreads;
    const int lo = min(t * chunk, L), hi = min(lo + chunk, L);
    for (int j = lo; j < hi; ++j) stage<D>(in, j, lane, nb, sh + j * F);
    cp_async_wait_all();  // a thread reads only the elements it copied
  }
  auto later = [&](Elem<D> c) {
#pragma unroll
    for (int o = 1; o < kScanThreads; o <<= 1) {
      const Elem<D> other = shfl_down<D>(c, o);
      if (t + o < kScanThreads) c = combine<D>(c, other);
    }
    const Elem<D> next = shfl_down<D>(c, 1);
    return t + 1 < kScanThreads ? next : identity<D>();
  };
  chunked_suffix<D, true>(
      L, t, kScanThreads,
      [&](int j) { return staged ? unstage<D>(sh + j * F) : load<D>(in, j, lane, nb); }, later,
      [&](int j, const Elem<D>& x) { store<D>(out, x, j, lane, nb); });
}

// Shared memory holds one element a thread, component-major (f * T + t),
// so a warp's accesses to one component are consecutive words.
template <int D>
__device__ __forceinline__ void to_shared(float* sh, const Elem<D>& e, int t, int T) {
  int f = 0;
#pragma unroll
  for (int i = 0; i < D * D; ++i) sh[(f++) * T + t] = e.A[i];
#pragma unroll
  for (int i = 0; i < D; ++i) sh[(f++) * T + t] = e.b[i];
#pragma unroll
  for (int i = 0; i < D * D; ++i) sh[(f++) * T + t] = e.C[i];
#pragma unroll
  for (int i = 0; i < D; ++i) sh[(f++) * T + t] = e.eta[i];
#pragma unroll
  for (int i = 0; i < D * D; ++i) sh[(f++) * T + t] = e.J[i];
}

template <int D>
__device__ __forceinline__ Elem<D> from_shared(const float* sh, int t, int T) {
  Elem<D> e;
  int f = 0;
#pragma unroll
  for (int i = 0; i < D * D; ++i) e.A[i] = sh[(f++) * T + t];
#pragma unroll
  for (int i = 0; i < D; ++i) e.b[i] = sh[(f++) * T + t];
#pragma unroll
  for (int i = 0; i < D * D; ++i) e.C[i] = sh[(f++) * T + t];
#pragma unroll
  for (int i = 0; i < D; ++i) e.eta[i] = sh[(f++) * T + t];
#pragma unroll
  for (int i = 0; i < D * D; ++i) e.J[i] = sh[(f++) * T + t];
  return e;
}

// in: the level-1 suffix slabs; their step-0 rows are the block totals.
// The chunk totals are scanned through shared memory (after the round
// with offset o, a thread's total covers chunks t .. t + 2o - 1).
template <int D>
__global__ void __launch_bounds__(kLevel2Threads)
riccati_level2_kernel(Slabs in, float* S_eta, float* S_J, int nb) {
  extern __shared__ float sh[];
  const int t = threadIdx.x;
  const int T = blockDim.x;
  auto later = [&](Elem<D> c) {
    for (int o = 1; o < T; o <<= 1) {
      to_shared<D>(sh, c, t, T);
      __syncthreads();
      if (t + o < T) c = combine<D>(c, from_shared<D>(sh, t + o, T));
      __syncthreads();
    }
    to_shared<D>(sh, c, t, T);
    __syncthreads();
    return (t + 1 < T) ? from_shared<D>(sh, t + 1, T) : identity<D>();
  };
  chunked_suffix<D, false>(
      nb, t, T, [&](int i) { return load<D>(in, 0, i, nb); }, later,
      [&](int i, const Elem<D>& x) {
#pragma unroll
        for (int k = 0; k < D; ++k) S_eta[static_cast<size_t>(k) * nb + i] = x.eta[k];
#pragma unroll
        for (int k = 0; k < D * D; ++k) S_J[static_cast<size_t>(k) * nb + i] = x.J[k];
      });
}

template <int D>
__global__ void __launch_bounds__(kJoinThreads)
riccati_join_kernel(Slabs r, const float* __restrict__ S_eta, const float* __restrict__ S_J,
                    float* __restrict__ eta_out, float* __restrict__ J_out, int L, int nb) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= L * nb) return;
  const int j = idx / nb;
  const int lane = idx - j * nb;
  const Elem<D> e1 = load<D>(r, j, lane, nb);
  float eta2[D], J2[D * D];
#pragma unroll
  for (int i = 0; i < D; ++i) eta2[i] = S_eta[static_cast<size_t>(i) * nb + lane];
#pragma unroll
  for (int i = 0; i < D * D; ++i) J2[i] = S_J[static_cast<size_t>(i) * nb + lane];
  float M[D * D], MA1[D * D], eta[D], J[D * D];
  combine_head<D>(e1, J2, M, MA1);
  combine_value<D>(e1, eta2, J2, MA1, eta, J);
  const size_t m0 = static_cast<size_t>(j) * D * D * nb + lane;
  const size_t v0 = static_cast<size_t>(j) * D * nb + lane;
#pragma unroll
  for (int i = 0; i < D; ++i) eta_out[v0 + static_cast<size_t>(i) * nb] = eta[i];
#pragma unroll
  for (int i = 0; i < D * D; ++i) J_out[m0 + static_cast<size_t>(i) * nb] = J[i];
}

Slabs slabs(const void* A, const void* b, const void* C, const void* eta, const void* J) {
  return Slabs{static_cast<const float*>(A), static_cast<const float*>(b),
               static_cast<const float*>(C), static_cast<const float*>(eta),
               static_cast<const float*>(J)};
}

bool bad_shape(int d, int L, int nb) { return d < 1 || d > 4 || L < 1 || nb < 1; }

template <int D>
int launch_scan(Slabs in, OutSlabs out, int L, int nb, cudaStream_t stream) {
  // a lane's elements staged in shared memory where they fit
  const size_t smem = sizeof(float) * elem_floats<D>() * static_cast<size_t>(L);
  const int staged = smem <= kScanStageBytes;
  if (staged && smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(riccati_scan_kernel<D>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  riccati_scan_kernel<D><<<nb, kScanThreads, staged ? smem : 0, stream>>>(in, out, L, nb, staged);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_level2(Slabs in, float* S_eta, float* S_J, int nb, cudaStream_t stream) {
  const size_t smem = sizeof(float) * elem_floats<D>() * kLevel2Threads;
  riccati_level2_kernel<D><<<1, kLevel2Threads, smem, stream>>>(in, S_eta, S_J, nb);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_join(Slabs r, const float* S_eta, const float* S_J, float* eta_out, float* J_out,
                int L, int nb, cudaStream_t stream) {
  const long long n = static_cast<long long>(L) * nb;
  const int blocks = static_cast<int>((n + kJoinThreads - 1) / kJoinThreads);
  riccati_join_kernel<D><<<blocks, kJoinThreads, 0, stream>>>(r, S_eta, S_J, eta_out, J_out,
                                                              L, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int riccati_scan_launch(const void* A, const void* b, const void* C, const void* eta,
                                   const void* J, void* A_out, void* b_out, void* C_out,
                                   void* eta_out, void* J_out, int L, int nb, int d,
                                   void* stream) {
  if (bad_shape(d, L, nb)) return static_cast<int>(cudaErrorInvalidValue);
  const Slabs in = slabs(A, b, C, eta, J);
  const OutSlabs out{static_cast<float*>(A_out), static_cast<float*>(b_out),
                     static_cast<float*>(C_out), static_cast<float*>(eta_out),
                     static_cast<float*>(J_out)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch_scan<1>(in, out, L, nb, s);
    case 2: return launch_scan<2>(in, out, L, nb, s);
    case 3: return launch_scan<3>(in, out, L, nb, s);
    default: return launch_scan<4>(in, out, L, nb, s);
  }
}

extern "C" int riccati_level2_launch(const void* A, const void* b, const void* C,
                                     const void* eta, const void* J, void* S_eta, void* S_J,
                                     int nb, int d, void* stream) {
  if (bad_shape(d, 1, nb)) return static_cast<int>(cudaErrorInvalidValue);
  const Slabs in = slabs(A, b, C, eta, J);
  float* se = static_cast<float*>(S_eta);
  float* sj = static_cast<float*>(S_J);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch_level2<1>(in, se, sj, nb, s);
    case 2: return launch_level2<2>(in, se, sj, nb, s);
    case 3: return launch_level2<3>(in, se, sj, nb, s);
    default: return launch_level2<4>(in, se, sj, nb, s);
  }
}

extern "C" int riccati_join_launch(const void* A, const void* b, const void* C, const void* eta,
                                   const void* J, const void* S_eta, const void* S_J,
                                   void* eta_out, void* J_out, int L, int nb, int d,
                                   void* stream) {
  if (bad_shape(d, L, nb)) return static_cast<int>(cudaErrorInvalidValue);
  const Slabs r = slabs(A, b, C, eta, J);
  const float* se = static_cast<const float*>(S_eta);
  const float* sj = static_cast<const float*>(S_J);
  float* eo = static_cast<float*>(eta_out);
  float* jo = static_cast<float*>(J_out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch_join<1>(r, se, sj, eo, jo, L, nb, s);
    case 2: return launch_join<2>(r, se, sj, eo, jo, L, nb, s);
    case 3: return launch_join<3>(r, se, sj, eo, jo, L, nb, s);
    default: return launch_join<4>(r, se, sj, eo, jo, L, nb, s);
  }
}

extern "C" const char* riccati_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
