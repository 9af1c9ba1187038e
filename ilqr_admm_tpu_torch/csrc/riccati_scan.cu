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
// Two kernels, two launches a pass:
// - riccati_scan_kernel<D>: one warp a lane (a block each), the lane's L
//   steps in 32 chunks (`chunked_suffix`: a thread folds its chunk, the
//   chunk totals are scanned by warp shuffles into the suffix of the later
//   chunks, the thread walks its chunk again from there); writes every
//   local suffix r[j] (all five components). At L = 79: chunks of 3, 11
//   combines deep instead of 79. Each thread first copies its chunk's
//   elements to shared memory with cp.async (where a lane's elements fit
//   in 96 KB), all its loads in flight at once.
// - riccati_join_kernel<D, Cb>: (eta, J) of r[j] o S_b for every step j
//   and lane b, S_b = r_{b+1}[0] o ... o r_{nb-1}[0] the exclusive suffix
//   of the block totals, written time-major as the gains read them: eta
//   (N, d) and J (N, d, d), rows t = b * L + j < N only. A block owns a
//   group of kJoinGroup = 16 consecutive lanes and a tile of jt steps. It
//   copies the tile's r to shared memory with cp.async (a warp's copies of
//   one slab row are consecutive lanes) and, while they fly, computes the
//   S_b of its own lanes as a prologue: (1) the totals of the lanes after
//   the group, each of the 16 combine groups folding a chunk of them,
//   then an ordered pairwise tree over the chunk totals; (2) beside it, in
//   the same four rounds through shared memory, an inclusive
//   Hillis-Steele suffix over the group's own 16 totals; (3) S_b = (the
//   group's suffix after b) o (the later lanes' total). Lanes past nb hold
//   the identity. Every block repeats the level-2 work of its group
//   (O(nb^2 / 16) combines in all), so nothing goes through global memory
//   or a second launch. The outputs are staged in shared memory and
//   written as each lane's contiguous run of rows.
//
// A combine in the join kernel is spread over a group of Dp^2 threads
// (Dp = D rounded up to a power of two: a half-warp at d = 4,
// `GroupCombine`): thread (i, j) holds entry (i, j) of A, C and J and
// entry i of b and eta, and the d x d products exchange operands through
// the group's scratch in shared memory; in the adjugate inverse each
// thread reads the whole matrix and forms its own cofactor. Every entry
// is the same chain of f32 operations as the one-thread `combine` forms
// for it, but for the inverse's two reciprocals: approximate (2 ulp)
// divisions, as IEEE division's slow-path call spilled in this kernel.
// -DRICCATI_JOIN_ONE_THREAD builds the join with one thread a combine
// (`WholeCombine`) instead, and -DRICCATI_JOIN_GROUP=n with n lanes a
// block, for comparison (tools/riccati_join_variants.py).
//
// The inverse is the adjugate of the max-abs-scaled matrix, as
// `_inv_slab` / `inv_small` compute it (the same cancellation structure,
// so the same accuracy envelope, relative error ~ eps * cond(I + C1 J2)),
// with 1/(det s) formed once; every d x d product is unrolled at compile
// time (D is a template parameter). A combine with the identity on
// either side is exact in f32, so identity padding changes no bit.
//
// What bounds it on an H100: at N = 10,000, nb = 128 (L = 79) the scan
// reads and writes 10,112 x 56 floats (2.26 MB each way) and the join
// reads them again and writes 0.81 MB: a few microseconds of HBM time,
// and about 14 MFLOP of combines, a fraction of a microsecond at the f32
// CUDA-core peak. What the kernels take instead is their dependency
// chains: a combine in one thread is ~1 us of dependent arithmetic (the
// adjugate inverse and a dozen d x d products), with few warps on the
// card. The scan cuts the chain to 2 ceil(L / 32) + 6 combines and spreads
// the lanes over nb warps. The join's prologue is ceil((nb - 16) / 16) +
// 2 log2(16) + 1 combines deep and its loop jt joins; a combine spread
// over 16 threads is ~300 instructions a thread, and with a block's 8
// warps issuing them at once the SM's issue rate, not one thread's chain,
// sets its time: fewer lanes a block make a combine cheaper and the
// prologue deeper, and 16 measured fastest.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kScanThreads = 32;    // one warp a lane and a block, so the warps spread over SMs
// lanes a join block: a warp's copies of a slab row coalesce
#ifdef RICCATI_JOIN_GROUP
constexpr int kJoinGroup = RICCATI_JOIN_GROUP;
#else
constexpr int kJoinGroup = 16;
#endif
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

// Determinant of a (D-1) x (D-1) minor, its entries e(i, j).
template <int D, class Entry>
__device__ __forceinline__ float det_minor(const Entry& e) {
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

// Determinant of the minor of M without row r and column c. r and c are
// compile-time constants once the callers' loops unroll.
template <int D>
__device__ __forceinline__ float minor_det(const float* M, int r, int c) {
  return det_minor<D>([&](int i, int j) { return M[(i + (i >= r)) * D + (j + (j >= c))]; });
}

// The same for r and c known only at run time: each entry is selected
// from the four it can be, so M stays in registers.
template <int D>
__device__ __forceinline__ float minor_det_at(const float* M, int r, int c) {
  return det_minor<D>([&](int i, int j) {
    const float top = j >= c ? M[i * D + j + 1] : M[i * D + j];
    const float below = j >= c ? M[(i + 1) * D + j + 1] : M[(i + 1) * D + j];
    return i >= r ? below : top;
  });
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
// emit(i, x) takes x = e_i o ... o e_{n-1}.
template <int D, class Load, class Later, class Emit>
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
    x = combine<D>(load(i), x);
    emit(i, x);
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
  chunked_suffix<D>(
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

// Offsets of the five components in an element's F floats (A, b, C, eta, J)
template <int D>
struct Fields {
  static constexpr int A = 0, b = D * D, C = D * D + D, eta = 2 * D * D + D, J = 2 * D * D + 2 * D;
};

// The slab row of field f (0 .. F-1, component-major) at step j: nb lanes.
template <int D>
__device__ __forceinline__ const float* field_row(const Slabs& s, int f, int j, int nb) {
  constexpr int DD = D * D;
  using Fd = Fields<D>;
  const float* base;
  int row, rows;
  if (f < Fd::b) base = s.A, row = f, rows = DD;
  else if (f < Fd::C) base = s.b, row = f - Fd::b, rows = D;
  else if (f < Fd::eta) base = s.C, row = f - Fd::C, rows = DD;
  else if (f < Fd::J) base = s.eta, row = f - Fd::eta, rows = D;
  else base = s.J, row = f - Fd::J, rows = DD;
  return base + (static_cast<size_t>(j) * rows + row) * nb;
}

// One thread a combine: the element in one thread's registers, the
// arithmetic of `combine`. Exchange slots in shared memory are
// component-major (f * kJoinGroup + q), so a warp's accesses to one field
// are consecutive words.
template <int D>
struct WholeCombine {
  static constexpr int P = 1;  // threads a combine
  static constexpr int kScratch = 0;
  using E = Elem<D>;
  struct V {  // (eta, J) of an element
    float eta[D];
    float J[D * D];
  };

  __device__ WholeCombine(int, float*) {}
  __device__ E unit() const { return identity<D>(); }
  __device__ E read(const Slabs& s, int j, int lane, int nb) const {
    return load<D>(s, j, lane, nb);
  }
  __device__ void put(float* sh, const E& e, int q) const { to_shared<D>(sh, e, q, kJoinGroup); }
  __device__ E get(const float* sh, int q) const { return from_shared<D>(sh, q, kJoinGroup); }
  __device__ V get_value(const float* sh, int q) const {
    V v;
#pragma unroll
    for (int i = 0; i < D; ++i) v.eta[i] = sh[(Fields<D>::eta + i) * kJoinGroup + q];
#pragma unroll
    for (int i = 0; i < D * D; ++i) v.J[i] = sh[(Fields<D>::J + i) * kJoinGroup + q];
    return v;
  }
  __device__ E compose(const E& e1, const E& e2) const { return combine<D>(e1, e2); }
  // (eta, J) of e1 o e2, from e2's (eta, J)
  __device__ V join(const E& e1, const V& e2) const {
    float M[D * D], MA1[D * D];
    combine_head<D>(e1, e2.J, M, MA1);
    V out;
    combine_value<D>(e1, e2.eta, e2.J, MA1, out.eta, out.J);
    return out;
  }
  // v to output row `row` of the staged (rows, D) and (rows, D * D) tiles
  __device__ void put_out(float* o_eta, float* o_J, const V& v, int row) const {
#pragma unroll
    for (int i = 0; i < D; ++i) o_eta[row * D + i] = v.eta[i];
#pragma unroll
    for (int i = 0; i < D * D; ++i) o_J[row * D * D + i] = v.J[i];
  }
};

// D rounded up to a power of two: the side of a combine group's grid
template <int D>
__host__ __device__ constexpr int pad_dim() {
  return D == 3 ? 4 : D;
}

// A combine spread over Dp^2 threads of a warp: thread p = i * Dp + j
// holds entry (i, j) of A, C and J and entry i of b and eta (the same in
// every thread of row i). Threads with i or j >= D (d = 3) are padding:
// they compute what they are given, and no other thread reads them.
// Operands travel through the group's scratch in shared memory: a thread
// stores its entry of a matrix (row-major, or transposed where columns
// are read), the warp syncs, and each thread reads the row or column it
// needs as one vector load (the group's threads share the addresses, so
// a load is one broadcast). Each stage of a combine stores what the next
// reads, behind one __syncwarp on each side. Every entry is the chain of
// f32 operations `combine` forms for it, but for the inverse's two
// reciprocals (see the note at the top).
template <int D>
struct GroupCombine {
  static constexpr int Dp = pad_dim<D>();
  static constexpr int P = Dp * Dp;  // threads a combine
  // floats of a group's scratch: the most one stage stores, padded so two
  // groups of a warp fall on different banks
  static constexpr int kScratch = 6 * P + 2 * Dp + (48 - (6 * P + 2 * Dp) % 32) % 32;
  struct E {
    float A, b, C, eta, J;
  };
  struct V {
    float eta, J;
  };
  struct Vec {
    float v[D];
  };
  int i, j;
  bool valid;
  float* buf;

  __device__ GroupCombine(int p, float* scratch)
      : i(p / Dp), j(p % Dp), valid(i < D && j < D), buf(scratch) {}

  __device__ void sync() const {
    if constexpr (P > 1) __syncwarp();
  }
  // this thread's entry of a matrix at offset o, row-major or transposed;
  // a vector's entry i
  __device__ void store(int o, float x) const {
    if (valid) buf[o + i * Dp + j] = x;
  }
  __device__ void store_t(int o, float x) const {
    if (valid) buf[o + j * Dp + i] = x;
  }
  __device__ void store_v(int o, float x) const {
    if (valid && j == 0) buf[o + i] = x;
  }
  // D floats at offset o (a multiple of Dp)
  __device__ Vec load(int o) const {
    Vec out;
    if constexpr (Dp == 4) {
      const float4 v = *reinterpret_cast<const float4*>(buf + o);
      const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < D; ++k) out.v[k] = w[k];
    } else if constexpr (Dp == 2) {
      const float2 v = *reinterpret_cast<const float2*>(buf + o);
      out.v[0] = v.x;
      out.v[1] = v.y;
    } else {
      out.v[0] = buf[o];
    }
    return out;
  }
  // rows and columns of a stored matrix: X[i][k], X[j][k] (row-major);
  // X[k][j], X[k][i] (transposed)
  __device__ Vec row(int o) const { return load(o + i * Dp); }
  __device__ Vec row_j(int o) const { return load(o + j * Dp); }
  __device__ Vec col(int o) const { return load(o + j * Dp); }
  __device__ Vec col_i(int o) const { return load(o + i * Dp); }
  // the chain of `mm`, `mtm`, `mmt`, `mv`, `mtv` for one entry
  static __device__ float dot(const Vec& a, const Vec& b) {
    float acc = a.v[0] * b.v[0];
#pragma unroll
    for (int k = 1; k < D; ++k) acc = fmaf(a.v[k], b.v[k], acc);
    return acc;
  }

  // entry (i, j) of T^{-1}, as `inv_small`: every thread reads T, forms the
  // scale and its own cofactor adj[i][j] = (-1)^(i+j) minor(j, i); the
  // determinant is row 0's expansion, from the stored adjugate's column 0
  __device__ float inv(float T) const {
    if constexpr (D == 1) {
      return __fdividef(1.0f, T);
    } else {
      sync();
      store(0, T);
      sync();
      float Mh[D * D];
#pragma unroll
      for (int r = 0; r < D; ++r) {
        const Vec v = load(r * Dp);
#pragma unroll
        for (int c = 0; c < D; ++c) Mh[r * D + c] = v.v[c];
      }
      float s = fabsf(Mh[0]);
#pragma unroll
      for (int k = 1; k < D * D; ++k) s = fmaxf(s, fabsf(Mh[k]));
      const float rs = __fdividef(1.0f, s);
#pragma unroll
      for (int k = 0; k < D * D; ++k) Mh[k] *= rs;
      const float m = minor_det_at<D>(Mh, j, i);
      const float adj = ((i + j) & 1) ? -m : m;
      sync();
      store_t(0, adj);
      sync();
      const Vec adj_col0 = load(0);  // adj[k][0]
      float det = Mh[0] * adj_col0.v[0];
#pragma unroll
      for (int k = 1; k < D; ++k) det = fmaf(Mh[k], adj_col0.v[k], det);
      return adj * __fdividef(1.0f, det * s);
    }
  }

  __device__ E unit() const { return E{i == j ? 1.0f : 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}; }
  __device__ E read(const Slabs& s, int step, int lane, int nb) const {
    E e{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const size_t m = (static_cast<size_t>(step) * D * D + i * D + j) * nb + lane;
    const size_t v = (static_cast<size_t>(step) * D + i) * nb + lane;
    if (valid) e.A = s.A[m], e.C = s.C[m], e.J = s.J[m];
    if (i < D) e.b = s.b[v], e.eta = s.eta[v];
    return e;
  }
  __device__ void put(float* sh, const E& e, int q) const {
    using Fd = Fields<D>;
    constexpr int G = kJoinGroup;
    if (valid) {
      sh[(Fd::A + i * D + j) * G + q] = e.A;
      sh[(Fd::C + i * D + j) * G + q] = e.C;
      sh[(Fd::J + i * D + j) * G + q] = e.J;
      if (j == 0) sh[(Fd::b + i) * G + q] = e.b, sh[(Fd::eta + i) * G + q] = e.eta;
    }
  }
  __device__ E get(const float* sh, int q) const {
    using Fd = Fields<D>;
    constexpr int G = kJoinGroup;
    E e{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (valid) {
      e.A = sh[(Fd::A + i * D + j) * G + q];
      e.C = sh[(Fd::C + i * D + j) * G + q];
      e.J = sh[(Fd::J + i * D + j) * G + q];
    }
    if (i < D) e.b = sh[(Fd::b + i) * G + q], e.eta = sh[(Fd::eta + i) * G + q];
    return e;
  }
  __device__ V get_value(const float* sh, int q) const {
    const E e = get(sh, q);
    return V{e.eta, e.J};
  }

  // (eta, J) of e1 o e2 (combine_head, combine_value), and with full the
  // rest of the combine (A, b, C)
  template <bool full>
  __device__ E combine_entries(const E& e1, float A2, float b2, float C2, float eta2,
                               float J2) const {
    constexpr int M0 = 0, M1 = P, M2 = 2 * P, M3 = 3 * P, M4 = 4 * P, M5 = 5 * P;
    constexpr int V0 = 6 * P, V1 = 6 * P + Dp;
    // stage 1: the operands
    sync();
    store(M0, e1.C);
    store_t(M1, e1.C);
    store_t(M2, e1.A);
    store(M3, J2);
    store_t(M4, J2);
    store_v(V0, e1.b);
    if constexpr (full) {
      store(M5, A2);
      store_v(V1, eta2);
    }
    sync();
    const Vec c1_row = row(M0), a1_col = col(M2), j2_row = row(M3), b1 = load(V0);
    const Vec j2_col = col(M4);
    Vec c1_col, a2_row, a2_row_j, eta2_all;
    if constexpr (full) {
      c1_col = col(M1);
      a2_row = row(M5);
      a2_row_j = row_j(M5);
      eta2_all = load(V1);
    }
    float T = dot(c1_row, j2_col);
    if (i == j) T += 1.0f;
    const float w = eta2 - dot(j2_row, b1);
    const float J2A1 = dot(j2_row, a1_col);
    float x = 0.0f;
    if constexpr (full) x = dot(c1_row, eta2_all) + e1.b;
    // stage 2: the inverse
    const float M = inv(T);
    // stage 3: M
    sync();
    store(M0, M);
    if constexpr (full) store_t(M1, M);
    sync();
    const float MA1 = dot(row(M0), a1_col);
    float A2M = 0.0f;
    if constexpr (full) A2M = dot(a2_row, col(M1));
    // stage 4: M A1, w, J2 A1 (and A2 M, x)
    sync();
    store_t(M0, MA1);
    store_t(M1, J2A1);
    store_v(V0, w);
    if constexpr (full) {
      store(M2, A2M);
      store_v(V1, x);
    }
    sync();
    const Vec ma1_col = col_i(M0);
    E out{0.0f, 0.0f, 0.0f, dot(ma1_col, load(V0)) + e1.eta, dot(ma1_col, col(M1)) + e1.J};
    if constexpr (full) {
      const Vec a2m_row = row(M2);
      out.A = dot(a2m_row, a1_col);
      out.b = dot(a2m_row, load(V1)) + b2;
      const float A2MC1 = dot(a2m_row, c1_col);
      // stage 5: A2 M C1
      sync();
      store(M0, A2MC1);
      sync();
      out.C = dot(row(M0), a2_row_j) + C2;
    }
    return out;
  }
  __device__ E compose(const E& e1, const E& e2) const {
    return combine_entries<true>(e1, e2.A, e2.b, e2.C, e2.eta, e2.J);
  }
  __device__ V join(const E& e1, const V& e2) const {
    const E out = combine_entries<false>(e1, 0.0f, 0.0f, 0.0f, e2.eta, e2.J);
    return V{out.eta, out.J};
  }
  __device__ void put_out(float* o_eta, float* o_J, const V& v, int out_row) const {
    if (valid) {
      o_J[out_row * D * D + i * D + j] = v.J;
      if (j == 0) o_eta[out_row * D + i] = v.eta;
    }
  }
};

#ifdef RICCATI_JOIN_ONE_THREAD
template <int D>
using JoinCombine = WholeCombine<D>;
#else
template <int D>
using JoinCombine = GroupCombine<D>;
#endif

// Floats of the join kernel's shared memory at jt steps a block: the
// staged r, two exchange slots, the staged eta and J, the combine groups'
// scratch
template <int D, class Cb>
__host__ __device__ constexpr size_t join_smem_floats(int jt) {
  return static_cast<size_t>(jt + 2) * elem_floats<D>() * kJoinGroup +
         static_cast<size_t>(jt) * kJoinGroup * (D + D * D) +
         static_cast<size_t>(kJoinGroup) * Cb::kScratch;
}

// r: the level-1 suffix slabs (step 0: the block totals). Block
// (blockIdx.x, blockIdx.y) takes lanes 32 x .. 32 x + 31 at steps
// jt y .. jt y + jt - 1, one combine group (Cb::P threads) a lane.
template <int D, class Cb>
__global__ void __launch_bounds__(kJoinGroup * Cb::P)
riccati_join_kernel(Slabs r, float* __restrict__ eta_out, float* __restrict__ J_out, int L,
                    int nb, int N, int jt) {
  using E = typename Cb::E;
  constexpr int G = kJoinGroup, F = elem_floats<D>(), DD = D * D;
  extern __shared__ float sh[];
  const int q = threadIdx.x / Cb::P;
  const int lane0 = blockIdx.x * G;
  const int j0 = blockIdx.y * jt, nj = min(jt, L - j0);
  float* s_in = sh;                  // the tile's r, step k at k * F * G
  float* s_x = s_in + jt * F * G;    // exchange slots of the tree
  float* s_t = s_x + F * G;          // and of the group's suffix
  float* s_eta = s_t + F * G;        // outputs, row q * nj + k
  float* s_J = s_eta + jt * G * D;
  const Cb cb(threadIdx.x % Cb::P, s_J + jt * G * DD + q * Cb::kScratch);

  // 1. the tile's local suffixes to shared memory, in flight during 2
  for (int idx = threadIdx.x; idx < nj * F * G; idx += blockDim.x) {
    const int qq = idx % G, kf = idx / G;
    if (lane0 + qq < nb)
      cp_async_f32(s_in + idx, field_row<D>(r, kf % F, j0 + kf / F, nb) + lane0 + qq);
  }

  // 2. S_b of this block's lanes. x: the fold of chunk q of the later
  // lanes' totals (from its last, the identity past nb), then the ordered
  // tree over the chunks (after the round with offset o, x of q = 0 mod 2o
  // covers chunks q .. q + 2o - 1). t: lane q's total, then the group's
  // inclusive suffix (after the round with offset o, t covers lanes q ..
  // q + 2o - 1 of the group). A warp composes where any of its combine
  // groups has to, all its threads together, so no __syncwarp diverges;
  // a group with nothing to do in a round keeps its element.
  const int later0 = lane0 + G;
  const int chunk = (max(nb - later0, 0) + G - 1) / G;
  const int lo = later0 + q * chunk;
  auto total = [&](int lane) { return lane < nb ? cb.read(r, 0, lane, nb) : cb.unit(); };
  E x = chunk > 0 ? total(lo + chunk - 1) : cb.unit();
  for (int k = chunk - 2; k >= 0; --k) x = cb.compose(total(lo + k), x);
  E t = total(lane0 + q);
  for (int o = 1; o < G; o <<= 1) {
    cb.put(s_x, x, q);
    cb.put(s_t, t, q);
    __syncthreads();
    const int src = min(q + o, G - 1);
    const E xo = cb.get(s_x, src), to = cb.get(s_t, src);
    __syncthreads();
    const bool tree = q % (2 * o) == 0 && q + o < G, scan = q + o < G;
    if (__any_sync(__activemask(), tree)) {
      const E x2 = cb.compose(x, xo);
      if (tree) x = x2;
    }
    if (__any_sync(__activemask(), scan)) {
      const E t2 = cb.compose(t, to);
      if (scan) t = t2;
    }
  }
  cb.put(s_x, x, q);
  cb.put(s_t, t, q);
  __syncthreads();
  const E after = cb.get(s_t, min(q + 1, G - 1));
  const typename Cb::V S = cb.join(q + 1 < G ? after : cb.unit(), cb.get_value(s_x, 0));

  // 3. the joins, staged as each lane's run of output rows
  cp_async_wait_all();
  __syncthreads();
  for (int k = 0; k < nj; ++k)
    cb.put_out(s_eta, s_J, cb.join(cb.get(s_in + k * F * G, q), S), q * nj + k);
  __syncthreads();

  // 4. lane b's rows b * L + j0 .. b * L + j0 + nj - 1 (those < N) are
  // consecutive in both outputs
  for (int idx = threadIdx.x; idx < G * nj * DD; idx += blockDim.x) {
    const int qq = idx / (nj * DD), rem = idx - qq * nj * DD;
    const long long row0 = static_cast<long long>(lane0 + qq) * L + j0;
    if (lane0 + qq < nb && row0 + rem / DD < N) J_out[row0 * DD + rem] = s_J[idx];
  }
  for (int idx = threadIdx.x; idx < G * nj * D; idx += blockDim.x) {
    const int qq = idx / (nj * D), rem = idx - qq * nj * D;
    const long long row0 = static_cast<long long>(lane0 + qq) * L + j0;
    if (lane0 + qq < nb && row0 + rem / D < N) eta_out[row0 * D + rem] = s_eta[idx];
  }
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
int launch_join(Slabs r, float* eta_out, float* J_out, int L, int nb, int N, int jt,
                cudaStream_t stream) {
  using Cb = JoinCombine<D>;
  const size_t smem = sizeof(float) * join_smem_floats<D, Cb>(jt);
  const int tiles = (L + jt - 1) / jt;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(riccati_join_kernel<D, Cb>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((nb + kJoinGroup - 1) / kJoinGroup, tiles);
  riccati_join_kernel<D, Cb><<<grid, kJoinGroup * Cb::P, smem, stream>>>(r, eta_out, J_out, L,
                                                                          nb, N, jt);
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

// eta_out (N, d) and J_out (N, d, d): rows t = b * L + j < N of (eta, J) of
// r[j] o S_b; (L - 1) * nb < N <= L * nb, jt steps a block; group: the
// lanes a block the caller expects (kJoinGroup)
extern "C" int riccati_join_launch(const void* A, const void* b, const void* C, const void* eta,
                                   const void* J, void* eta_out, void* J_out, int L, int nb,
                                   int N, int d, int jt, int group, void* stream) {
  if (bad_shape(d, L, nb) || jt < 1 || group != kJoinGroup ||
      N <= (L - 1) * static_cast<long long>(nb) || N > L * static_cast<long long>(nb))
    return static_cast<int>(cudaErrorInvalidValue);
  const Slabs r = slabs(A, b, C, eta, J);
  float* eo = static_cast<float*>(eta_out);
  float* jo = static_cast<float*>(J_out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch_join<1>(r, eo, jo, L, nb, N, jt, s);
    case 2: return launch_join<2>(r, eo, jo, L, nb, N, jt, s);
    case 3: return launch_join<3>(r, eo, jo, L, nb, N, jt, s);
    default: return launch_join<4>(r, eo, jo, L, nb, N, jt, s);
  }
}

extern "C" const char* riccati_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
