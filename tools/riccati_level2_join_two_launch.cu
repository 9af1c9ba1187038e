// The level 2 and the join of the blocked Riccati scan as two launches:
// the design that `riccati_join_kernel` in
// ilqr_admm_tpu_torch/csrc/riccati_scan.cu replaced, kept to be timed
// beside it by tools/riccati_join_variants.py.
//
// - riccati_level2_kernel<D>: one block of 128 threads turns the nb block
//   totals r[0] into their exclusive suffixes S_b = r_{b+1}[0] o ... o
//   r_{nb-1}[0]: each thread folds a chunk of ceil(nb / 128), the chunk
//   totals are scanned through shared memory in Hillis-Steele rounds, and
//   each thread walks its chunk again. Only (eta, J) of S_b are written,
//   as (d, nb) and (d*d, nb) slabs.
// - riccati_join_slabs_kernel<D>: one thread an element (j, b): (eta, J)
//   of r[j] o S_b, written as (L, d, nb) and (L, d*d, nb) slabs, which the
//   caller unpacks to the time-major rows the gains read.
//
// Each combine is one thread's chain (`combine`, `combine_head`,
// `combine_value` of the committed source, included below).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//   -Xcompiler -fPIC -shared -I ilqr_admm_tpu_torch/csrc \
//   -o riccati_two_launch.so tools/riccati_level2_join_two_launch.cu

#include "riccati_scan.cu"

namespace {

constexpr int kLevel2Threads = 128;
constexpr int kJoinThreads = 128;

template <int D>
__global__ void __launch_bounds__(kLevel2Threads)
riccati_level2_kernel(Slabs in, float* S_eta, float* S_J, int nb) {
  extern __shared__ float sh[];
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int chunk = (nb + T - 1) / T;
  const int lo = min(t * chunk, nb);
  const int hi = min(lo + chunk, nb);
  // this thread's chunk total
  Elem<D> c = identity<D>();
  for (int i = hi - 1; i >= lo; --i) c = combine<D>(load<D>(in, 0, i, nb), c);
  // the suffix of the later chunks (after the round with offset o, a
  // thread's total covers chunks t .. t + 2o - 1)
  for (int o = 1; o < T; o <<= 1) {
    to_shared<D>(sh, c, t, T);
    __syncthreads();
    if (t + o < T) c = combine<D>(c, from_shared<D>(sh, t + o, T));
    __syncthreads();
  }
  to_shared<D>(sh, c, t, T);
  __syncthreads();
  Elem<D> x = (t + 1 < T) ? from_shared<D>(sh, t + 1, T) : identity<D>();
  // walk the chunk backwards, emitting the exclusive suffixes
  for (int i = hi - 1; i >= lo; --i) {
#pragma unroll
    for (int k = 0; k < D; ++k) S_eta[static_cast<size_t>(k) * nb + i] = x.eta[k];
#pragma unroll
    for (int k = 0; k < D * D; ++k) S_J[static_cast<size_t>(k) * nb + i] = x.J[k];
    if (i > lo) x = combine<D>(load<D>(in, 0, i, nb), x);
  }
}

template <int D>
__global__ void __launch_bounds__(kJoinThreads)
riccati_join_slabs_kernel(Slabs r, const float* __restrict__ S_eta,
                          const float* __restrict__ S_J, float* __restrict__ eta_out,
                          float* __restrict__ J_out, int L, int nb) {
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

template <int D>
int launch_level2(Slabs in, float* S_eta, float* S_J, int nb, cudaStream_t stream) {
  const size_t smem = sizeof(float) * elem_floats<D>() * kLevel2Threads;
  riccati_level2_kernel<D><<<1, kLevel2Threads, smem, stream>>>(in, S_eta, S_J, nb);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_join_slabs(Slabs r, const float* S_eta, const float* S_J, float* eta_out,
                      float* J_out, int L, int nb, cudaStream_t stream) {
  const long long n = static_cast<long long>(L) * nb;
  const int blocks = static_cast<int>((n + kJoinThreads - 1) / kJoinThreads);
  riccati_join_slabs_kernel<D><<<blocks, kJoinThreads, 0, stream>>>(r, S_eta, S_J, eta_out,
                                                                    J_out, L, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// S_eta (d, nb), S_J (d*d, nb) from the local suffix slabs
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

// eta_out (L, d, nb), J_out (L, d*d, nb) from the local suffix slabs and S
extern "C" int riccati_join_slabs_launch(const void* A, const void* b, const void* C,
                                         const void* eta, const void* J, const void* S_eta,
                                         const void* S_J, void* eta_out, void* J_out, int L,
                                         int nb, int d, void* stream) {
  if (bad_shape(d, L, nb)) return static_cast<int>(cudaErrorInvalidValue);
  const Slabs r = slabs(A, b, C, eta, J);
  const float* se = static_cast<const float*>(S_eta);
  const float* sj = static_cast<const float*>(S_J);
  float* eo = static_cast<float*>(eta_out);
  float* jo = static_cast<float*>(J_out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch_join_slabs<1>(r, se, sj, eo, jo, L, nb, s);
    case 2: return launch_join_slabs<2>(r, se, sj, eo, jo, L, nb, s);
    case 3: return launch_join_slabs<3>(r, se, sj, eo, jo, L, nb, s);
    default: return launch_join_slabs<4>(r, se, sj, eo, jo, L, nb, s);
  }
}
