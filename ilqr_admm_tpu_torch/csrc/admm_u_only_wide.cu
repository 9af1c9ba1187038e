// Fused box-constrained LQT-ADMM fleet, control bounds only, at widths
// where W_u does not fit in a block's shared memory, for sm_90a.
//
// The wide route of the Pallas TPU kernel `_admm_kernel_u_only`
// (ilqr_admm_tpu/ops/pallas_admm.py:90), beside csrc/admm_u_only.cu,
// which stages W_u whole (64 Nm^2 / 8^2 floats: 1 MiB at the Nm = 512 of
// benchmarks/bench_wide_certified.py, against a block's 227 KB). The loop
// is the same: each CUDA block owns one tile of T instances and runs the
// whole ADMM loop on it,
//
//     s     = z - lambda
//     c     = s @ W_u (refresh), or c += (s - s_prev) @ W_u (delta)
//     u_hat = u_base + c
//     z     = clip(alpha u_hat + (1 - alpha) z + lambda, lo, hi)
//     lambda= (lambda + u_hat) - z
//
// then x = x_base + s @ W_x once, from the s that produced the last u_hat.
// With refresh_every = r > 1 the first iteration of each block of r sets c
// in 3xTF32 and the others add the delta product in one TF32 pass; the
// polish tail and, with early exit, each chunk's last iteration set c in
// 6xTF32, as the TPU kernel schedules its products.
//
// What bounds it on an H100: the bench row (B = 8192, Nm = 512, 100
// iterations, r = 8) is 2 Nm^2 B = 4.3e9 FLOP an iteration. As 3xTF32
// refreshes, one-pass deltas and a 6xTF32 tail that is ~1.3 ms of the
// 495 TFLOP/s dense TF32 peak. W_u is read by every block every
// iteration: 1 MiB x 256 blocks x ~100 iterations = ~27 GB a solve from
// L2 (W_u and W_x, 3 MiB, stay resident in the 50 MB L2), which at a few
// TB/s of L2 bandwidth is several ms: the L2 stream, not the tensor cores,
// sets this design's time.
//
// The design (a simple one; splitting W_u over a thread-block cluster
// through distributed shared memory would cut the L2 stream by the
// cluster's size):
// - T = 32 instances a block (two m16 row tiles) at Nm <= 512, T = 16 (one)
//   at Nm <= 1,024. Shared memory holds two s buffers (group-major,
//   `a_pos`), lambda and the bounds: 200,704 B at Nm = 512, T = 32. A
//   larger tile would halve the L2 stream, but two s buffers of 64
//   instances are 256 KB.
// - Warp w owns pairs PW w .. PW w + PW - 1 of W_u's n-tiles (PW = 2 at
//   T = 32, 4 at T = 16) for all the tile's row tiles, over the whole k
//   range: 32 accumulators a thread, and each W_u block is read by one
//   warp of the block, so W_u's B fragments go from L2 to registers
//   (`pair_pack` storage: a lane's 16-byte load, 512 contiguous bytes a
//   warp) with nothing to share through shared memory. 16 warps at Nm =
//   512.
// - With r > 1, c stays in the accumulators across iterations; the delta
//   reads s_k and s_k-1 from the two buffers, so an iteration has two
//   barriers (every warp has read s_k-1 before s_k+1 overwrites it). With
//   r = 1 one barrier, and each pair's product is followed by its update,
//   so only one pair's c is live at a time.
// - lambda lives in shared memory in the accumulator layout (each thread
//   its own words); u_base is re-read from device memory (L2) every
//   iteration; with over-relaxation z lives in zu_out, in device memory.
// - Padded columns (Nm up to a multiple of 8) get u_base = lo = hi = 0 and
//   zero operator columns, so they stay 0; early exit, the residual words
//   and the explicitly rounded f32 updates are those of admm_u_only.cu.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tf32x3.cuh"

// k-steps a product chains on the tensor cores before it adds the chunk's
// sum to its total in f32 (`product`'s KC), and k-steps in flight;
// tools/admm_u_only_wide_variants.py builds and times other values
#ifndef WIDE_KC
#define WIDE_KC 8
#endif
#ifndef WIDE_UNROLL
#define WIDE_UNROLL 2
#endif

namespace {

constexpr int kMaxWarps = 16;
constexpr int KC = WIDE_KC;
constexpr int UNROLL = WIDE_UNROLL;

struct Problem {
  const float* u_base;
  const float* x_base;
  const float* ops_f;  // W_u's then W_x's blocks (pair_pack storage)
  const int* ops_i;    // their pair tables: (offset, klo, khi, nb) rows
  const float* lo;
  const float* hi;
  float* x_out;
  float* u_out;
  float* zu_out;
  int Nm, Nd, chunk_len, n_chunks, n_tail, refresh_every;
  float alpha, one_minus_alpha, stop_tol;
};

// T = 16 MT instances a block; PW pairs of W_u's n-tiles a warp
template <int MT, bool RELAX, bool DELTA>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) admm_u_only_wide_kernel(Problem P) {
  constexpr int T = 16 * MT;
  constexpr int PW = 4 / MT;
  constexpr int LDA = 8 * T;
  extern __shared__ float4 smem_f4[];
  __shared__ unsigned int residual[3];
  const int n1 = (P.Nm + 7) / 8, n_pairs = (n1 + 1) / 2;
  float* s0 = reinterpret_cast<float*>(smem_f4);  // two s buffers, group-major
  float* s1 = s0 + T * 8 * n1;
  float* lam_s = s1 + T * 8 * n1;  // lambda: element i of (pair, n, mt) at 32 index + lane
  float* lo = lam_s + 16 * T * n_pairs;  // the bounds, zero-padded to 8 n1
  float* hi = lo + 8 * n1;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * T;
  for (int i = tid; i < 8 * n1; i += blockDim.x) {
    lo[i] = i < P.Nm ? P.lo[i] : 0.0f;
    hi[i] = i < P.Nm ? P.hi[i] : 0.0f;
  }
  if (tid < 3) residual[tid] = 0u;

  auto lam_at = [&](int pr, int n, int mt, int i) -> float& {
    return lam_s[(((pr * 2 + n) * MT + mt) * 4 + i) * 32 + lane];
  };

  // z0 = u_base, lambda0 = 0, s0 = u_base
#pragma unroll
  for (int p = 0; p < PW; ++p) {
    const int pr = PW * warp + p;
    if (pr >= n_pairs) continue;
    const int nb = P.ops_i[4 * pr + 3];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (n >= nb) continue;
      const int c0 = 8 * (2 * pr + n);
      float ub[MT][4], zero[MT][4];
      load_frag<MT>(P.u_base, row0, c0, P.Nm, g, t, ub);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          zero[mt][i] = 0.0f;
          lam_at(pr, n, mt, i) = 0.0f;
        }
      store_piece_s<LDA, MT>(s0, c0, g, t, ub, zero);
      if (RELAX || P.chunk_len * P.n_chunks + P.n_tail == 0)
        store_frag<MT>(P.zu_out, row0, c0, P.Nm, g, t, ub);
      if (P.chunk_len * P.n_chunks + P.n_tail == 0)  // no iterations: u = z = u_base
        store_frag<MT>(P.u_out, row0, c0, P.Nm, g, t, ub);
    }
  }
  __syncthreads();  // the bounds and s0 staged

  // c[p]: the running correction of the warp's p-th pair, in the
  // accumulator layout (kept across iterations with DELTA)
  float c[PW][2][MT][4];

  // c[p] from s_in (s_prev: the s before it). kind 0: c = s W_u in 3xTF32;
  // 1: c += (s - s_prev) W_u in one TF32 pass; 2: c = s W_u in 6xTF32
  auto product_pair = [&](int p, const float* s_in, const float* s_prev, int kind) {
    const int* row = P.ops_i + 4 * (PW * warp + p);
    const float* b = P.ops_f + row[0];
    if (kind == 2) {
      product_nb<MT, 1, LDA, true, KC>(c[p], row[3], s_in, b, row[1], row[2], lane, g, t);
    } else if (!DELTA || kind == 0) {
      product_nb<MT, UNROLL, LDA, false, KC>(c[p], row[3], s_in, b, row[1], row[2], lane, g,
                                              t);
    } else {
      float d[2][MT][4];
      product1_nb<MT, UNROLL, LDA>(d, row[3], s_in, s_prev, b, row[1], row[2], lane, g, t);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) c[p][n][mt][i] = add(c[p][n][mt][i], d[n][mt][i]);
    }
  };

  // The rest of the iteration for the p-th pair from c[p]: u_hat, the box
  // and dual updates, s into s_out. out: store u and z; test: fold
  // max |u_hat - z| into m
  auto finish_pair = [&](int p, float* s_out, bool out, bool test, unsigned int& m) {
    const int pr = PW * warp + p;
    const int nb = P.ops_i[4 * pr + 3];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (n >= nb) continue;
      const int c0 = 8 * (2 * pr + n);
      float v[MT][4], z[MT][4], lam[MT][4];
      load_frag<MT>(P.u_base, row0, c0, P.Nm, g, t, v);
      if constexpr (RELAX) load_frag<MT>(P.zu_out, row0, c0, P.Nm, g, t, z);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[mt][i] = add(v[mt][i], c[p][n][mt][i]);
          lam[mt][i] = lam_at(pr, n, mt, i);
        }
      box_update<MT, RELAX>(v, z, lam, lo, hi, c0 + 2 * t, P.alpha, P.one_minus_alpha);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) lam_at(pr, n, mt, i) = lam[mt][i];
      store_piece_s<LDA, MT>(s_out, c0, g, t, z, lam);
      if (RELAX || out) store_frag<MT>(P.zu_out, row0, c0, P.Nm, g, t, z);
      if (out) store_frag<MT>(P.u_out, row0, c0, P.Nm, g, t, v);
      if (test) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            m = max(m, __float_as_uint(fabsf(sub(v[mt][i], z[mt][i]))));
      }
    }
  };

  // One iteration from s_in (s_prev: the s before it, in s_out's buffer)
  // into s_out. With DELTA every warp's products come first, then a
  // barrier (every warp has read s_prev before s_out overwrites it), then
  // the updates, and c[p] lives on; without it each pair's product is
  // followed by its update. test: fold max |u_hat - z| into word
  // `test - 1` of the residual
  auto iterate = [&](const float* s_in, float* s_out, int kind, bool out, int test) {
    unsigned int m = 0u;
    if constexpr (DELTA) {
#pragma unroll
      for (int p = 0; p < PW; ++p)
        if (PW * warp + p < n_pairs) product_pair(p, s_in, s_out, kind);
      __syncthreads();
#pragma unroll
      for (int p = 0; p < PW; ++p)
        if (PW * warp + p < n_pairs) finish_pair(p, s_out, out, test, m);
    } else {
#pragma unroll
      for (int p = 0; p < PW; ++p) {
        if (PW * warp + p >= n_pairs) continue;
        product_pair(p, s_in, s_out, kind);
        finish_pair(p, s_out, out, test, m);
      }
    }
    if (test) {
      // max over non-negative floats as unsigned bits; a NaN residual
      // sorts above +inf and, like the JAX while_loop test, stops the tile
#pragma unroll
      for (int d = 16; d > 0; d /= 2) m = max(m, __shfl_xor_sync(0xFFFFFFFFu, m, d));
      if (lane == 0) atomicMax(residual + test - 1, m);
      if (threadIdx.x == 0) residual[test % 3] = 0u;
    }
  };

  const bool early_exit = P.stop_tol > 0.0f;
  int p = 0;                 // buffer the next iteration reads
  const float* s_last = s0;  // the s that produced the last u_hat
  for (int ch = 0; ch < P.n_chunks; ++ch) {
    for (int it = 0; it < P.chunk_len; ++it) {
      const bool chunk_end = it == P.chunk_len - 1;
      const float* s_in = p ? s1 : s0;
      float* s_out = p ? s0 : s1;
      const int kind = early_exit && chunk_end ? 2 : (DELTA && it % P.refresh_every ? 1 : 0);
      iterate(s_in, s_out, kind, P.n_tail == 0 && chunk_end,
              early_exit && chunk_end ? ch % 3 + 1 : 0);
      s_last = s_in;
      p ^= 1;
      __syncthreads();
    }
    if (early_exit && !(__uint_as_float(residual[ch % 3]) >= P.stop_tol)) break;
  }
  for (int it = 0; it < P.n_tail; ++it) {
    const float* s_in = p ? s1 : s0;
    float* s_out = p ? s0 : s1;
    iterate(s_in, s_out, 2, it == P.n_tail - 1, 0);
    s_last = s_in;
    p ^= 1;
    __syncthreads();
  }

  // x = x_base + s W_x: W_x's pairs of n-tiles over all the tile's row
  // tiles, dealt to the warps in turn; W_x's blocks come from L2
  const int n2 = (P.Nd + 7) / 8, n_pairs_x = (n2 + 1) / 2;
  for (int px = warp; px < n_pairs_x; px += blockDim.x / 32) {
    const int* rx = P.ops_i + 4 * (n_pairs + px);
    float acc[2][MT][4];
    product_nb<MT, 1, LDA, false, KC>(acc, rx[3], s_last, P.ops_f + rx[0], rx[1], rx[2], lane,
                                      g, t);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (n >= rx[3]) continue;
      const int c0 = 8 * (2 * px + n);
      float v[MT][4];
      load_frag<MT>(P.x_base, row0, c0, P.Nd, g, t, v);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) v[mt][i] = add(v[mt][i], acc[n][mt][i]);
      store_frag<MT>(P.x_out, row0, c0, P.Nd, g, t, v);
    }
  }
}

}  // namespace

// The arguments of admm_u_only_launch (csrc/admm_u_only.cu); T 16 or 32.
extern "C" int admm_u_only_wide_launch(const void* u_base, const void* x_base, const void* ops_f,
                                       const void* ops_i, const void* lo, const void* hi,
                                       void* x_out, void* u_out, void* zu_out, int batch, int Nm,
                                       int Nd, int T, int chunk_len, int n_chunks, int n_tail,
                                       int refresh_every, float alpha, float one_minus_alpha,
                                       float stop_tol, void* stream) {
  if (Nm <= 0 || Nd <= 0 || (T != 16 && T != 32) || batch <= 0 || batch % T != 0 ||
      chunk_len < 0 || n_chunks < 0 || n_tail < 0 || refresh_every < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int MT = T / 16, PW = 4 / MT;
  const int n1 = (Nm + 7) / 8, n_pairs = (n1 + 1) / 2;
  const int warps = (n_pairs + PW - 1) / PW;
  if (warps > kMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  const bool relax = alpha != 1.0f, delta = refresh_every > 1;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(T) * 8 * n1 +
                                       16 * static_cast<size_t>(T) * n_pairs + 16 * n1);
  Problem P{static_cast<const float*>(u_base), static_cast<const float*>(x_base),
            static_cast<const float*>(ops_f), static_cast<const int*>(ops_i),
            static_cast<const float*>(lo), static_cast<const float*>(hi),
            static_cast<float*>(x_out), static_cast<float*>(u_out), static_cast<float*>(zu_out),
            Nm, Nd, chunk_len, n_chunks, n_tail, refresh_every, alpha, one_minus_alpha,
            stop_tol};
  using Kernel = void (*)(Problem);
  // [T / 32 (0, 1 for 16, 32)][relax][delta]
  static const Kernel kernels[2][2][2] = {
      {{admm_u_only_wide_kernel<1, false, false>, admm_u_only_wide_kernel<1, false, true>},
       {admm_u_only_wide_kernel<1, true, false>, admm_u_only_wide_kernel<1, true, true>}},
      {{admm_u_only_wide_kernel<2, false, false>, admm_u_only_wide_kernel<2, false, true>},
       {admm_u_only_wide_kernel<2, true, false>, admm_u_only_wide_kernel<2, true, true>}}};
  const Kernel kernel = kernels[T / 32][relax][delta];
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch / T, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
