// Fused box-constrained LQT-ADMM fleet, control bounds only, for sm_90a.
//
// Replaces the Pallas TPU kernel `_admm_kernel_u_only`
// (ilqr_admm_tpu/ops/pallas_admm.py:90) where W_u fits in a block's shared
// memory (Nm <= 224; csrc/admm_u_only_wide.cu streams it from L2 beyond).
// Each CUDA block owns one tile of `T` instances and runs the whole ADMM
// loop on it without leaving the SM:
//
//     s     = z - lambda                  (the regularization target)
//     c     = s @ W_u                     (W_u = (Rr l_inv)^T, Nm x Nm)
//     u_hat = u_base + c
//     z     = clip(alpha u_hat + (1 - alpha) z + lambda, lo, hi)
//     lambda= (lambda + u_hat) - z
//
// and, once after the loop, x = x_base + s @ W_x from the s that produced
// the last u_hat. Warm start z0 = u_base, lambda0 = 0.
//
// What bounds it on an H100: one solve at the bench size (B = 16384,
// Nm = 100, Nd = 200, 100 iterations) is 2 Nm^2 B iters = 3.3e10 FLOP of
// f32-accurate products against ~46 MB of iterate traffic: compute bound.
// As three TF32 products that is 0.20 ms at the 495 TFLOP/s dense TF32
// peak (0.49 ms in f32 on the CUDA cores); `mma.sync`, which this kernel
// issues, reaches ~260 TFLOP/s on the card (tools/mma_sync_bench.cu).
//
// What the design does about it:
// - The products run on the tensor cores as warp-level
//   `mma.sync.m16n8k8`, instances as M, u columns as N, the reduction as K
//   (helpers in csrc/tf32x3.cuh, shared with csrc/admm_box.cu). The main
//   iterations take 3xTF32 (the counterpart of the TPU's bf16x3 `_dot3`);
//   the `polish_iters` tail and, with early exit, the last iteration of
//   each chunk, whose residual is the exit test, take 6xTF32 (the
//   counterpart of `_dot6`), as the TPU kernel schedules its products.
//   The x product after the loop is 3xTF32, as there.
// - Delta products (refresh_every = r > 1, a separate build, DELTA): the
//   first iteration of each block of r sets c in 3xTF32 and the r - 1
//   others add (s - s_prev) @ W_u in one TF32 pass, the TPU kernel's
//   c += bf16(s - s_prev) @ Wu_hi; c stays in the accumulators from one
//   iteration to the next, and s rotates through three buffers, so an
//   iteration still has one barrier (it reads s_k and s_k-1 and writes
//   s_k+1 over s_k-2). The r = 1 builds are the code they were before.
// - W_u lives in shared memory as 8 x 8 blocks in B-fragment order, the
//   n-tiles in interleaved pairs (`pair_pack` in ops/fused_admm.py); W_x
//   in the same storage is read from device memory (L2) once, after the
//   loop.
// - s goes to shared memory group-major (`a_pos`), double buffered (triple
//   with delta products), so an iteration has one barrier and every
//   inner-loop address is a base plus a constant.
// - Work: a warp owns one piece, an output pair of n-tiles (16 u columns)
//   for two m-tiles (32 instances), or the last single n-tile for one
//   m-tile, over the whole k range: no partial sums change hands. At T =
//   64 and Nm = 100 that is 12 pair pieces and 4 single ones, 16 warps;
//   warp w runs on sub-partition w % 4, so in that order each
//   sub-partition carries three pairs and one single: equal work.
// - z, lambda and u_base stay in registers in the accumulator layout
//   (without over-relaxation z is not kept from one iteration to the
//   next; with it, the two-m-tile pieces keep z in shared memory and
//   re-read u_base from L1),
//   and the outputs are stored from there at the last iteration. Every
//   build is spill-free: a spill cost admm_box 28% on the card.
// - Padded columns (Nm up to a multiple of 8) get u_base = lo = hi = 0
//   and zero operator columns, so they stay 0 and need no mask.
// - Per-tile early exit: after each chunk the block reduces
//   max |u_hat - z| over its tile and leaves the main phase below
//   `stop_tol`; the tail (`polish`) iterations always run.
// - The clip and dual updates use explicitly rounded f32 operations (no
//   FMA contraction), as the plain torch version rounds them.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int kMaxWarps = 16;  // four a sub-partition, 128 registers a thread

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

// The whole solve of one warp's piece: m-tiles m0..m0 + MW - 1 of the
// block's T = 16 MT instances, the nb n-tiles of pair row `pr` of W_u's
// table. Every warp runs the same sequence of barriers. `residual` has
// three words: chunk ch folds its max into word ch % 3 and clears word
// (ch + 1) % 3, whose last readers have passed a barrier since. DELTA:
// refresh_every > 1, so c = s W_u stays in this thread's accumulators
// from one iteration to the next and s rotates through three buffers
// (s2 unused otherwise).
template <int MT, int MW, bool RELAX, bool DELTA>
__device__ __forceinline__ void solve(const Problem P, const float* ops, float* s0, float* s1,
                                      float* s2, const float* lo, const float* hi,
                                      float* zslots, unsigned int* residual, int pr, int m0) {
  constexpr int T = 16 * MT;
  constexpr int LDA = 8 * T;
  constexpr int MX = MT >= 2 ? 2 : 1;  // m-tiles of an x-product piece
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int* row = P.ops_i + 4 * pr;
  const int off = row[0], klo = row[1], khi = row[2], nb = row[3];
  const int n0 = 2 * pr;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * T + 16 * m0;
  const float* b = ops + off;
  const int a_off = 16 * m0 * 8;  // the piece's first row in an A buffer
  // Over-relaxation keeps z from one iteration to the next; to stay
  // within 128 registers its two-m-tile pieces keep z in this thread's
  // slots of shared memory and re-read u_base from device memory (L1)
  constexpr bool kSlots = RELAX && MW == 2;
  float* zslot = zslots + 16 * 32 * warp + lane;  // element e at zslot[32 e]

  float ub[2][MW][4], lam[2][MW][4], z[2][MW][4];
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    if (n < nb) {
      load_frag<MW>(P.u_base, row0, 8 * (n0 + n), P.Nm, g, t, ub[n]);
    } else {
#pragma unroll
      for (int mt = 0; mt < MW; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) ub[n][mt][i] = 0.0f;
    }
#pragma unroll
    for (int mt = 0; mt < MW; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lam[n][mt][i] = 0.0f;
        z[n][mt][i] = ub[n][mt][i];
        if constexpr (kSlots) zslot[32 * (4 * (MW * n + mt) + i)] = z[n][mt][i];
      }
    if (n < nb) {
      store_piece_s<LDA, MW>(s0 + a_off, 8 * (n0 + n), g, t, z[n], lam[n]);
      if (P.chunk_len * P.n_chunks + P.n_tail == 0) {  // no iterations: u = z = u_base
        store_frag<MW>(P.u_out, row0, 8 * (n0 + n), P.Nm, g, t, ub[n]);
        store_frag<MW>(P.zu_out, row0, 8 * (n0 + n), P.Nm, g, t, ub[n]);
      }
    }
  }
  __syncthreads();  // W_u, the bounds and s0 staged

  // The rest of an iteration from acc = s W_u: u_hat, the box and dual
  // updates, s into s_out. out: store u and z; test: fold max |u_hat - z|
  // into word `test - 1` of the residual
  auto finish = [&](const float (&acc)[2][MW][4], float* s_out, bool out, int test) {
    unsigned int m = 0u;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (n >= nb) continue;
      const int c0 = 8 * (n0 + n);
      float v[MW][4];
      if constexpr (kSlots) {
        load_frag<MW>(P.u_base, row0, c0, P.Nm, g, t, v);
      } else {
#pragma unroll
        for (int mt = 0; mt < MW; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) v[mt][i] = ub[n][mt][i];
      }
#pragma unroll
      for (int mt = 0; mt < MW; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[mt][i] = add(v[mt][i], acc[n][mt][i]);
          if constexpr (kSlots) z[n][mt][i] = zslot[32 * (4 * (MW * n + mt) + i)];
        }
      box_update<MW, RELAX>(v, z[n], lam[n], lo, hi, c0 + 2 * t, P.alpha, P.one_minus_alpha);
      if constexpr (kSlots) {
#pragma unroll
        for (int mt = 0; mt < MW; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) zslot[32 * (4 * (MW * n + mt) + i)] = z[n][mt][i];
      }
      store_piece_s<LDA, MW>(s_out + a_off, c0, g, t, z[n], lam[n]);
      if (out) {
        store_frag<MW>(P.u_out, row0, c0, P.Nm, g, t, v);
        store_frag<MW>(P.zu_out, row0, c0, P.Nm, g, t, z[n]);
      }
      if (test) {
#pragma unroll
        for (int mt = 0; mt < MW; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) m = max(m, __float_as_uint(fabsf(sub(v[mt][i], z[n][mt][i]))));
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

  // One iteration from s_in into s_out. six: 6xTF32
  auto iterate = [&](const float* s_in, float* s_out, bool six, bool out, int test) {
    float acc[2][MW][4];
    if (six) product_nb<MW, 1, LDA, true>(acc, nb, s_in + a_off, b, klo, khi, lane, g, t);
    else product_nb<MW, RELAX ? 1 : 2, LDA, false>(acc, nb, s_in + a_off, b, klo, khi, lane, g, t);
    finish(acc, s_out, out, test);
  };

  const bool early_exit = P.stop_tol > 0.0f;
  const float* s_last = s0;  // the s that produced the last u_hat
  if constexpr (DELTA) {
    // kind 0: c = s W_u in 3xTF32; 1: c += (s - s_prev) W_u in one TF32
    // pass; 2: c = s W_u in 6xTF32. Iteration k reads s_k (sa) and
    // s_k-1 (sp) and writes s_k+1 (sb), the buffer of s_k-2, whose last
    // readers have passed a barrier since
    float c[2][MW][4];
    float *sa = s0, *sb = s1, *sp = s2;
    auto step = [&](int kind, bool out, int test) {
      if (kind == 2) {
        product_nb<MW, 1, LDA, true>(c, nb, sa + a_off, b, klo, khi, lane, g, t);
      } else if (kind == 0) {
        product_nb<MW, RELAX ? 1 : 2, LDA, false>(c, nb, sa + a_off, b, klo, khi, lane, g, t);
      } else {
        float d[2][MW][4];
        product1_nb<MW, 2, LDA>(d, nb, sa + a_off, sp + a_off, b, klo, khi, lane, g, t);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int mt = 0; mt < MW; ++mt)
#pragma unroll
            for (int i = 0; i < 4; ++i) c[n][mt][i] = add(c[n][mt][i], d[n][mt][i]);
      }
      finish(c, sb, out, test);
      s_last = sa;
      float* used = sp;
      sp = sa;
      sa = sb;
      sb = used;
      __syncthreads();
    };
    for (int ch = 0; ch < P.n_chunks; ++ch) {
      for (int it = 0; it < P.chunk_len; ++it) {
        const bool chunk_end = it == P.chunk_len - 1;
        step(early_exit && chunk_end ? 2 : (it % P.refresh_every ? 1 : 0),
             P.n_tail == 0 && chunk_end, early_exit && chunk_end ? ch % 3 + 1 : 0);
      }
      if (early_exit && !(__uint_as_float(residual[ch % 3]) >= P.stop_tol)) break;
    }
    for (int it = 0; it < P.n_tail; ++it) step(2, it == P.n_tail - 1, 0);
  } else {
    int p = 0;  // buffer the next iteration reads
    for (int ch = 0; ch < P.n_chunks; ++ch) {
      for (int it = 0; it < P.chunk_len; ++it) {
        const bool chunk_end = it == P.chunk_len - 1;
        const float* s_in = p ? s1 : s0;
        iterate(s_in, p ? s0 : s1, early_exit && chunk_end, P.n_tail == 0 && chunk_end,
                early_exit && chunk_end ? ch % 3 + 1 : 0);
        s_last = s_in;
        p ^= 1;
        __syncthreads();
      }
      if (early_exit && !(__uint_as_float(residual[ch % 3]) >= P.stop_tol)) break;
    }
    for (int it = 0; it < P.n_tail; ++it) {
      const float* s_in = p ? s1 : s0;
      iterate(s_in, p ? s0 : s1, true, it == P.n_tail - 1, 0);
      s_last = s_in;
      p ^= 1;
      __syncthreads();
    }
  }

  // x = x_base + s W_x: pieces of (pair of W_x's n-tiles, MX m-tiles),
  // dealt to the warps in turn; W_x's blocks come from device memory
  const int n1 = (P.Nm + 7) / 8, n2 = (P.Nd + 7) / 8;
  const int n_pairs_u = (n1 + 1) / 2, n_pairs_x = (n2 + 1) / 2;
  constexpr int GX = MT / MX;
  for (int piece = warp; piece < n_pairs_x * GX; piece += blockDim.x / 32) {
    const int px = piece / GX, mx0 = (piece % GX) * MX;
    const int* rx = P.ops_i + 4 * (n_pairs_u + px);
    float acc[2][MX][4];
    product_nb<MX, 1, LDA, false>(acc, rx[3], s_last + 16 * mx0 * 8, P.ops_f + rx[0], rx[1],
                                  rx[2], lane, g, t);
    const size_t xrow0 = static_cast<size_t>(blockIdx.x) * T + 16 * mx0;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (n >= rx[3]) continue;
      const int c0 = 8 * (2 * px + n);
      float v[MX][4];
      load_frag<MX>(P.x_base, xrow0, c0, P.Nd, g, t, v);
#pragma unroll
      for (int mt = 0; mt < MX; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) v[mt][i] = add(v[mt][i], acc[n][mt][i]);
      store_frag<MX>(P.x_out, xrow0, c0, P.Nd, g, t, v);
    }
  }
}

// Pieces: W_u's pairs of n-tiles, each cut into MT / MW pieces of MW
// m-tiles (MW = 2 when MT >= 2), in order, then the last single n-tile
// (when Nm / 8 rounds up to an odd count) cut into MT pieces of one
// m-tile. Warp w takes piece w.
template <int MT, bool RELAX, bool DELTA>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) admm_u_only_kernel(Problem P) {
  constexpr int T = 16 * MT;
  constexpr int MW = MT >= 2 ? 2 : 1;
  extern __shared__ float4 smem_f4[];
  __shared__ unsigned int residual[3];
  const int n1 = (P.Nm + 7) / 8;
  float* ops = reinterpret_cast<float*>(smem_f4);  // room for a dense W_u
  float* s0 = ops + kBlock * n1 * n1;              // two s buffers (three: DELTA), group-major
  float* s1 = s0 + T * 8 * n1;
  float* s2 = s1 + T * 8 * n1;
  float* lo = (DELTA ? s2 : s1) + T * 8 * n1;  // the bounds, zero-padded to 8 n1
  float* hi = lo + 8 * n1;
  float* zslots = hi + 8 * n1;  // with alpha != 1: 16 floats a thread

  const int tid = threadIdx.x;
  const int n_pairs_u = (n1 + 1) / 2;
  const int wu_floats = P.ops_i[4 * n_pairs_u];  // where W_x's blocks start
  const float4* src = reinterpret_cast<const float4*>(P.ops_f);
  for (int i = tid; i < wu_floats / 4; i += blockDim.x) smem_f4[i] = src[i];
  for (int i = tid; i < 8 * n1; i += blockDim.x) {
    lo[i] = i < P.Nm ? P.lo[i] : 0.0f;
    hi[i] = i < P.Nm ? P.hi[i] : 0.0f;
  }
  if (tid < 3) residual[tid] = 0u;

  const int warp = tid / 32;
  const int pair_pieces = (n1 / 2) * (MT / MW);
  if (warp < pair_pieces) {
    solve<MT, MW, RELAX, DELTA>(P, ops, s0, s1, s2, lo, hi, zslots, residual,
                                warp / (MT / MW), (warp % (MT / MW)) * MW);
  } else {
    solve<MT, 1, RELAX, DELTA>(P, ops, s0, s1, s2, lo, hi, zslots, residual, n1 / 2,
                               warp - pair_pieces);
  }
}

}  // namespace

extern "C" int admm_u_only_launch(const void* u_base, const void* x_base, const void* ops_f,
                                  const void* ops_i, const void* lo, const void* hi,
                                  void* x_out, void* u_out, void* zu_out, int batch, int Nm,
                                  int Nd, int T, int chunk_len, int n_chunks, int n_tail,
                                  int refresh_every, float alpha, float one_minus_alpha,
                                  float stop_tol, void* stream) {
  if (Nm <= 0 || Nd <= 0 || (T != 16 && T != 32 && T != 64) || batch <= 0 || batch % T != 0 ||
      chunk_len < 0 || n_chunks < 0 || n_tail < 0 || refresh_every < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int MT = T / 16, MW = MT >= 2 ? 2 : 1;
  const int n1 = (Nm + 7) / 8;
  const int warps = (n1 / 2) * (MT / MW) + (n1 % 2) * MT;
  if (warps > kMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  const bool relax = alpha != 1.0f, delta = refresh_every > 1;
  const size_t smem = sizeof(float) * (static_cast<size_t>(kBlock) * n1 * n1 +
                                       (delta ? 3 : 2) * static_cast<size_t>(T) * 8 * n1 +
                                       16 * n1 + (relax ? 16 * 32 * warps : 0));
  Problem P{static_cast<const float*>(u_base), static_cast<const float*>(x_base),
            static_cast<const float*>(ops_f), static_cast<const int*>(ops_i),
            static_cast<const float*>(lo), static_cast<const float*>(hi),
            static_cast<float*>(x_out), static_cast<float*>(u_out), static_cast<float*>(zu_out),
            Nm, Nd, chunk_len, n_chunks, n_tail, refresh_every, alpha, one_minus_alpha,
            stop_tol};
  using Kernel = void (*)(Problem);
  // [T / 32 (0, 1, 2 for 16, 32, 64)][relax][delta]
  static const Kernel kernels[3][2][2] = {
      {{admm_u_only_kernel<1, false, false>, admm_u_only_kernel<1, false, true>},
       {admm_u_only_kernel<1, true, false>, admm_u_only_kernel<1, true, true>}},
      {{admm_u_only_kernel<2, false, false>, admm_u_only_kernel<2, false, true>},
       {admm_u_only_kernel<2, true, false>, admm_u_only_kernel<2, true, true>}},
      {{admm_u_only_kernel<4, false, false>, admm_u_only_kernel<4, false, true>},
       {admm_u_only_kernel<4, true, false>, admm_u_only_kernel<4, true, true>}}};
  const Kernel kernel = kernels[T / 32][relax][delta];
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch / T, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* admm_u_only_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
