// Fused box-constrained LQT-ADMM fleet with state bounds, at widths where
// the operators do not fit in a block's shared memory, for sm_90a.
//
// The wide route of the Pallas TPU kernel `_admm_kernel`
// (ilqr_admm_tpu/ops/pallas_admm.py:229), beside csrc/admm_box.cu, which
// stages its packed operators whole in shared memory and so stops at Nm =
// 128, Nd = 256 (its 663 blocks already take 227,456 B at Nm = 100). The
// iteration is csrc/admm_box.cu's folded form:
//
//     u_hat = u_base + [z_x - l_x, z_u - l_u] W_s                (phase 1)
//     x_hat = free + u_hat Su^T                                   (phase 2)
//
// then, for the x block and (when `has_u`) the u block,
// z = clip(alpha v_hat + (1 - alpha) z + l, lo, hi) and l = l + v_hat - z,
// from (z_x, z_u, l_x, l_u) = (free + u0 Su^T, u0, 0, 0); +-inf bounds pass
// through fminf/fmaxf. Outputs: x_hat, u_hat, z_x, z_u of the last
// iteration.
//
// What bounds it on an H100: the planar double integrator's state-bounded
// fleet (N = 100: Nm = 200, Nd = 400) packs W_s and Su^T into 2,525 8 x 8
// blocks (646 KB; Su^T's zero blocks skipped), 323,200 FLOP an
// instance-iteration as the kernel multiplies them, about half of them on
// exact zeros (the x and y axes do not couple, so W_s is a checkerboard of
// zeros inside its blocks). 16,384 instances x 200 iterations is 1.06e12
// FLOP: 6.42 ms as 3xTF32 at the 495 TFLOP/s dense TF32 peak (3.13 ms on
// the nonzeros alone), against ~80 MB of traffic in and out. Every block
// reads every operator block every iteration, 646 KB x 512 blocks x 200
// iterations = 66 GB from L2 a solve, ~17 ms at the few TB/s of L2 the
// wide u-only kernel sees (csrc/admm_u_only_wide.cu); the measurements
// below found the issue of the products' instructions, not that stream,
// setting the time.
//
// The design (the wide u-only kernel's, csrc/admm_u_only_wide.cu, for
// two products):
// - T = 32 instances a block (two m16 row tiles) to Nm = 256, Nd = 512;
//   T = 16 (one) to Nm = 512, Nd = 1,024. 16 warps.
// - Warp w owns W_s's pairs of n-tiles w, w + 16, ... (one at T = 32, two
//   at T = 16: the u columns whose u_hat, l_u and, over-relaxed, z_u it
//   updates) and Su^T's pairs w, w + 16, ... (two or four: the x columns
//   it updates), each over the whole k range, so no partial sum crosses
//   warps. B fragments go from L2 straight into registers (`pair_pack`
//   storage: a lane's 16-byte load, 512 contiguous bytes a warp), one
//   k-step in flight at T = 32, two at T = 16; each pair's k range in
//   chunks of KC k-steps, each chunk summed on the tensor cores from zero
//   and added in f32, as the wide u-only kernel does.
// - What the measurements say (H100, the planar fleet at T = 32;
//   numbers in PERF.md §6): not the L2 stream. Copying the B fragments
//   with cp.async into a ring in shared memory two to eight k-steps ahead
//   was no faster than loading them into registers one k-step ahead.
//   Left to itself the compiler hoists the epilogues' global addresses
//   out of the loop and spills them, ~20% slower; `fresh` keeps them
//   where they are used, and no build spills. What is left is the issue
//   of the mma and, beside it, of the 3xTF32 splits (each warp splits its
//   own A fragments: 48 integer and f32 operations beside 12 mma a
//   k-step) and the chunk sums: one chain over the k range (75 k-steps in
//   phase 1) is faster but misses the f32 plain version by more than its
//   tolerance, which chunks of 8 meet. T = 16 is slower than T = 32.
// - Shared memory holds the A operands, s = [z_x - l_x, z_u - l_u] and
//   u_hat, group-major (`a_pos`), l_x in the accumulator layout (each
//   thread its own words), and the bounds: 158,400 B at the planar fleet,
//   at most 208,896 B. l_u and the u_hat of a warp's own columns stay in
//   registers (128 a thread at T = 32, 126-128 at T = 16, no spills);
//   u_base and free are read again from device memory (L2) each
//   iteration; over-relaxed, z lives in zx_out and zu_out.
// - Two barriers an iteration: after phase 1 (u_hat complete, every read
//   of s done, so the u block may write s_u), and after phase 2 (s
//   complete, every read of u_hat done).
// - Padded columns (Nm, Nd up to multiples of 8) get zero bounds, inputs
//   and operator columns, so they stay 0; s_x is padded to whole tiles and
//   W_s's rows with it (`pack_box_operators`). The clip and dual updates
//   use explicitly rounded f32 operations (no FMA contraction), as the
//   plain torch version rounds them.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int kWarps = 16;
// k-steps a product chains on the tensor cores before it adds the chunk's
// sum to its total in f32 (`product`'s KC), and k-steps in flight at 32
// and at 16 instances a block; tools/admm_box_wide_variants.py builds and
// times other values
constexpr int KC = 8;
constexpr int kUnroll32 = 1;
constexpr int kUnroll16 = 2;

struct Problem {
  const float* free_g;
  const float* u_base;
  const float* u0;
  const float* ops_f;  // W_s's then Su^T's blocks (pair_pack storage)
  const int* ops_i;    // their pair tables, W_s's first: (offset, klo, khi, nb) rows
  const float* xb;
  const float* ub;
  float* x_out;
  float* u_out;
  float* zx_out;
  float* zu_out;
  int Nm, Nd, n_iters, has_u;
  float alpha, one_minus_alpha;
};

// v, as a value the compiler cannot see through: the global addresses
// derived from it are computed where they are used instead of being held
// (and spilled) across the loop's products
__device__ __forceinline__ size_t fresh(size_t v) {
  asm volatile("" : "+l"(v));
  return v;
}

// v (the thread's columns 2 t + e of an n-tile) to an A buffer at columns
// k0 + 2 t + e, k0 a multiple of 8
template <int MT>
__device__ __forceinline__ void store_a(float* buf, int k0, int g, int t,
                                        const float (&v)[MT][4]) {
  float* p = buf + (k0 / 8) * (16 * MT * 8) + 8 * g;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) p[8 * frag_row(mt, i, 0) + a_pos(2 * t + (i & 1))] = v[mt][i];
}

template <int MT>
__device__ __forceinline__ void add_to(float (&v)[MT][4], const float (&w)[MT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) v[mt][i] = add(v[mt][i], w[mt][i]);
}

// T = 16 MT instances a block; P1 pairs of W_s's and P2 of Su^T's n-tiles
// a warp
template <int MT, bool RELAX>
__global__ void __launch_bounds__(kWarps * 32, 1) admm_box_wide_kernel(Problem P) {
  constexpr int T = 16 * MT;
  constexpr int LDA = 8 * T;
  constexpr int P1 = 2 / MT;
  constexpr int P2 = 4 / MT;
  constexpr int UNROLL = MT == 1 ? kUnroll16 : kUnroll32;
  extern __shared__ float4 smem_f4[];
  const int n1 = (P.Nm + 7) / 8, n2 = (P.Nd + 7) / 8;
  const int np1 = (n1 + 1) / 2, np2 = (n2 + 1) / 2;
  const int ku = 8 * n2;  // s_u's first column: s_x is padded to whole tiles
  float* s = reinterpret_cast<float*>(smem_f4);  // n2 + n1 groups: [s_x, s_u]
  float* uh = s + LDA * (n2 + n1);                // n1 groups: u_hat
  float* lx_s = uh + LDA * n1;  // l_x: element i of (pair, n, mt) at 32 index + lane
  float* xlo = lx_s + 16 * T * np2;  // the bounds, zero-padded to 8 n2 and 8 n1
  float* xhi = xlo + 8 * n2;
  float* ulo = xhi + 8 * n2;
  float* uhi = ulo + 8 * n1;
  const int* tab1 = P.ops_i;           // W_s's pairs
  const int* tab2 = P.ops_i + 4 * np1;  // Su^T's

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * T;
  for (int i = tid; i < LDA * (n2 + 2 * n1); i += blockDim.x) s[i] = 0.0f;
  for (int i = tid; i < 8 * n2; i += blockDim.x) {
    xlo[i] = i < P.Nd ? P.xb[i] : 0.0f;
    xhi[i] = i < P.Nd ? P.xb[P.Nd + i] : 0.0f;
  }
  for (int i = tid; i < 8 * n1; i += blockDim.x) {
    ulo[i] = i < P.Nm ? P.ub[i] : 0.0f;
    uhi[i] = i < P.Nm ? P.ub[P.Nm + i] : 0.0f;
  }
  auto lx_at = [&](int p, int n, int mt, int i) -> float& {
    return lx_s[(((p * 2 + n) * MT + mt) * 4 + i) * 32 + lane];
  };
  // l_u of the warp's u columns, and their u_hat from phase 1 to the u block
  float lu[P1][2][MT][4], uv[P1][2][MT][4];
#pragma unroll
  for (int j = 0; j < P1; ++j)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) lu[j][n][mt][i] = 0.0f;
  __syncthreads();  // buffers zeroed

  // z_u = u0, l_u = 0: u0 into the u_hat buffer and s_u
#pragma unroll
  for (int j = 0; j < P1; ++j) {
    const int p = warp + kWarps * j;
    if (p >= np1) continue;
    const int nb = tab1[4 * p + 3];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (n >= nb) continue;
      const int c0 = 8 * (2 * p + n);
      float z[MT][4];
      load_frag<MT>(P.u0, row0, c0, P.Nm, g, t, z);
      store_a<MT>(uh, c0, g, t, z);
      store_a<MT>(s, ku + c0, g, t, z);
      if (P.n_iters == 0) store_frag<MT>(P.u_out, row0, c0, P.Nm, g, t, z);
      if (RELAX || P.n_iters == 0 || !P.has_u) store_frag<MT>(P.zu_out, row0, c0, P.Nm, g, t, z);
    }
  }
  __syncthreads();  // u_hat = u0

  // z_x = free + u0 Su^T, l_x = 0
#pragma unroll
  for (int j = 0; j < P2; ++j) {
    const int p = warp + kWarps * j;
    if (p >= np2) continue;
    const int* row = tab2 + 4 * p;
    float acc[2][MT][4];
    product_nb<MT, UNROLL, LDA, false, KC>(acc, row[3], uh, P.ops_f + row[0], row[1], row[2],
                                           lane, g, t);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (n >= row[3]) continue;
      const int c0 = 8 * (2 * p + n);
      float v[MT][4];
      load_frag<MT>(P.free_g, row0, c0, P.Nd, g, t, v);
      add_to<MT>(v, acc[n]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) lx_at(p, n, mt, i) = 0.0f;
      store_a<MT>(s, c0, g, t, v);
      if (P.n_iters == 0) store_frag<MT>(P.x_out, row0, c0, P.Nd, g, t, v);
      if (RELAX || P.n_iters == 0) store_frag<MT>(P.zx_out, row0, c0, P.Nd, g, t, v);
    }
  }
  __syncthreads();  // s complete

  for (int it = 0; it < P.n_iters; ++it) {
    const bool last = it == P.n_iters - 1;
    // phase 1: u_hat = u_base + s W_s on the warp's u columns
#pragma unroll
    for (int j = 0; j < P1; ++j) {
      const int p = warp + kWarps * j;
      if (p >= np1) continue;
      const int* row = tab1 + 4 * p;
      product_nb<MT, UNROLL, LDA, false, KC>(uv[j], row[3], s, P.ops_f + row[0], row[1],
                                             row[2], lane, g, t);
      const size_t r0 = fresh(row0);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        if (n >= row[3]) continue;
        const int c0 = 8 * (2 * p + n);
        float b[MT][4];
        load_frag<MT>(P.u_base, r0, c0, P.Nm, g, t, b);
        add_to<MT>(b, uv[j][n]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) uv[j][n][mt][i] = b[mt][i];
        store_a<MT>(uh, c0, g, t, b);
        if (last) store_frag<MT>(P.u_out, r0, c0, P.Nm, g, t, b);
      }
    }
    __syncthreads();  // u_hat complete; every read of s done
    // the u block
    if (P.has_u) {
#pragma unroll
      for (int j = 0; j < P1; ++j) {
        const int p = warp + kWarps * j;
        if (p >= np1) continue;
        const int nb = tab1[4 * p + 3];
        const size_t r0 = fresh(row0);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          if (n >= nb) continue;
          const int c0 = 8 * (2 * p + n);
          float z[MT][4];
          if constexpr (RELAX) load_frag<MT>(P.zu_out, r0, c0, P.Nm, g, t, z);
          box_update<MT, RELAX>(uv[j][n], z, lu[j][n], ulo, uhi, c0 + 2 * t, P.alpha,
                                P.one_minus_alpha);
          store_piece_s<LDA, MT>(s, ku + c0, g, t, z, lu[j][n]);
          if (RELAX || last) store_frag<MT>(P.zu_out, r0, c0, P.Nm, g, t, z);
        }
      }
    }
    // phase 2: x_hat = free + u_hat Su^T on the warp's x columns, then the
    // x block
#pragma unroll
    for (int j = 0; j < P2; ++j) {
      const int p = warp + kWarps * j;
      if (p >= np2) continue;
      const int* row = tab2 + 4 * p;
      float acc[2][MT][4];
      product_nb<MT, UNROLL, LDA, false, KC>(acc, row[3], uh, P.ops_f + row[0], row[1], row[2],
                                             lane, g, t);
      const size_t r0 = fresh(row0);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        if (n >= row[3]) continue;
        const int c0 = 8 * (2 * p + n);
        float v[MT][4], z[MT][4], l[MT][4];
        load_frag<MT>(P.free_g, r0, c0, P.Nd, g, t, v);
        add_to<MT>(v, acc[n]);
        if (last) store_frag<MT>(P.x_out, r0, c0, P.Nd, g, t, v);
        if constexpr (RELAX) load_frag<MT>(P.zx_out, r0, c0, P.Nd, g, t, z);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) l[mt][i] = lx_at(p, n, mt, i);
        box_update<MT, RELAX>(v, z, l, xlo, xhi, c0 + 2 * t, P.alpha, P.one_minus_alpha);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) lx_at(p, n, mt, i) = l[mt][i];
        store_piece_s<LDA, MT>(s, c0, g, t, z, l);
        if (RELAX || last) store_frag<MT>(P.zx_out, r0, c0, P.Nd, g, t, z);
      }
    }
    __syncthreads();  // s complete; every read of u_hat done
  }
}

}  // namespace

// The arguments of admm_box_launch (csrc/admm_box.cu), with the pair
// tables of W_s and Su^T (ceil(n1 / 2) + ceil(n2 / 2) rows, W_s's first;
// Su^T's offsets count from the start of ops_f) in place of the warp
// schedule; T 16 or 32.
extern "C" int admm_box_wide_launch(const void* free_g, const void* u_base, const void* u0,
                                    const void* ops_f, const void* ops_i, const void* xb,
                                    const void* ub, void* x_out, void* u_out, void* zx_out,
                                    void* zu_out, int batch, int Nm, int Nd, int T, int n_iters,
                                    int has_u, float alpha, float one_minus_alpha,
                                    void* stream) {
  if (Nm <= 0 || Nd <= 0 || (T != 16 && T != 32) || batch <= 0 || batch % T != 0 ||
      n_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int MT = T / 16;
  const int n1 = (Nm + 7) / 8, n2 = (Nd + 7) / 8;
  const int np1 = (n1 + 1) / 2, np2 = (n2 + 1) / 2;
  if (np1 > kWarps * (2 / MT) || np2 > kWarps * (4 / MT))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (8 * static_cast<size_t>(T) * (n2 + 2 * n1) +
                       16 * static_cast<size_t>(T) * np2 + 16 * static_cast<size_t>(n1 + n2));
  Problem P{static_cast<const float*>(free_g), static_cast<const float*>(u_base),
            static_cast<const float*>(u0),     static_cast<const float*>(ops_f),
            static_cast<const int*>(ops_i),    static_cast<const float*>(xb),
            static_cast<const float*>(ub),     static_cast<float*>(x_out),
            static_cast<float*>(u_out),        static_cast<float*>(zx_out),
            static_cast<float*>(zu_out),       Nm,
            Nd,                                n_iters,
            has_u,                             alpha,
            one_minus_alpha};
  const bool relax = alpha != 1.0f;
  auto kernel = T == 32 ? (relax ? admm_box_wide_kernel<2, true> : admm_box_wide_kernel<2, false>)
                        : (relax ? admm_box_wide_kernel<1, true> : admm_box_wide_kernel<1, false>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch / T, 32 * kWarps, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
