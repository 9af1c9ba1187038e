// Warp-level 3xTF32 (and 6xTF32) products on Hopper's tensor cores, and
// the fragment-layout helpers around them, shared by csrc/admm_box.cu,
// csrc/admm_u_only.cu and csrc/sls_admm.cu.
//
// Products are `mma.sync.m16n8k8` in TF32 with instances as M, output
// columns as N and the reduction as K. TF32 keeps 11 bits of an f32
// operand, so each operand x is split as it is loaded:
// - 3xTF32 (`k_step`): hi = tf32(x), lo = x - hi; lo_a hi_b + hi_a lo_b
//   + hi_a hi_b, the small terms first, into one f32 accumulator: the
//   counterpart of the TPU kernels' bf16x3 `_dot3`;
// - 6xTF32 (`k_step6`): hi, mid = tf32(x - hi), lo = x - hi - mid; the six
//   products above the f32 rounding, smallest first: the counterpart of
//   the TPU's bf16x6 `_dot6` (ops/fused_admm.py and utils/precision.py
//   emulate both in plain torch).
//
// Operators are 8 x 8 (k, n) blocks in the B-fragment order of the mma,
// the two n-tiles of a pair interleaved (lane 4 g + t reads (k, n) = (t, g)
// and (t + 4, g) of each in one 16-byte load): `pair_pack` in
// ops/fused_admm.py. A operands (s, u_hat) sit in shared memory
// group-major (`a_pos`): every address in the inner loop is a per-thread
// base plus a constant, and the fragment loads are free of bank
// conflicts.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBlock = 64;  // floats of one 8 x 8 operator block

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// x split for 3xTF32: hi = x rounded to TF32, to nearest with ties away
// from zero, as `cvt.rna.tf32.f32` rounds finite values (two integer
// operations on the bits; the carry of the rounding runs into the exponent
// as it should); lo = x - hi, exact in f32, handed to the tensor core as
// it is: the mma reads the top 19 bits of a TF32 operand, so lo is
// truncated to TF32 there (ptxas drops an explicit mask of those bits).
// |lo| <= 2^-11 |x|, so its truncation costs at most 2^-21 |x|; rounding
// it too costs one more operation a value, which the solve shows on an
// H100, for the same error against the f32 plain version
// (tools/admm_box_variants.py).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(sub(x, __uint_as_float(hi)));
}

// x split for 6xTF32: hi and mid rounded as `split` rounds hi, lo the
// rest (truncated by the tensor core)
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  uint32_t r;
  split(x, hi, r);
  split(__uint_as_float(r), mid, lo);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A buffer (s or u_hat) holds T rows of 8-column groups, group-major:
// column k of row r sits at (k / 8) T 8 + 8 r + a_pos(k % 8), with the
// lane pair (t, t + 4) side by side, so a lane's A fragment is two 8-byte
// loads at offsets known at compile time, and a half-warp's loads cover
// the 32 banks once.
__device__ __forceinline__ int a_pos(int c) { return 2 * (c & 3) + (c >> 2); }

// One k-step of 3xTF32 into acc[0..NB): A columns 8 kk..8 kk + 7 of the
// buffer at `a`, whose 8-column groups are LDA floats apart (by default a
// buffer of exactly the MT row tiles); B the NB n-tiles' 8 x 8 blocks at
// `b`, interleaved by lane. Each A fragment is split once for the NB
// n-tiles, each B fragment once for the MT row tiles.
template <int MT, int NB, int LDA = 16 * MT * 8>
__device__ __forceinline__ void k_step(float (&acc)[2][MT][4], const float* a, int kk,
                                       const float* b, int lane, int g, int t) {
  uint32_t b_hi[NB][2], b_lo[NB][2];
  if constexpr (NB == 2) {
    const float4 bv = *reinterpret_cast<const float4*>(b + 4 * lane);
    split(bv.x, b_hi[0][0], b_lo[0][0]);
    split(bv.y, b_hi[0][1], b_lo[0][1]);
    split(bv.z, b_hi[NB - 1][0], b_lo[NB - 1][0]);
    split(bv.w, b_hi[NB - 1][1], b_lo[NB - 1][1]);
  } else {
    const float2 bv = *reinterpret_cast<const float2*>(b + 2 * lane);
    split(bv.x, b_hi[0][0], b_lo[0][0]);
    split(bv.y, b_hi[0][1], b_lo[0][1]);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float* row = a + kk * LDA + (16 * mt + g) * 8 + 2 * t;
    const float2 top = *reinterpret_cast<const float2*>(row);
    const float2 bot = *reinterpret_cast<const float2*>(row + 64);
    uint32_t hi[4], lo[4];
    split(top.x, hi[0], lo[0]);  // (g, t)
    split(bot.x, hi[1], lo[1]);  // (g + 8, t)
    split(top.y, hi[2], lo[2]);  // (g, t + 4)
    split(bot.y, hi[3], lo[3]);  // (g + 8, t + 4)
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      mma(acc[n][mt], lo, b_hi[n][0], b_hi[n][1]);
      mma(acc[n][mt], hi, b_lo[n][0], b_lo[n][1]);
      mma(acc[n][mt], hi, b_hi[n][0], b_hi[n][1]);
    }
  }
}

// One k-step of 6xTF32, laid out as `k_step`: (lo_a hi_b + mid_a mid_b +
// hi_a lo_b) + (mid_a hi_b + hi_a mid_b) + hi_a hi_b, in that order
template <int MT, int NB, int LDA = 16 * MT * 8>
__device__ __forceinline__ void k_step6(float (&acc)[2][MT][4], const float* a, int kk,
                                        const float* b, int lane, int g, int t) {
  uint32_t bp[3][NB][2];  // [hi, mid, lo][n-tile][register]
  if constexpr (NB == 2) {
    const float4 bv = *reinterpret_cast<const float4*>(b + 4 * lane);
    split3(bv.x, bp[0][0][0], bp[1][0][0], bp[2][0][0]);
    split3(bv.y, bp[0][0][1], bp[1][0][1], bp[2][0][1]);
    split3(bv.z, bp[0][NB - 1][0], bp[1][NB - 1][0], bp[2][NB - 1][0]);
    split3(bv.w, bp[0][NB - 1][1], bp[1][NB - 1][1], bp[2][NB - 1][1]);
  } else {
    const float2 bv = *reinterpret_cast<const float2*>(b + 2 * lane);
    split3(bv.x, bp[0][0][0], bp[1][0][0], bp[2][0][0]);
    split3(bv.y, bp[0][0][1], bp[1][0][1], bp[2][0][1]);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float* row = a + kk * LDA + (16 * mt + g) * 8 + 2 * t;
    const float2 top = *reinterpret_cast<const float2*>(row);
    const float2 bot = *reinterpret_cast<const float2*>(row + 64);
    uint32_t ap[3][4];
    split3(top.x, ap[0][0], ap[1][0], ap[2][0]);
    split3(bot.x, ap[0][1], ap[1][1], ap[2][1]);
    split3(top.y, ap[0][2], ap[1][2], ap[2][2]);
    split3(bot.y, ap[0][3], ap[1][3], ap[2][3]);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      mma(acc[n][mt], ap[2], bp[0][n][0], bp[0][n][1]);
      mma(acc[n][mt], ap[1], bp[1][n][0], bp[1][n][1]);
      mma(acc[n][mt], ap[0], bp[2][n][0], bp[2][n][1]);
      mma(acc[n][mt], ap[1], bp[0][n][0], bp[0][n][1]);
      mma(acc[n][mt], ap[0], bp[1][n][0], bp[1][n][1]);
      mma(acc[n][mt], ap[0], bp[0][n][0], bp[0][n][1]);
    }
  }
}

// acc[n] = A[:, 8 klo : 8 khi] B_n for the NB n-tiles whose interleaved
// blocks for k-steps klo..khi-1 start at `b`; UNROLL k-steps in flight;
// SIX: the 6xTF32 form. KC > 0: the k range in chunks of KC k-steps, each
// summed by the tensor cores from zero and added to acc in f32 (rounded
// to nearest): the tensor cores' accumulation truncates, an error that
// grows with the magnitude of the running sum and the length of the
// chain, which the chunks keep short.
template <int MT, int NB, int UNROLL, int LDA = 16 * MT * 8, bool SIX = false, int KC = 0>
__device__ __forceinline__ void product(float (&acc)[2][MT][4], const float* a,
                                        const float* b, int klo, int khi, int lane, int g,
                                        int t) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][mt][i] = 0.0f;
  if constexpr (KC == 0) {
#pragma unroll UNROLL
    for (int kk = klo; kk < khi; ++kk, b += NB * kBlock) {
      if constexpr (SIX) k_step6<MT, NB, LDA>(acc, a, kk, b, lane, g, t);
      else k_step<MT, NB, LDA>(acc, a, kk, b, lane, g, t);
    }
  } else {
    for (int k0 = klo; k0 < khi; k0 += KC) {
      float part[2][MT][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[n][mt][i] = 0.0f;
      const int k1 = min(k0 + KC, khi);
#pragma unroll UNROLL
      for (int kk = k0; kk < k1; ++kk, b += NB * kBlock) {
        if constexpr (SIX) k_step6<MT, NB, LDA>(part, a, kk, b, lane, g, t);
        else k_step<MT, NB, LDA>(part, a, kk, b, lane, g, t);
      }
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[n][mt][i] = add(acc[n][mt][i], part[n][mt][i]);
    }
  }
}

// product<MT, nb> for a run-time nb of 0 (no work: acc = 0), 1 or 2
template <int MT, int UNROLL, int LDA = 16 * MT * 8, bool SIX = false, int KC = 0>
__device__ __forceinline__ void product_nb(float (&acc)[2][MT][4], int nb, const float* a,
                                           const float* b, int klo, int khi, int lane, int g,
                                           int t) {
  if (nb == 2) product<MT, 2, UNROLL, LDA, SIX, KC>(acc, a, b, klo, khi, lane, g, t);
  else product<MT, 1, UNROLL, LDA, SIX, KC>(acc, a, b, klo, nb == 1 ? khi : klo, lane, g, t);
}

// x rounded to TF32 as `split` rounds its high part, as bits
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// One k-step of the one-pass delta product, laid out as `k_step`: the A
// operand is a - a_prev (two buffers of the same layout), each difference
// and each B value rounded to TF32, one mma a row tile and n-tile: the
// counterpart of the TPU kernel's bf16(s - s_prev) @ W_u_hi
template <int MT, int NB, int LDA = 16 * MT * 8>
__device__ __forceinline__ void k_step1(float (&acc)[2][MT][4], const float* a,
                                        const float* a_prev, int kk, const float* b, int lane,
                                        int g, int t) {
  uint32_t b_hi[NB][2];
  if constexpr (NB == 2) {
    const float4 bv = *reinterpret_cast<const float4*>(b + 4 * lane);
    b_hi[0][0] = tf32_hi(bv.x);
    b_hi[0][1] = tf32_hi(bv.y);
    b_hi[NB - 1][0] = tf32_hi(bv.z);
    b_hi[NB - 1][1] = tf32_hi(bv.w);
  } else {
    const float2 bv = *reinterpret_cast<const float2*>(b + 2 * lane);
    b_hi[0][0] = tf32_hi(bv.x);
    b_hi[0][1] = tf32_hi(bv.y);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int o = kk * LDA + (16 * mt + g) * 8 + 2 * t;
    const float2 top = *reinterpret_cast<const float2*>(a + o);
    const float2 bot = *reinterpret_cast<const float2*>(a + o + 64);
    const float2 ptop = *reinterpret_cast<const float2*>(a_prev + o);
    const float2 pbot = *reinterpret_cast<const float2*>(a_prev + o + 64);
    const uint32_t hi[4] = {tf32_hi(sub(top.x, ptop.x)), tf32_hi(sub(bot.x, pbot.x)),
                            tf32_hi(sub(top.y, ptop.y)), tf32_hi(sub(bot.y, pbot.y))};
#pragma unroll
    for (int n = 0; n < NB; ++n) mma(acc[n][mt], hi, b_hi[n][0], b_hi[n][1]);
  }
}

// acc = (A - A_prev)[:, 8 klo : 8 khi] B in one TF32 pass, for a run-time
// nb of 0, 1 or 2 n-tiles (as `product_nb`)
template <int MT, int UNROLL, int LDA = 16 * MT * 8>
__device__ __forceinline__ void product1_nb(float (&acc)[2][MT][4], int nb, const float* a,
                                            const float* a_prev, const float* b, int klo,
                                            int khi, int lane, int g, int t) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][mt][i] = 0.0f;
  if (nb == 2) {
#pragma unroll UNROLL
    for (int kk = klo; kk < khi; ++kk, b += 2 * kBlock)
      k_step1<MT, 2, LDA>(acc, a, a_prev, kk, b, lane, g, t);
  } else if (nb == 1) {
#pragma unroll UNROLL
    for (int kk = klo; kk < khi; ++kk, b += kBlock)
      k_step1<MT, 1, LDA>(acc, a, a_prev, kk, b, lane, g, t);
  }
}

// Accumulator element i of m-tile mt sits at row 16 mt + g + 8 (i / 2),
// column 2 t + i % 2 of the n-tile.
__device__ __forceinline__ int frag_row(int mt, int i, int g) { return 16 * mt + g + 8 * (i >> 1); }

// s = z - l of the thread's accumulator tile into an A buffer at columns
// c0 + 2 t + e (c0 a multiple of 8); `buf` points at the piece's first
// row, and the buffer's 8-column groups are LDA floats apart
template <int LDA, int MW>
__device__ __forceinline__ void store_piece_s(float* buf, int c0, int g, int t,
                                              const float (&z)[MW][4],
                                              const float (&l)[MW][4]) {
  float* p = buf + (c0 / 8) * LDA + 8 * g;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int mt = 0; mt < MW; ++mt)
      p[8 * frag_row(mt, i, 0) + a_pos(2 * t + (i & 1))] = sub(z[mt][i], l[mt][i]);
}

// z = clip(alpha v + (1 - alpha) z + l, lo, hi); l = (l + v) - z, with
// lo[c + e], hi[c + e] the bounds of the thread's column c + e (padded
// columns: 0, so they stay 0). Without over-relaxation (alpha = 1) the
// old z is not read, so z need not live from one iteration to the next.
template <int MT, bool RELAX>
__device__ __forceinline__ void box_update(const float (&v)[MT][4], float (&z)[MT][4],
                                           float (&l)[MT][4], const float* lo, const float* hi,
                                           int c, float alpha, float one_minus_alpha) {
  const float2 lo2 = *reinterpret_cast<const float2*>(lo + c);
  const float2 hi2 = *reinterpret_cast<const float2*>(hi + c);
  const float lo_e[2] = {lo2.x, lo2.y}, hi_e[2] = {hi2.x, hi2.y};
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float zr =
          RELAX ? add(mul(alpha, v[mt][i]), mul(one_minus_alpha, z[mt][i])) : v[mt][i];
      const float zn = clip(add(zr, l[mt][i]), lo_e[i & 1], hi_e[i & 1]);
      l[mt][i] = sub(add(l[mt][i], v[mt][i]), zn);
      z[mt][i] = zn;
    }
}

// A fragment-layout tile of a row-major (batch, width) array: rows
// row0 + frag_row, columns c0 + 2 t + {0, 1}; columns >= width are 0.
template <int MT>
__device__ __forceinline__ void load_frag(const float* __restrict__ g_arr, size_t row0, int c0,
                                          int width, int g, int t, float (&v)[MT][4]) {
  const int c = c0 + 2 * t;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* p = g_arr + (row0 + frag_row(mt, 2 * h, g)) * width + c;
      if (width % 2 == 0 && c < width) {
        const float2 x = *reinterpret_cast<const float2*>(p);
        v[mt][2 * h] = x.x;
        v[mt][2 * h + 1] = x.y;
      } else {
        v[mt][2 * h] = c < width ? p[0] : 0.0f;
        v[mt][2 * h + 1] = c + 1 < width ? p[1] : 0.0f;
      }
    }
}

template <int MT>
__device__ __forceinline__ void store_frag(float* __restrict__ g_arr, size_t row0, int c0,
                                           int width, int g, int t, const float (&v)[MT][4]) {
  const int c = c0 + 2 * t;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* p = g_arr + (row0 + frag_row(mt, 2 * h, g)) * width + c;
      if (width % 2 == 0 && c < width) {
        *reinterpret_cast<float2*>(p) = make_float2(v[mt][2 * h], v[mt][2 * h + 1]);
      } else {
        if (c < width) p[0] = v[mt][2 * h];
        if (c + 1 < width) p[1] = v[mt][2 * h + 1];
      }
    }
}

}  // namespace
