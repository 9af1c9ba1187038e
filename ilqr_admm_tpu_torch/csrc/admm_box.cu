// Fused box-constrained LQT-ADMM fleet with state bounds, for sm_90a.
//
// Replaces the Pallas TPU kernel `_admm_kernel`
// (ilqr_admm_tpu/ops/pallas_admm.py:229). Each CUDA block owns one tile of
// `T` instances and runs the whole ADMM loop on it without leaving the SM.
// The TPU kernel's iteration
//
//     r     = r_base + (z_x - l_x) (Su^T Qr)^T + (z_u - l_u) Rr^T
//     u_hat = r l_inv^T;   x_hat = free + u_hat Su^T
//
// is run with l_inv folded into the operators once, in f64, on the host,
// as the TPU's u-only kernel folds it into W_u:
//
//     u_hat = u_base + [z_x - l_x, z_u - l_u] W_s                (phase 1)
//     x_hat = free + u_hat Su^T                                   (phase 2)
//
// with u_base = r_base l_inv^T and W_s = [(l_inv Su^T Qr)^T; (l_inv Rr)^T]
// ((Nd + Nm) x Nm; the last Nm rows are zero without control bounds);
// then, for the x block and (when `has_u`) the u block,
// z = clip(alpha v_hat + (1 - alpha) z + l, lo, hi) and l = l + v_hat - z.
// From (z_x, z_u, l_x, l_u) = (free + u0 Su^T, u0, 0, 0). A problem
// without state bounds takes the u-only kernel instead, so the x block
// always runs; +-inf bounds pass through fminf/fmaxf.
// Outputs: x_hat, u_hat, z_x, z_u of the last iteration.
//
// Why the folded form: in f32 the TPU kernel's r reaches |r| ~ 33 at the
// full-width configuration while u_hat is ~5, and the rounding of r and of
// r l_inv^T holds ||u_hat - z_u|| near 1.2e-4 at any iteration count,
// above the 1e-4 certificate. Folded, the residual floor is ~2e-5 (both
// measured with the plain version on the CPU).
//
// What bounds it on an H100: at the full width (Nm = 100, Nd = 200) an
// instance-iteration is 2 ((Nd + Nm) Nm + Nm Nd / 2) = 80,000 FLOP with
// the zeros of Su^T skipped; 16,384 instances x 200 iterations is
// 2.6e11 FLOP against ~40 MB of traffic in and out: compute bound. As
// three TF32 products (below) that is 1.56 ms at the 495 TFLOP/s dense
// TF32 peak, against 3.9 ms at the 67 TFLOP/s f32 CUDA-core peak. Two
// things measured on an H100 (tools/mma_sync_bench.cu, PERF.md) shape the
// design: `mma.sync` TF32 reaches ~260 TFLOP/s (one m16n8k8 every ~7.4
// cycles on each of an SM's four sub-partitions), and other instructions
// a sub-partition issues beside it add to that time as often as they
// hide behind it. So the design spends as few instructions as it can on
// each mma, and none on spills.
//
// What the design does about it:
// - Both products run on the tensor cores as warp-level
//   `mma.sync.m16n8k8` in TF32, with instances as M, output columns as N
//   and the reduction as K. TF32 alone keeps 11 bits of each operand,
//   which holds the residual near 1e-2 (the plain TF32 trap); so every
//   operand x is split into hi = tf32(x) and lo = x - hi, and each
//   product is lo_a hi_b + hi_a lo_b + hi_a hi_b, the two small terms
//   first, into one f32 accumulator: 3xTF32, the Hopper counterpart of the
//   TPU kernel's bf16x3 `_dot3`. Operands are split as their fragments are
//   loaded (pre-split operators would not fit): three integer or f32
//   operations a value (`split`; the helpers are in csrc/tf32x3.cuh).
// - A warp takes two n-tiles at a time (16 output columns) for all T
//   instances, so each A fragment it splits feeds two n-tiles and each B
//   fragment MT row tiles: 12 mma a k-step.
// - The operators live in shared memory, in f32, as 8 x 8 (k, n) blocks in
//   the B-fragment order of the mma, the two n-tiles of a pair interleaved
//   (lane 4 g + t reads (k, n) = (t, g) and (t + 4, g) of each in one
//   16-byte load), one contiguous run for each pair over its k-range
//   (`pair_pack` in ops/fused_admm.py). Su^T is block triangular, so its
//   pairs keep only their nonzero blocks: exact zeros are skipped and no
//   sum changes. W_s is dense (38 x 13 blocks at the full width); Su^T
//   keeps 169 of its 13 x 25.
// - s = [z_x - l_x, z_u - l_u] and u_hat, the A operands, go to shared
//   memory group-major (`a_pos`): every address in the inner loop is a
//   per-thread base plus a constant, and the fragment loads are free of
//   bank conflicts. s_x is padded to whole 8-column tiles, and W_s's rows
//   with it, so that no store needs a mask.
// - The host deals the work out (`box_schedule`): phase 1 splits each
//   pair of W_s's n-tiles by k over two warps, each owning one n-tile's
//   u_hat, z_u, l_u and u_base in registers in the accumulator layout and
//   adding the other's partial sum from the u_hat buffer; a last single
//   n-tile is shared by up to four warps, through two more slots. Phase 2
//   gives each warp at most one pair of Su^T's n-tiles, whose z_x, l_x and
//   free stay in its registers. Warp w runs on sub-partition w % 4, and
//   the pieces are dealt so that the four carry nearly equal work.
// - Three barriers an iteration: after phase 1's products (partial sums
//   handed over, every read of s done), after u_hat and the u block, and
//   after phase 2 (the new s complete).
// - Registers: 16 warps leave 128 a thread, and a spill costs more than
//   the loads it saves (on an H100 the spill-free build took 6.0 ms where
//   one spilling 384 bytes took 7.6). So the bounds and the warp
//   schedule sit in shared memory; without over-relaxation the old z is
//   not read and does not stay in registers; the over-relaxed build with
//   32 instances re-reads free each iteration and keeps one k-step in
//   flight instead of two.
// - The clip and dual updates use explicitly rounded f32 operations (no
//   FMA contraction), as the plain torch version rounds them.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int kMaxWarps = 16;  // four a sub-partition, 128 registers a thread
constexpr int kSched = 16;     // ints of one warp's schedule (see admm_box_kernel)
constexpr int kSlots = 2;      // partial-sum slots besides the u_hat buffer

// v (the thread's columns 2 t + e of a tile) to an A buffer at columns
// k0 + 2 t + e, k0 a multiple of 8, or back from it. Padded columns hold
// zeros, and every A column has room for a whole tile, so no store is
// masked.
template <int MT>
__device__ __forceinline__ void store_a(float* buf, int k0, int g, int t,
                                        const float (&v)[MT][4]) {
  float* p = buf + (k0 / 8) * (16 * MT * 8) + 8 * g;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) p[8 * (frag_row(mt, i, 0)) + a_pos(2 * t + (i & 1))] = v[mt][i];
}

template <int MT>
__device__ __forceinline__ void load_a(const float* buf, int k0, int g, int t,
                                       float (&v)[MT][4]) {
  const float* p = buf + (k0 / 8) * (16 * MT * 8) + 8 * g;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) v[mt][i] = p[8 * (frag_row(mt, i, 0)) + a_pos(2 * t + (i & 1))];
}

// s = z - l into an A buffer
template <int MT>
__device__ __forceinline__ void store_s(float* buf, int k0, int g, int t,
                                        const float (&z)[MT][4], const float (&l)[MT][4]) {
  float s[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[mt][i] = sub(z[mt][i], l[mt][i]);
  store_a<MT>(buf, k0, g, t, s);
}

// acc[n] for a run-time n of 0 or 1
template <int MT>
__device__ __forceinline__ void pick(const float (&acc)[2][MT][4], int n, float (&v)[MT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) v[mt][i] = n == 0 ? acc[0][mt][i] : acc[1][mt][i];
}

// ops_f: the operators' blocks in `pair_pack` storage (W_s's, then Su^T's);
// sched: kSched ints a warp, from `box_schedule` in ops/fused_admm.py:
//   [0..10] phase 1: float offset of its first block, k-steps [klo, khi),
//          nb (0: no phase-1 work, 1 or 2 n-tiles), first n-tile; the
//          n-tile (0 or 1 of its nb; -1: none) whose partial sum it hands
//          over, and where to (-1: the u_hat buffer at that tile's
//          columns, else a partial-sum slot); the n-tile whose u columns
//          it owns (-1: none), whether its owner adds a partial from the
//          u_hat buffer, and the slots [lo, hi) it adds after that;
//   [11..15] phase 2: float offset, klo, khi, nb (0, 1 or 2), first n-tile.
// Phase-1 items (pairs of n-tiles, or a last single one) are split by k
// over two or more warps; each n-tile has one owner (u_hat, z_u, l_u,
// u_base in registers), which adds the others' partial sums in a fixed
// order.
template <int MT, bool RELAX>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
admm_box_kernel(const float* __restrict__ free_g, const float* __restrict__ u_base,
                const float* __restrict__ u0, const float* __restrict__ ops_f, int n_ops_f,
                const int* __restrict__ sched, const float* __restrict__ xb,
                const float* __restrict__ ub, float* __restrict__ x_out,
                float* __restrict__ u_out, float* __restrict__ zx_out,
                float* __restrict__ zu_out, int Nm, int Nd, int n_iters,
                int has_u, float alpha, float one_minus_alpha) {
  constexpr int T = 16 * MT;
  extern __shared__ float4 smem_f4[];
  float* ops = reinterpret_cast<float*>(smem_f4);
  const int n1 = (Nm + 7) / 8, n2 = (Nd + 7) / 8;
  const int ku = 8 * n2;     // s_u's first column: s_x is padded to whole tiles
  float* s = ops + n_ops_f;         // n2 + n1 groups: [s_x, s_u]
  float* uh = s + T * 8 * (n1 + n2);  // n1 groups: u_hat (and partial sums)
  float* xlo = uh + T * 8 * n1;       // the bounds, zero-padded to 8 n2 and 8 n1
  float* xhi = xlo + 8 * n2;
  float* ulo = xhi + 8 * n2;
  float* uhi = ulo + 8 * n1;
  float* slots = uhi + 8 * n1;  // kSlots x (32 lanes x 4 MT) partial sums
  int* sched_s = reinterpret_cast<int*>(slots + kSlots * T * 8);  // the schedule

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  const float4* src = reinterpret_cast<const float4*>(ops_f);
  for (int i = tid; i < n_ops_f / 4; i += blockDim.x) smem_f4[i] = src[i];
  for (int i = tid; i < T * 8 * (2 * n1 + n2) + 16 * (n1 + n2); i += blockDim.x) s[i] = 0.0f;

  for (int i = tid; i < kSched * (blockDim.x / 32); i += blockDim.x) sched_s[i] = sched[i];
  // this warp's schedule, read from shared memory where it is used rather
  // than held in registers, which the tiles' state needs
  const volatile int* w = sched_s + kSched * warp;

  // Over-relaxation keeps z in registers; to stay within 128 registers
  // that variant re-reads free from global memory (L1/L2) each iteration
  // and keeps one k-step in flight instead of two
  constexpr bool kFreeInRegs = !(RELAX && MT == 2);
  constexpr int kUnroll = kFreeInRegs ? 2 : 1;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * T;
  float zu[MT][4], lu[MT][4], ubase[MT][4];
  float zx[2][MT][4], lx[2][MT][4], fr[2][MT][4];
  float acc[2][MT][4], v[MT][4];

  __syncthreads();  // operators and schedule staged, buffers zeroed
  for (int i = tid; i < Nd; i += blockDim.x) {
    xlo[i] = xb[i];
    xhi[i] = xb[Nd + i];
  }
  for (int i = tid; i < Nm; i += blockDim.x) {
    ulo[i] = ub[i];
    uhi[i] = ub[Nm + i];
  }
  if (w[7] >= 0) {
    const int cu = 8 * (w[4] + w[7]);  // the owned u columns
    load_frag<MT>(u0, row0, cu, Nm, g, t, zu);
    load_frag<MT>(u_base, row0, cu, Nm, g, t, ubase);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) lu[mt][i] = 0.0f;
    store_a<MT>(uh, cu, g, t, zu);
    store_a<MT>(s, ku + cu, g, t, zu);
    if (n_iters == 0) store_frag<MT>(u_out, row0, cu, Nm, g, t, zu);
    if (n_iters == 0 || !has_u) store_frag<MT>(zu_out, row0, cu, Nm, g, t, zu);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
    if (n < w[14]) load_frag<MT>(free_g, row0, 8 * (w[15] + n), Nd, g, t, fr[n]);
  __syncthreads();

  // z_x = free + u0 Su^T
  product_nb<MT, kUnroll>(acc, w[14], uh, ops + w[11], w[12], w[13], lane, g, t);
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    if (n >= w[14]) continue;
    const int n2_0 = w[15];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        zx[n][mt][i] = add(fr[n][mt][i], acc[n][mt][i]);
        lx[n][mt][i] = 0.0f;
      }
    store_a<MT>(s, 8 * (n2_0 + n), g, t, zx[n]);
    if (n_iters == 0) {
      store_frag<MT>(x_out, row0, 8 * (n2_0 + n), Nd, g, t, zx[n]);
      store_frag<MT>(zx_out, row0, 8 * (n2_0 + n), Nd, g, t, zx[n]);
    }
  }
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    const bool last = it == n_iters - 1;
    // phase 1: this warp's k-part of s W_s for its n-tiles; the partner's
    // slot goes to the u_hat buffer
    product_nb<MT, kUnroll>(acc, w[3], s, ops + w[0], w[1], w[2], lane, g, t);
    if (w[5] >= 0) {
      const int give_to = w[6];
      pick<MT>(acc, w[5], v);
      if (give_to < 0) {
        store_a<MT>(uh, 8 * (w[4] + w[5]), g, t, v);
      } else {
        float4* slot = reinterpret_cast<float4*>(slots + (give_to * 32 + lane) * 4 * MT);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) slot[mt] = make_float4(v[mt][0], v[mt][1], v[mt][2], v[mt][3]);
      }
    }
    __syncthreads();  // partial sums handed over; every read of s done
    // u_hat = u_base + (own part + the others' parts), then the u block
    if (w[7] >= 0) {
      const int cu = 8 * (w[4] + w[7]);
      float part[MT][4];
      pick<MT>(acc, w[7], v);
      if (w[8]) {
        load_a<MT>(uh, cu, g, t, part);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) v[mt][i] = add(v[mt][i], part[mt][i]);
      }
      for (int j = w[9]; j < w[10]; ++j) {
        const float4* slot = reinterpret_cast<const float4*>(slots + (j * 32 + lane) * 4 * MT);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float4 q = slot[mt];
          v[mt][0] = add(v[mt][0], q.x);
          v[mt][1] = add(v[mt][1], q.y);
          v[mt][2] = add(v[mt][2], q.z);
          v[mt][3] = add(v[mt][3], q.w);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) v[mt][i] = add(ubase[mt][i], v[mt][i]);
      store_a<MT>(uh, cu, g, t, v);
      if (last) store_frag<MT>(u_out, row0, cu, Nm, g, t, v);
      if (has_u) {
        box_update<MT, RELAX>(v, zu, lu, ulo, uhi, cu + 2 * t, alpha, one_minus_alpha);
        store_s<MT>(s, ku + cu, g, t, zu, lu);
        if (last) store_frag<MT>(zu_out, row0, cu, Nm, g, t, zu);
      }
    }
    __syncthreads();  // u_hat complete
    // phase 2: x_hat = free + u_hat Su^T, then the x block
    product_nb<MT, kUnroll>(acc, w[14], uh, ops + w[11], w[12], w[13], lane, g, t);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (n >= w[14]) continue;
      const int c0 = 8 * (w[15] + n);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) v[mt][i] = acc[n][mt][i];
      if (!kFreeInRegs) load_frag<MT>(free_g, row0, c0, Nd, g, t, fr[n]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) v[mt][i] = add(fr[n][mt][i], v[mt][i]);
      if (last) store_frag<MT>(x_out, row0, c0, Nd, g, t, v);
      box_update<MT, RELAX>(v, zx[n], lx[n], xlo, xhi, c0 + 2 * t, alpha, one_minus_alpha);
      store_s<MT>(s, c0, g, t, zx[n], lx[n]);
      if (last) store_frag<MT>(zx_out, row0, c0, Nd, g, t, zx[n]);
    }
    __syncthreads();  // s complete
  }
}

}  // namespace

extern "C" int admm_box_launch(const void* free_g, const void* u_base, const void* u0,
                               const void* ops_f, int n_ops_f, const void* sched, int n_warps,
                               const void* xb, const void* ub, void* x_out, void* u_out,
                               void* zx_out, void* zu_out, int batch, int Nm, int Nd, int T,
                               int n_iters, int has_u, float alpha, float one_minus_alpha,
                               void* stream) {
  if (Nm <= 0 || Nd <= 0 || (T != 16 && T != 32) || batch <= 0 || batch % T != 0 ||
      n_ops_f < 0 || n_ops_f % kBlock != 0 || n_iters < 0 || n_warps < 1 ||
      n_warps > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n1 = (Nm + 7) / 8, n2 = (Nd + 7) / 8;
  const size_t smem = sizeof(float) * (static_cast<size_t>(n_ops_f) +
                                       static_cast<size_t>(T) * 8 * (2 * n1 + n2 + kSlots) +
                                       16 * (n1 + n2) + kSched * n_warps);
  const bool relax = alpha != 1.0f;
  auto kernel = T == 32 ? (relax ? admm_box_kernel<2, true> : admm_box_kernel<2, false>)
                        : (relax ? admm_box_kernel<1, true> : admm_box_kernel<1, false>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch / T, 32 * n_warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(free_g), static_cast<const float*>(u_base),
      static_cast<const float*>(u0), static_cast<const float*>(ops_f), n_ops_f,
      static_cast<const int*>(sched), static_cast<const float*>(xb),
      static_cast<const float*>(ub), static_cast<float*>(x_out), static_cast<float*>(u_out),
      static_cast<float*>(zx_out), static_cast<float*>(zu_out), Nm, Nd, n_iters,
      has_u, alpha, one_minus_alpha);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* admm_box_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
