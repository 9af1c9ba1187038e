// Fused box-constrained LQT-ADMM fleet with state bounds, at widths where
// the operators do not fit in a block's shared memory, for sm_90a.
//
// The wide route of the Pallas TPU kernel `_admm_kernel`
// (ilqr_admm_tpu/ops/pallas_admm.py:229), beside csrc/admm_box.cu, which
// stages its packed operators whole in shared memory and so stops at Nm =
// 128, Nd = 256. The iteration is csrc/admm_box.cu's folded form:
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
// fleet (N = 100: Nm = 200, Nd = 400) multiplies about 80,000 nonzeros of
// W_s and Su^T an instance-iteration (the x and y axes do not couple),
// 16,384 instances x 200 iterations: 3.13 ms as 3xTF32 at the 495 TFLOP/s
// dense TF32 peak, against ~80 MB of traffic in and out. Every block
// reads the operators every iteration, so the stream from L2 is the cost
// to cut: the warp-level design this kernel replaced (mma.sync with the
// instances as M, each warp splitting its own s fragments, 16 times the
// same ones a block) streamed 2,525 8 x 8 blocks (646 KB) a
// block-iteration, half of them exact zeros, and was set by the issue of
// its instructions.
//
// The design, for Hopper's warpgroup products:
// - The roles swapped: the operators' transposes (W_s^T, Su) are the A
//   operand of TF32 `wgmma.m64nTk8`, in 64-row M tiles, from registers;
//   the block's T = 8, 16 or 32 instances are N. s = [s_x, s_u] and u_hat
//   are the B operand in shared memory, K-major without swizzle, as TF32
//   hi and lo (`split`), each value split once an iteration by the
//   epilogue that writes it. Three wgmma a k-step, small terms first:
//   hi_W lo_s, lo_W hi_s, hi_W hi_s; kGroup k-steps a commit group.
// - The columns are ordered group by group (the plant's axes,
//   `box_components` in ops/fused_admm.py), each padded to 8 in shared
//   memory and to whole M tiles in the accumulators, so each tile's A
//   holds only its own group's k-steps: the packing keeps a tile's
//   nonzero k-steps only (228 of them at the planar fleet, 467 KB a
//   block-iteration, against 646 KB before). The wrapper spreads the
//   inputs to that order and gathers the outputs back.
// - 4 warpgroups. Each streams its own tiles' A fragments from L2 (f32,
//   16 bytes a thread a k-step, `pack_box_operators(..., "wide")` order:
//   its phase-1 tiles, then its phase-2 tiles, one contiguous stream an
//   iteration) through a ring of kStages k-steps in shared memory
//   (`cp.async`, each thread copying and reading its own 16 bytes), and
//   splits its own 4 values a k-step. The tiles are dealt longest first to
//   the least loaded warpgroup, so both phases are balanced by k-steps.
// - Each tile's k range in chunks of KC k-steps, each chunk summed on the
//   tensor cores from zero and added to its total in f32: one chain over
//   the k range misses the f32 plain version.
// - Shared memory: s (u_hat takes s_u's place while phase 2 reads it), the
//   rings, the bounds, the tile table and the k-steps: 196,448 B at the
//   planar fleet, T = 32. l_u, the u-block's new s_u and the phase-1 u_hat
//   of a warpgroup's own u columns stay in registers (at most 32 / T
//   tiles a warpgroup); l_x lives in x_out, which the last iteration
//   overwrites with x_hat.
// - What the measurements say (H100, the planar fleet at T = 32; PERF.md
//   §6): the tensor cores take a TF32 m64n32k8 in 16 cycles of an SM when
//   4 warpgroups issue 3 a wait (tools/wgmma_tf32_bench.cu), ~11 k cycles
//   a block-iteration, ~5 ms a solve. The L2 stream sets the time: the
//   fragments, u_base, free and l_x, ~650 KB a block-iteration, move at
//   ~3.2 TB/s, and the stream without the products takes ~13.6 ms
//   (tools/admm_box_wide_variants.py). A ring of k-steps in registers left
//   the L2 latency exposed (ptxas refills the registers the split frees
//   only after the wgmma wait); the shared-memory ring hides it, 4 stages
//   as well as 8.
// - Four barriers an iteration: after phase 1 (every read of s done), once
//   u_hat is in place of s_u, after phase 2 (every read of u_hat done),
//   and once s_u is back. Writes to the B operands are made visible to
//   the tensor cores' async proxy before each barrier.
// - Padded columns get zero inputs, bounds and operator rows, so they stay
//   0. The clip and dual updates use explicitly rounded f32 operations (no
//   FMA contraction), as the plain torch version rounds them.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int kGroups = 4;   // warpgroups a block
constexpr int kHeader = 32;  // ints of ops_i's header
// k-steps a product chains on the tensor cores before it adds the chunk's
// sum to its total in f32; k-steps of A fragments in flight a warpgroup
// (its ring of shared-memory stages); k-steps whose wgmma are issued as
// one commit group and waited for together (a tile's stored k-steps are a
// multiple of it); tools/admm_box_wide_variants.py builds and times other
// values
constexpr int KC = 8;
constexpr int kStages = 4;
constexpr int kGroup = 2;

struct Problem {
  const float* free_g;  // (batch, nx), in the layout's column order
  const float* u_base;  // (batch, nu)
  const float* u0;      // (batch, nu)
  const float* ops_f;   // the warpgroups' streams of A fragments
  const int* ops_i;     // header, tile table (col0, rows, steps), k-steps
  const float* xb;      // (2, nx)
  const float* ub;      // (2, nu)
  float* x_out;         // l_x until the last iteration writes x_hat
  float* u_out;
  float* zx_out;
  float* zu_out;
  int nx, nu, n_tiles, n_steps, n_iters, has_u;
  float alpha, one_minus_alpha;
};

// v, as a value the compiler cannot see through: the global addresses
// derived from it are computed where they are used instead of being held
// (and spilled) across the loop's products
__device__ __forceinline__ size_t fresh(size_t v) {
  asm volatile("" : "+l"(v));
  return v;
}

// registers the compiler must keep (and not move reads of) up to here: a
// wgmma reads its A registers and writes its accumulators asynchronously
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void keep(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// this thread's writes to shared memory, visible to the tensor cores
__device__ __forceinline__ void async_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes from global to shared memory, asynchronously (L2 only), one
// commit group each; a thread waits for its own copies
__device__ __forceinline__ void copy16(float4* dst, const float4* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\ncp.async.commit_group;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d (+)= A B for a 64 x 8 A in registers (TF32, the thread's 4 values) and
// an 8 x T B in shared memory (descriptor b); scale_d 0 sets d = A B
template <int T>
struct Mma;

template <>
struct Mma<8> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// The B operands (s, u_hat) hold T instances of each column k, K-major
// without swizzle: 8 x 16-byte core matrices (8 instances x 4 k), the
// instance groups T / 8 apart inside each group of 4 k, so a k-step of 8
// is 32 T bytes at byte 32 T (k / 8): LBO 16 T (the next 4 k), SBO 128.
template <int T>
__device__ __forceinline__ int b_index(int k, int n) {
  return (((k >> 2) * (T / 8) + (n >> 3)) << 5) + ((n & 7) << 2) + (k & 3);
}

template <int T>
__device__ __forceinline__ uint64_t b_desc(const float* base) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(base));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(T) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// v split into TF32 hi and lo at (k, n) of the two B buffers
template <int T>
__device__ __forceinline__ void store_b(float* b_hi, float* b_lo, int k, int n, float v) {
  uint32_t hi, lo;
  split(v, hi, lo);
  const int i = b_index<T>(k, n);
  b_hi[i] = __uint_as_float(hi);
  b_lo[i] = __uint_as_float(lo);
}

// Accumulator element e of a thread: row 16 w + g + 8 ((e >> 1) & 1) of the
// M tile (w the warp in its warpgroup), instance 8 (e >> 2) + 2 t + (e & 1)
__device__ __forceinline__ int acc_row(int e, int w, int g) { return 16 * w + g + 8 * ((e >> 1) & 1); }
__device__ __forceinline__ int acc_inst(int e, int t) { return 8 * (e >> 2) + 2 * t + (e & 1); }

// A warpgroup's stream of A fragments, as one thread sees it: its 16
// bytes of each k-step (128 float4 apart) in global memory, cycled every
// iteration, and a ring of kStages shared-memory stages (128 float4 apart)
// that holds the next kStages - 1 k-steps, each thread copying and
// reading only its own 16 bytes of a stage.
struct Stream {
  const float4* frag;  // k-step 0 of the warpgroup's stream
  float4* ring;        // stage 0 of the warpgroup's ring
  const int* ks;       // the k-steps' absolute 8-column groups (shared memory)
  int len;             // k-steps an iteration
  int v;               // stream step consumed next
  int next;            // stream step copied next
  unsigned q;          // k-steps consumed so far: stage q % kStages is next

  // copy kStages - 1 k-steps from stream step v0 (len > 0)
  __device__ __forceinline__ void start(int v0) {
    v = next = v0;
    q = 0;
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) refill(i);
  }
  __device__ __forceinline__ void refill(unsigned stage) {
    copy16(ring + (stage % kStages) * 128, frag + static_cast<size_t>(next) * 128);
    if (++next == len) next = 0;
  }
  // the next k-step's 16 bytes and its k-step index; the stage read last
  // time (read, so free) takes the k-step kStages - 1 ahead
  __device__ __forceinline__ float4 take(int& k) {
    copies_wait<kStages - 2>();
    const float4 a = ring[(q % kStages) * 128];
    k = ks[v];
    refill(q + kStages - 1);
    ++q;
    if (++v == len) v = 0;
    return a;
  }
};

// acc = the tile's A times B over its n stored k-steps (a multiple of
// kGroup), taken from the warpgroup's stream. kGroup k-steps are split,
// then their 3 kGroup wgmma issued as one commit group and waited for; a
// chunk's end adds the chunk to acc. desc: B hi at k-step 0; lo_step: B
// lo's offset, 16-byte units.
template <int T>
__device__ __forceinline__ void product(float (&acc)[T / 2], float (&part)[T / 2], Stream& st,
                                        int n, uint64_t desc, uint32_t lo_step) {
  static_assert(KC % kGroup == 0, "groups must tile the chunks");
#pragma unroll
  for (int i = 0; i < T / 2; ++i) acc[i] = 0.0f;
  for (int s = 0; s < n; s += kGroup) {
    uint32_t hi[kGroup][4], lo[kGroup][4];
    uint64_t bh[kGroup];
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      int k;
      const float4 a = st.take(k);
      split(a.x, hi[e][0], lo[e][0]);
      split(a.y, hi[e][1], lo[e][1]);
      split(a.z, hi[e][2], lo[e][2]);
      split(a.w, hi[e][3], lo[e][3]);
      bh[e] = desc + static_cast<uint64_t>(k * (2 * T));
    }
    wgmma_fence();
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      Mma<T>::run(part, hi[e], bh[e] + lo_step, (s + e) % KC != 0);
      Mma<T>::run(part, lo[e], bh[e], 1);
      Mma<T>::run(part, hi[e], bh[e], 1);
    }
    wgmma_commit();
    wgmma_wait();
    keep(part);
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      keep(hi[e]);
      keep(lo[e]);
    }
    if ((s + kGroup) % KC == 0 || s + kGroup == n) {
#pragma unroll
      for (int i = 0; i < T / 2; ++i) acc[i] = add(acc[i], part[i]);
    }
  }
}

template <int T, bool RELAX>
__global__ void __launch_bounds__(128 * kGroups, 1) admm_box_wide_kernel(Problem P) {
  constexpr int NR = T / 2;   // accumulator registers a tile
  constexpr int P1 = 32 / T;  // phase-1 tiles a warpgroup at most
  extern __shared__ __align__(128) float smem[];
  const int nx = P.nx, nu = P.nu, nk = nx + nu;
  float* b_hi = smem;  // s = [s_x, s_u] (u_hat in s_u's place in phase 2), TF32 hi
  float* b_lo = b_hi + T * nk;
  float4* rings = reinterpret_cast<float4*>(b_lo + T * nk);  // kStages x 128 float4 a warpgroup
  float* xlo = reinterpret_cast<float*>(rings + kGroups * kStages * 128);
  float* xhi = xlo + nx;
  float* ulo = xhi + nx;
  float* uhi = ulo + nu;
  int* tiles = reinterpret_cast<int*>(uhi + nu);  // (col0, rows, steps)
  int* ksteps = tiles + 3 * P.n_tiles;

  const int tid = threadIdx.x, wg = tid / 128, tw = tid % 128;
  const int w = tw / 32, g = tw % 32 / 4, t = tw % 4;
  const int* H = P.ops_i;
  const int n1 = H[4 + wg], n2 = H[4 + kGroups + wg], tile0 = H[4 + 2 * kGroups + wg];
  const int len = H[4 + 3 * kGroups + wg], step0 = H[4 + 4 * kGroups + wg];
  const int p2 = H[4 + 5 * kGroups + wg];
  const size_t row0 = static_cast<size_t>(blockIdx.x) * T;
  for (int i = tid; i < 2 * T * nk; i += blockDim.x) smem[i] = 0.0f;
  for (int i = tid; i < nx; i += blockDim.x) {
    xlo[i] = P.xb[i];
    xhi[i] = P.xb[nx + i];
  }
  for (int i = tid; i < nu; i += blockDim.x) {
    ulo[i] = P.ub[i];
    uhi[i] = P.ub[nu + i];
  }
  for (int i = tid; i < 3 * P.n_tiles + P.n_steps; i += blockDim.x) tiles[i] = H[kHeader + i];
  __syncthreads();  // buffers zeroed, bounds and tables staged

  Stream st;
  st.frag = reinterpret_cast<const float4*>(P.ops_f) + static_cast<size_t>(step0) * 128 + tw;
  st.ring = rings + wg * kStages * 128 + tw;
  st.ks = ksteps + step0;
  st.len = len;
  if (len > 0) st.start(p2 == len ? 0 : p2);  // the stream starts at phase 2 (z_x = free + u0 Su^T)
  const uint64_t desc = b_desc<T>(b_hi);
  const uint32_t lo_step = static_cast<uint32_t>(T * nk / 4);
  float acc[NR], part[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) part[i] = 0.0f;
  // per own phase-1 tile: l_u, the u block's new s_u (u0 without one), u_hat
  float lu[P1][NR], su[P1][NR], uh[P1][NR];

  // z_u = u0, l_u = 0: u0 into s_u, which is u_hat for the first phase 2
#pragma unroll
  for (int j = 0; j < P1; ++j) {
    if (j >= n1) continue;
    const int* tile = tiles + 3 * (tile0 + j);
    const int col0 = tile[0], rows = tile[1];
#pragma unroll
    for (int e = 0; e < NR; ++e) {
      lu[j][e] = 0.0f;
      su[j][e] = 0.0f;
      const int r = acc_row(e, w, g), n = acc_inst(e, t);
      if (r >= rows) continue;
      const size_t gi = (row0 + n) * nu + col0 + r;
      const float z = P.u0[gi];
      su[j][e] = z;
      store_b<T>(b_hi, b_lo, nx + col0 + r, n, z);
      if (P.n_iters == 0) P.u_out[gi] = z;
      if (RELAX || P.n_iters == 0 || !P.has_u) P.zu_out[gi] = z;
    }
  }
  async_fence();
  __syncthreads();  // u_hat = u0

  // z_x = free + u0 Su^T, l_x = 0 (in x_out)
  for (int j = 0; j < n2; ++j) {
    const int* tile = tiles + 3 * (tile0 + n1 + j);
    const int col0 = tile[0], rows = tile[1];
    product<T>(acc, part, st, tile[2], desc, lo_step);
    const size_t r0 = fresh(row0);
#pragma unroll
    for (int e = 0; e < NR; ++e) {
      const int r = acc_row(e, w, g), n = acc_inst(e, t);
      if (r >= rows) continue;
      const size_t gi = (r0 + n) * nx + col0 + r;
      const float x = add(acc[e], P.free_g[gi]);
      store_b<T>(b_hi, b_lo, col0 + r, n, x);
      P.x_out[gi] = P.n_iters == 0 ? x : 0.0f;
      if (RELAX || P.n_iters == 0) P.zx_out[gi] = x;
    }
  }
  async_fence();
  __syncthreads();  // s complete

  for (int it = 0; it < P.n_iters; ++it) {
    const bool last = it == P.n_iters - 1;
    // phase 1: u_hat = u_base + s W_s on the warpgroup's u tiles, then the
    // u block
#pragma unroll
    for (int j = 0; j < P1; ++j) {
      if (j >= n1) continue;
      const int* tile = tiles + 3 * (tile0 + j);
      const int col0 = tile[0], rows = tile[1];
      product<T>(acc, part, st, tile[2], desc, lo_step);
      const size_t r0 = fresh(row0);
#pragma unroll
      for (int e = 0; e < NR; ++e) {
        const int r = acc_row(e, w, g), n = acc_inst(e, t);
        if (r >= rows) continue;
        const int c = col0 + r;
        const size_t gi = (r0 + n) * nu + c;
        const float u = add(acc[e], P.u_base[gi]);
        uh[j][e] = u;
        if (last) P.u_out[gi] = u;
        if (P.has_u) {
          const float zr = RELAX ? add(mul(P.alpha, u), mul(P.one_minus_alpha, P.zu_out[gi])) : u;
          const float z = clip(add(zr, lu[j][e]), ulo[c], uhi[c]);
          lu[j][e] = sub(add(lu[j][e], u), z);
          su[j][e] = sub(z, lu[j][e]);
          if (RELAX || last) P.zu_out[gi] = z;
        }
      }
    }
    __syncthreads();  // every read of s done
#pragma unroll
    for (int j = 0; j < P1; ++j) {
      if (j >= n1) continue;
      const int* tile = tiles + 3 * (tile0 + j);
#pragma unroll
      for (int e = 0; e < NR; ++e) {
        const int r = acc_row(e, w, g);
        if (r < tile[1]) store_b<T>(b_hi, b_lo, nx + tile[0] + r, acc_inst(e, t), uh[j][e]);
      }
    }
    async_fence();
    __syncthreads();  // u_hat in place of s_u
    // phase 2: x_hat = free + u_hat Su^T on the warpgroup's x tiles, then
    // the x block (l_x read from and written back to x_out, which the last
    // iteration leaves holding x_hat)
    for (int j = 0; j < n2; ++j) {
      const int* tile = tiles + 3 * (tile0 + n1 + j);
      const int col0 = tile[0], rows = tile[1];
      product<T>(acc, part, st, tile[2], desc, lo_step);
      const size_t r0 = fresh(row0);
#pragma unroll
      for (int e = 0; e < NR; ++e) {
        const int r = acc_row(e, w, g), n = acc_inst(e, t);
        if (r >= rows) continue;
        const int c = col0 + r;
        const size_t gi = (r0 + n) * nx + c;
        const float x = add(acc[e], P.free_g[gi]);
        const float l = P.x_out[gi];
        const float zr = RELAX ? add(mul(P.alpha, x), mul(P.one_minus_alpha, P.zx_out[gi])) : x;
        const float z = clip(add(zr, l), xlo[c], xhi[c]);
        const float l_new = sub(add(l, x), z);
        P.x_out[gi] = last ? x : l_new;
        store_b<T>(b_hi, b_lo, c, n, sub(z, l_new));
        if (RELAX || last) P.zx_out[gi] = z;
      }
    }
    async_fence();
    __syncthreads();  // every read of u_hat done
#pragma unroll
    for (int j = 0; j < P1; ++j) {
      if (j >= n1) continue;
      const int* tile = tiles + 3 * (tile0 + j);
#pragma unroll
      for (int e = 0; e < NR; ++e) {
        const int r = acc_row(e, w, g);
        if (r < tile[1]) store_b<T>(b_hi, b_lo, nx + tile[0] + r, acc_inst(e, t), su[j][e]);
      }
    }
    async_fence();
    __syncthreads();  // s complete
  }
  copies_wait<0>();
}

template <int T, bool RELAX>
cudaError_t launch(const Problem& P, int batch, size_t smem, cudaStream_t stream) {
  auto kernel = admm_box_wide_kernel<T, RELAX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<batch / T, 128 * kGroups, smem, stream>>>(P);
  return cudaGetLastError();
}

}  // namespace

// free, u_base, u0, the bounds and the outputs in the layout's padded
// column order (nx and nu wide, multiples of 8); ops_f and ops_i of
// `pack_box_operators(W_s, SuT, "wide")` with its tile and k-step counts;
// T 8, 16 or 32.
extern "C" int admm_box_wide_launch(const void* free_g, const void* u_base, const void* u0,
                                    const void* ops_f, const void* ops_i, const void* xb,
                                    const void* ub, void* x_out, void* u_out, void* zx_out,
                                    void* zu_out, int batch, int nx, int nu, int n_tiles,
                                    int n_steps, int T, int n_iters, int has_u, float alpha,
                                    float one_minus_alpha, void* stream) {
  if (nx <= 0 || nu <= 0 || nx % 8 != 0 || nu % 8 != 0 || (T != 8 && T != 16 && T != 32) ||
      batch <= 0 || batch % T != 0 || n_iters < 0 || n_tiles <= 0 || n_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float4) * kGroups * kStages * 128 +
      sizeof(float) * (2 * static_cast<size_t>(T) * (nx + nu) + 2 * static_cast<size_t>(nx + nu) +
                       3 * static_cast<size_t>(n_tiles) + n_steps);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  Problem P{static_cast<const float*>(free_g), static_cast<const float*>(u_base),
            static_cast<const float*>(u0),     static_cast<const float*>(ops_f),
            static_cast<const int*>(ops_i),    static_cast<const float*>(xb),
            static_cast<const float*>(ub),     static_cast<float*>(x_out),
            static_cast<float*>(u_out),        static_cast<float*>(zx_out),
            static_cast<float*>(zu_out),       nx,
            nu,                                n_tiles,
            n_steps,                           n_iters,
            has_u,                             alpha,
            one_minus_alpha};
  const bool relax = alpha != 1.0f;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (T == 32) err = relax ? launch<32, true>(P, batch, smem, s) : launch<32, false>(P, batch, smem, s);
  else if (T == 16) err = relax ? launch<16, true>(P, batch, smem, s) : launch<16, false>(P, batch, smem, s);
  else err = relax ? launch<8, true>(P, batch, smem, s) : launch<8, false>(P, batch, smem, s);
  return static_cast<int>(err);
}
