// Fused robust SLS-ADMM scenario fleet at widths where W does not fit in a
// block's shared memory, on Hopper's warpgroup tensor cores, for sm_90a.
//
// The wide route of the Pallas TPU kernel `_sls_admm_kernel`
// (ilqr_admm_tpu/ops/pallas_sls.py:99), beside csrc/sls_admm.cu, which
// stages W whole in shared memory and so stops at Nm = 224 (p1 = 2) and
// 208 (p1 = 3). The iteration is the same:
//
//     s_k = Z_k - L_k                         (k = 0 .. p1 - 1)
//     U_k = U_base_k + s_k @ W                (W = (l_inv Rr)^T, Nm x Nm)
//     Z   = P(alpha U + (1 - alpha) Z + L)    (row by row, coupling the slabs)
//     L   = L + U - Z
//
// from Z = U_base, L = 0, with the z-updates of csrc/sls_zupdate.cuh (the
// diamond, the two compiled consensus shapes, the general one), the same
// chunked schedule and per-tile early exit. U is written as (batch, Nm,
// p1) at the last iteration of every chunk.
//
// What bounds it on an H100: the bench's 1-D problem refined to N = 400
// (Nm = 400, 1,024 instances, 200 iterations) takes 3 x 1,024 x 200 x 2
// slabs x 2 x 400^2 = 3.9e11 TF32 FLOP of products as 3xTF32, 0.79 ms at
// the 495 TFLOP/s dense TF32 peak. But W (640 KB) does not fit in shared
// memory, so every block reads it from L2 every iteration: 128 blocks x
// 200 x ~717 KB of fragments (W^T padded to 64-row tiles) = 18 GB, ~5.7 ms
// at the ~3.2 TB/s that csrc/admm_box_wide.cu reached. The L2 stream is
// the cost to cut.
//
// The design, after csrc/admm_box_wide.cu (and what its measurements
// taught):
// - W^T is the A operand of TF32 `wgmma.m64nNk8`, in 64-row M tiles (the
//   output columns), from registers: each warpgroup streams its own tiles'
//   A fragments (16 bytes a thread a k-step, `pack_sls_wide` order) from
//   L2 through a ring of kStages k-steps in shared memory (`cp.async`,
//   each thread copying and reading its own 16 bytes) and splits its own
//   values hi/lo for 3xTF32. Tiles are dealt round robin: tile i to
//   warpgroup i % 4.
// - s is the B operand, K-major without swizzle, pre-split hi and lo in
//   shared memory, each value split once an iteration by the epilogue that
//   writes it. Its N = 2 T H columns (H = ceil(p1 / 2) slab pairs, T
//   instances) are ordered so that every slab of an instance sits in one
//   thread's accumulators (`sls_wide_column` in ops/fused_sls.py): instance
//   4 i + t, slab k at column 8 (i H + k / 2) + 2 t + k % 2, and in the
//   m64nNk8 layout a thread holds columns 8 j + 2 t and 8 j + 2 t + 1 of
//   every 8-column group j. So the z-update, which couples the slabs, runs
//   in the accumulator layout with no exchange; an odd p1's last pair has
//   a zero slab (a quarter of the products at p1 = 3).
// - Three wgmma a k-step, small terms first: hi_W lo_s, lo_W hi_s, hi_W
//   hi_s; kGroup k-steps a commit group; each tile's k range in chunks of
//   kc k-steps (ops/fused_sls.py SLS_WIDE_K_CHUNK), each chunk summed on
//   the tensor cores from zero and added to the tile's total in f32.
// - Z and L live in device memory (`state`, in each thread's accumulator
//   order, so every access is coalesced; 57 KB a block at the N = 400
//   fleet, read twice and written once an iteration, ~172 KB against W's
//   ~717 KB): registers cannot hold them for the 16 tiles of Nm = 1,024
//   or the 8 slabs of the general z-update.
//   The epilogue of a tile projects its rows (two a thread an instance:
//   rows g and g + 8) and writes Z and L; after a barrier every thread
//   writes s = Z - L back into B; a second barrier closes the iteration.
// - Padded rows (Nm up to a multiple of 16 in K, of 64 in M) have zero
//   rows of W^T and U_base = 0; their Z, L and s are held at 0 and they
//   enter neither the residual nor the output.
// - Shared memory: s hi and lo (2 N K floats) and the rings (32 KB):
//   Nm <= 1,552 at p1 = 2 and T = 8, 768 at p1 = 3 or 4 or T = 16
//   (`sls_wide_launch_geometry`); the general z-update at T = 8 only.
// - The z-update and dual update use explicitly rounded f32 operations, as
//   the plain torch version rounds them; only the products differ from it.
// - What the measurements say (H100 80GB HBM3, 700 W; PERF.md §6 row 3b):
//   200 diamond iterations on the N = 400 fleet take 5.61 ms at 1,024
//   instances and 89.5 at 16,384, W^T's fragments streamed at ~3.3 TB/s
//   (18.4 and 294 GB), as the design expected. Chunks of 2 k-steps put the
//   kernel at half the distance to the f64 loop that chunks of 8 do, at
//   the same time (tools/sls_admm_wide_variants.py): this loop amplifies
//   rounding, and its 3xTF32 and f32 plain versions land ~5e-4 apart.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sls_zupdate.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kGroups = 4;  // warpgroups a block
// k-steps of A fragments in flight a warpgroup (its ring of shared-memory
// stages); k-steps whose wgmma are issued as one commit group and waited
// for together (a tile's k-steps and the chunks, `Problem::kc`, are
// multiples of it)
constexpr int kStages = 4;
constexpr int kGroup = 2;

struct Problem {
  const float* bounds;  // (batch,)
  const float* U_base;  // (p1, Nm)
  const float* ops_f;   // W^T's A fragments: (n_tiles, nk, 512)
  float* state;         // Z and L: (blocks, n_tiles, 2 NR, 128), thread-major
  float* U_out;         // (batch, Nm, p1)
  int Nm, n_tiles, nk, chunk_len, n_chunks;
  int kc;  // k-steps a product chains on the tensor cores before it adds
           // the chunk's sum to its total in f32
  float alpha, one_minus_alpha, stop_tol;
};

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
// an 8 x N B in shared memory (descriptor b); scale_d 0 sets d = A B
template <int N>
struct Mma;

template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
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
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<48> {
  static __device__ __forceinline__ void run(float (&d)[24], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// The B operand (s) holds N columns (instance, slab) of each row k of s,
// K-major without swizzle: 8 x 16-byte core matrices (8 columns x 4 k),
// the column groups N / 8 apart inside each group of 4 k, so a k-step of 8
// is 32 N bytes at byte 32 N (k / 8): LBO 16 N (the next 4 k), SBO 128.
template <int N>
__device__ __forceinline__ int b_index(int k, int n) {
  return (((k >> 2) * (N / 8) + (n >> 3)) << 5) + ((n & 7) << 2) + (k & 3);
}

template <int N>
__device__ __forceinline__ uint64_t b_desc(const float* base) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(base));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(N) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// v split into TF32 hi and lo at (k, n) of the two B buffers
template <int N>
__device__ __forceinline__ void store_b(float* b_hi, float* b_lo, int k, int n, float v) {
  uint32_t hi, lo;
  split(v, hi, lo);
  const int i = b_index<N>(k, n);
  b_hi[i] = __uint_as_float(hi);
  b_lo[i] = __uint_as_float(lo);
}

// A warpgroup's stream of A fragments, as one thread sees it: its 16
// bytes of each k-step (128 float4 apart) of its tiles wg, wg + 4, ... in
// global memory, cycled every iteration, and a ring of kStages
// shared-memory stages (128 float4 apart) that holds the next kStages - 1
// k-steps, each thread copying and reading only its own 16 bytes.
struct Stream {
  const float4* frag;  // k-step 0 of tile 0, this thread's 16 bytes
  float4* ring;        // stage 0 of the warpgroup's ring
  int wg, nk, n_own;   // warpgroup, k-steps a tile, tiles it owns
  int tile, step;      // the tile (0 .. n_own - 1) and k-step copied next
  unsigned q;          // k-steps consumed so far: stage q % kStages is next

  __device__ __forceinline__ void start() {
    tile = step = 0;
    q = 0;
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) refill(i);
  }
  __device__ __forceinline__ void refill(unsigned stage) {
    const size_t at = static_cast<size_t>(wg + kGroups * tile) * nk + step;
    copy16(ring + (stage % kStages) * 128, frag + at * 128);
    if (++step == nk) {
      step = 0;
      if (++tile == n_own) tile = 0;
    }
  }
  // the next k-step's 16 bytes; the stage read last time (read, so free)
  // takes the k-step kStages - 1 ahead
  __device__ __forceinline__ float4 take() {
    copies_wait<kStages - 2>();
    const float4 a = ring[(q % kStages) * 128];
    refill(q + kStages - 1);
    ++q;
    return a;
  }
};

// acc = the tile's A (its nk k-steps, taken from the warpgroup's stream)
// times B. kGroup k-steps are split, then their 3 kGroup wgmma issued as
// one commit group and waited for; the end of a chunk of kc k-steps adds
// the chunk to acc. desc: B hi at k-step 0; lo_step: B lo's offset,
// 16-byte units.
template <int N>
__device__ __forceinline__ void product(float (&acc)[N / 2], float (&part)[N / 2], Stream& st,
                                        int nk, int kc, uint64_t desc, uint32_t lo_step) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  for (int s = 0; s < nk; s += kGroup) {
    uint32_t hi[kGroup][4], lo[kGroup][4];
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      const float4 a = st.take();
      split(a.x, hi[e][0], lo[e][0]);
      split(a.y, hi[e][1], lo[e][1]);
      split(a.z, hi[e][2], lo[e][2]);
      split(a.w, hi[e][3], lo[e][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      const uint64_t bh = desc + static_cast<uint64_t>((s + e) * (2 * N));
      Mma<N>::run(part, hi[e], bh + lo_step, (s + e) % kc != 0);
      Mma<N>::run(part, lo[e], bh, 1);
      Mma<N>::run(part, hi[e], bh, 1);
    }
    wgmma_commit();
    wgmma_wait();
    keep(part);
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      keep(hi[e]);
      keep(lo[e]);
    }
    if ((s + kGroup) % kc == 0 || s + kGroup == nk) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = add(acc[i], part[i]);
    }
  }
}

// Accumulator element e of a thread: row 16 w + g + 8 ((e >> 1) & 1) of the
// M tile (w the warp in its warpgroup), column 8 (e >> 2) + 2 t + (e & 1):
// instance 4 ((e >> 2) / H) + t, slab 2 ((e >> 2) % H) + (e & 1)
__device__ __forceinline__ int acc_row(int e, int w, int g) { return 16 * w + g + 8 * ((e >> 1) & 1); }
__device__ __forceinline__ int acc_col(int e, int t) { return 8 * (e >> 2) + 2 * t + (e & 1); }

// Each block owns T instances; warpgroup wg the M tiles wg, wg + 4, ...
template <int T, class ZP>
__global__ void __launch_bounds__(128 * kGroups, 1) sls_admm_wide_kernel(Problem P, ZP zp) {
  constexpr int P1 = ZP::kP1;      // slabs the z-update is compiled for (2 H)
  constexpr int H = (P1 + 1) / 2;  // slab pairs an instance
  constexpr int N = 2 * T * H;     // B columns
  constexpr int NR = N / 2;        // accumulator registers a tile
  constexpr int NI = T / 4;        // instances a thread
  static_assert(T % 4 == 0 && N % 16 == 0 && N <= 64, "no wgmma built for this tile");
  extern __shared__ __align__(128) float smem[];
  __shared__ unsigned int residual[3];
  const int nk = P.nk, kp = 8 * nk, Nm = P.Nm;
  float* b_hi = smem;  // s, TF32 hi
  float* b_lo = b_hi + N * kp;
  float4* rings = reinterpret_cast<float4*>(b_lo + N * kp);  // kStages x 128 float4 a warpgroup

  const int tid = threadIdx.x, wg = tid / 128, tw = tid % 128;
  const int w = tw / 32, g = tw % 32 / 4, t = tw % 4;
  for (int i = tid; i < 2 * N * kp; i += blockDim.x) smem[i] = 0.0f;
  if (tid < 3) residual[tid] = 0u;
  // the z-update: the compiled ones as they are, the general one's
  // constants copied into shared memory (read after the first barrier)
  decltype(auto) zu = stage(zp);
  const int p1 = zu.slabs();
  const int n_own = P.n_tiles > wg ? (P.n_tiles - wg + kGroups - 1) / kGroups : 0;
  const size_t inst0 = static_cast<size_t>(blockIdx.x) * T;
  float bnd[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) bnd[i] = P.bounds[inst0 + 4 * i + t];
  // this thread's Z (elements 0 .. NR - 1) and L (NR .. 2 NR - 1) of
  // tile j at state[(j 2 NR + e) 128]
  float* state = P.state + static_cast<size_t>(blockIdx.x) * P.n_tiles * 2 * NR * 128 + tw;
  __syncthreads();  // B zeroed, constants staged

  // Z = U_base, L = 0: s = U_base
  for (int j = 0; j < n_own; ++j) {
    const int tile = wg + kGroups * j;
    float* st_z = state + static_cast<size_t>(tile) * 2 * NR * 128;
#pragma unroll
    for (int e = 0; e < NR; ++e) {
      const int c = 64 * tile + acc_row(e, w, g);
      const int k = 2 * ((e >> 2) % H) + (e & 1);
      const bool valid = c < Nm && k < p1;
      const float z = valid ? P.U_base[k * Nm + c] : 0.0f;
      st_z[e * 128] = z;
      st_z[(NR + e) * 128] = 0.0f;
      if (valid) {
        store_b<N>(b_hi, b_lo, c, acc_col(e, t), z);
        if (P.chunk_len * P.n_chunks == 0) {  // no iterations: U = U_base
          const size_t b = inst0 + 4 * ((e >> 2) / H) + t;
          P.U_out[(b * Nm + c) * p1 + k] = z;
        }
      }
    }
  }
  async_fence();
  __syncthreads();  // s complete

  Stream st;
  st.frag = reinterpret_cast<const float4*>(P.ops_f) + tw;
  st.ring = rings + wg * kStages * 128 + tw;
  st.wg = wg;
  st.nk = nk;
  st.n_own = n_own;
  if (n_own > 0) st.start();
  const uint64_t desc = b_desc<N>(b_hi);
  const uint32_t lo_step = static_cast<uint32_t>(N * kp / 4);
  float acc[NR], part[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) part[i] = 0.0f;

  const bool early_exit = P.stop_tol > 0.0f;
  for (int ch = 0; ch < P.n_chunks; ++ch) {
    for (int it = 0; it < P.chunk_len; ++it) {
      const bool out = it == P.chunk_len - 1;  // U stored at every chunk's end
      const int test = early_exit && out ? ch % 3 + 1 : 0;
      unsigned int m = 0u;
      for (int j = 0; j < n_own; ++j) {
        const int tile = wg + kGroups * j;
        product<N>(acc, part, st, nk, P.kc, desc, lo_step);
        float* st_z = state + static_cast<size_t>(tile) * 2 * NR * 128;
        // the rows of instance i: g and g + 8 of the warp's 16 (h = 0, 1)
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          float u[2][P1], y[2][P1], zo[2][P1], lo[2][P1], zn[2][P1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = 64 * tile + 16 * w + g + 8 * h;
#pragma unroll
            for (int k = 0; k < P1; ++k) {
              const int e = 4 * (i * H + k / 2) + 2 * h + (k & 1);
              const bool valid = c < Nm && k < p1;
              zo[h][k] = st_z[e * 128];
              lo[h][k] = st_z[(NR + e) * 128];
              u[h][k] = add(valid ? P.U_base[k * Nm + c] : 0.0f, acc[e]);
              y[h][k] = add(add(mul(P.alpha, u[h][k]), mul(P.one_minus_alpha, zo[h][k])),
                            lo[h][k]);
            }
          }
          zu.template project<2>(y, bnd[i], zn);
          const size_t b = inst0 + 4 * i + t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = 64 * tile + 16 * w + g + 8 * h;
#pragma unroll
            for (int k = 0; k < P1; ++k) {
              if (!(c < Nm && k < p1)) continue;  // held at 0
              const int e = 4 * (i * H + k / 2) + 2 * h + (k & 1);
              const float znk = zn[h][k];
              if (test) {
                m = max(m, __float_as_uint(fabsf(sub(u[h][k], znk))));
                m = max(m, __float_as_uint(fabsf(sub(znk, zo[h][k]))));
              }
              st_z[e * 128] = znk;
              st_z[(NR + e) * 128] = sub(add(lo[h][k], u[h][k]), znk);
              if (out) P.U_out[(b * Nm + c) * p1 + k] = u[h][k];
            }
          }
        }
      }
      if (test) {
        // max over non-negative floats as unsigned bits; a NaN residual
        // sorts above +inf and, like the JAX while_loop test, stops the tile
#pragma unroll
        for (int d = 16; d > 0; d /= 2) m = max(m, __shfl_xor_sync(0xFFFFFFFFu, m, d));
        if ((tid & 31) == 0) atomicMax(residual + test - 1, m);
        if (tid == 0) residual[test % 3] = 0u;
      }
      __syncthreads();  // every read of s done
      for (int j = 0; j < n_own; ++j) {
        const int tile = wg + kGroups * j;
        const float* st_z = state + static_cast<size_t>(tile) * 2 * NR * 128;
#pragma unroll
        for (int e = 0; e < NR; ++e) {
          const int c = 64 * tile + acc_row(e, w, g);
          const int k = 2 * ((e >> 2) % H) + (e & 1);
          if (c < Nm && k < p1)
            store_b<N>(b_hi, b_lo, c, acc_col(e, t), sub(st_z[e * 128], st_z[(NR + e) * 128]));
        }
      }
      async_fence();
      __syncthreads();  // s complete
    }
    if (early_exit && !(__uint_as_float(residual[ch % 3]) >= P.stop_tol)) break;
  }
  copies_wait<0>();
}

template <int T, class ZP>
int launch(const Problem& P, int batch, const ZP& zp, cudaStream_t stream) {
  constexpr int H = (ZP::kP1 + 1) / 2;
  constexpr int N = 2 * T * H;
  if constexpr (N > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const size_t smem = sizeof(float) * 2 * static_cast<size_t>(N) * 8 * P.nk +
                        sizeof(float4) * kGroups * kStages * 128;
    auto kernel = sls_admm_wide_kernel<T, ZP>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<batch / T, 128 * kGroups, smem, stream>>>(P, zp);
    return static_cast<int>(cudaGetLastError());
  }
}

// the general z-update is built for T = 8 only
template <class ZP>
int launch(const Problem& P, int batch, int T, const ZP& zp, cudaStream_t stream) {
  if (T == 8) return launch<8>(P, batch, zp, stream);
  if constexpr (IsGeneral<ZP>::value) return static_cast<int>(cudaErrorInvalidValue);
  else return launch<16>(P, batch, zp, stream);
}

}  // namespace

// ops_f of `pack_sls_wide(W)` (n_tiles = ceil(Nm / 64) tiles of nk
// k-steps, 8 nk >= Nm, nk even); kc: k-steps a chunk of the products (a
// multiple of 2); state: blocks x n_tiles x N x 128 floats
// of scratch (N = 2 T ceil(p1 / 2)); z_update and coeffs as
// sls_admm_launch takes them. T 8 or 16 (16 for p1 <= 4, and not with the
// general z-update).
extern "C" int sls_admm_wide_launch(const void* bounds, const void* U_base, const void* ops_f,
                                    void* state, void* U_out, int batch, int Nm, int n_tiles,
                                    int nk, int kc, int T, int p1, int chunk_len,
                                    int n_chunks, float alpha, float one_minus_alpha,
                                    float stop_tol,
                                    int z_update, const void* coeffs, int n_sets, int q,
                                    int n_cons_iters, void* stream) {
  if (Nm <= 0 || p1 < 2 || (T != 8 && T != 16) || batch <= 0 || batch % T != 0 ||
      n_tiles != (Nm + 63) / 64 || nk % kGroup != 0 || 8 * nk < Nm || kc <= 0 ||
      kc % kGroup != 0 || chunk_len < 0 ||
      n_chunks < 0 || n_cons_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem P{static_cast<const float*>(bounds), static_cast<const float*>(U_base),
                  static_cast<const float*>(ops_f),  static_cast<float*>(state),
                  static_cast<float*>(U_out),        Nm,
                  n_tiles,                           nk,
                  chunk_len,                         n_chunks,
                  kc,                                alpha,
                  one_minus_alpha,                   stop_tol};
  const float* c = static_cast<const float*>(coeffs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (z_update == 0 && p1 == 2) return launch(P, batch, T, Diamond{c[0], c[1], c[2]}, s);
  if (z_update != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (p1 == 2 && n_sets == 2 && q == 3)
    return launch(P, batch, T, unpack_consensus<2, 2, 3>(c, n_cons_iters), s);
  if (p1 == 3 && n_sets == 2 && q == 4)
    return launch(P, batch, T, unpack_consensus<3, 2, 4>(c, n_cons_iters), s);
  if (!general_shape(p1, n_sets, q)) return static_cast<int>(cudaErrorInvalidValue);
  switch ((p1 + 1) / 2) {
    case 1: return launch(P, batch, T, general_params<1>(c, p1, n_sets, q, n_cons_iters), s);
    case 2: return launch(P, batch, T, general_params<2>(c, p1, n_sets, q, n_cons_iters), s);
    case 3: return launch(P, batch, T, general_params<3>(c, p1, n_sets, q, n_cons_iters), s);
    default: return launch(P, batch, T, general_params<4>(c, p1, n_sets, q, n_cons_iters), s);
  }
}
