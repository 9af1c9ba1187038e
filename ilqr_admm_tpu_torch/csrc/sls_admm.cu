// Fused robust SLS-ADMM scenario fleet on Hopper's tensor cores, for sm_90a.
//
// Replaces the Pallas TPU kernel `_sls_admm_kernel`
// (ilqr_admm_tpu/ops/pallas_sls.py:99). The decision matrix of each
// instance is p1 = robust_dim + 1 column slabs of Nm rows ([du | phi_u
// columns]). Each CUDA block owns one tile of T instances and runs the
// whole ADMM loop on it without leaving the SM:
//
//     s_k = Z_k - L_k                         (k = 0 .. p1 - 1)
//     U_k = U_base_k + s_k @ W                (W = (l_inv Rr)^T, Nm x Nm)
//     Z   = P(alpha U + (1 - alpha) Z + L)    (row by row, coupling the slabs)
//     L   = L + U - Z
//
// from Z = U_base, L = 0. P is the exact projection of each row onto the
// diamond w0 |du| + w1 |phi| <= bound (`Diamond`, p1 = 2), or a
// fixed-count consensus ADMM onto an intersection of second-order cones
// (csrc/sls_zupdate.cuh: `Consensus<P1, NSETS, Q>`, the TPU kernel's
// trace-time constants passed by value in the kernel's parameters, built
// for (p1, NSETS, Q) = (2, 2, 3) and (3, 2, 4), the rows of the (3, 2, 4)
// build one at a time so that registers stay bounded; `General<H>` for
// any other shape to p1 <= 8, 4 sets, q <= 9, read at run time, a build
// for each count H of slab pairs). U is written as (batch, Nm, p1). W
// staged whole takes Nm <= 224 (p1 = 2); csrc/sls_admm_wide.cu streams it
// from L2 past that.
//
// What bounds it on an H100: the bench's serving solve (B = 1024, Nm =
// 100, diamond z-update, early exit) runs 64-208 iterations a tile, each
// 2 x 2 Nm^2 FLOP an instance of f32-accurate products: 7.6e9 FLOP, as
// three TF32 products 0.046 ms at the 495 TFLOP/s dense TF32 peak. The
// z-update adds ~30 flops a row (the consensus one ~60 a row per inner
// iteration, 30 inner iterations). But a tile's iterations cannot leave
// its SM, and at 1,024 instances there is one tile of 8 instances an SM:
// each iteration is a chain (the product, the z-update, the store of s and
// a barrier) that one block runs alone, so the slowest tile's 208
// iterations at one SM's share of the TF32 peak, 0.058 ms, are this
// tiling's floor, and the chain's latency sets the time above it.
//
// What the design does about it:
// - The product runs on the tensor cores as warp-level 3xTF32
//   `mma.sync.m16n8k8` (helpers in csrc/tf32x3.cuh, shared with the LQT
//   kernels), instances x slabs as M, the Nm output columns as N, the
//   reduction as K: in f32 on the CUDA cores (this kernel's first design)
//   a block's iteration was ~3.5 us of dependent shared loads and FMAs.
//   Each k-step splits its operands as it loads them: splitting W at
//   setup and s where it is stored, then loading both parts, measured no
//   faster on an H100, for twice the shared memory (the loads cost what
//   the splits did).
// - Each group of 8 instances has ceil(p1 / 2) 16-row m-tiles, slab-major:
//   rows 0-7 of m-tile j are slab 2 j of instances 0-7, rows 8-15 slab
//   2 j + 1 of the same instances (a zero slab after an odd p1: its rows
//   are held at 0 and cost a quarter of the products at p1 = 3). An
//   accumulator holds rows g and g + 8 of columns 2 t and 2 t + 1, and one
//   warp owns all of a group's m-tiles for its columns, so every slab of
//   instance g at a column sits in one thread, and the z-update, which
//   couples them, runs in the accumulator layout:
//   U = U_base + acc, the projection and the dual update in registers, Z
//   and L in registers for the whole solve. The consensus z-update takes a
//   thread's rows two at a time, their inner iterations two independent
//   chains side by side.
// - W lives in shared memory as 8 x 8 blocks in B-fragment order
//   (`pair_pack` in ops/fused_admm.py, packed once at setup); s goes to
//   shared memory group-major (`a_pos`), double buffered, so an iteration
//   has one barrier.
// - Work: a warp owns one piece, a pair of W's n-tiles (16 columns) or the
//   last single n-tile, for one instance group (`sls_pieces` in
//   ops/fused_sls.py):
//   at T = 8 and Nm = 100, 6 pairs and 1 single, 7 warps (14 at T = 16).
//   So each thread's rows are all of one instance, and the consensus
//   z-update keeps one set of cone offsets for them. With k_split = 2 each
//   piece's k range is split over two warps, which hand their partial sums
//   over through shared memory: half the chain of dependent mma, for a
//   second barrier an iteration (built for p1 = 2). The wrapper takes it
//   where the fleet has at most one block an SM (`k_split` in ops/fused_sls.py), as at the
//   bench's 1,024 instances; with more blocks an SM they hide each other's
//   latency and the split only costs (tools/sls_admm_variants.py times
//   both).
// - U_base is instance-invariant: a thread loads its columns' values once,
//   and its instance's bound once. U is stored from the registers at the
//   last iteration of every chunk, so the last iterate's U is written
//   without a product after the loop.
// - Padded columns (Nm up to a multiple of 8) have zero rows and columns
//   of W and U_base = 0; their Z, L and s are held at 0 (a consensus
//   projection would move them: its cone offsets are nonzero) and they
//   enter neither the residual nor the output.
// - Per-tile early exit: at the last iteration of each chunk each warp
//   reduces max(|U - Z|, |Z - Z_prev|) over its valid elements by
//   shuffles and folds it with atomicMax on the float bits (non-negative,
//   so bit order is value order; a NaN stops the tile, as the JAX
//   while_loop test does) into one of three rotating words, so the test
//   costs no barrier of its own.
// - The z-update and dual update use explicitly rounded f32 operations
//   (no FMA contraction), so they round as the plain torch version does;
//   only the products differ from it (their split and order of sums).
//   Every build is spill-free: a spill cost admm_box 28% on the card.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sls_zupdate.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kMaxWarps = 16;
struct Problem {
  const float* bounds;  // (batch,)
  const float* U_base;  // (p1, Nm)
  const float* ops_f;   // W's blocks (pair_pack storage)
  const int* ops_i;     // its pair table: (offset, klo, khi, nb) rows
  float* U_out;         // (batch, Nm, p1)
  int Nm, n_ops, chunk_len, n_chunks;
  float alpha, one_minus_alpha, stop_tol;
};

// The whole solve of one warp's piece: instance group m0 (8 instances,
// MS = ceil(p1 / 2) m-tiles: slabs 2 j and 2 j + 1 in m-tile j, a zero slab
// after an odd p1) of the block's MT groups, the NB n-tiles of pair row
// `pr` of W's table, k-steps [klo, khi) of it, or half `half` of them when
// the piece is split over KS = 2 warps (p1 = 2 only). A thread's rows are
// all of one instance (row g of each m-tile). The warp owns NO n-tiles in
// the epilogue: all NB, or with a split tile `half` of a pair (the single
// tile: half 0). Every warp runs the same sequence of barriers.
// `residual` has three words: chunk ch folds its max into word ch % 3 and
// clears word (ch + 1) % 3, whose last readers have passed a barrier
// since.
template <int MT, int KS, int NB, class ZU>
__device__ __forceinline__ void solve(const Problem& P, const ZU& zu, const float* ops, float* s0,
                                      float* s1, float* slots, unsigned int* residual, int pr,
                                      int m0, int half) {
  constexpr int P1 = ZU::kP1;
  constexpr int MS = (P1 + 1) / 2;           // m-tiles of an instance group
  static_assert(KS == 1 || MS == 1, "the k split is built for p1 = 2");
  constexpr int LDA = 16 * MT * MS * 8;
  constexpr int NO = KS == 1 ? NB : 1;  // n-tiles the warp owns
  constexpr int R = NO * 2;                  // rows (columns of the p1 slabs) a thread projects
  // rows the epilogue takes at a time: all, or one where the z-update
  // runs one row at a time (so that registers stay bounded)
  constexpr int RC = ZU::kRows == 1 ? 1 : R;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int* row = P.ops_i + 4 * pr;
  const int off = row[0], klo = row[1], khi = row[2];
  const int kmid = klo + (khi - klo) / 2;
  const int k0 = KS == 2 && half ? kmid : klo;
  const int k1 = KS == 2 && !half ? kmid : khi;
  const float* b = ops + off + (k0 - klo) * NB * kBlock;
  const int a_off = 16 * MS * m0 * 8;  // the piece's first row in an A buffer
  // the first owned n-tile, as a column offset, and whether any is owned
  const int own = KS == 2 && NB == 2 ? half : 0;
  const bool owns = KS == 1 || NB == 2 || half == 0;
  const int c_own = 8 * (2 * pr + own);
  const size_t inst = static_cast<size_t>(blockIdx.x) * 8 * MT + 8 * m0 + g;
  const float bound = P.bounds[inst];
  // the slabs: P1 for the compiled z-updates, p1 <= P1 read at run time
  // for the general one (its slabs past p1 held at 0, as a zero slab is)
  const int p1 = zu.slabs();
  float* u_out = P.U_out + inst * P.Nm * p1;

  // ub[o][j][i]: U_base of slab 2 j + i / 2 at column c_own + 8 o + 2 t +
  // i % 2 (0 for the zero slab); z and lam in the accumulator layout of
  // the owned tiles
  float ub[NO][MS][4], z[NO][MS][4], lam[NO][MS][4];
#pragma unroll
  for (int o = 0; o < NO; ++o) {
#pragma unroll
    for (int j = 0; j < MS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c_own + 8 * o + 2 * t + (i & 1);
        const int slab = 2 * j + (i >> 1);
        ub[o][j][i] = c < P.Nm && slab < p1 ? P.U_base[slab * P.Nm + c] : 0.0f;
        z[o][j][i] = ub[o][j][i];
        lam[o][j][i] = 0.0f;
      }
    if (owns) {
      store_piece_s<LDA, MS>(s0 + a_off, c_own + 8 * o, g, t, z[o], lam[o]);
      if (P.chunk_len * P.n_chunks == 0) {  // no iterations: U = U_base
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c_own + 8 * o + 2 * t + e;
          if (c < P.Nm) {
            if constexpr (P1 == 2) {
              *reinterpret_cast<float2*>(u_out + 2 * c) =
                  make_float2(ub[o][0][e], ub[o][0][2 + e]);
            } else {
#pragma unroll
              for (int q = 0; q < P1; ++q)
                if (q < p1) u_out[p1 * c + q] = ub[o][q / 2][2 * (q % 2) + e];
            }
          }
        }
      }
    }
  }
  __syncthreads();  // W and s0 staged

  // One iteration from s_in into s_out. out: store U; test: fold the
  // residual into word `test - 1`
  auto iterate = [&](const float* s_in, float* s_out, bool out, int test) {
    float acc[2][MS][4];
    product<MS, NB, 2, LDA>(acc, s_in + a_off, b, k0, k1, lane, g, t);
    float v[NO][MS][4];  // the owned tiles' sums
    if constexpr (KS == 1) {
#pragma unroll
      for (int o = 0; o < NO; ++o)
#pragma unroll
        for (int j = 0; j < MS; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) v[o][j][i] = acc[o][j][i];
    } else {
      // hand the partial of the partner's tile over; element e of a
      // warp's slot at slot[32 e]
      const int warp = threadIdx.x / 32;
      float* mine = slots + warp * 32 * 4 + lane;
      const float* theirs = slots + (warp ^ 1) * 32 * 4 + lane;
      if (NB == 2 || half == 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mine[32 * i] = NB == 2 && half == 0 ? acc[NB - 1][0][i] : acc[0][0][i];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float mine_sum = NB == 2 && half == 1 ? acc[NB - 1][0][i] : acc[0][0][i];
        v[0][0][i] = owns ? add(mine_sum, theirs[32 * i]) : 0.0f;
      }
    }
    unsigned int m = 0u;
    if (owns) {
      // row k = 2 o + e: column c_own + 8 o + 2 t + e; slab q is
      // accumulator element 2 (q % 2) + e of m-tile q / 2
#pragma unroll
      for (int k0 = 0; k0 < R; k0 += RC) {
        float u[RC][P1], y[RC][P1], zn[RC][P1];
#pragma unroll
        for (int r = 0; r < RC; ++r) {
          const int o = (k0 + r) / 2, e = (k0 + r) % 2;
#pragma unroll
          for (int q = 0; q < P1; ++q) {
            const int j = q / 2, i = 2 * (q % 2) + e;
            u[r][q] = add(ub[o][j][i], v[o][j][i]);
            y[r][q] = add(add(mul(P.alpha, u[r][q]), mul(P.one_minus_alpha, z[o][j][i])),
                          lam[o][j][i]);
          }
        }
        zu.template project<RC>(y, bound, zn);
#pragma unroll
        for (int r = 0; r < RC; ++r) {
          const int o = (k0 + r) / 2, e = (k0 + r) % 2;
          const int c = c_own + 8 * o + 2 * t + e;
          const bool valid = c < P.Nm;
#pragma unroll
          for (int q = 0; q < P1; ++q) {
            if (q >= p1) continue;
            const int j = q / 2, i = 2 * (q % 2) + e;
            const float znq = valid ? zn[r][q] : 0.0f;
            if (test && valid) {
              m = max(m, __float_as_uint(fabsf(sub(u[r][q], znq))));
              m = max(m, __float_as_uint(fabsf(sub(znq, z[o][j][i]))));
            }
            lam[o][j][i] = sub(add(lam[o][j][i], u[r][q]), znq);
            z[o][j][i] = znq;
          }
          if (out && valid) {
            if constexpr (P1 == 2) {
              *reinterpret_cast<float2*>(u_out + 2 * c) = make_float2(u[r][0], u[r][1]);
            } else {
#pragma unroll
              for (int q = 0; q < P1; ++q)
                if (q < p1) u_out[p1 * c + q] = u[r][q];
            }
          }
        }
      }
#pragma unroll
      for (int o = 0; o < NO; ++o)
        store_piece_s<LDA, MS>(s_out + a_off, c_own + 8 * o, g, t, z[o], lam[o]);
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
  int p = 0;  // buffer the next iteration reads
  for (int ch = 0; ch < P.n_chunks; ++ch) {
    for (int it = 0; it < P.chunk_len; ++it) {
      const bool chunk_end = it == P.chunk_len - 1;
      iterate(p ? s1 : s0, p ? s0 : s1, chunk_end, early_exit && chunk_end ? ch % 3 + 1 : 0);
      p ^= 1;
      __syncthreads();
    }
    if (early_exit && !(__uint_as_float(residual[ch % 3]) >= P.stop_tol)) break;
  }
}

// Pieces: W's pairs of n-tiles, each cut into MT pieces of one instance
// group (its MS m-tiles), in order, then the last single n-tile (when
// Nm / 8 rounds up to an odd count) cut likewise. Warp w takes piece
// w / KS (half w % KS of it).
template <int MT, int KS, class ZP>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) sls_admm_kernel(Problem P, ZP zp) {
  constexpr int MS = (ZP::kP1 + 1) / 2;
  extern __shared__ float4 smem_f4[];
  __shared__ unsigned int residual[3];
  const int n1 = (P.Nm + 7) / 8;
  float* ops = reinterpret_cast<float*>(smem_f4);  // room for a dense W
  float* s0 = ops + kBlock * n1 * n1;              // two s buffers, group-major
  float* s1 = s0 + 16 * MT * MS * 8 * n1;
  float* slots = s1 + 16 * MT * MS * 8 * n1;       // with a k split: 4 floats a thread

  const int tid = threadIdx.x;
  const float4* src = reinterpret_cast<const float4*>(P.ops_f);
  for (int i = tid; i < P.n_ops / 4; i += blockDim.x) smem_f4[i] = src[i];
  if (tid < 3) residual[tid] = 0u;
  // the z-update: the compiled ones as they are, the general one's
  // constants copied into shared memory (read after solve's first barrier)
  decltype(auto) zu = stage(zp);

  const int piece = tid / 32 / KS, half = tid / 32 % KS;
  const int pair_pieces = (n1 / 2) * MT;
  if (piece < pair_pieces) {
    solve<MT, KS, 2>(P, zu, ops, s0, s1, slots, residual, piece / MT, piece % MT, half);
  } else {
    solve<MT, KS, 1>(P, zu, ops, s0, s1, slots, residual, n1 / 2, piece - pair_pieces, half);
  }
}

template <int MT, int KS, class ZU>
int launch(const Problem& P, int batch, const ZU& zu, cudaStream_t stream) {
  constexpr int MS = (ZU::kP1 + 1) / 2;
  const int n1 = (P.Nm + 7) / 8;
  const int warps = KS * (n1 / 2 + n1 % 2) * MT;
  if (warps > kMaxWarps || P.n_ops > kBlock * n1 * n1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (static_cast<size_t>(kBlock) * n1 * n1 +
                                       2 * static_cast<size_t>(16) * MT * MS * 8 * n1 +
                                       (KS == 2 ? static_cast<size_t>(warps) * 32 * 4 : 0));
  cudaError_t err = cudaFuncSetAttribute(sls_admm_kernel<MT, KS, ZU>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sls_admm_kernel<MT, KS, ZU><<<batch / (8 * MT), 32 * warps, smem, stream>>>(P, zu);
  return static_cast<int>(cudaGetLastError());
}

// T = 16 has 14 warps at Nm = 100, so its pieces are never split; the
// split is built for p1 = 2; the general z-update for T = 8 only
template <class ZU>
int launch(const Problem& P, int batch, int T, int k_split, const ZU& zu, cudaStream_t stream) {
  if (T == 16) {
    if constexpr (IsGeneral<ZU>::value) return static_cast<int>(cudaErrorInvalidValue);
    else
      return k_split == 1 ? launch<2, 1>(P, batch, zu, stream)
                          : static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (ZU::kP1 == 2) {
    if (k_split == 2) return launch<1, 2>(P, batch, zu, stream);
  }
  return k_split == 1 ? launch<1, 1>(P, batch, zu, stream)
                      : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// W arrives packed (ops_f, n_ops floats; ops_i, its pair table). z_update:
// 0 = diamond (coeffs = w0, w1, w0^2 + w1^2; p1 = 2), 1 = consensus
// (coeffs packed as in unpack_consensus). T 8 or 16, k_split (warps a
// piece) 1 or 2 (2 at p1 <= 2 only). The consensus shapes (p1, n_sets, q)
// with builds of their own are ops/fused_sls.py's CONSENSUS_SHAPES; the
// general build takes the rest to CONSENSUS_MAX.
extern "C" int sls_admm_launch(const void* bounds, const void* U_base, const void* ops_f,
                               int n_ops, const void* ops_i, void* U_out, int batch, int Nm,
                               int T, int p1, int chunk_len, int n_chunks, float alpha,
                               float one_minus_alpha, float stop_tol, int z_update,
                               const void* coeffs, int n_sets, int q, int n_cons_iters,
                               int k_split, void* stream) {
  if (Nm <= 0 || p1 < 2 || (T != 8 && T != 16) || batch <= 0 || batch % T != 0 ||
      n_ops < 0 || n_ops % kBlock != 0 || chunk_len < 0 || n_chunks < 0 ||
      n_cons_iters < 0 || (k_split != 1 && k_split != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem P{static_cast<const float*>(bounds), static_cast<const float*>(U_base),
                  static_cast<const float*>(ops_f), static_cast<const int*>(ops_i),
                  static_cast<float*>(U_out), Nm, n_ops, chunk_len, n_chunks, alpha,
                  one_minus_alpha, stop_tol};
  const float* c = static_cast<const float*>(coeffs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (z_update == 0 && p1 == 2) return launch(P, batch, T, k_split, Diamond{c[0], c[1], c[2]}, s);
  if (z_update != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (p1 == 2 && n_sets == 2 && q == 3)
    return launch(P, batch, T, k_split, unpack_consensus<2, 2, 3>(c, n_cons_iters), s);
  if (p1 == 3 && n_sets == 2 && q == 4)
    return launch(P, batch, T, k_split, unpack_consensus<3, 2, 4>(c, n_cons_iters), s);
  if (!general_shape(p1, n_sets, q)) return static_cast<int>(cudaErrorInvalidValue);
  switch ((p1 + 1) / 2) {
    case 1: return launch(P, batch, T, k_split, general_params<1>(c, p1, n_sets, q, n_cons_iters), s);
    case 2: return launch(P, batch, T, k_split, general_params<2>(c, p1, n_sets, q, n_cons_iters), s);
    case 3: return launch(P, batch, T, k_split, general_params<3>(c, p1, n_sets, q, n_cons_iters), s);
    default: return launch(P, batch, T, k_split, general_params<4>(c, p1, n_sets, q, n_cons_iters), s);
  }
}

extern "C" const char* sls_admm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
