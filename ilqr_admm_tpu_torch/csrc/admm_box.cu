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
// 2.6e11 FLOP, 3.9 ms at the 67 TFLOP/s f32 CUDA-core peak, against
// ~40 MB of traffic in and out: compute bound. Inside the loop the limit
// is the rate at which shared memory feeds the FMA units.
//
// What the design does about it:
// - The operators live in shared memory in row-profile form
//   (`profile_pack` in ops/fused_admm.py): row k keeps the columns
//   [start_k, stop_k), both multiples of 4 and nondecreasing in k. A thread
//   that owns 4 columns reads one contiguous range of rows, and exact zeros
//   are skipped. Su is strictly block lower-triangular, so Su^T packs to
//   half; W_s is dense and packs whole: ~40,000 floats (159 KB) at the
//   full width. Skipping exact zeros changes no sum, so the kernel differs
//   from the dense plain version only in summation order.
// - Tile buffers in shared memory, stored transposed as buf[k][b], carry
//   the all-to-all products: s = [s_x; s_u], u_hat and a partial sum. z
//   and l live in registers; the bounds in shared memory (registers are
//   the scarce resource: a 13-warp block gets at most 128 a thread).
// - A thread owns a 4 x 4 (instances x columns) tile, so every k step is
//   two 16-byte shared loads feeding 16 FMAs; row groups vary fastest over
//   a warp's threads, so those loads are two shared-memory wavefronts a
//   warp. Phase 1 has half as many output tiles as phase 2 but three times
//   its rows (Nd + Nm against ~Nm / 2), so each of its tiles is split over
//   two threads, each taking half of the rows; the second half's partial
//   sum goes through shared memory. Every thread then works in both
//   phases; an iteration has three barriers.
// - Products are plain f32 FMAs. The TPU kernel's bf16 hi/lo splits were
//   a Mosaic workaround and are not carried. The clip and dual updates use
//   explicitly rounded f32 operations (no FMA contraction), as the plain
//   torch version rounds them.
// Tensor cores (3xTF32 wgmma) and TMA staging are left for later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRows = 4;  // instances per thread
constexpr int kCols = 4;  // columns per thread
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// Rows [klo, khi) of a profile-packed operator that hold the column group
// j0..j0+3: start[k] <= j0 < stop[k]. Both tables are nondecreasing, so
// the rows with start <= j0 are a prefix and those with stop <= j0 too.
__device__ __forceinline__ void row_range(const int* __restrict__ start,
                                          const int* __restrict__ stop, int rows, int j0,
                                          int& klo, int& khi) {
  int a = 0, b = 0;
  for (int k = 0; k < rows; ++k) {
    a += start[k] <= j0;
    b += stop[k] <= j0;
  }
  klo = b;
  khi = a;
}

// acc[r][c] = sum_{k in [klo, khi)} s[k][b0 + r] * W[k][j0 + c], with W in
// profile storage: W[k][j] = w[base[k] + j].
__device__ __forceinline__ void product(float (&acc)[kRows][kCols], const float* __restrict__ s,
                                        int T, int b0, const float* __restrict__ w,
                                        const int* __restrict__ base, int klo, int khi,
                                        int j0) {
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  // the next row's offset is loaded one step ahead, so the operator load
  // does not wait on a dependent shared load (base[khi] is still inside
  // the block's shared memory: the tables are followed by the tile buffers)
  const float* wj = w + j0;
  int bk = base[klo];
#pragma unroll 4
  for (int k = klo; k < khi; ++k) {
    const int b_next = base[k + 1];
    const float4 s4 = *reinterpret_cast<const float4*>(s + k * T + b0);
    const float4 w4 = *reinterpret_cast<const float4*>(wj + bk);
    bk = b_next;
    const float sv[kRows] = {s4.x, s4.y, s4.z, s4.w};
    const float wv[kCols] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(sv[r], wv[c], acc[r][c]);
  }
}

// z = clip(alpha v + (1 - alpha) z + l, lo, hi); l = (l + v) - z, with
// lo, hi the bounds of columns j0..j0+3 (padded columns: 0, so they stay 0)
__device__ __forceinline__ void box_update(const float (&v)[kRows][kCols],
                                           float (&z)[kRows][kCols], float (&l)[kRows][kCols],
                                           const float* lo, const float* hi, int j0, int width,
                                           float alpha, float one_minus_alpha) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const float lo_c = j0 + c < width ? lo[j0 + c] : 0.0f;
    const float hi_c = j0 + c < width ? hi[j0 + c] : 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float zr =
          alpha == 1.0f ? v[r][c] : add(mul(alpha, v[r][c]), mul(one_minus_alpha, z[r][c]));
      const float zn = clip(add(zr, l[r][c]), lo_c, hi_c);
      l[r][c] = sub(add(l[r][c], v[r][c]), zn);
      z[r][c] = zn;
    }
  }
}

// Column j0 + c of a thread's tile, transposed, to buf[j][b0..b0+3], for
// the columns below `width`.
__device__ __forceinline__ void store_tile(float* buf, const float (&v)[kRows][kCols], int T,
                                           int b0, int j0, int width) {
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (j0 + c < width)
      *reinterpret_cast<float4*>(buf + (j0 + c) * T + b0) =
          make_float4(v[0][c], v[1][c], v[2][c], v[3][c]);
}

// s = z - l, transposed into buf
__device__ __forceinline__ void store_s(float* buf, const float (&z)[kRows][kCols],
                                        const float (&l)[kRows][kCols], int T, int b0, int j0,
                                        int width) {
  float s[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[r][c] = sub(z[r][c], l[r][c]);
  store_tile(buf, s, T, b0, j0, width);
}

// Rows row0..row0+3, columns j0..j0+3 of a row-major (batch, width)
// array; one 16-byte access a row when the width allows it
__device__ __forceinline__ void load_global(const float* __restrict__ g, size_t row0, int j0,
                                            int width, float (&v)[kRows][kCols]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float* p = g + (row0 + r) * width + j0;
    if (width % kCols == 0) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      v[r][0] = t.x;
      v[r][1] = t.y;
      v[r][2] = t.z;
      v[r][3] = t.w;
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[r][c] = j0 + c < width ? p[c] : 0.0f;
    }
  }
}

__device__ __forceinline__ void store_global(float* __restrict__ g, size_t row0, int j0,
                                             int width, const float (&v)[kRows][kCols]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float* p = g + (row0 + r) * width + j0;
    if (width % kCols == 0) {
      *reinterpret_cast<float4*>(p) = make_float4(v[r][0], v[r][1], v[r][2], v[r][3]);
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (j0 + c < width) p[c] = v[r][c];
    }
  }
}

// ops_f: the packed operators W_s (Nd + Nm rows) and Su^T (Nm rows),
// concatenated; ops_i: their row tables base (offsets into ops_f), start
// and stop, each Nd + 2 Nm ints in the same row order.
__global__ void __launch_bounds__(kMaxThreads)
admm_box_kernel(const float* __restrict__ free_g, const float* __restrict__ u_base,
                const float* __restrict__ u0, const float* __restrict__ ops_f, int n_ops_f,
                const int* __restrict__ ops_i, const float* __restrict__ xb,
                const float* __restrict__ ub, float* __restrict__ x_out,
                float* __restrict__ u_out, float* __restrict__ zx_out,
                float* __restrict__ zu_out, int Nm, int Nd, int T, int n_iters, int has_u,
                float alpha, float one_minus_alpha) {
  extern __shared__ float4 smem_f4[];
  const int n_rows = Nd + 2 * Nm;
  const int o_ws = 0, o_st = Nd + Nm;
  float* W = reinterpret_cast<float*>(smem_f4);
  int* base = reinterpret_cast<int*>(W + n_ops_f);
  float* s = reinterpret_cast<float*>(base + (n_rows + 3) / 4 * 4);  // (Nd + Nm) x T
  float* s_u = s + Nd * T;                                            // its last Nm rows
  float* uh_s = s + (Nd + Nm) * T;                                    // Nm x T
  float* part = uh_s + Nm * T;                                        // Nm x T
  float* xb_s = part + Nm * T;                                        // 2 x Nd
  float* ub_s = xb_s + 2 * Nd;                                        // 2 x Nm

  const int tid = threadIdx.x;
  const float4* src = reinterpret_cast<const float4*>(ops_f);
  for (int i = tid; i < n_ops_f / 4; i += blockDim.x) smem_f4[i] = src[i];
  for (int i = tid; i < n_rows; i += blockDim.x) base[i] = ops_i[i];
  for (int i = tid; i < 2 * Nd; i += blockDim.x) xb_s[i] = xb[i];
  for (int i = tid; i < 2 * Nm; i += blockDim.x) ub_s[i] = ub[i];
  const int* start = ops_i + n_rows;
  const int* stop = ops_i + 2 * n_rows;

  // phase 1: output tile (bu, j0), rows [k_lo, k_hi) of W_s; threads in
  // the second half take the upper half of the tile's rows. phase 2:
  // output tile (bx, c0). Row groups run fastest over the threads, so a
  // warp covers 8 row groups x 4 column groups: its s loads are one
  // 128-byte row and its operator loads one 64-byte row of shared memory,
  // and its threads have nearly the same row range.
  const int n_rg = T / kRows;
  const int n_u_tiles = n_rg * ((Nm + kCols - 1) / kCols);
  const bool u_owner = tid < n_u_tiles;
  const bool u_item = tid < 2 * n_u_tiles;
  const bool x_item = tid < n_rg * ((Nd + kCols - 1) / kCols);
  const int ut = u_owner ? tid : tid - n_u_tiles;
  const int j0 = (ut / n_rg) * kCols;
  const int bu = (ut % n_rg) * kRows;
  const int c0 = (tid / n_rg) * kCols;
  const int bx = (tid % n_rg) * kRows;
  const size_t row_u = static_cast<size_t>(blockIdx.x) * T + bu;
  const size_t row_x = static_cast<size_t>(blockIdx.x) * T + bx;

  int k_lo = 0, k_hi = 0, st_lo = 0, st_hi = 0;
  if (u_item) {
    row_range(start + o_ws, stop + o_ws, Nd + Nm, j0, k_lo, k_hi);
    const int mid = k_lo + (k_hi > k_lo ? (k_hi - k_lo) / 2 : 0);
    if (u_owner) k_hi = mid > k_lo ? mid : k_lo;
    else k_lo = mid > k_lo ? mid : k_lo;
  }
  if (x_item) row_range(start + o_st, stop + o_st, Nm, c0, st_lo, st_hi);

  float zu[kRows][kCols], lu[kRows][kCols];
  float zx[kRows][kCols], lx[kRows][kCols];
  float acc[kRows][kCols], v[kRows][kCols];

  if (u_owner) {
    load_global(u0, row_u, j0, Nm, zu);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) lu[r][c] = 0.0f;
    store_tile(uh_s, zu, T, bu, j0, Nm);
    store_tile(s_u, zu, T, bu, j0, Nm);
    if (n_iters == 0) store_global(u_out, row_u, j0, Nm, zu);
  }
  __syncthreads();

  // z_x = free + u0 Su^T
  if (x_item) {
    product(acc, uh_s, T, bx, W, base + o_st, st_lo, st_hi, c0);
    load_global(free_g, row_x, c0, Nd, v);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        zx[r][c] = add(v[r][c], acc[r][c]);
        lx[r][c] = 0.0f;
      }
    store_tile(s, zx, T, bx, c0, Nd);
    if (n_iters == 0) store_global(x_out, row_x, c0, Nd, zx);
  }
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    const bool last = it == n_iters - 1;
    // phase 1a: each half of the rows of s W_s
    if (u_item) {
      product(acc, s, T, bu, W, base + o_ws, k_lo, k_hi, j0);
      if (!u_owner) store_tile(part, acc, T, bu, j0, Nm);
    }
    __syncthreads();
    // phase 1b: u_hat = u_base + (s W_s), then the u block
    if (u_owner) {
      load_global(u_base, row_u, j0, Nm, v);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (j0 + c < Nm) {
          const float4 p = *reinterpret_cast<const float4*>(part + (j0 + c) * T + bu);
          const float pv[kRows] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int r = 0; r < kRows; ++r) v[r][c] = add(v[r][c], add(acc[r][c], pv[r]));
        }
      }
      store_tile(uh_s, v, T, bu, j0, Nm);
      if (last) store_global(u_out, row_u, j0, Nm, v);
      if (has_u) {
        box_update(v, zu, lu, ub_s, ub_s + Nm, j0, Nm, alpha, one_minus_alpha);
        store_s(s_u, zu, lu, T, bu, j0, Nm);
      }
    }
    __syncthreads();
    // phase 2: x_hat = free + u_hat Su^T, then the x block
    if (x_item) {
      product(acc, uh_s, T, bx, W, base + o_st, st_lo, st_hi, c0);
      load_global(free_g, row_x, c0, Nd, v);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) v[r][c] = add(v[r][c], acc[r][c]);
      if (last) store_global(x_out, row_x, c0, Nd, v);
      box_update(v, zx, lx, xb_s, xb_s + Nd, c0, Nd, alpha, one_minus_alpha);
      store_s(s, zx, lx, T, bx, c0, Nd);
    }
    __syncthreads();
  }

  if (u_owner) store_global(zu_out, row_u, j0, Nm, zu);
  if (x_item) store_global(zx_out, row_x, c0, Nd, zx);
}

}  // namespace

extern "C" int admm_box_launch(const void* free_g, const void* u_base, const void* u0,
                               const void* ops_f, int n_ops_f, const void* ops_i,
                               const void* xb, const void* ub, void* x_out, void* u_out,
                               void* zx_out, void* zu_out, int batch, int Nm, int Nd, int T,
                               int n_iters, int has_u, float alpha, float one_minus_alpha,
                               void* stream) {
  if (Nm <= 0 || Nd <= 0 || T <= 0 || T % kRows != 0 || batch <= 0 || batch % T != 0 ||
      n_ops_f < 0 || n_ops_f % 4 != 0 || n_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_u = 2 * (T / kRows) * ((Nm + kCols - 1) / kCols);
  const int tiles_x = (T / kRows) * ((Nd + kCols - 1) / kCols);
  const int threads = tiles_u > tiles_x ? tiles_u : tiles_x;
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n_rows = static_cast<size_t>(Nd) + 2 * static_cast<size_t>(Nm);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(n_ops_f) + (n_rows + 3) / 4 * 4 +
                       (static_cast<size_t>(Nd) + 3 * Nm) * T + 2 * (static_cast<size_t>(Nd) + Nm));
  cudaError_t err = cudaFuncSetAttribute(
      admm_box_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  admm_box_kernel<<<batch / T, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(free_g), static_cast<const float*>(u_base),
      static_cast<const float*>(u0), static_cast<const float*>(ops_f), n_ops_f,
      static_cast<const int*>(ops_i), static_cast<const float*>(xb),
      static_cast<const float*>(ub), static_cast<float*>(x_out), static_cast<float*>(u_out),
      static_cast<float*>(zx_out), static_cast<float*>(zu_out), Nm, Nd, T, n_iters, has_u,
      alpha, one_minus_alpha);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* admm_box_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
