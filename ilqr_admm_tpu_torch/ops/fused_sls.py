"""Fused robust SLS-ADMM scenario fleet on the card.

Counterpart of `ilqr_admm_tpu/ops/pallas_sls.py` (`make_pallas_sls_admm`
and its kernel `_sls_admm_kernel`). The one-time operator setup runs in
float64 on the host and is cast to the working dtype once; the ADMM loop
is one hand-written CUDA kernel, launched by `sls_admm`: `csrc/sls_admm.cu`
(the narrow route, W staged in shared memory, to Nm = 224 at p1 = 2) or
`csrc/sls_admm_wide.cu` (the wide route, W streamed from L2, to Nm =
1,552), chosen when the fleet is built (`sls_route`). On CPU tensors
`sls_admm` runs its plain torch version `sls_admm_reference` instead.

The decision matrix [du | Phi_u columns] of each instance is kept as
p + 1 column slabs of Nm rows. Each iteration is

    U_k = U_base_k + (Z_k - L_k) @ W                (W = (l_inv Rr)^T)
    Z   = P(alpha U + (1 - alpha) Z + L)           (row by row, over k)
    L   = L + U - Z

from Z = U_base, L = 0. P is either the exact projection of each row
(du_r, phi_r) onto the diamond w0 |du_r| + w1 |phi_r| <= bound
(z_update="diamond") or a fixed-count consensus ADMM onto the
intersection of second-order cones {phi : A_i phi + b_i in SOC}, with
b_i = b_fixed_i + bound * b_bound_i (z_update="consensus").

The kernel takes (Z - L) @ W on the tensor cores in 3xTF32, f32-accurate
products (`utils/precision.py::tf32x3_matmul` emulates them, and
`sls_admm_reference(..., products="tf32x3")` replays the loop with
them). The TPU kernel's `gemm_precision="bf16x3"` is a workaround for
Mosaic, which rejects `Precision.HIGH`, and was measured insufficient at
N = 100; it is not carried.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ilqr_admm_tpu_torch.ops.fused_admm import _check_packed, _fragments, pair_pack
from ilqr_admm_tpu_torch.ops.lifted import build_Su, build_Sx
from ilqr_admm_tpu_torch.problem import QuadCost, host_f64
from ilqr_admm_tpu_torch.solvers.lqt import block_diag_stacked, broadcast_rho, lqt_solve_sls
from ilqr_admm_tpu_torch.utils.device import resolve_device
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul, tf32x3_matmul

# Number of times `sls_admm` has launched its CUDA kernels in this process:
# the narrow route's (csrc/sls_admm.cu) and the wide route's
# (csrc/sls_admm_wide.cu).
launch_count = 0
wide_launch_count = 0

_EPS = 1e-30

# Kernel geometry, as in csrc/sls_admm.cu: a block owns 8 or 16
# instances; each group of 8 has ceil(p1 / 2) m16n8k8 row tiles, slabs
# 2 j and 2 j + 1 in tile j (a zero slab after an odd p1); one warp a
# piece of W's 8-column n-tiles for one group (`sls_pieces`), at most 16;
# it stages W (room for all its 8 x 8 blocks) and two s buffers in shared
# memory.
_TILES = (8, 16)
_MAX_WARPS = 16
_MAX_SMEM = 232448 - 16  # an H100 block's 227 KB, less the kernel's static words

# The (p1, n_sets, q) of the consensus z-updates that both kernels compile
# as their own builds (the bench's shapes, `Consensus` in
# csrc/sls_zupdate.cuh); every other shape up to CONSENSUS_MAX runs the
# general build (`General`), which reads the shape at run time and its
# constants from shared memory (_GENERAL_SMEM bytes of it). The diamond
# z-update is built for p1 = 2. The JAX kernel takes no robust_dim = 0
# (its setup divides by p), so p1 >= 2.
CONSENSUS_SHAPES = ((2, 2, 3), (3, 2, 4))
CONSENSUS_MAX = (8, 4, 9)  # p1, n_sets, q (q >= 2: a cone of dimension >= 2)
_MAX_COEFFS = 2 * 4 * 9 * 8 + 2 * 4 * 9 + 8 * 8
_GENERAL_SMEM = 4 * _MAX_COEFFS
_GENERAL_TILE_ONLY = ("the general consensus build (a shape not in CONSENSUS_SHAPES) takes "
                      "batch_tile 8")
Z_UPDATES = ("consensus", "diamond")


def sls_row(b: int, p: int, p1: int = 2) -> int:
    """Row of (instance b, slab p) in a tile's s and in its accumulators,
    in `csrc/sls_admm.cu`: each group of eight instances has ceil(p1 / 2)
    16-row m-tiles, slab-major inside each, so rows 0-7 of the group's
    m-tile j are slab 2 j of its eight instances and rows 8-15 slab 2 j + 1
    of the same eight (a zero slab after an odd p1). An accumulator holds
    rows g and g + 8 of its m-tile, so every slab of instance g at a column
    sits in one thread."""
    return 16 * ((b // 8) * -(-p1 // 2) + p // 2) + 8 * (p % 2) + b % 8


def sls_pieces(batch_tile: int, Nm: int, p1: int = 2) -> list[tuple[int, int, int]]:
    """Each warp's piece of the loop's product in `csrc/sls_admm.cu`, in
    warp order: (row of W's pair table, first m-tile, m-tiles). The
    batch_tile / 8 instance groups have ceil(p1 / 2) m-tiles each; each
    pair of W's 8-column n-tiles is cut into one piece a group, then the
    last single n-tile (when Nm / 8 rounds up to an odd count) likewise:
    at batch_tile 8 and Nm = 100, six pairs and the single, 7 warps (14 at
    16). A piece is one group, so each thread's rows belong to one
    instance."""
    groups, n1, ms = batch_tile // 8, -(-Nm // 8), -(-p1 // 2)
    pieces = [(p, m * ms, ms) for p in range(n1 // 2) for m in range(groups)]
    return pieces + [(n1 // 2, m * ms, ms) for m in range(groups if n1 % 2 else 0)]


def k_split(batch: int, batch_tile: int, Nm: int, sms: int, p1: int = 2) -> int:
    """Warps a piece of the product in `csrc/sls_admm.cu`: 2 (each piece's
    k range on two warps, which hand their partial sums over through
    shared memory) when the fleet has at most one block an SM, where one
    block's chain of dependent mma sets the time, and the doubled block
    fits in 16 warps (the kernel splits only 8-instance tiles at p1 = 2);
    else 1, where blocks sharing an SM hide each other's latency and the
    split's second barrier and sums only cost (tools/sls_admm_variants.py
    times both)."""
    fits = (batch_tile == 8 and p1 == 2
            and 2 * len(sls_pieces(batch_tile, Nm, p1)) <= _MAX_WARPS)
    return 2 if fits and batch // batch_tile <= sms else 1


def launch_geometry(batch_tile: int, Nm: int, p1: int, k_split: int = 1,
                    general: bool = False) -> tuple[int, int]:
    """(threads, dynamic shared-memory bytes) of one block of the narrow
    route, `csrc/sls_admm.cu`.

    Raises ValueError when the tile cannot be launched: p1 must be at
    least 2, batch_tile 8 or 16 (whole m16n8k8 row tiles), the block's
    pieces (each on k_split warps; 2 only at p1 = 2) must fit in 16 warps,
    and W with two copies of the tile's s (ceil(p1 / 2) 16-row m-tiles a
    group of 8 instances) must fit in shared memory, beside the general
    z-update's constants when it runs (general: tile 8 only).
    """
    if p1 < 2:
        raise ValueError(f"the kernel takes p1 >= 2 slabs (robust_dim >= 1), got p1 = {p1}")
    if batch_tile not in _TILES:
        raise ValueError(f"batch_tile={batch_tile}: the kernel takes "
                         f"{' or '.join(map(str, _TILES))} instances a block")
    if general and batch_tile != 8:
        raise ValueError(f"batch_tile={batch_tile}: {_GENERAL_TILE_ONLY}")
    warps = len(sls_pieces(batch_tile, Nm, p1)) * k_split
    if k_split == 2 and (batch_tile != 8 or p1 != 2):
        raise ValueError(f"the kernel splits the pieces of 8-instance tiles only, at p1 = 2; got "
                         f"batch_tile={batch_tile}, p1={p1}")
    if warps > _MAX_WARPS:
        raise ValueError(f"Nm={Nm} with batch_tile={batch_tile} needs {warps} warps per block; "
                         f"the kernel takes at most {_MAX_WARPS}")
    n1 = -(-Nm // 8)
    smem = 4 * (64 * n1 * n1 + 2 * (2 * -(-p1 // 2) * batch_tile) * 8 * n1
                + (32 * 4 * warps if k_split == 2 else 0))
    if smem + (_GENERAL_SMEM if general else 0) > _MAX_SMEM:
        raise ValueError(
            f"Nm={Nm} with batch_tile={batch_tile} needs {smem} bytes of shared memory to "
            f"stage W and the tile's iterate; the limit is {_MAX_SMEM} bytes"
        )
    return 32 * warps, smem


# The wide route, csrc/sls_admm_wide.cu: W^T as the A operand of TF32
# `wgmma.m64nNk8` in 64-row M tiles (tile i on warpgroup i % 4 of 4), its
# fragments streamed from L2 through a ring of _WIDE_STAGES k-steps in
# shared memory; s as B, pre-split hi and lo in shared memory, its N = 2
# batch_tile ceil(p1 / 2) columns laid out by `sls_wide_column`; K padded
# to a multiple of 16 (whole commit groups of two k-steps). Builds: tiles
# 8 and 16, N <= 64.
_WIDE_TILES = (8, 16)
_WIDE_GROUPS = 4
_WIDE_M = 64
_WIDE_STAGES = 4
_WIDE_MAX_N = 64
_WIDE_RING = 16 * 128 * _WIDE_STAGES * _WIDE_GROUPS
# k-steps a wide product chains on the tensor cores before it adds the
# chunk's sum to its f32 total (a multiple of the commit group, 2): at the
# N = 400 fleet 2 halves the kernel's distance to the f64 loop against 8,
# at the same time (tools/sls_admm_wide_variants.py)
SLS_WIDE_K_CHUNK = 2


def sls_wide_columns(batch_tile: int, p1: int) -> int:
    """N, the wide kernel's B columns: batch_tile instances of ceil(p1 / 2)
    slab pairs (an odd p1's last pair with a zero slab)."""
    return 2 * batch_tile * -(-p1 // 2)


def sls_wide_column(b: int, k: int, p1: int) -> int:
    """Column of (instance b of a tile, slab k) in `csrc/sls_admm_wide.cu`'s
    B operand and accumulators: 8 (b // 4 * H + k // 2) + 2 (b % 4) + k % 2
    with H = ceil(p1 / 2). In the m64nNk8 accumulator layout thread t of a
    quad holds columns 8 j + 2 t and 8 j + 2 t + 1 of every 8-column group
    j, so every slab of instance b sits in thread b % 4 at each row it
    holds, and the z-update needs no exchange."""
    H = -(-p1 // 2)
    return 8 * (b // 4 * H + k // 2) + 2 * (b % 4) + k % 2


def sls_wide_k_steps(Nm: int) -> int:
    """k-steps of 8 a wide product runs: Nm padded to a multiple of 16."""
    return 2 * -(-Nm // 16)


def sls_wide_tiles(Nm: int) -> int:
    """64-row M tiles of the wide route's output columns."""
    return -(-Nm // _WIDE_M)


def sls_wide_smem(batch_tile: int, Nm: int, p1: int) -> int:
    """Dynamic shared-memory bytes of one block of csrc/sls_admm_wide.cu:
    s as TF32 hi and lo (2 N K floats, K = 8 sls_wide_k_steps(Nm)) and the
    four warpgroups' rings of A fragments."""
    N = sls_wide_columns(batch_tile, p1)
    return 4 * 2 * N * 8 * sls_wide_k_steps(Nm) + _WIDE_RING


def sls_wide_edge(batch_tile: int, p1: int, general: bool = False) -> int:
    """The widest Nm the wide route takes at this tile and p1: where shared
    memory ends (1,552 at p1 = 2 and tile 8; 768 at p1 = 3 or 4, or tile
    16; 1,536 and 768 with the general z-update's constants)."""
    N = sls_wide_columns(batch_tile, p1)
    room = _MAX_SMEM - _WIDE_RING - (_GENERAL_SMEM if general else 0)
    return room // (4 * 2 * N * 16) * 16


def sls_wide_launch_geometry(batch_tile: int, Nm: int, p1: int,
                             general: bool = False) -> tuple[int, int]:
    """(threads, dynamic shared-memory bytes) of one block of the wide
    route, `csrc/sls_admm_wide.cu`, which streams W from L2.

    Raises ValueError when the tile cannot be launched: p1 from 2 to 8,
    batch_tile 8 or 16 with N = `sls_wide_columns` <= 64 (tile 16 takes
    p1 <= 4; the general z-update, tile 8 only), and s (hi and lo) with the
    rings, and the general z-update's constants when it runs, must fit in
    shared memory: to Nm = `sls_wide_edge` (1,552 at p1 = 2 and tile 8).
    """
    if not 2 <= p1 <= CONSENSUS_MAX[0]:
        raise ValueError(f"the wide kernel takes 2 <= p1 <= {CONSENSUS_MAX[0]}, got p1 = {p1}")
    if batch_tile not in _WIDE_TILES:
        raise ValueError(f"batch_tile={batch_tile}: the wide SLS kernel takes "
                         f"{' or '.join(map(str, _WIDE_TILES))} instances a block")
    if general and batch_tile != 8:
        raise ValueError(f"batch_tile={batch_tile}: {_GENERAL_TILE_ONLY}")
    N = sls_wide_columns(batch_tile, p1)
    if N > _WIDE_MAX_N:
        raise ValueError(f"batch_tile={batch_tile} at p1 = {p1} needs {N} columns of B; the wide "
                         f"kernel is built for at most {_WIDE_MAX_N} (tile 16 takes p1 <= 4)")
    smem = sls_wide_smem(batch_tile, Nm, p1)
    if smem + (_GENERAL_SMEM if general else 0) > _MAX_SMEM:
        raise ValueError(
            f"Nm={Nm} with batch_tile={batch_tile} at p1 = {p1} needs {smem} bytes of shared "
            f"memory on the wide route; the limit is {_MAX_SMEM} bytes (Nm <= "
            f"{sls_wide_edge(batch_tile, p1, general)} at this tile)"
        )
    return 128 * _WIDE_GROUPS, smem


def sls_route(batch_tile: int, Nm: int, p1: int, general: bool = False) -> str:
    """"narrow" when `csrc/sls_admm.cu` takes the tile (W staged in shared
    memory; `launch_geometry`), else "wide" when `csrc/sls_admm_wide.cu`
    does (W streamed from L2; `sls_wide_launch_geometry`); raises
    ValueError, with both kernels' reasons and limits, when neither does.
    general: the consensus z-update runs the general build (a shape not in
    CONSENSUS_SHAPES). Every launch the narrow kernel took before the wide
    route existed stays with it."""
    try:
        launch_geometry(batch_tile, Nm, p1, general=general)
        return "narrow"
    except ValueError as narrow:
        try:
            sls_wide_launch_geometry(batch_tile, Nm, p1, general)
            return "wide"
        except ValueError as wide:
            raise ValueError(
                f"no SLS kernel takes this launch: the narrow kernel (csrc/sls_admm.cu, W in "
                f"shared memory, Nm <= 224 at p1 = 2): {narrow}; the wide kernel "
                f"(csrc/sls_admm_wide.cu, W streamed from L2, Nm <= {sls_wide_edge(8, 2)} at "
                f"p1 = 2 and batch_tile 8): {wide}"
            ) from None


def pack_sls_wide(W: torch.Tensor):
    """W in the wide route's storage: (ops_f, ops_i). ops_f holds W^T,
    zero-padded to (64 sls_wide_tiles(Nm), 8 sls_wide_k_steps(Nm)), as
    (tile, k-step, 512) A fragments of a TF32 `wgmma.m64nNk8` (thread 32 w
    + 4 g + t of the warpgroup: rows 16 w + g and 16 w + g + 8, columns t
    and t + 4; `fused_admm._fragments`); ops_i = (tiles, k-steps) int32."""
    Nm = W.shape[0]
    n_tiles, nk = sls_wide_tiles(Nm), sls_wide_k_steps(Nm)
    A = torch.nn.functional.pad(W.T, (0, 8 * nk - Nm, 0, _WIDE_M * n_tiles - Nm))
    blocks = A.reshape(n_tiles, _WIDE_M, nk, 8).permute(0, 2, 1, 3)
    ops_f = _fragments(blocks).reshape(-1).contiguous()
    return ops_f, torch.tensor([n_tiles, nk], dtype=torch.int32, device=W.device)


def _schedule(n_iters: int, stop_tol: float, check_every: int) -> tuple[int, int]:
    """(chunk_len, n_chunks): the iteration counts of one solve.

    With stop_tol > 0 a tile runs up to ceil(n_iters / check_every)
    chunks of check_every iterations and leaves after any chunk whose
    residual is below stop_tol, so an unconverged tile runs up to
    check_every - 1 iterations past n_iters, as `_sls_admm_kernel` does.
    With stop_tol = 0 it runs exactly n_iters.
    """
    if n_iters < 0:
        raise ValueError(f"n_iters must be >= 0, got {n_iters}")
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if stop_tol > 0.0:
        return check_every, -(-n_iters // check_every)
    return n_iters, 1


def _soc_project_slabs(ws, t):
    """SOC projection of slab-decomposed [w_0..w_{q-2} | t] onto ||w|| <= t."""
    n2 = ws[0] * ws[0]
    for w in ws[1:]:
        n2 = n2 + w * w
    n = torch.sqrt(n2)
    inside = n <= t
    polar = n <= -t
    scale = 0.5 * (n + t) / (n + _EPS)
    w_out = [torch.where(inside, w, torch.where(polar, 0.0, scale * w)) for w in ws]
    t_out = torch.where(inside, t, torch.where(polar, 0.0, 0.5 * (n + t)))
    return w_out, t_out


def _diamond_project_slabs(a, b, w0: float, w1: float, r):
    """Exact projection of rows (a, b) onto {w0 |a| + w1 |b| <= r}.

    The soft-threshold solution with the 2D multiplier in closed form:
    the line projection where both coordinates stay active, else the
    vertex where one is clamped to 0. sign(0) = 0 keeps a zero
    coordinate at zero.
    """
    aa = torch.abs(a)
    ab = torch.abs(b)
    s = w0 * aa + w1 * ab
    inside = s <= r
    lam = (s - r) / (w0 * w0 + w1 * w1)
    xa = aa - lam * w0
    xb = ab - lam * w1
    na = torch.where(xb < 0.0, r / w0, torch.where(xa < 0.0, 0.0, xa))
    nb = torch.where(xb < 0.0, 0.0, torch.where(xa < 0.0, r / w1, xb))
    return (torch.where(inside, a, torch.sign(a) * na),
            torch.where(inside, b, torch.sign(b) * nb))


def _consensus_project(ys, bound, *, soc_A, soc_b_fixed, soc_b_bound, l_inv_cons, cons_rho,
                       n_cons_iters):
    """Project each row y (slab list of length p1) onto the intersection
    {phi : A_i phi + b_i in SOC for all i} by n_cons_iters consensus-ADMM
    iterations from z_i = A_i y + b_i, lambda_i = 0, and one x-update
    after the last. Zero coefficients are skipped, as in the TPU kernel."""
    nsets = len(soc_A)
    p1 = len(ys)
    q = soc_A[0].shape[0] if nsets else 0
    zero = torch.zeros_like(ys[0])

    def offset(i, r):
        out = torch.full_like(ys[0], float(soc_b_fixed[i][r]))
        s = float(soc_b_bound[i][r])
        return out + s * bound if s != 0.0 else out

    bsl = [[offset(i, r) for r in range(q)] for i in range(nsets)]

    def A_times(i, r, vs, acc):
        for k in range(p1):
            a = float(soc_A[i][r, k])
            if a != 0.0:
                acc = acc + a * vs[k]
        return acc

    def x_update(zs, lmbs):
        rx = []
        for k in range(p1):
            acc = ys[k]
            for i in range(nsets):
                for r in range(q):
                    a = float(soc_A[i][r, k])
                    if a != 0.0:
                        acc = acc + (cons_rho * a) * (zs[i][r] - bsl[i][r] - lmbs[i][r])
            rx.append(acc)
        xs = []
        for k in range(p1):
            acc = zero
            for j in range(p1):
                c = float(l_inv_cons[k, j])
                if c != 0.0:
                    acc = acc + c * rx[j]
            xs.append(acc)
        return xs

    zs = [[A_times(i, r, ys, zero) + bsl[i][r] for r in range(q)] for i in range(nsets)]
    lmbs = [[zero] * q for _ in range(nsets)]
    for _ in range(n_cons_iters):
        xs = x_update(zs, lmbs)
        zs_new, lmbs_new = [], []
        for i in range(nsets):
            Ax_b = [A_times(i, r, xs, bsl[i][r]) for r in range(q)]
            w_in = [Ax_b[r] + lmbs[i][r] for r in range(q)]
            w_out, t_out = _soc_project_slabs(w_in[:-1], w_in[-1])
            z_new = w_out + [t_out]
            lmbs_new.append([lmbs[i][r] + Ax_b[r] - z_new[r] for r in range(q)])
            zs_new.append(z_new)
        zs, lmbs = zs_new, lmbs_new
    return x_update(zs, lmbs)


def _check_inputs(bounds, U_base, W, batch_tile):
    named = dict(bounds=bounds, U_base=U_base, W=W)
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.device != W.device:
            raise ValueError(f"{name} is on {t.device} but W is on {W.device}")
        if t.dtype != W.dtype:
            raise TypeError(f"{name} is {t.dtype} but W is {W.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if W.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sls_admm takes float32 (or float64 on CPU), got {W.dtype}")
    if bounds.ndim != 1 or U_base.ndim != 2 or W.ndim != 2:
        raise ValueError("bounds, U_base and W must be (batch,), (p1, Nm) and (Nm, Nm)")
    Nm = U_base.shape[1]
    if tuple(W.shape) != (Nm, Nm):
        raise ValueError(f"W has shape {tuple(W.shape)}, expected {(Nm, Nm)}")
    batch = bounds.shape[0]
    if batch_tile < 1 or batch % batch_tile:
        raise ValueError(f"batch {batch} must be a multiple of batch_tile {batch_tile}")


def sls_admm_reference(
    bounds, U_base, W, *, n_iters, n_cons_iters=20, alpha=1.0, cons_rho=10.0, stop_tol=0.0,
    check_every=8, batch_tile=8, z_update="consensus", diamond_w=None, soc_A=(),
    soc_b_fixed=(), soc_b_bound=(), l_inv_cons=None, products="f32", stats=None,
):
    """Plain torch version of the kernel, in f32 or f64, on any device.

    Works on (n_tiles, batch_tile, Nm) slabs so that early exit is per
    tile, as in the kernel: a tile that has exited keeps its iterates.
    With stop_tol > 0 the residual of a chunk is the max over the tile
    of |U - Z| and |Z - Z_prev| at the chunk's last iteration; a NaN
    residual stops the tile. Returns U (batch, Nm, p1).

    products: "f32" (full f32 matmuls) or "tf32x3", the product
    (Z - L) @ W as the kernel's tensor cores take it (`tf32x3_matmul`;
    float32 only). The z-update and the dual update are the same in both.
    stats: a dict that receives "tile_iterations", the (n_tiles,)
    iterations each tile ran.
    """
    if products == "f32":
        matmul = torch.matmul
    elif products == "tf32x3":
        if W.dtype != torch.float32:
            raise TypeError(f'products="tf32x3" takes float32, got {W.dtype}')
        matmul = tf32x3_matmul
    else:
        raise ValueError(f'products must be "f32" or "tf32x3", got {products!r}')
    chunk_len, n_chunks = _schedule(n_iters, stop_tol, check_every)
    batch = bounds.shape[0]
    p1, Nm = U_base.shape
    n_tiles = batch // batch_tile
    bound = bounds.reshape(n_tiles, batch_tile, 1)
    ub = U_base[:, None, None, :]  # (p1, 1, 1, Nm) against (p1, n_tiles, batch_tile, Nm)
    if z_update == "diamond":
        w0, w1 = float(diamond_w[0]), float(diamond_w[1])

        def project(Y):
            return torch.stack(_diamond_project_slabs(Y[0], Y[1], w0, w1, bound))
    else:
        cons = dict(soc_A=soc_A, soc_b_fixed=soc_b_fixed, soc_b_bound=soc_b_bound,
                    l_inv_cons=l_inv_cons, cons_rho=cons_rho, n_cons_iters=n_cons_iters)

        def project(Y):
            return torch.stack(_consensus_project(list(Y), bound, **cons))

    def step(Z, L):
        U = ub + matmul(Z - L, W)
        Z_new = project(alpha * U + (1.0 - alpha) * Z + L)
        return Z_new, L + U - Z_new, U

    with full_f32_matmul():
        Z = ub.expand(p1, n_tiles, batch_tile, Nm)
        L = torch.zeros_like(Z)
        U = Z
        active = None  # per-tile mask, once early exit has been tested
        ran = torch.zeros(n_tiles, dtype=torch.long, device=W.device)
        for _ in range(n_chunks):
            ran += chunk_len if active is None else chunk_len * active
            for _ in range(chunk_len):
                Z_prev = Z
                new = step(Z, L)
                if active is None:
                    Z, L, U = new
                else:
                    keep = active[None, :, None, None]
                    Z, L, U = (torch.where(keep, a, b) for a, b in zip(new, (Z, L, U)))
            if stop_tol > 0.0:
                res = torch.maximum(torch.abs(U - Z), torch.abs(Z - Z_prev))
                running = torch.amax(res, dim=(0, 2, 3)) >= stop_tol
                active = running if active is None else active & running
                if not bool(active.any()):
                    break
    if stats is not None:
        stats["tile_iterations"] = ran
    return U.permute(1, 2, 3, 0).reshape(batch, Nm, p1)


def general_z_update(p1: int, z_update: str, soc_A) -> bool:
    """Whether the kernels run the general consensus build: a consensus
    shape without a build of its own (not in CONSENSUS_SHAPES)."""
    n_sets = len(soc_A)
    q = soc_A[0].shape[0] if n_sets else 0
    return z_update == "consensus" and (p1, n_sets, q) not in CONSENSUS_SHAPES


def kernel_z_update(p1, z_update, diamond_w, soc_A, soc_b_fixed, soc_b_bound, l_inv_cons,
                    cons_rho):
    """(mode, coeffs, n_sets, q): the z-update as both kernels take it.

    mode 0 is the diamond, with coeffs (w0, w1, w0^2 + w1^2); mode 1 the
    consensus, with coeffs A, cons_rho * A, b_fixed, b_bound and
    l_inv_cons packed row-major (the shapes of CONSENSUS_SHAPES run their
    own builds, the rest the general one). Each f32 coefficient is rounded
    once from its f64 value, as the TPU kernel's trace-time constants are.
    Raises ValueError for a shape past CONSENSUS_MAX.
    """
    if z_update == "diamond":
        if p1 != 2:
            raise ValueError(f"the diamond kernel is built for p1 = 2, got p1 = {p1}")
        w0, w1 = float(diamond_w[0]), float(diamond_w[1])
        return 0, np.asarray([w0, w1, w0 * w0 + w1 * w1], np.float32), 0, 0
    n_sets = len(soc_A)
    q = soc_A[0].shape[0] if n_sets else 0
    max_p1, max_sets, max_q = CONSENSUS_MAX
    if not (2 <= p1 <= max_p1 and 1 <= n_sets <= max_sets and 2 <= q <= max_q):
        raise ValueError(
            f"the consensus kernels are not built for (p1, n_sets, q) = {(p1, n_sets, q)}: they "
            f"take 2 <= p1 <= {max_p1}, 1 <= n_sets <= {max_sets} and 2 <= q <= {max_q} "
            f"(the general build's constants, {_MAX_COEFFS} floats, live in shared memory)"
        )
    A = np.stack([np.asarray(a, np.float64) for a in soc_A])
    parts = (A, cons_rho * A, np.stack(soc_b_fixed), np.stack(soc_b_bound), l_inv_cons)
    coeffs = np.concatenate([np.asarray(x, np.float64).ravel() for x in parts])
    return 1, coeffs.astype(np.float32), n_sets, q


def _check_route_packed(packed, W, route):
    """packed: W in the storage of `route`, on W's device."""
    Nm = W.shape[0]
    if route == "narrow":
        _check_packed(packed, W, (-(-Nm // 16), 4), "pair_pack(W)", f"Nm={Nm}")
    elif route == "wide":
        _check_packed(packed, W, (2,), "pack_sls_wide(W)", f"Nm={Nm}")
        if packed[0].numel() != 512 * sls_wide_tiles(Nm) * sls_wide_k_steps(Nm):
            raise ValueError(f"packed does not have the shapes of pack_sls_wide(W) at Nm={Nm}")
    else:
        raise ValueError(f'route must be "narrow" or "wide", got {route!r}')


def sls_admm(
    bounds, U_base, W, packed, *, n_iters, n_cons_iters=20, alpha=1.0, cons_rho=10.0,
    stop_tol=0.0, check_every=8, batch_tile=8, z_update="consensus", diamond_w=None, soc_A=(),
    soc_b_fixed=(), soc_b_bound=(), l_inv_cons=None, route="narrow",
):
    """Run the robust SLS-ADMM loop on a fleet; returns U (batch, Nm, p1).

    bounds (batch,): the per-instance scenario bound; U_base (p1, Nm):
    the unconstrained x-update, shared by every instance; W (Nm, Nm):
    the response to s = Z - L; packed: W in the storage of `route`
    (the solver packs it once, at setup): `pair_pack(W)` for "narrow",
    `pack_sls_wide(W)` for "wide". batch must be a multiple of
    batch_tile. The z-update options are those of `make_fused_sls_admm`;
    soc_* and l_inv_cons are float64 numpy arrays.

    CUDA tensors (float32) go to the route's kernel, which reads only the
    packed W and runs its products on the tensor cores in 3xTF32, held to
    `sls_admm_reference(..., products="tf32x3")`: "narrow" to
    `csrc/sls_admm.cu` (W in shared memory; batch_tile 8 or 16, any p1 >=
    2 to Nm = 224 at p1 = 2, see `launch_geometry`; `k_split` chooses its
    warps), "wide" to `csrc/sls_admm_wide.cu` (W streamed from L2; see
    `sls_wide_launch_geometry`). Both take the diamond at p1 = 2 and the
    consensus at any shape to CONSENSUS_MAX (`kernel_z_update`). CPU
    tensors go to `sls_admm_reference` with f32 products, which reads only
    the dense W. Any other device raises.
    """
    global launch_count, wide_launch_count
    _check_inputs(bounds, U_base, W, batch_tile)
    _check_route_packed(packed, W, route)
    kw = dict(
        n_iters=n_iters, n_cons_iters=n_cons_iters, alpha=alpha, cons_rho=cons_rho,
        stop_tol=stop_tol, check_every=check_every, batch_tile=batch_tile, z_update=z_update,
        diamond_w=diamond_w, soc_A=soc_A, soc_b_fixed=soc_b_fixed, soc_b_bound=soc_b_bound,
        l_inv_cons=l_inv_cons,
    )
    device = W.device
    if device.type == "cpu":
        return sls_admm_reference(bounds, U_base, W, **kw)
    if device.type != "cuda":
        raise ValueError(f"sls_admm runs on CPU or CUDA tensors, got {device}")
    if W.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {W.dtype}")
    chunk_len, n_chunks = _schedule(n_iters, stop_tol, check_every)
    batch = bounds.shape[0]
    p1, Nm = U_base.shape
    mode, coeffs, n_sets, q = kernel_z_update(
        p1, z_update, diamond_w, soc_A, soc_b_fixed, soc_b_bound, l_inv_cons, cons_rho
    )
    general = general_z_update(p1, z_update, soc_A)
    if route == "narrow":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        split = k_split(batch, batch_tile, Nm, sms, p1)
        launch_geometry(batch_tile, Nm, p1, split, general)
    else:
        sls_wide_launch_geometry(batch_tile, Nm, p1, general)

    from ilqr_admm_tpu_torch._build import load_library

    lib = load_library()
    ops_f, ops_i = packed
    U = torch.empty((batch, Nm, p1), dtype=W.dtype, device=device)
    schedule = (chunk_len, n_chunks, float(alpha), float(1.0 - alpha), float(stop_tol))
    z_args = (mode, coeffs.ctypes.data, n_sets, q, int(n_cons_iters))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if route == "narrow":
            err = lib.sls_admm_launch(
                bounds.data_ptr(), U_base.data_ptr(), ops_f.data_ptr(), ops_f.numel(),
                ops_i.data_ptr(), U.data_ptr(), batch, Nm, batch_tile, p1, *schedule, *z_args,
                split, stream,
            )
        else:
            n_tiles, nk = sls_wide_tiles(Nm), sls_wide_k_steps(Nm)
            # Z and L of every block, in each thread's accumulator order
            state = torch.empty(
                (batch // batch_tile) * n_tiles * sls_wide_columns(batch_tile, p1) * 128,
                dtype=W.dtype, device=device,
            )
            err = lib.sls_admm_wide_launch(
                bounds.data_ptr(), U_base.data_ptr(), ops_f.data_ptr(), state.data_ptr(),
                U.data_ptr(), batch, Nm, n_tiles, nk, SLS_WIDE_K_CHUNK, batch_tile, p1,
                *schedule, *z_args,
                stream,
            )
    if err != 0:
        msg = lib.sls_admm_error_string(err).decode()
        raise RuntimeError(f"sls_admm ({route}) kernel launch failed: {msg} (cudaError {err})")
    if route == "narrow":
        launch_count += 1
    else:
        wide_launch_count += 1
    return U


class FusedSLSADMM(nn.Module):
    """Batched robust SLS-ADMM solver for one problem and z-update.

    Holds the one-time operators as buffers (PHI_unc (Nm, Nd), U_base
    (p1, Nm), W (Nm, Nm) and W packed for its kernel, ops_f and ops_i);
    `route` is the kernel chosen at build ("narrow" or "wide", `sls_route`;
    None on the CPU, where the plain version runs). `forward(bounds
    (batch,))` returns (du (batch, Nm), phi_u (batch, Nm, Nd), U (batch,
    Nm, p1)) like the JAX `solve`.
    """

    def __init__(self, operators: dict, robust_dim: int, route: str | None, **kernel_options):
        super().__init__()
        for name, value in operators.items():
            self.register_buffer(name, value)
        self.robust_dim = robust_dim
        self.route = route
        self.kernel_options = kernel_options

    @property
    def packed(self):
        """(ops_f, ops_i): W in its route's storage (`pair_pack` for the
        narrow route and on the CPU, `pack_sls_wide` for the wide one)."""
        return self.ops_f, self.ops_i

    def forward(self, bounds):
        bounds = torch.as_tensor(bounds).to(self.W.device, self.W.dtype).contiguous()
        U = sls_admm(bounds, self.U_base, self.W, self.packed, **self.kernel_options,
                     route=self.route or "narrow")
        p = self.robust_dim
        phi_u = torch.cat(
            [U[:, :, 1:], self.PHI_unc[:, p:].expand(U.shape[0], -1, -1)], dim=-1
        )
        return U[:, :, 0], phi_u, U


def make_fused_sls_admm(
    A,
    B,
    cost: QuadCost,
    soc_A,
    soc_b_fixed,
    soc_b_bound,
    rho_u,
    robust_dim: int = 1,
    n_iters: int = 50,
    n_cons_iters: int = 20,
    cons_rho: float = 10.0,
    alpha: float = 1.0,
    batch_tile: int = 8,
    gemm_precision: str = "f32",
    stop_tol: float = 0.0,
    check_every: int = 8,
    z_update: str = "consensus",
    diamond_w=None,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> FusedSLSADMM:
    """Build a batched robust SLS-ADMM solver for the fused kernel.

    The arguments are those of `make_pallas_sls_admm`, with `device` and
    `dtype` in place of `interpret`; device defaults to the CUDA card
    ("cpu" runs the plain version of the kernel). Returns a module; solver(bounds
    (batch,)) -> (du, phi_u, U) with batch a multiple of batch_tile.

    Chance-constrained control rows: every row phi (length p + 1) of
    [du | Phi_u columns] must satisfy soc_A[i] @ phi + b_i in SOC for
    each set i, with b_i = soc_b_fixed[i] + bound * soc_b_bound[i]
    (z_update="consensus", n_cons_iters inner iterations at cons_rho).
    z_update="diamond" needs robust_dim = 1 and diamond_w = (w_du,
    w_phi) > 0 and projects each row exactly onto w_du |du| + w_phi |phi|
    <= bound; soc_* are then ignored. stop_tol > 0 turns on per-tile
    early exit, tested every check_every iterations.

    batch_tile is the number of instances one CUDA block owns (and the
    early-exit group). Both kernels take 8 or 16 (`launch_geometry`,
    `sls_wide_launch_geometry`); the default 8 gives the bench batch of
    1024 128 blocks, about one for each of an H100's 132 SMs. On a CUDA
    device dtype must be float32, and the kernel is chosen here
    (`sls_route`: W staged in shared memory to Nm = 224 at p1 = 2, else
    streamed from L2 to Nm = 1,552): a fleet that neither kernel takes, or
    a consensus shape past CONSENSUS_MAX, raises ValueError here, not at
    its first call.

    The problem data are rounded to `dtype`, then the setup (PHI_unc
    from `lqt_solve_sls`, U_base = (l_inv r_base)^T and W = (l_inv Rr)^T)
    runs in float64 and is cast to `dtype` once.
    """
    device = resolve_device(device)
    if z_update not in Z_UPDATES:
        raise ValueError(f"unknown z_update {z_update!r}; expected one of {Z_UPDATES}")
    if robust_dim < 1:
        raise ValueError(f"robust_dim must be >= 1, got {robust_dim} (the JAX kernel's setup "
                         "takes none either)")
    p1 = robust_dim + 1
    if z_update == "diamond":
        if p1 != 2 or diamond_w is None or len(diamond_w) != 2:
            raise ValueError(
                "z_update='diamond' requires robust_dim == 1 and diamond_w = (w_du, w_phi)"
            )
        diamond_w = np.asarray(diamond_w, np.float64)
        if not np.all(diamond_w > 0.0):
            # a zero weight makes r / w infinite in the vertex branch of the
            # closed-form projection: NaN iterates with no error
            raise ValueError(f"diamond_w must be strictly positive, got {tuple(diamond_w)}")
        soc_A, soc_b_fixed, soc_b_bound = (), (), ()
        l_inv_cons = np.eye(p1)
    else:
        soc_A = tuple(np.asarray(a, np.float64) for a in soc_A)
        soc_b_fixed = tuple(np.asarray(b, np.float64) for b in soc_b_fixed)
        soc_b_bound = tuple(np.asarray(b, np.float64) for b in soc_b_bound)
        if len({a.shape[0] for a in soc_A}) > 1:
            # the row loops run over q = soc_A[0].shape[0]; a ragged set
            # would have its extra rows silently dropped
            raise ValueError(
                "all soc_A constraint sets must have the same number of rows; "
                f"got {[a.shape[0] for a in soc_A]}; zero-pad the smaller sets"
            )
        if not len(soc_A) == len(soc_b_fixed) == len(soc_b_bound):
            raise ValueError("soc_A, soc_b_fixed and soc_b_bound must have equal lengths")
        for a, bf, bb in zip(soc_A, soc_b_fixed, soc_b_bound):
            q = a.shape[0]
            if a.shape != (q, p1) or bf.shape != (q,) or bb.shape != (q,):
                raise ValueError(
                    f"each soc_A must be (q, robust_dim + 1) = (q, {p1}) and each soc_b (q,); "
                    f"got {a.shape}, {bf.shape}, {bb.shape}"
                )
        lc = np.eye(p1)
        for a in soc_A:
            lc = lc + cons_rho * (a.T @ a)
        l_inv_cons = np.linalg.inv(lc)
    if gemm_precision == "bf16x3":
        raise ValueError(
            "gemm_precision='bf16x3' is not carried by the port: it exists because Mosaic "
            "rejects Precision.HIGH on the TPU, and was measured insufficient at N = 100 "
            "(19% solution drift through the ill-conditioned (l_inv Rr) operator); use 'f32'"
        )
    if gemm_precision != "f32":
        raise ValueError(f"unknown gemm_precision {gemm_precision!r}; the port has only 'f32'")
    _schedule(n_iters, stop_tol, check_every)
    route = None
    if device.type == "cuda":
        # refuse what no kernel takes now, not at the first call
        kernel_z_update(p1, z_update, diamond_w, soc_A, soc_b_fixed, soc_b_bound, l_inv_cons,
                        cons_rho)
        route = sls_route(batch_tile, A.shape[0] * B.shape[-1], p1,
                          general_z_update(p1, z_update, soc_A))

    A, B, cost = host_f64(A, B, cost, dtype)
    N, m = A.shape[0], B.shape[-1]
    p = robust_dim
    with full_f32_matmul():
        PHI_unc, _ = lqt_solve_sls(A, B, cost)
        Su = build_Su(A, B)
        Sx = build_Sx(A, p).reshape(-1, p)
        Rr_l = block_diag_stacked(broadcast_rho(rho_u, m, N, dtype).to(torch.float64))
        SuTQ = Su.T @ block_diag_stacked(cost.Q)
        l_inv = torch.linalg.inv(SuTQ @ Su + block_diag_stacked(cost.R) + Rr_l)
        r_base = torch.cat([(SuTQ @ cost.lifted_xd())[:, None], -SuTQ @ Sx], dim=-1)
        operators = dict(
            PHI_unc=PHI_unc,
            U_base=(l_inv @ r_base).T,  # (p1, Nm)
            W=(l_inv @ Rr_l).T,  # (Nm, Nm); U += (Z - L) @ W
        )
    operators = {k: v.to(device=device, dtype=dtype).contiguous() for k, v in operators.items()}
    # the kernel's storage of W, packed once
    pack = pack_sls_wide if route == "wide" else pair_pack
    operators["ops_f"], operators["ops_i"] = pack(operators["W"])
    return FusedSLSADMM(
        operators, robust_dim, route, n_iters=n_iters, n_cons_iters=n_cons_iters, alpha=alpha,
        cons_rho=cons_rho, stop_tol=float(stop_tol), check_every=int(check_every),
        batch_tile=batch_tile, z_update=z_update, diamond_w=diamond_w, soc_A=soc_A,
        soc_b_fixed=soc_b_fixed, soc_b_bound=soc_b_bound, l_inv_cons=l_inv_cons,
    )
