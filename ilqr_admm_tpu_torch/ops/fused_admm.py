"""Fused box-constrained LQT-ADMM fleet on the card.

Counterpart of `ilqr_admm_tpu/ops/pallas_admm.py` (`make_pallas_lqt_admm`
and its kernels `_admm_kernel_u_only` and `_admm_kernel`). The one-time
operator setup runs in float64 on the host and is cast to the working
dtype; the per-solve pre-kernel products are plain torch matmuls in full
f32; the ADMM loop itself is one hand-written CUDA kernel:

- control bounds only: `admm_u_only`, which launches `csrc/admm_u_only.cu`
  where W_u fits in a block's shared memory (`launch_geometry`) and
  `csrc/admm_u_only_wide.cu`, which streams W_u from L2, where it does
  not (`wide_launch_geometry`; Nm = 512 in `bench_wide_certified.py`);
- state bounds, with or without control bounds: `admm_box`, which
  launches `csrc/admm_box.cu` where its packed operators fit in a block's
  shared memory (`box_launch_geometry`; Nm <= 128, Nd <= 256) and
  `csrc/admm_box_wide.cu`, which streams them from L2, where they do not
  (`box_wide_launch_geometry`; Nm <= 512, Nd <= 1,024; `box_route`
  chooses).

On CPU tensors each wrapper runs its plain torch version
(`admm_u_only_reference`, `admm_box_reference`) instead.

Both kernels take their products on the tensor cores in 3xTF32, the
counterpart of the TPU's bf16x3 `_dot3` (`utils/precision.py` emulates
it). The u-only kernels schedule their products as the TPU kernel does:
with refresh_every = r > 1 the running correction c = s @ W_u is set
exactly (3xTF32) at the first iteration of each block of r and updated
as c += (s - s_prev) @ W_u in one TF32 pass (`tf32x1_matmul`, the
counterpart of the TPU's single bf16 pass) at the r - 1 others; the
`polish_iters` tail and, with `stop_tol > 0`, the last iteration of each
chunk (whose residual is the exit test) set c afresh in 6xTF32, the
counterpart of the bf16x6 `_dot6`. With r = 1 every main iteration is a
3xTF32 refresh. The main phase runs ceil(n_main / r) * r iterations and
the tail min(polish_iters, n_iters) more, with n_main =
max(n_iters - polish_iters, 0). The state-bounded path ignores
`refresh_every`, `polish_iters`, `stop_tol` and `check_every`, as the
JAX factory does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ilqr_admm_tpu_torch.ops.lifted import build_Su, build_Sx
from ilqr_admm_tpu_torch.problem import QuadCost, host_f64
from ilqr_admm_tpu_torch.solvers.admm import validate_constraint_blocks
from ilqr_admm_tpu_torch.solvers.lqt import block_diag_stacked, broadcast_rho
from ilqr_admm_tpu_torch.utils.device import resolve_device
from ilqr_admm_tpu_torch.utils.precision import (
    full_f32_matmul,
    tf32x1_matmul,
    tf32x3_matmul,
    tf32x6_matmul,
)

# Number of times `admm_u_only` has launched each of its CUDA kernels in
# this process: csrc/admm_u_only.cu, and the wide route
# csrc/admm_u_only_wide.cu.
launch_count = 0
wide_launch_count = 0

# Kernel geometry, as in csrc/admm_u_only.cu: a block owns 16, 32 or 64
# instances (one, two or four m16n8k8 row tiles) and has one warp a piece
# (a pair of 8-column n-tiles over two row tiles, or the last single
# n-tile over one), at most 16; it stages W_u (room for all its 8 x 8
# blocks), two s buffers (three with delta products) and the bounds in
# shared memory.
_U_TILES = (16, 32, 64)
_U_MAX_WARPS = 16
_MAX_SMEM = 232448 - 16  # an H100 block's 227 KB, less the kernels' static words

# The wide route's geometry, as in csrc/admm_u_only_wide.cu: a block owns
# 16 or 32 instances; each warp owns _WIDE_PAIRS[tile] pairs of W_u's
# n-tiles over all the tile's m16 row tiles (32 accumulators a thread),
# at most 16 warps; W_u's blocks stream from L2, and shared memory holds
# two s buffers, lambda and the bounds.
_WIDE_TILES = (16, 32)
_WIDE_PAIRS = {16: 4, 32: 2}
# k-steps of 8 that the wide route's refresh, tail and x products chain on
# the tensor cores before adding the chunk to their f32 total (WIDE_KC)
WIDE_K_CHUNK = 8


def u_only_pieces(batch_tile: int, Nm: int) -> list[tuple[int, int, int]]:
    """Each warp's piece of the loop's product in `csrc/admm_u_only.cu`,
    in warp order: (row of W_u's pair table, first m-tile, m-tiles).

    W_u's pairs of 8-column n-tiles are cut into pieces of two m16 row
    tiles (one at batch_tile 16), then the last single n-tile (when Nm / 8
    rounds up to an odd count) into pieces of one; the kernel derives the
    same list from its warp index. Warp w runs on sub-partition w % 4, so
    at batch_tile 64 and Nm = 100 each of the four carries three pair
    pieces and one single piece.
    """
    mt = batch_tile // 16
    mw = min(mt, 2)
    n1 = -(-Nm // 8)
    pieces = [(p, m0, mw) for p in range(n1 // 2) for m0 in range(0, mt, mw)]
    return pieces + [(n1 // 2, m0, 1) for m0 in range(mt if n1 % 2 else 0)]


def launch_geometry(batch_tile: int, Nm: int, alpha: float = 1.0,
                    delta: bool = False) -> tuple[int, int]:
    """(threads, dynamic shared-memory bytes) of one block of
    `csrc/admm_u_only.cu`, the narrow route, which stages W_u whole.

    Raises ValueError when the tile cannot be launched: batch_tile must
    be 16, 32 or 64, the block's pieces must fit in 16 warps, and W_u
    with two copies of the tile's s (three with delta products, whose
    iteration reads s and s_prev; and, with over-relaxation, 16 floats
    of z a thread) must fit in shared memory.
    """
    if batch_tile not in _U_TILES:
        raise ValueError(f"batch_tile={batch_tile}: the u-only kernel takes "
                         f"{', '.join(map(str, _U_TILES[:-1]))} or {_U_TILES[-1]} instances a block")
    warps = len(u_only_pieces(batch_tile, Nm))
    if warps > _U_MAX_WARPS:
        fits = [tile for tile in _U_TILES if len(u_only_pieces(tile, Nm)) <= _U_MAX_WARPS]
        raise ValueError(
            f"batch_tile={batch_tile} at Nm={Nm} needs {warps} warps per block; the kernel "
            f"takes at most {_U_MAX_WARPS}, so batch_tile <= {max(fits, default=0)}"
        )
    n1 = -(-Nm // 8)
    smem = 4 * (64 * n1 * n1 + (3 if delta else 2) * 8 * batch_tile * n1 + 16 * n1
                + (16 * 32 * warps if alpha != 1.0 else 0))
    if smem > _MAX_SMEM:
        raise ValueError(
            f"Nm={Nm} with batch_tile={batch_tile} needs {smem} bytes of shared memory "
            f"to stage W_u and the tile's iterate; the limit is {_MAX_SMEM} bytes"
        )
    return 32 * warps, smem


def wide_pieces(batch_tile: int, Nm: int) -> list[tuple[int, ...]]:
    """Each warp's rows of W_u's pair table in `csrc/admm_u_only_wide.cu`,
    in warp order: warp w owns pairs p * w .. p * w + p - 1 (p = 2 at
    batch_tile 32, 4 at 16; the last warp fewer) of the 8-column n-tiles,
    for every m16 row tile of the block, over the whole k range. At Nm =
    512 and batch_tile 32 that is 32 pairs on 16 warps."""
    p = _WIDE_PAIRS[batch_tile]
    n_pairs = -(-Nm // 16)
    return [tuple(range(w, min(w + p, n_pairs))) for w in range(0, n_pairs, p)]


def wide_launch_geometry(batch_tile: int, Nm: int) -> tuple[int, int]:
    """(threads, dynamic shared-memory bytes) of one block of
    `csrc/admm_u_only_wide.cu`, the wide route, which streams W_u from L2.

    Raises ValueError when the tile cannot be launched: batch_tile must
    be 16 or 32, the block's warps (`wide_pieces`) at most 16, and two
    copies of the tile's s, its lambda and the bounds must fit in shared
    memory (Nm <= 512 at batch_tile 32, <= 1,024 at 16).
    """
    if batch_tile not in _WIDE_TILES:
        raise ValueError(f"batch_tile={batch_tile}: the wide u-only kernel takes "
                         f"{' or '.join(map(str, _WIDE_TILES))} instances a block")
    warps = len(wide_pieces(batch_tile, Nm))
    if warps > _U_MAX_WARPS:
        raise ValueError(
            f"batch_tile={batch_tile} at Nm={Nm} needs {warps} warps per block on the wide "
            f"route; it takes at most {_U_MAX_WARPS} (Nm <= {16 * _WIDE_PAIRS[batch_tile] * 16})"
        )
    n1 = -(-Nm // 8)
    smem = 4 * (2 * 8 * batch_tile * n1 + 16 * batch_tile * -(-n1 // 2) + 16 * n1)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"Nm={Nm} with batch_tile={batch_tile} needs {smem} bytes of shared memory on the "
            f"wide route; the limit is {_MAX_SMEM} bytes"
        )
    return 32 * warps, smem


def u_only_route(batch_tile: int, Nm: int, alpha: float = 1.0,
                 refresh_every: int = 1) -> str:
    """"narrow" when `csrc/admm_u_only.cu` takes the tile (W_u staged in
    shared memory), else "wide" when `csrc/admm_u_only_wide.cu` does;
    raises ValueError, with both kernels' reasons, when neither does."""
    try:
        launch_geometry(batch_tile, Nm, alpha, delta=refresh_every > 1)
        return "narrow"
    except ValueError as narrow:
        try:
            wide_launch_geometry(batch_tile, Nm)
            return "wide"
        except ValueError as wide:
            raise ValueError(f"no u-only kernel takes this launch: {narrow}; {wide}") from None


def default_u_tile(Nm: int, alpha: float = 1.0, refresh_every: int = 1) -> int:
    """The largest tile the narrow kernel takes at this width, else the
    largest the wide route takes (64 at the bench's Nm = 100, 32 at
    Nm = 512)."""
    routes = {}
    for tile in _U_TILES:
        try:
            routes[tile] = u_only_route(tile, Nm, alpha, refresh_every)
        except ValueError:
            pass
    if not routes:
        raise ValueError(f"no u-only kernel takes Nm={Nm}: the wide route's limit is Nm <= "
                         f"{16 * _WIDE_PAIRS[16] * 16}")
    return max((t for t, r in routes.items() if r == "narrow"), default=max(routes))


def _schedule(n_iters, refresh_every, polish_iters, stop_tol, check_every):
    """(chunk_len, n_chunks, n_tail): the iteration counts of one solve.

    The main phase runs up to n_chunks chunks of chunk_len iterations;
    with stop_tol > 0 a tile leaves it after any chunk whose max
    |u_hat - z| is below stop_tol. Then n_tail iterations always run.
    Mirrors the accounting of `_admm_kernel_u_only`, where an
    early-exit chunk is (check_every - 1) refresh blocks plus one polish
    iteration.
    """
    if n_iters < 0 or polish_iters < 0:
        raise ValueError("n_iters and polish_iters must be >= 0")
    if refresh_every < 1 or check_every < 1:
        raise ValueError("refresh_every and check_every must be >= 1")
    n_tail = min(polish_iters, n_iters)
    n_main = max(n_iters - n_tail, 0)
    if stop_tol > 0.0:
        chunk_len = (check_every - 1) * refresh_every + 1
        return chunk_len, -(-n_main // chunk_len), n_tail
    return -(-n_main // refresh_every) * refresh_every, 1, n_tail


def _check_inputs(u_base, x_base, W_u, W_x, lo, hi, batch_tile):
    named = dict(u_base=u_base, x_base=x_base, W_u=W_u, W_x=W_x, lo=lo, hi=hi)
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.device != u_base.device:
            raise ValueError(f"{name} is on {t.device} but u_base is on {u_base.device}")
        if t.dtype != u_base.dtype:
            raise TypeError(f"{name} is {t.dtype} but u_base is {u_base.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if u_base.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"admm_u_only takes float32 (or float64 on CPU), got {u_base.dtype}")
    if u_base.ndim != 2 or x_base.ndim != 2:
        raise ValueError("u_base and x_base must be (batch, Nm) and (batch, Nd)")
    batch, Nm = u_base.shape
    Nd = x_base.shape[1]
    expected = dict(x_base=(batch, Nd), W_u=(Nm, Nm), W_x=(Nm, Nd), lo=(Nm,), hi=(Nm,))
    for name, shape in expected.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(named[name].shape)}, expected {shape}")
    if batch_tile < 1 or batch % batch_tile:
        raise ValueError(f"batch {batch} must be a multiple of batch_tile {batch_tile}")


def admm_u_only_reference(
    u_base, x_base, W_u, W_x, lo, hi, *, n_iters, refresh_every=1, alpha=1.0,
    polish_iters=8, stop_tol=0.0, check_every=8, batch_tile=64, products="f32",
):
    """Plain torch version of the kernels, in f32 or f64, on any device.

    Works on (n_tiles, batch_tile, Nm) views so that early exit is per
    tile, as in the kernels: a tile that has exited keeps its iterates
    until the tail. Returns (x (B, Nd), u (B, Nm), z_u (B, Nm)).

    Each iteration takes u_hat = u_base + c with c ~ s @ W_u, s = z - l:
    with refresh_every = r > 1 the first iteration of each block of r
    sets c = s @ W_u and the r - 1 others update c += (s - s_prev) @ W_u
    (the delta product of `_admm_kernel_u_only`); the tail and, with
    stop_tol > 0, the last iteration of each chunk set c afresh. With r
    = 1 every iteration sets c.

    products: "f32" (full f32 matmuls) or "tf32x3", the kernels'
    schedule of tensor-core products (float32 only): `tf32x3_matmul` for
    the refreshes and for x, `tf32x1_matmul` (one TF32 pass) for the
    deltas, `tf32x6_matmul` in the tail and, with stop_tol > 0, in the
    last iteration of each chunk.
    """
    if products == "f32":
        main = six = one = torch.matmul
    elif products == "tf32x3":
        if u_base.dtype != torch.float32:
            raise TypeError(f'products="tf32x3" takes float32, got {u_base.dtype}')
        main, six, one = tf32x3_matmul, tf32x6_matmul, tf32x1_matmul
    else:
        raise ValueError(f'products must be "f32" or "tf32x3", got {products!r}')
    chunk_len, n_chunks, n_tail = _schedule(
        n_iters, refresh_every, polish_iters, stop_tol, check_every
    )
    batch, Nm = u_base.shape
    n_tiles = batch // batch_tile
    ub = u_base.reshape(n_tiles, batch_tile, Nm)
    one_minus_alpha = 1.0 - alpha

    def step(z, lam, s_prev, c, matmul):
        """One iteration; matmul None: the delta product onto c."""
        s = z - lam
        c = c + one(s - s_prev, W_u) if matmul is None else matmul(s, W_u)
        u = ub + c
        if alpha == 1.0:
            v = u + lam
            z_new = torch.minimum(torch.maximum(v, lo), hi)
            return z_new, v - z_new, s, c, u
        z_rel = alpha * u + one_minus_alpha * z
        z_new = torch.minimum(torch.maximum(z_rel + lam, lo), hi)
        return z_new, lam + u - z_new, s, c, u

    with full_f32_matmul():
        z, lam, s, c, u = ub, torch.zeros_like(ub), ub, torch.zeros_like(ub), ub
        active = None  # per-tile mask, once early exit has been tested
        for _ in range(n_chunks):
            for i in range(chunk_len):
                if stop_tol > 0.0 and i == chunk_len - 1:
                    matmul = six
                else:
                    matmul = None if i % refresh_every else main
                new = step(z, lam, s, c, matmul)
                if active is None:
                    z, lam, s, c, u = new
                else:
                    keep = active[:, None, None]
                    z, lam, s, c, u = (
                        torch.where(keep, a, b) for a, b in zip(new, (z, lam, s, c, u))
                    )
            if stop_tol > 0.0:
                running = torch.amax(torch.abs(u - z), dim=(1, 2)) >= stop_tol
                active = running if active is None else active & running
                if not bool(active.any()):
                    break
        for _ in range(n_tail):
            z, lam, s, c, u = step(z, lam, s, c, six)
        x = x_base.reshape(n_tiles, batch_tile, -1) + main(s, W_x)
    return x.reshape(batch, -1), u.reshape(batch, Nm), z.reshape(batch, Nm)


def pack_u_only_operators(W_u, W_x):
    """(ops_f, ops_i): W_u and W_x in `pair_pack` storage, end to end,
    and their pair tables, W_u's rows first (W_x's offsets count from the
    start of ops_f)."""
    (f1, t1), (f2, t2) = pair_pack(W_u), pair_pack(W_x)
    t2 = t2.clone()
    t2[:, 0] += f1.numel()
    return torch.cat([f1, f2]), torch.cat([t1, t2])


def admm_u_only(
    u_base, x_base, W_u, W_x, lo, hi, packed, *, n_iters, refresh_every=1, alpha=1.0,
    polish_iters=8, stop_tol=0.0, check_every=8, batch_tile=64,
):
    """Run the u-only ADMM loop on a fleet; returns (x, u, z_u).

    u_base (B, Nm), x_base (B, Nd): unconstrained iterates; W_u (Nm, Nm)
    and W_x (Nm, Nd): control and state responses to s = z - lambda;
    lo, hi (Nm,): the box; packed: (ops_f, ops_i) =
    `pack_u_only_operators(W_u, W_x)`, the same two operators in the
    kernel's storage (the solver packs them once, at setup). B must be a
    multiple of batch_tile.

    CUDA tensors (float32) go to a kernel that reads only the packed
    operators (`u_only_route` chooses it): `csrc/admm_u_only.cu`, which
    stages W_u in shared memory and takes batch_tile 16, 32 or 64 (see
    `launch_geometry`), else `csrc/admm_u_only_wide.cu`, which streams
    W_u from L2 and takes 16 or 32 (see `wide_launch_geometry`); a launch
    neither takes raises. Both run their products on the tensor cores
    (3xTF32 refreshes, one-pass TF32 deltas, 6xTF32 in the tail), held to
    `admm_u_only_reference(..., products="tf32x3")`. CPU tensors go to
    `admm_u_only_reference` with f32 products, which reads only the dense
    operators. Any other device raises.
    """
    global launch_count, wide_launch_count
    _check_inputs(u_base, x_base, W_u, W_x, lo, hi, batch_tile)
    Nm, Nd = W_x.shape
    _check_packed(packed, u_base, (-(-Nm // 16) + -(-Nd // 16), 4),
                  "pack_u_only_operators(W_u, W_x)", f"Nm={Nm}, Nd={Nd}")
    kw = dict(
        n_iters=n_iters, refresh_every=refresh_every, alpha=alpha,
        polish_iters=polish_iters, stop_tol=stop_tol, check_every=check_every,
        batch_tile=batch_tile,
    )
    device = u_base.device
    if device.type == "cpu":
        return admm_u_only_reference(u_base, x_base, W_u, W_x, lo, hi, **kw)
    if device.type != "cuda":
        raise ValueError(f"admm_u_only runs on CPU or CUDA tensors, got {device}")
    if u_base.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {u_base.dtype}")
    chunk_len, n_chunks, n_tail = _schedule(
        n_iters, refresh_every, polish_iters, stop_tol, check_every
    )
    batch = u_base.shape[0]
    route = u_only_route(batch_tile, Nm, alpha, refresh_every)

    from ilqr_admm_tpu_torch._build import load_library

    lib = load_library()
    ops_f, ops_i = packed
    x = torch.empty_like(x_base)
    u = torch.empty_like(u_base)
    z_u = torch.empty_like(u_base)
    launch = lib.admm_u_only_launch if route == "narrow" else lib.admm_u_only_wide_launch
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = launch(
            u_base.data_ptr(), x_base.data_ptr(), ops_f.data_ptr(), ops_i.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), x.data_ptr(), u.data_ptr(), z_u.data_ptr(),
            batch, Nm, Nd, batch_tile, chunk_len, n_chunks, n_tail, refresh_every,
            float(alpha), float(1.0 - alpha), float(stop_tol), stream,
        )
    if err != 0:
        msg = lib.admm_u_only_error_string(err).decode()
        raise RuntimeError(f"admm_u_only ({route}) kernel launch failed: {msg} (cudaError {err})")
    if route == "narrow":
        launch_count += 1
    else:
        wide_launch_count += 1
    return x, u, z_u


# ---- the state-bounded path: csrc/admm_box.cu, csrc/admm_box_wide.cu -----

# Number of times `admm_box` has launched each of its CUDA kernels in this
# process: csrc/admm_box.cu, and the wide route csrc/admm_box_wide.cu.
box_launch_count = 0
box_wide_launch_count = 0


# Kernel geometry, as in csrc/admm_box.cu: operators in 8 x 8 blocks; an
# m16n8k8 row tile is 16 instances; a warp takes up to two n-tiles at a
# time; at most 16 warps a block; kSched ints of schedule a warp.
_BOX_BLOCK = 8
_BOX_TILES = (16, 32)
_BOX_MAX_WARPS = 16
_BOX_SCHED = 16
_BOX_SLOTS = 2  # partial-sum slots besides the u_hat buffer


def pair_pack(W: torch.Tensor):
    """8 x 8 block storage of a (K, C) operator for `csrc/admm_box.cu`.

    W is zero-padded to multiples of 8 and cut into 8 x 8 (k, n) blocks;
    its 8-column n-tiles are taken in pairs (2p, 2p + 1), the last one
    alone when their count is odd. For each pair the k-tiles [klo, khi)
    are kept, the smallest range that holds every nonzero block of its
    columns (klo = khi = 0 when all are zero), so exact zeros outside it
    are skipped and no sum changes. For each kept k-tile, the nb = 1 or 2
    blocks are stored interleaved in the B-fragment order of a TF32
    `mma.m16n8k8`: lane 4 g + t holds, for each n-tile of the pair, its
    (k, n) entries (t, g) and (t + 4, g). Returns (packed, table): packed
    the pairs' blocks end to end, table (n_pairs, 4) int32 rows (offset
    of the first block in floats, klo, khi, nb).
    """
    K, C = W.shape
    nk, nn = -(-K // _BOX_BLOCK), -(-C // _BOX_BLOCK)
    Wp = torch.nn.functional.pad(W, (0, nn * _BOX_BLOCK - C, 0, nk * _BOX_BLOCK - K))
    # (n-tile, k-tile, g, t, h): entry (k, n) = (t + 4 h, g) of each block
    blocks = Wp.reshape(nk, 2, 4, nn, 8).permute(3, 0, 4, 2, 1)
    nz = (blocks != 0).flatten(2).any(dim=2)
    ks = torch.arange(nk, device=W.device)
    packed, rows, offset = [], [], 0
    for n0 in range(0, nn, 2):
        nb = min(2, nn - n0)
        used = ks[nz[n0:n0 + nb].any(dim=0)]
        klo, khi = (int(used[0]), int(used[-1]) + 1) if used.numel() else (0, 0)
        # (k-tile, g, t, n, h): lane 4 g + t reads 2 nb consecutive floats
        packed.append(blocks[n0:n0 + nb, klo:khi].permute(1, 2, 3, 0, 4).reshape(-1))
        rows.append((offset, klo, khi, nb))
        offset += packed[-1].numel()
    return torch.cat(packed), torch.tensor(rows, dtype=torch.int32, device=W.device)


def _single_parts(n_pairs: int) -> int:
    """Warps that share a last single n-tile of W_s: those left of the 16
    by the pairs' two each, two to four."""
    return max(2, min(2 + _BOX_SLOTS, _BOX_MAX_WARPS - 2 * n_pairs))


def _box_warps(n1: int, n2: int) -> int:
    """Warps of a block (`box_schedule`) for n1 and n2 8-column n-tiles."""
    parts = 2 * (n1 // 2) + (_single_parts(n1 // 2) if n1 % 2 else 0)
    return max(parts, -(-n2 // 2))


def box_schedule(table1, table2) -> torch.Tensor:
    """Each warp's work in `csrc/admm_box.cu`, from `pair_pack`'s tables
    of W_s (phase 1) and Su^T (phase 2, whose offsets count from the end
    of W_s's blocks).

    Phase 1: each pair of W_s's n-tiles is split by k into two halves,
    one warp each; the warp of the first half owns the pair's first
    n-tile (its u_hat, z_u, l_u columns) and hands its partial sum of the
    second to the other warp through the u_hat buffer, which owns the
    second and hands back its partial of the first. A last single n-tile
    is split over the warps left of the 16 (two to four): the first owns
    it, the second hands over through the u_hat buffer, the others
    through partial-sum slots. Phase 2: one warp a pair of Su^T's
    n-tiles. Warp w runs on sub-partition w % 4, so within each phase the
    pieces are dealt out longest first to the least loaded sub-partition
    that has a warp free. Returns (warps, 16) int32 rows, in the order
    the kernel reads them; nb = 0 for no work.
    """
    pairs = table1.tolist()
    parts = []  # (cost, phase-1 row)
    for p, (off, klo, khi, nb) in enumerate(pairs):
        q = 2 if nb == 2 else _single_parts(len(pairs) - 1)
        cuts = [klo + (khi - klo) * j // q for j in range(q + 1)]
        for j, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
            row = [off + (lo - klo) * 64 * nb, lo, hi, nb, 2 * p]
            if nb == 2:  # own tile j, hand the other over through u_hat
                row += [1 - j, -1, j, 1, 0, 0]
            elif j == 0:  # own the tile, add the u_hat partial and the slots
                row += [-1, -1, 0, 1, 0, q - 2]
            else:
                row += [0, j - 2, -1, 0, 0, 0]
            parts.append(((hi - lo) * nb, row))
    items = [((khi - klo) * nb, [off, klo, khi, nb, 2 * p])
             for p, (off, klo, khi, nb) in enumerate(table2.tolist())]
    n_warps = max(len(parts), len(items))

    def deal(pieces):
        """Piece index -> warp: longest first, to the least loaded
        sub-partition with a free warp."""
        free = [[w for w in range(n_warps) if w % 4 == r] for r in range(4)]
        load = [0] * 4
        where = {}
        for i in sorted(range(len(pieces)), key=lambda i: -pieces[i][0]):
            r = min((r for r in range(4) if free[r]), key=lambda r: (load[r], r))
            load[r] += pieces[i][0]
            where[i] = free[r].pop(0)
        return where

    idle = [0, 0, 0, 0, 0, -1, -1, -1, 0, 0, 0]
    sched = [idle + [0, 0, 0, 0, 0] for _ in range(n_warps)]
    for i, w in deal(parts).items():
        sched[w][:11] = parts[i][1]
    for i, w in deal(items).items():
        sched[w][11:] = items[i][1]
    return torch.tensor(sched, dtype=torch.int32, device=table1.device)


def pack_box_operators(W_s, SuT, route: str = "narrow", batch_tile: int | None = None):
    """The two operators in the storage of the route's kernel (see
    `box_route`).

    "narrow": (ops_f, ops_i), W_s and Su^T in `pair_pack` storage end to
    end (W_s's rows for s_x zero-padded to whole 8-row tiles first) and the
    kernel's warp schedule (`box_schedule`).

    "wide": a `BoxWidePacked` (ops_f, ops_i) with its `BoxWideLayout`:
    the columns ordered component by component (`box_components`), each
    warpgroup's M tiles of W_s^T and Su as TF32 wgmma A fragments in f32,
    its phase-1 tiles then its phase-2 tiles, each tile's nonzero k-steps
    only (`_fragments`), dealt to the warpgroups longest first; ops_i the
    header, tile table and k-steps the kernel reads, then each original
    column's padded position. With batch_tile, the one-component layout
    when the components' do not fit that tile
    (`box_wide_launch_geometry`).
    """
    if route == "narrow":
        ops_f, t1, t2 = _pack_box_pairs(W_s, SuT)
        return ops_f, box_schedule(t1, t2)
    if route != "wide":
        raise ValueError(f'route must be "narrow" or "wide", got {route!r}')
    ops_f, ops_i, layout = _pack_box_wide(W_s, SuT)
    if batch_tile is not None and not layout.identity:
        try:
            box_wide_launch_geometry(batch_tile, *SuT.shape, layout)
        except ValueError:
            ops_f, ops_i, layout = _pack_box_wide(W_s, SuT, components=False)
    return BoxWidePacked(ops_f, ops_i, layout)


def _pack_box_pairs(W_s, SuT):
    """(ops_f, W_s's pair table, Su^T's) of `pack_box_operators`."""
    Nm, Nd = SuT.shape
    gap = -Nd % _BOX_BLOCK
    W_s = torch.cat([W_s[:Nd], W_s.new_zeros(gap, Nm), W_s[Nd:]])
    (f1, t1), (f2, t2) = pair_pack(W_s), pair_pack(SuT)
    t2 = t2.clone()
    t2[:, 0] += f1.numel()
    return torch.cat([f1, f2]), t1, t2


def box_launch_geometry(batch_tile: int, Nm: int, Nd: int, n_blocks: int) -> tuple[int, int]:
    """(threads, dynamic shared-memory bytes) of one `admm_box` block.

    As in csrc/admm_box.cu: a block owns batch_tile = 16 or 32 instances
    (one or two m16n8k8 row tiles) and has the warps of `box_schedule`,
    at most 16; it stages the packed operators (n_blocks 8 x 8 blocks of
    `pair_pack`), the s and u_hat tiles, the bounds, two partial-sum
    slots and the schedule in shared memory. Raises ValueError when the tile cannot be
    launched.
    """
    if batch_tile not in _BOX_TILES:
        raise ValueError(f"batch_tile={batch_tile}: the state-bounded kernel takes "
                         f"{' or '.join(map(str, _BOX_TILES))} instances a block")
    n1, n2 = -(-Nm // _BOX_BLOCK), -(-Nd // _BOX_BLOCK)
    warps = _box_warps(n1, n2)
    if warps > _BOX_MAX_WARPS:
        raise ValueError(
            f"Nm={Nm}, Nd={Nd} needs {warps} warps per block; the kernel takes at most "
            f"{_BOX_MAX_WARPS} (Nm <= {_BOX_BLOCK * _BOX_MAX_WARPS}, "
            f"Nd <= {2 * _BOX_BLOCK * _BOX_MAX_WARPS})"
        )
    smem = 4 * (64 * n_blocks + 8 * batch_tile * (2 * n1 + n2 + _BOX_SLOTS) + 16 * (n1 + n2)
                + _BOX_SCHED * warps)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"Nm={Nm}, Nd={Nd} with batch_tile={batch_tile} needs {smem} bytes of shared memory "
            f"({256 * n_blocks} of them packed operators); the limit is {_MAX_SMEM} bytes"
        )
    return 32 * warps, smem


# The wide route, csrc/admm_box_wide.cu: 4 warpgroups a block; the
# operators' transposes as wgmma A fragments in 64-row M tiles, each
# warpgroup streaming its own tiles' fragments from L2 through a ring of
# _BOX_WIDE_STAGES k-steps in shared memory; the instances as N (8, 16 or
# 32 a block). Each tile keeps only its nonzero 8-column k-steps, stored in
# multiples of _BOX_WIDE_QUANTUM (the kernel's commit group; zero fragments
# pad); a warpgroup owns at most 32 / batch_tile phase-1 tiles (their l_u
# and u_hat in registers).
_BOX_WIDE_GROUPS = 4
_BOX_WIDE_TILES = (8, 16, 32)
_BOX_WIDE_M = 64
_BOX_WIDE_QUANTUM = 2
_BOX_WIDE_STAGES = 4
_BOX_WIDE_HEADER = 32
_BOX_WIDE_LIMITS = (512, 1024)  # (Nm, Nd) the route takes at most
# k-steps a wide product chains on the tensor cores before it adds the
# chunk to its f32 total (the kernel's KC)
BOX_WIDE_K_CHUNK = 8


@dataclass(frozen=True)
class BoxWideLayout:
    """Where `csrc/admm_box_wide.cu` keeps a fleet's columns and work.

    The u and x columns are ordered component by component (`box_components`),
    each component's padded to a multiple of 8: the U space (nu columns)
    and the X space (nx). gather_u[c] / gather_x[c] is the original column
    at padded position c, -1 for padding; M tiles are 64 rows of one
    component's columns (its last tile shorter: `rows`, a multiple of 8).
    Phase-1 tiles (u rows) multiply s = [s_x, s_u] over K = [X, U]; phase-2
    tiles (x rows) multiply u_hat over U. `tiles` lists, warpgroup by
    warpgroup, its phase-1 then its phase-2 tiles as (col0, rows, steps):
    col0 the tile's first column in its space, steps its stored k-steps.
    `ksteps` are
    the tiles' k-steps (absolute 8-column groups of [X, U]) in the same
    order. `groups` holds, for each warpgroup, (phase-1 tiles, phase-2
    tiles, first tile, stream steps, first step, stream step of phase 2).
    identity: the original order, each space padded at its end (one
    component).
    """

    Nm: int
    Nd: int
    nx: int
    nu: int
    gather_x: tuple
    gather_u: tuple
    tiles: tuple
    ksteps: tuple
    groups: tuple
    identity: bool

    @property
    def n_tiles(self) -> int:
        return len(self.tiles)

    @property
    def n_steps(self) -> int:
        return len(self.ksteps)

    @property
    def max_u_tiles(self) -> int:
        """The most phase-1 tiles one warpgroup owns."""
        return max(g[0] for g in self.groups)

    @property
    def ints(self) -> int:
        """Length of ops_i: header, tile table, k-steps, then the padded
        position of each original x and u column."""
        return _BOX_WIDE_HEADER + 3 * self.n_tiles + self.n_steps + self.Nd + self.Nm

    @property
    def positions(self) -> int:
        """Offset of the positions (x's, then u's) in ops_i."""
        return self.ints - self.Nd - self.Nm


class BoxWidePacked(tuple):
    """(ops_f, ops_i) of `pack_box_operators(W_s, SuT, "wide")`, carrying
    its `BoxWideLayout` as `layout` (host numbers: the wrapper sizes the
    launch from it without reading the card)."""

    def __new__(cls, ops_f, ops_i, layout: BoxWideLayout):
        self = super().__new__(cls, (ops_f, ops_i))
        self.layout = layout
        return self


def _pad8(n: int) -> int:
    return -(-n // _BOX_BLOCK) * _BOX_BLOCK


def box_components(W_s, SuT) -> list[tuple[list[int], list[int]]]:
    """The groups of columns the wide kernel keeps together: [(u columns,
    x columns)] in original numbering.

    The connected components of the graph whose edges are W_s's and
    Su^T's nonzeros (W_s[k, j] joins u_j with x_k, or with u_{k - Nd} for
    k >= Nd; Su^T[j, i] joins u_j with x_i; a column that touches no
    nonzero is a component of its own), largest first, each merged into
    the first group whose 64-column M tiles still hold it (its u columns
    and its x columns each within the group's count of whole tiles), else
    a group of its own: merging never adds a tile. The planar double
    integrator gives two groups (its axes), the 1-D one a single one."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    Nm, Nd = SuT.shape
    n = Nm + Nd  # nodes: u_0..u_{Nm-1}, then x_0..x_{Nd-1}
    k, j = (W_s != 0).nonzero(as_tuple=True)
    uj, xi = (SuT != 0).nonzero(as_tuple=True)
    a = torch.cat([torch.where(k < Nd, Nm + k, k - Nd), uj]).cpu().numpy()
    b = torch.cat([j, Nm + xi]).cpu().numpy()
    _, label = connected_components(coo_matrix(([1] * len(a), (a, b)), shape=(n, n)),
                                    directed=False)
    comps = {}
    for node in range(n):
        comps.setdefault(int(label[node]), []).append(node)
    def tiles(c):
        return -(-c // _BOX_WIDE_M)

    groups = []
    for nodes in sorted(comps.values(), key=lambda nodes: (-len(nodes), nodes[0])):
        us, xs = [v for v in nodes if v < Nm], [v - Nm for v in nodes if v >= Nm]
        for gu, gx in groups:
            if (tiles(len(gu) + len(us)) <= max(tiles(len(gu)), 1)
                    and tiles(len(gx) + len(xs)) <= max(tiles(len(gx)), 1)):
                gu += us
                gx += xs
                break
        else:
            groups.append((us, xs))
    return groups


def _deal(costs: list[int], cap: int | None) -> list[list[int]]:
    """Tile indices for each warpgroup: longest first to the least loaded
    warpgroup with fewer than cap tiles (ties: the lowest)."""
    load = [0] * _BOX_WIDE_GROUPS
    owned = [[] for _ in range(_BOX_WIDE_GROUPS)]
    for i in sorted(range(len(costs)), key=lambda i: (-costs[i], i)):
        w = min((w for w in range(_BOX_WIDE_GROUPS) if cap is None or len(owned[w]) < cap),
                key=lambda w: (load[w], w))
        load[w] += costs[i]
        owned[w].append(i)
    return owned


def _fragments(block: torch.Tensor) -> torch.Tensor:
    """(64, 8) blocks (..., M rows, K columns) in the A-fragment order of a
    TF32 `wgmma.m64nNk8`: thread 32 w + 4 g + t of the warpgroup holds
    (16 w + g, t), (16 w + g + 8, t), (16 w + g, t + 4), (16 w + g + 8,
    t + 4), 16 bytes a thread."""
    lead = block.shape[:-2]
    b = block.reshape(*lead, 4, 2, 8, 2, 4)  # w, h, g, q, t: row 16 w + 8 h + g, column 4 q + t
    n = len(lead)
    return b.permute(*range(n), n, n + 2, n + 4, n + 3, n + 1).reshape(*lead, 512)


def _box_wide_spaces(W_s, SuT, components: bool):
    """(gather_u, gather_x, [(u start, u width), ...], [(x start, x width),
    ...]) of the padded spaces; one component, in the original order, if
    components is False or the operators couple everything."""
    Nm, Nd = SuT.shape
    comps = box_components(W_s, SuT) if components else []
    if len(comps) <= 1:
        comps = [(list(range(Nm)), list(range(Nd)))]
    gu, gx, cu, cx = [], [], [], []
    for us, xs in comps:
        cu.append((len(gu), _pad8(len(us))))
        cx.append((len(gx), _pad8(len(xs))))
        gu += us + [-1] * (_pad8(len(us)) - len(us))
        gx += xs + [-1] * (_pad8(len(xs)) - len(xs))
    return gu, gx, cu, cx, len(comps) == 1


def _permuted(M, rows, cols):
    """M[rows][:, cols] with -1 selecting a zero row or column."""
    Mp = torch.nn.functional.pad(M, (0, 1, 0, 1))
    r = torch.tensor(rows, dtype=torch.long, device=M.device) % Mp.shape[0]
    c = torch.tensor(cols, dtype=torch.long, device=M.device) % Mp.shape[1]
    return Mp[r][:, c]


def _pack_box_wide(W_s, SuT, components: bool = True):
    """(ops_f, ops_i, layout) of the wide route: see `pack_box_operators`."""
    Nm, Nd = SuT.shape
    gu, gx, cu, cx, identity = _box_wide_spaces(W_s, SuT, components)
    nx, nu = len(gx), len(gu)
    # A of phase 1 (nu x (nx + nu)): W_s^T with s = [s_x, s_u] over [X, U];
    # of phase 2 (nx x nu): Su
    A1 = _permuted(W_s, gx + [Nd + u if u >= 0 else -1 for u in gu], gu).T
    A2 = _permuted(SuT, gu, gx).T
    tiles, frags, steps = [[], []], [[], []], [[], []]
    for phase, (A, spans, k0) in enumerate(((A1, cu, 0), (A2, cx, nx // 8))):
        K = A.shape[1]
        for start, width in spans:
            for r0 in range(0, width, _BOX_WIDE_M):
                rows = min(_BOX_WIDE_M, width - r0)
                block = A.new_zeros(_BOX_WIDE_M, K)
                block[:rows] = A[start + r0:start + r0 + rows]
                blocks = block.reshape(_BOX_WIDE_M, K // 8, 8).permute(1, 0, 2)
                keep = (blocks != 0).flatten(1).any(dim=1).nonzero().flatten().tolist()
                pad = -len(keep) % _BOX_WIDE_QUANTUM
                ks = keep + [keep[-1]] * pad if keep else []
                f = _fragments(blocks[keep]) if keep else block.new_zeros(0, 512)
                frags[phase].append(torch.cat([f, f.new_zeros(pad, 512)]))
                steps[phase].append([k0 + k for k in ks])
                tiles[phase].append((start + r0, rows, len(ks)))
    owned = [_deal([t[2] for t in tiles[0]], -(-len(tiles[0]) // _BOX_WIDE_GROUPS)),
             _deal([t[2] for t in tiles[1]], None)]
    table, ksteps, stream, groups = [], [], [], []
    for w in range(_BOX_WIDE_GROUPS):
        first_tile, first_step, p2 = len(table), len(ksteps), 0
        for phase in (0, 1):
            if phase == 1:
                p2 = len(ksteps) - first_step
            for i in owned[phase][w]:
                table.append(tiles[phase][i])
                ksteps += steps[phase][i]
                stream.append(frags[phase][i])
        groups.append((len(owned[0][w]), len(owned[1][w]), first_tile,
                       len(ksteps) - first_step, first_step, p2))
    layout = BoxWideLayout(Nm, Nd, nx, nu, tuple(gx), tuple(gu), tuple(table), tuple(ksteps),
                           tuple(groups), identity)
    pos_x, pos_u = [0] * Nd, [0] * Nm
    for c, x in enumerate(gx):
        if x >= 0:
            pos_x[x] = c
    for c, u in enumerate(gu):
        if u >= 0:
            pos_u[u] = c
    header = [nx, nu, layout.n_tiles, layout.n_steps]
    header += [v for i in range(6) for v in (g[i] for g in groups)]
    header += [0] * (_BOX_WIDE_HEADER - len(header))
    ints = header + [v for row in table for v in row] + ksteps + pos_x + pos_u
    ops_f = torch.cat(stream) if stream else W_s.new_zeros(0, 512)
    return (ops_f.reshape(-1).contiguous(),
            torch.tensor(ints, dtype=torch.int32, device=W_s.device), layout)


def _identity_dims(Nm: int, Nd: int) -> dict:
    """The widths of the one-group layout of (Nm, Nd) with every k-step
    kept: no layout of that width needs less shared memory but for its
    k-steps, which this counts at their most."""
    nx, nu = _pad8(Nd), _pad8(Nm)
    q = _BOX_WIDE_QUANTUM
    n_u, n_x = -(-nu // _BOX_WIDE_M), -(-nx // _BOX_WIDE_M)
    return dict(nx=nx, nu=nu, n_tiles=n_u + n_x,
                n_steps=n_u * -(-(nx + nu) // 8 // q) * q + n_x * -(-nu // 8 // q) * q,
                max_u_tiles=-(-n_u // _BOX_WIDE_GROUPS))


def box_wide_smem(batch_tile: int, nx: int, nu: int, n_tiles: int, n_steps: int) -> int:
    """Dynamic shared-memory bytes of one block of csrc/admm_box_wide.cu:
    s = [s_x, s_u] (u_hat takes s_u's place during phase 2) as TF32 hi and
    lo, each warpgroup's ring of A fragments, the bounds, the tile table
    and the k-steps."""
    T = batch_tile
    ring = 2048 * _BOX_WIDE_STAGES * _BOX_WIDE_GROUPS
    return ring + 4 * (2 * T * (nx + nu) + 2 * (nx + nu) + 3 * n_tiles + n_steps)


def box_wide_launch_geometry(batch_tile: int, Nm: int, Nd: int,
                             layout: BoxWideLayout | None = None) -> tuple[int, int]:
    """(threads, dynamic shared-memory bytes) of one block of
    `csrc/admm_box_wide.cu`, the wide route, which streams its operators
    from L2, for `layout` (None: the one-component layout of (Nm, Nd),
    every k-step kept).

    Raises ValueError when the tile cannot be launched: batch_tile must be
    8, 16 or 32, Nm <= 512 and Nd <= 1,024, a warpgroup may own at most
    32 / batch_tile phase-1 tiles, and shared memory (`box_wide_smem`)
    must fit: 196,448 B for the planar fleet's two components at
    batch_tile 32; the route's edge (Nm = 512, Nd = 1,024) takes 8.
    """
    if batch_tile not in _BOX_WIDE_TILES:
        raise ValueError(f"batch_tile={batch_tile}: the wide state-bounded kernel takes "
                         f"{', '.join(map(str, _BOX_WIDE_TILES))} instances a block")
    max_m, max_d = _BOX_WIDE_LIMITS
    if Nm > max_m or Nd > max_d:
        raise ValueError(f"Nm={Nm}, Nd={Nd} is past the wide route's Nm <= {max_m}, "
                         f"Nd <= {max_d}")
    if layout is None:
        dims = _identity_dims(Nm, Nd)
    else:
        if (layout.Nm, layout.Nd) != (Nm, Nd):
            raise ValueError(f"the layout is for Nm={layout.Nm}, Nd={layout.Nd}, not Nm={Nm}, "
                             f"Nd={Nd}")
        dims = dict(nx=layout.nx, nu=layout.nu, n_tiles=layout.n_tiles,
                    n_steps=layout.n_steps, max_u_tiles=layout.max_u_tiles)
    cap = 32 // batch_tile
    if dims["max_u_tiles"] > cap:
        raise ValueError(
            f"Nm={Nm}, Nd={Nd} with batch_tile={batch_tile} puts {dims['max_u_tiles']} tiles of "
            f"u columns on a warpgroup; the kernel takes at most {cap} at this tile")
    smem = box_wide_smem(batch_tile, dims["nx"], dims["nu"], dims["n_tiles"], dims["n_steps"])
    if smem > _MAX_SMEM:
        raise ValueError(
            f"Nm={Nm}, Nd={Nd} with batch_tile={batch_tile} needs {smem} bytes of shared memory "
            f"on the wide route; the limit is {_MAX_SMEM} bytes"
        )
    return 128 * _BOX_WIDE_GROUPS, smem


def box_route(batch_tile: int, Nm: int, Nd: int, n_blocks: int) -> str:
    """"narrow" when `csrc/admm_box.cu` takes the tile (its packed
    operators, n_blocks 8 x 8 blocks of `pack_box_operators`, staged in
    shared memory), else "wide" when `csrc/admm_box_wide.cu` does
    (operators streamed from L2; `box_wide_launch_geometry` of the
    one-component layout, which no layout needs less shared memory than
    but for its k-steps); raises ValueError, with both kernels' reasons and
    limits, when neither does. Every launch the narrow kernel took before
    the wide route existed stays with it."""
    try:
        box_launch_geometry(batch_tile, Nm, Nd, n_blocks)
        return "narrow"
    except ValueError as narrow:
        try:
            box_wide_launch_geometry(batch_tile, Nm, Nd)
            return "wide"
        except ValueError as wide:
            raise ValueError(
                f"no state-bounded kernel takes this launch: the narrow kernel (csrc/admm_box.cu, "
                f"Nm <= {_BOX_BLOCK * _BOX_MAX_WARPS}, Nd <= {2 * _BOX_BLOCK * _BOX_MAX_WARPS}, "
                f"operators in shared memory): {narrow}; the wide kernel "
                f"(csrc/admm_box_wide.cu, Nm <= {_BOX_WIDE_LIMITS[0]}, Nd <= "
                f"{_BOX_WIDE_LIMITS[1]}): {wide}"
            ) from None


def default_box_tile(Nm: int, Nd: int, n_blocks: int) -> int:
    """The largest tile (32 or 16) the narrow kernel takes at this width
    (32 at the 1-D fleet's Nm = 100), else the largest (32, 16 or 8) the
    wide route takes (32 at the planar fleet's Nm = 200, Nd = 400; 8 at
    its edge, Nm = 512, Nd = 1,024); raises ValueError when neither takes
    any."""
    routes = {}
    for tile in sorted({*_BOX_TILES, *_BOX_WIDE_TILES}):
        try:
            routes[tile] = box_route(tile, Nm, Nd, n_blocks)
        except ValueError as exc:
            reason = exc
    if not routes:
        raise reason
    return max((t for t, r in routes.items() if r == "narrow"), default=max(routes))


def _check_box_inputs(free, u_base, u0, W_s, SuT, xb, ub, n_iters, batch_tile):
    named = dict(free=free, u_base=u_base, u0=u0, W_s=W_s, SuT=SuT, xb=xb, ub=ub)
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.device != free.device:
            raise ValueError(f"{name} is on {t.device} but free is on {free.device}")
        if t.dtype != free.dtype:
            raise TypeError(f"{name} is {t.dtype} but free is {free.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if free.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"admm_box takes float32 (or float64 on CPU), got {free.dtype}")
    if free.ndim != 2 or u_base.ndim != 2:
        raise ValueError("free and u_base must be (batch, Nd) and (batch, Nm)")
    (batch, Nd), Nm = free.shape, u_base.shape[1]
    expected = dict(u_base=(batch, Nm), u0=(batch, Nm), W_s=(Nd + Nm, Nm), SuT=(Nm, Nd),
                    xb=(2, Nd), ub=(2, Nm))
    for name, shape in expected.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(named[name].shape)}, expected {shape}")
    if batch_tile < 1 or batch % batch_tile:
        raise ValueError(f"batch {batch} must be a multiple of batch_tile {batch_tile}")
    if n_iters < 0:
        raise ValueError("n_iters must be >= 0")


def _box_update(v_hat, z, lam, bounds, alpha):
    """Over-relaxed clip and scaled dual update of one block."""
    z_rel = v_hat if alpha == 1.0 else alpha * v_hat + (1.0 - alpha) * z
    z_new = torch.minimum(torch.maximum(z_rel + lam, bounds[0]), bounds[1])
    return z_new, lam + v_hat - z_new


def admm_box_reference(
    free, u_base, u0, W_s, SuT, xb, ub, *, n_iters, alpha=1.0, has_u=True, batch_tile=32,
    products="f32",
):
    """Plain torch version of the kernel, in f32 or f64, on any device.

    From (z_x, z_u, l_x, l_u) = (free + u0 Su^T, u0, 0, 0), each iteration
    is
        u_hat = u_base + [z_x - l_x, z_u - l_u] W_s
        x_hat = free + u_hat Su^T
    then the clip and dual update of the x block and, with has_u, of the
    u block. This is `_admm_kernel`'s iteration with l_inv folded into
    the operators: u_base = r_base l_inv^T and W_s = [(l_inv Su^T Qr)^T;
    (l_inv Rr)^T], whose last Nm rows are zero without control bounds.
    Returns (x_hat, u_hat, z_x, z_u) of the last iteration ((z_x, z_u)
    after none). batch_tile does not change the result.

    products: "f32" (full f32 matmuls, the version the kernel is held
    to) or "tf32x3" (each product as the kernel's tensor cores take it,
    `tf32x3_matmul`; float32 only), which separates the kernel's split
    from its order of summation.
    """
    if products == "f32":
        matmul = torch.matmul
    elif products == "tf32x3":
        if free.dtype != torch.float32:
            raise TypeError(f'products="tf32x3" takes float32, got {free.dtype}')
        matmul = tf32x3_matmul
    else:
        raise ValueError(f'products must be "f32" or "tf32x3", got {products!r}')
    with full_f32_matmul():
        z_u = u0
        z_x = free + matmul(u0, SuT)
        l_x, l_u = torch.zeros_like(z_x), torch.zeros_like(z_u)
        x, u = z_x, z_u
        for _ in range(n_iters):
            u = u_base + matmul(torch.cat([z_x - l_x, z_u - l_u], dim=1), W_s)
            x = free + matmul(u, SuT)
            z_x, l_x = _box_update(x, z_x, l_x, xb, alpha)
            if has_u:
                z_u, l_u = _box_update(u, z_u, l_u, ub, alpha)
    return x, u, z_x, z_u


def _check_packed(packed, ref, ints_shape, origin, shapes):
    """packed: the pair (ops_f, ops_i) of `origin`, on ref's device, in
    (ref's dtype, int32), ops_i of ints_shape; shapes names the operators'
    shapes in the message."""
    if not (isinstance(packed, tuple) and len(packed) == 2
            and all(isinstance(t, torch.Tensor) for t in packed)):
        raise TypeError(f"packed must be the pair (ops_f, ops_i) of {origin}")
    ops_f, ops_i = packed
    if ops_f.device != ref.device or ops_i.device != ref.device:
        raise ValueError(f"packed is on {ops_f.device}/{ops_i.device} but the iterates are on "
                         f"{ref.device}")
    if ops_f.dtype != ref.dtype or ops_i.dtype != torch.int32:
        raise TypeError(f"packed must be ({ref.dtype}, torch.int32), got "
                        f"({ops_f.dtype}, {ops_i.dtype})")
    if ops_f.ndim != 1 or ops_f.numel() % 64 or tuple(ops_i.shape) != ints_shape:
        raise ValueError(f"packed does not have the shapes of {origin} at {shapes}")
    if not (ops_f.is_contiguous() and ops_i.is_contiguous()):
        raise ValueError("packed must be contiguous")


def _check_wide_packed(packed, ref, Nm: int, Nd: int):
    """packed: a `BoxWidePacked` of `pack_box_operators(W_s, SuT, "wide")`
    at (Nm, Nd), on ref's device, whole."""
    origin = "pack_box_operators(W_s, SuT, 'wide')"
    shapes = f"Nm={Nm}, Nd={Nd}"
    layout = getattr(packed, "layout", None)
    if not isinstance(layout, BoxWideLayout) or (layout.Nm, layout.Nd) != (Nm, Nd):
        raise ValueError(f"packed does not have the shapes of {origin} at {shapes} (no layout "
                         f"of this width)")
    _check_packed(packed, ref, (layout.ints,), origin, shapes)
    if packed[0].numel() != 512 * layout.n_steps:
        raise ValueError(f"packed does not have the shapes of {origin} at {shapes}")


def admm_box(
    free, u_base, u0, W_s, SuT, xb, ub, packed, *, n_iters, alpha=1.0, has_u=True,
    batch_tile=32, route="narrow",
):
    """Run the state-and-control box ADMM loop on a fleet; returns
    (x_hat, u_hat, z_x, z_u).

    free (B, Nd): free responses; u_base (B, Nm): r_base l_inv^T; u0
    (B, Nm): the warm start; W_s (Nd + Nm, Nm): the response of u_hat to
    [z_x - l_x, z_u - l_u]; SuT (Nm, Nd); xb (2, Nd) and ub (2, Nm):
    [lower; upper] bounds, +-inf where free; packed: the same two
    operators in the kernel's storage (the solver packs them once, at
    setup). B must be a multiple of batch_tile. See `admm_box_reference`
    for the iteration.

    route names the kernel (`box_route` chooses it; the solver holds its
    factory's choice as `route`), and packed must be in its form
    (`pack_box_operators(W_s, SuT, route)`). CUDA tensors (float32) go to
    that kernel, which reads only the packed operators: "narrow" is
    `csrc/admm_box.cu`, which stages them in shared memory (see
    `box_launch_geometry`; batch_tile 16 or 32), "wide" is
    `csrc/admm_box_wide.cu`, which streams them from L2 (see
    `box_wide_launch_geometry`; batch_tile 8, 16 or 32): its inputs are
    spread to the layout's padded column order and its outputs gathered
    back, unless the layout is the original order. A launch the route's
    kernel does not take raises. Both run their products on the tensor
    cores in 3xTF32, held to the f32 plain version. CPU tensors go to
    `admm_box_reference` with f32 products, which reads only the dense
    operators. Any other device raises.
    """
    global box_launch_count, box_wide_launch_count
    _check_box_inputs(free, u_base, u0, W_s, SuT, xb, ub, n_iters, batch_tile)
    batch, Nd = free.shape
    Nm = u_base.shape[1]
    if route == "narrow":
        n1, n2 = -(-Nm // _BOX_BLOCK), -(-Nd // _BOX_BLOCK)
        _check_packed(packed, free, (_box_warps(n1, n2), _BOX_SCHED),
                      "pack_box_operators(W_s, SuT, 'narrow')", f"Nm={Nm}, Nd={Nd}")
    elif route == "wide":
        _check_wide_packed(packed, free, Nm, Nd)
    else:
        raise ValueError(f'route must be "narrow" or "wide", got {route!r}')
    kw = dict(n_iters=n_iters, alpha=alpha, has_u=has_u, batch_tile=batch_tile)
    device = free.device
    if device.type == "cpu":
        return admm_box_reference(free, u_base, u0, W_s, SuT, xb, ub, **kw)
    if device.type != "cuda":
        raise ValueError(f"admm_box runs on CPU or CUDA tensors, got {device}")
    if free.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {free.dtype}")
    ops_f, ops_i = packed
    if route == "narrow":
        box_launch_geometry(batch_tile, Nm, Nd, ops_f.numel() // 64)
    else:
        box_wide_launch_geometry(batch_tile, Nm, Nd, packed.layout)

    from ilqr_admm_tpu_torch._build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if route == "narrow":
            x, z_x = torch.empty_like(free), torch.empty_like(free)
            u, z_u = torch.empty_like(u0), torch.empty_like(u0)
            err = lib.admm_box_launch(
                free.data_ptr(), u_base.data_ptr(), u0.data_ptr(), ops_f.data_ptr(),
                ops_f.numel(), ops_i.data_ptr(), ops_i.shape[0], xb.data_ptr(), ub.data_ptr(),
                x.data_ptr(), u.data_ptr(), z_x.data_ptr(), z_u.data_ptr(),
                batch, Nm, Nd, batch_tile, n_iters, int(has_u),
                float(alpha), float(1.0 - alpha), stream,
            )
        else:
            layout = packed.layout
            nx, nu = layout.nx, layout.nu
            in_order = layout.identity and (nx, nu) == (Nd, Nm)
            if not in_order:
                pos = ops_i[layout.positions:].long()
                pos_x, pos_u = pos[:Nd], pos[Nd:]

                def widen(t, width, p):
                    out = t.new_zeros(t.shape[0], width)
                    return out.index_copy_(1, p, t)

                free, xb = widen(free, nx, pos_x), widen(xb, nx, pos_x)
                u_base, u0 = widen(u_base, nu, pos_u), widen(u0, nu, pos_u)
                ub = widen(ub, nu, pos_u)
            x, z_x = free.new_empty(batch, nx), free.new_empty(batch, nx)
            u, z_u = free.new_empty(batch, nu), free.new_empty(batch, nu)
            err = lib.admm_box_wide_launch(
                free.data_ptr(), u_base.data_ptr(), u0.data_ptr(), ops_f.data_ptr(),
                ops_i.data_ptr(), xb.data_ptr(), ub.data_ptr(),
                x.data_ptr(), u.data_ptr(), z_x.data_ptr(), z_u.data_ptr(),
                batch, nx, nu, layout.n_tiles, layout.n_steps, batch_tile, n_iters, int(has_u),
                float(alpha), float(1.0 - alpha), stream,
            )
            if err == 0 and not in_order:
                x, z_x = x.index_select(1, pos_x), z_x.index_select(1, pos_x)
                u, z_u = u.index_select(1, pos_u), z_u.index_select(1, pos_u)
    if err != 0:
        msg = lib.admm_box_error_string(err).decode()
        raise RuntimeError(f"admm_box ({route}) kernel launch failed: {msg} (cudaError {err})")
    if route == "narrow":
        box_launch_count += 1
    else:
        box_wide_launch_count += 1
    return x, u, z_x, z_u


class FusedLQTADMM(nn.Module):
    """Batched solver for one box-constrained LQT problem.

    Holds the one-time operators as buffers; `forward(x0s)` returns
    (x, u, z_x, z_u) like the JAX `solve`, with z_x = x on this path.
    """

    def __init__(self, operators: dict, **kernel_options):
        super().__init__()
        for name, value in operators.items():
            self.register_buffer(name, value)
        self.kernel_options = kernel_options

    def bases(self, x0s):
        """(u_base, x_base): the unconstrained iterates the kernel starts from."""
        x0s = torch.as_tensor(x0s).to(self.W_u.device, self.W_u.dtype)
        if x0s.shape[0] % self.kernel_options["batch_tile"]:
            raise ValueError("batch must be a multiple of batch_tile")
        with full_f32_matmul():
            free = x0s @ self.Sx.T
            r_base = self.r_const[None] - free @ self.SuTQ.T
            u_base = r_base @ self.l_inv.T
            x_base = free + u_base @ self.Su.T
        return u_base, x_base

    @property
    def packed(self):
        """(ops_f, ops_i): the loop's operators in the kernel's storage."""
        return self.ops_f, self.ops_i

    def kernel_inputs(self, x0s):
        """`admm_u_only_reference`'s positional arguments for a batch of
        initial states (`admm_u_only` takes `packed` after them)."""
        return (*self.bases(x0s), self.W_u, self.W_x, self.lo, self.hi)

    def forward(self, x0s):
        x, u, z_u = admm_u_only(*self.kernel_inputs(x0s), self.packed, **self.kernel_options)
        return x, u, x, z_u


class FusedBoxLQTADMM(FusedLQTADMM):
    """The state-bounded solver: `forward(x0s)` returns (x, u, z_x, z_u)
    like the JAX `solve`, through `admm_box`. `route` is the kernel the
    factory chose ("narrow" or "wide", `box_route`), and `packed` is in
    its form (on the wide route with its `BoxWideLayout`, `layout`). A
    fleet that no kernel takes is built only for the CPU: its route is
    None, it holds no packed operators, and `forward` runs
    `admm_box_reference`."""

    def __init__(self, operators: dict, route: str | None, layout: BoxWideLayout | None = None,
                 **kernel_options):
        super().__init__(operators, **kernel_options)
        self.route = route
        self.layout = layout

    @property
    def packed(self):
        """(ops_f, ops_i) in the route's form; None without a route."""
        if self.route is None:
            return None
        if self.route == "wide":
            return BoxWidePacked(self.ops_f, self.ops_i, self.layout)
        return self.ops_f, self.ops_i

    def bases(self, x0s):
        """(free, r_base, u0): the JAX general path's per-solve products."""
        x0s = torch.as_tensor(x0s).to(self.l_invT.device, self.l_invT.dtype)
        if x0s.shape[0] % self.kernel_options["batch_tile"]:
            raise ValueError("batch must be a multiple of batch_tile")
        with full_f32_matmul():
            free = x0s @ self.Sx.T
            r0 = self.r_const[None] - free @ self.SuTQ.T
            r_base = r0 - free @ self.SuTQrT
            # warm start through the regularized inverse, as the TPU path does
            u0 = r0 @ self.l_invT
        return free, r_base, u0

    def kernel_inputs(self, x0s):
        """`admm_box_reference`'s positional arguments for a batch of
        initial states (`admm_box` takes `packed` after them)."""
        free, r_base, u0 = self.bases(x0s)
        with full_f32_matmul():
            u_base = r_base @ self.l_invT
        return free, u_base, u0, self.W_s, self.SuT, self.xb, self.ub

    def forward(self, x0s):
        if self.route is None:
            return admm_box_reference(*self.kernel_inputs(x0s), **self.kernel_options)
        return admm_box(*self.kernel_inputs(x0s), self.packed, **self.kernel_options,
                        route=self.route)


def make_fused_lqt_admm(
    A,
    B,
    cost: QuadCost,
    u_lower=None,
    u_upper=None,
    x_lower=None,
    x_upper=None,
    rho_x=None,
    rho_u=None,
    n_iters: int = 100,
    alpha: float = 1.0,
    batch_tile: int | None = None,
    refresh_every: int = 1,
    polish_iters: int = 8,
    stop_tol: float = 0.0,
    check_every: int = 8,
    *,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> FusedLQTADMM:
    """Build a batched box-constrained LQT-ADMM solver for the fused kernel.

    The arguments are those of `make_pallas_lqt_admm`, with `device` and
    `dtype` in place of `interpret`; device defaults to the CUDA card
    ("cpu" runs the plain versions of the kernels). u_lower/u_upper: scalars or (N*u_dim,)
    bounds; x_lower/x_upper: scalars or (N*x_dim,) bounds, +-inf where a
    coordinate is free (None disables that block). rho_x: scalar, (d, d)
    or (N, d, d). Returns a module; solver(x0s (batch, d)) -> (x, u, z_x,
    z_u) with batch a multiple of batch_tile.

    Without state bounds the solver runs `admm_u_only` and z_x is x. With
    state bounds it runs `admm_box`: the general path of the JAX factory,
    warm-started through the regularized inverse as there, with l_inv
    folded into the loop's operators (in f32 the unfolded loop holds the
    residual above the 1e-4 certificate; see csrc/admm_box.cu); and
    `refresh_every`, `polish_iters`, `stop_tol` and `check_every` are
    accepted and ignored, as there.

    batch_tile is the number of instances one CUDA block owns (and, on
    the u-only path, the early-exit group). The default (None) on the
    u-only path is `default_u_tile`: the largest tile of 16, 32 or 64 the
    narrow kernel takes (see `launch_geometry`; 64 gives 256 blocks of 16
    warps at the bench width), else the largest of 16 or 32 the wide
    route takes (`wide_launch_geometry`; 32 at Nm = 512). On the
    state-bounded path the route and the default tile are chosen when the
    fleet is built, from the packed operators: the default is
    `default_box_tile`, the largest of 16 or 32 the narrow kernel takes
    (its block stages the packed operators in shared memory, see
    `box_launch_geometry`; 32 at Nm = 100), else the largest the wide route
    takes (operators read from L2, see `box_wide_launch_geometry`; 32 at
    the planar fleet's Nm = 200, Nd = 400, 16 to Nm = 512, Nd = 1,024);
    then `box_route` picks the kernel for the tile (the solver's `route`)
    and the operators are packed in its form. On a CUDA device a fleet
    that neither kernel takes raises ValueError here, not at its first
    call; on the CPU such a fleet builds with route None and runs the plain
    version. On a CUDA device dtype must be float32.

    The problem data are rounded to `dtype` (as the JAX factory rounds
    them to f32), then the setup (Su, the lifted normal matrix, its
    inverse and the loop operators) runs in float64 and is cast to
    `dtype`: setup at reduced precision converges to the optimum of a
    perturbed problem.
    """
    device = resolve_device(device)
    has_u = u_lower is not None or u_upper is not None
    has_x = x_lower is not None or x_upper is not None
    if not (has_u or has_x):
        raise ValueError("at least one box constraint required")
    validate_constraint_blocks(
        object() if has_x else None, rho_x,
        object() if has_u else None, rho_u,
    )
    if not has_x:
        _schedule(n_iters, refresh_every, polish_iters, stop_tol, check_every)
    elif n_iters < 0:
        raise ValueError("n_iters must be >= 0")
    f64 = torch.float64
    A, B, cost = host_f64(A, B, cost, dtype)
    N, d, m = A.shape[0], A.shape[-1], B.shape[-1]
    if batch_tile is None and not has_x:
        batch_tile = default_u_tile(N * m, alpha, refresh_every)

    Su = build_Su(A, B)
    Sx = build_Sx(A).reshape(N * d, d)
    SuTQ = Su.T @ block_diag_stacked(cost.Q)
    l_side = SuTQ @ Su + block_diag_stacked(cost.R)
    r_const = SuTQ @ cost.lifted_xd()

    def bounds(lo, hi, size):
        lo = -float("inf") if lo is None else lo
        hi = float("inf") if hi is None else hi
        return torch.stack([torch.as_tensor(v, dtype=f64).expand(size) for v in (lo, hi)])

    def cast(operators):
        return {k: v.to(device=device, dtype=dtype).contiguous() for k, v in operators.items()}

    if has_x:
        # the general path of `make_pallas_lqt_admm` (pallas_admm.py:356-398, 424-429)
        SuTQr = torch.zeros((N * m, N * d), dtype=f64)
        Rr_l = torch.zeros((N * m, N * m), dtype=f64)
        Qr = broadcast_rho(rho_x, d, N, dtype)
        if Qr is not None:
            SuTQr = Su.T @ block_diag_stacked(Qr.to(f64))
            l_side = l_side + SuTQr @ Su
        Rr = broadcast_rho(rho_u, m, N, dtype)
        if Rr is not None and has_u:
            Rr_l = block_diag_stacked(Rr.to(f64))
            l_side = l_side + Rr_l
        l_inv = torch.linalg.inv(l_side)
        operators = dict(
            Sx=Sx, SuTQ=SuTQ, r_const=r_const, SuTQrT=SuTQr.T, l_invT=l_inv.T,
            W_s=torch.cat([(l_inv @ SuTQr).T, (l_inv @ Rr_l).T]), SuT=Su.T,
            xb=bounds(x_lower, x_upper, N * d), ub=bounds(u_lower, u_upper, N * m),
        )
        operators = {k: v.to(dtype).contiguous() for k, v in operators.items()}
        # the route, chosen once, here, from the packed operators' size; the
        # kernel's storage of its two operators, packed once in its form,
        # on the host, so that a fleet no kernel takes raises before
        # anything reaches the card; on the CPU such a fleet runs the plain
        # version, unpacked
        ops_f, t1, t2 = _pack_box_pairs(operators["W_s"], operators["SuT"])
        widths = (N * m, N * d, ops_f.numel() // 64)
        route = None
        try:
            if batch_tile is None:
                batch_tile = default_box_tile(*widths)
            route = box_route(batch_tile, *widths)
        except ValueError:
            if device.type == "cuda":
                raise
            batch_tile = 32 if batch_tile is None else batch_tile
        layout = None
        if route == "narrow":
            operators["ops_f"], operators["ops_i"] = ops_f, box_schedule(t1, t2)
        elif route == "wide":
            packed = pack_box_operators(operators["W_s"], operators["SuT"], "wide", batch_tile)
            (operators["ops_f"], operators["ops_i"]), layout = packed, packed.layout
        operators = {k: v.to(device) for k, v in operators.items()}
        return FusedBoxLQTADMM(
            operators, route, layout, n_iters=n_iters, alpha=alpha, has_u=has_u,
            batch_tile=batch_tile,
        )

    Rr = broadcast_rho(rho_u, m, N, dtype).to(f64)
    Rr_l = block_diag_stacked(Rr)
    l_side = l_side + Rr_l
    l_inv = torch.linalg.inv(l_side)
    W_u = Rr_l.T @ l_inv.T  # (Nm, Nm) in-loop control response
    W_x = W_u @ Su.T  # (Nm, Nd) state recovery
    lo, hi = bounds(u_lower, u_upper, N * m)
    operators = cast(dict(
        Su=Su, Sx=Sx, SuTQ=SuTQ, l_side=l_side, l_inv=l_inv, r_const=r_const,
        W_u=W_u, W_x=W_x, lo=lo, hi=hi,
    ))
    # the kernel's storage of its two operators, packed once
    operators["ops_f"], operators["ops_i"] = pack_u_only_operators(
        operators["W_u"], operators["W_x"]
    )
    return FusedLQTADMM(
        operators, n_iters=n_iters, alpha=alpha, batch_tile=batch_tile,
        refresh_every=refresh_every, polish_iters=polish_iters,
        stop_tol=float(stop_tol), check_every=int(check_every),
    )
