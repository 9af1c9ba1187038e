"""Fused box-constrained LQT-ADMM fleet on the card.

Counterpart of `ilqr_admm_tpu/ops/pallas_admm.py` (`make_pallas_lqt_admm`
and its kernel `_admm_kernel_u_only`). The one-time operator setup runs
in float64 on the host and is cast to the working dtype; the per-solve
pre-kernel products are plain torch matmuls in full f32; the ADMM loop
itself is one hand-written CUDA kernel (`csrc/admm_u_only.cu`), launched
by `admm_u_only`. On CPU tensors `admm_u_only` runs its plain torch
version `admm_u_only_reference` instead.

Only the control-bounds (u-only) path is ported. State bounds need the
general kernel `_admm_kernel`, which is still to be ported.

Unlike the TPU kernel, every product is plain f32 (no bf16 splits), so
`refresh_every` and `polish_iters` change only the iteration count: the
main phase runs ceil(n_main / refresh_every) * refresh_every iterations
and the tail min(polish_iters, n_iters) more, with
n_main = max(n_iters - polish_iters, 0).
"""

from __future__ import annotations

import torch
from torch import nn

from ilqr_admm_tpu_torch.ops.lifted import build_Su, build_Sx
from ilqr_admm_tpu_torch.problem import QuadCost, host_f64
from ilqr_admm_tpu_torch.solvers.admm import validate_constraint_blocks
from ilqr_admm_tpu_torch.solvers.lqt import block_diag_stacked, broadcast_rho
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul

# Number of times `admm_u_only` has launched its CUDA kernel in this process.
launch_count = 0

# Kernel geometry, as in csrc/admm_u_only.cu: each thread owns a 4 x 4
# (instances x controls) register tile; a block holds at most 512 threads
# and stages W_u plus two s buffers in shared memory.
_ROWS = 4
_COLS = 4
_MAX_THREADS = 512
_MAX_SMEM = 232448 - 16  # an H100 block's 227 KB, less the kernel's static word


def launch_geometry(batch_tile: int, Nm: int) -> tuple[int, int]:
    """(threads, dynamic shared-memory bytes) of one kernel block.

    Raises ValueError when the tile cannot be launched: batch_tile must
    be a multiple of 4, the block must fit in 512 threads, and W_u with
    two copies of the tile's s must fit in shared memory.
    """
    if batch_tile < _ROWS or batch_tile % _ROWS:
        raise ValueError(f"batch_tile={batch_tile} must be a positive multiple of {_ROWS}")
    col_groups = -(-Nm // _COLS)
    threads = (batch_tile // _ROWS) * col_groups
    if threads > _MAX_THREADS:
        raise ValueError(
            f"batch_tile={batch_tile} at Nm={Nm} needs {threads} threads per block; "
            f"the kernel takes at most {_MAX_THREADS}, so batch_tile <= "
            f"{_ROWS * (_MAX_THREADS // col_groups)}"
        )
    smem = 4 * (Nm * col_groups * _COLS + 2 * Nm * batch_tile)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"Nm={Nm} with batch_tile={batch_tile} needs {smem} bytes of shared memory "
            f"to stage W_u and the tile's iterate; the limit is {_MAX_SMEM} bytes"
        )
    return threads, smem


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
    polish_iters=8, stop_tol=0.0, check_every=8, batch_tile=64,
):
    """Plain torch version of the kernel, in f32 or f64, on any device.

    Works on (n_tiles, batch_tile, Nm) views so that early exit is per
    tile, as in the kernel: a tile that has exited keeps its iterates
    until the tail. Returns (x (B, Nd), u (B, Nm), z_u (B, Nm)).
    """
    chunk_len, n_chunks, n_tail = _schedule(
        n_iters, refresh_every, polish_iters, stop_tol, check_every
    )
    batch, Nm = u_base.shape
    n_tiles = batch // batch_tile
    ub = u_base.reshape(n_tiles, batch_tile, Nm)
    one_minus_alpha = 1.0 - alpha

    def step(z, lam):
        s = z - lam
        u = ub + s @ W_u
        if alpha == 1.0:
            v = u + lam
            z_new = torch.minimum(torch.maximum(v, lo), hi)
            return z_new, v - z_new, s, u
        z_rel = alpha * u + one_minus_alpha * z
        z_new = torch.minimum(torch.maximum(z_rel + lam, lo), hi)
        return z_new, lam + u - z_new, s, u

    with full_f32_matmul():
        z, lam, s, u = ub, torch.zeros_like(ub), ub, ub
        active = None  # per-tile mask, once early exit has been tested
        for _ in range(n_chunks):
            for _ in range(chunk_len):
                new = step(z, lam)
                if active is None:
                    z, lam, s, u = new
                else:
                    keep = active[:, None, None]
                    z, lam, s, u = (
                        torch.where(keep, a, b) for a, b in zip(new, (z, lam, s, u))
                    )
            if stop_tol > 0.0:
                running = torch.amax(torch.abs(u - z), dim=(1, 2)) >= stop_tol
                active = running if active is None else active & running
                if not bool(active.any()):
                    break
        for _ in range(n_tail):
            z, lam, s, u = step(z, lam)
        x = x_base.reshape(n_tiles, batch_tile, -1) + s @ W_x
    return x.reshape(batch, -1), u.reshape(batch, Nm), z.reshape(batch, Nm)


def admm_u_only(
    u_base, x_base, W_u, W_x, lo, hi, *, n_iters, refresh_every=1, alpha=1.0,
    polish_iters=8, stop_tol=0.0, check_every=8, batch_tile=64,
):
    """Run the u-only ADMM loop on a fleet; returns (x, u, z_u).

    u_base (B, Nm), x_base (B, Nd): unconstrained iterates; W_u (Nm, Nm)
    and W_x (Nm, Nd): control and state responses to s = z - lambda;
    lo, hi (Nm,): the box. B must be a multiple of batch_tile.

    CUDA tensors (float32) go to the kernel in `csrc/admm_u_only.cu`; CPU
    tensors go to `admm_u_only_reference`. Any other device raises.
    """
    global launch_count
    _check_inputs(u_base, x_base, W_u, W_x, lo, hi, batch_tile)
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
    batch, Nm = u_base.shape
    Nd = x_base.shape[1]
    launch_geometry(batch_tile, Nm)

    from ilqr_admm_tpu_torch._build import load_library

    lib = load_library()
    x = torch.empty_like(x_base)
    u = torch.empty_like(u_base)
    z_u = torch.empty_like(u_base)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.admm_u_only_launch(
            u_base.data_ptr(), x_base.data_ptr(), W_u.data_ptr(), W_x.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), x.data_ptr(), u.data_ptr(), z_u.data_ptr(),
            batch, Nm, Nd, batch_tile, chunk_len, n_chunks, n_tail,
            float(alpha), float(1.0 - alpha), float(stop_tol), stream,
        )
    if err != 0:
        msg = lib.admm_u_only_error_string(err).decode()
        raise RuntimeError(f"admm_u_only kernel launch failed: {msg} (cudaError {err})")
    launch_count += 1
    return x, u, z_u


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

    def forward(self, x0s):
        u_base, x_base = self.bases(x0s)
        x, u, z_u = admm_u_only(
            u_base, x_base, self.W_u, self.W_x, self.lo, self.hi, **self.kernel_options
        )
        return x, u, x, z_u


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
    batch_tile: int = 64,
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
    `dtype` in place of `interpret`. u_lower/u_upper: scalars or (N*u_dim,)
    bounds. Returns a module; solver(x0s (batch, d)) -> (x, u, z_x, z_u)
    with batch a multiple of batch_tile.

    batch_tile is the number of instances one CUDA block owns (and the
    early-exit group); the default 64 fills an H100 with 256 blocks at the
    bench width, where the largest tile the kernel takes is 80 (see
    `launch_geometry`). On a CUDA device dtype must be float32.

    The problem data are rounded to `dtype` (as the JAX factory rounds
    them to f32), then the setup (Su, the lifted normal matrix, its
    inverse, W_u = (Rr l_inv)^T and W_x = W_u Su^T) runs in float64 and
    is cast to `dtype`: setup at reduced precision converges to the
    optimum of a perturbed problem.
    """
    has_u = u_lower is not None or u_upper is not None
    has_x = x_lower is not None or x_upper is not None
    if not (has_u or has_x):
        raise ValueError("at least one box constraint required")
    validate_constraint_blocks(
        object() if has_x else None, rho_x,
        object() if has_u else None, rho_u,
    )
    if has_x:
        raise NotImplementedError(
            "state bounds (x_lower/x_upper) need the general kernel `_admm_kernel` "
            "(ROADMAP.md, TPU kernels still to port, entry 2), which is not ported yet"
        )
    _schedule(n_iters, refresh_every, polish_iters, stop_tol, check_every)

    f64 = torch.float64
    A, B, cost = host_f64(A, B, cost, dtype)
    N, d, m = A.shape[0], A.shape[-1], B.shape[-1]
    Rr = broadcast_rho(rho_u, m, N, dtype, A.device).to(f64)

    Su = build_Su(A, B)
    Sx = build_Sx(A).reshape(N * d, d)
    SuTQ = Su.T @ block_diag_stacked(cost.Q)
    Rr_l = block_diag_stacked(Rr)
    l_side = SuTQ @ Su + block_diag_stacked(cost.R) + Rr_l
    l_inv = torch.linalg.inv(l_side)
    r_const = SuTQ @ cost.lifted_xd()
    W_u = Rr_l.T @ l_inv.T  # (Nm, Nm) in-loop control response
    W_x = W_u @ Su.T  # (Nm, Nd) state recovery

    def bound(v, default):
        v = default if v is None else v
        return torch.as_tensor(v, dtype=f64).expand(N * m)

    operators = dict(
        Su=Su, Sx=Sx, SuTQ=SuTQ, l_side=l_side, l_inv=l_inv, r_const=r_const,
        W_u=W_u, W_x=W_x,
        lo=bound(u_lower, -float("inf")), hi=bound(u_upper, float("inf")),
    )
    operators = {k: v.to(device=device, dtype=dtype).contiguous() for k, v in operators.items()}
    return FusedLQTADMM(
        operators, n_iters=n_iters, alpha=alpha, batch_tile=batch_tile,
        refresh_every=refresh_every, polish_iters=polish_iters,
        stop_tol=float(stop_tol), check_every=int(check_every),
    )
