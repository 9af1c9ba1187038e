"""Mesh-parallel consensus-ADMM intersection projection (counterpart of
`ilqr_admm_tpu/parallel/consensus.py`).

`projections/sets.py::project_set_convex` loops over its constraint
blocks one by one. Here the blocks (A_i, b_i, P_i) are stacked along a
leading block axis and partitioned over the ranks of a ('consensus',)
mesh axis:

- the x-update's consensus aggregate sum_i A_i^T (z_i - b_i - lmb_i) is
  a rank-local partial sum and one all_reduce(SUM) over the axis, the
  only exchange of an iteration that grows with the batch (O(batch *
  dim));
- the z-updates (projections) and scaled duals are block-local;
- the stop test reduces the block-wise residual maxima with one
  all_reduce(MAX) of the two residuals, after which every rank reads the
  same flag on the host and stops at the same iteration.

`project_set_convex_stacked` is the one-process form over the same
stacked operands (the sharded form's exactness oracle, and one batched
einsum in place of a loop over blocks).
"""

from __future__ import annotations

import inspect
from typing import Callable

import torch
import torch.distributed as dist

from ilqr_admm_tpu_torch.parallel.collectives import all_reduce
from ilqr_admm_tpu_torch.parallel.mesh import axis_group
from ilqr_admm_tpu_torch.projections.sets import _admm_stop, _loop, _residual_start
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


def _blockwise(projection: Callable) -> Callable:
    """The projection as (y, block_idx) -> z.

    `projection(y)`: one operator applied to every block's frame y
    (nb, batch..., m); or `projection(y, idx)` with idx (nb,) the global
    block indices of y's blocks, for heterogeneous sets that dispatch on
    the index, so the sharded path takes mixed constraint types with no
    per-rank branching. Parameters with defaults do not count.
    """
    try:
        params = inspect.signature(projection).parameters.values()
    except (TypeError, ValueError):  # builtins without a signature
        return lambda y, idx: projection(y)
    positional = [p for p in params if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                  and p.default is p.empty]
    if len(positional) >= 2 or any(p.kind == p.VAR_POSITIONAL for p in params):
        return projection
    return lambda y, idx: projection(y)


def _consensus_admm(x0b, As, bs, mask, idxs, proj, rho, max_iter, threshold, stall_tol,
                    reduce_sum, reduce_max):
    """The consensus-ADMM loop over stacked blocks.

    x0b: (batch..., dim), the same on every rank; As: (nb, m, dim); bs:
    (nb, m); mask: (nb,) 1 for a block, 0 for padding; idxs: (nb,) global
    block indices. reduce_sum / reduce_max: identity in one process,
    all_reduce over the 'consensus' axis when sharded. The math of
    `projections.sets.project_set_convex`.
    """
    dim = x0b.shape[-1]
    like = dict(dtype=x0b.dtype, device=x0b.device)
    # I + rho * sum_i A_i^T A_i (padding blocks are zero)
    l_local = rho * torch.einsum("smi,smj->ij", As * mask[:, None, None], As)
    l_inv = torch.linalg.inv(torch.eye(dim, **like) + reduce_sum(l_local))
    bs_b = bs.reshape(bs.shape[:1] + (1,) * (x0b.ndim - 1) + bs.shape[1:])
    bmask = mask.reshape((-1,) + (1,) * x0b.ndim)  # over batch and m

    def frames(x):  # (nb, batch..., m): y_i = A_i x + b_i
        return torch.einsum("smj,...j->s...m", As, x) + bs_b

    def step(state):
        x, zs, lmbs, prim, dual = state[:5]
        resid = (zs - bs_b - lmbs) * bmask
        r_side = reduce_sum(torch.einsum("s...m,smj->...j", resid, As))
        x_new = (x0b + rho * r_side) @ l_inv.T
        y = frames(x_new)
        z_new = proj(y + lmbs, idxs) * bmask
        r = (y - z_new) * bmask
        dz = torch.einsum("s...m,smj->s...j", (z_new - zs) * bmask, As)
        # block-wise residual maxima (padding gives 0), reduced over the
        # mesh: the list form's max over blocks
        prim_new, dual_new = reduce_max(torch.stack([
            torch.amax(torch.linalg.vector_norm(r, dim=-1)),
            torch.amax(rho * torch.linalg.vector_norm(dz, dim=-1))]))
        return [x_new, z_new, lmbs + r, prim_new, dual_new, prim, dual]

    z0 = frames(x0b) * bmask
    state = _loop(step, [x0b, z0, torch.zeros_like(z0)] + _residual_start((), like),
                  _admm_stop(threshold, stall_tol), max_iter, 0, None)
    return state[0]


def _stacked_operands(x0, As, bs, what: str):
    x0 = torch.as_tensor(x0)
    single = x0.ndim == 1
    x0b = x0[None] if single else x0
    like = dict(dtype=x0b.dtype, device=x0b.device)
    As, bs = torch.as_tensor(As, **like), torch.as_tensor(bs, **like)
    if As.shape[0] == 0:
        raise ValueError(f"{what} needs at least one (A, b) block")
    return x0b, single, As, bs


@full_f32_matmul()
def project_set_convex_stacked(x0, As, bs, projection: Callable, rho: float = 1.0,
                               max_iter: int = 200, threshold: float = 1e-4,
                               stall_tol: float = 1e-5):
    """One-process consensus-ADMM projection over stacked blocks.

    The math of `projections.sets.project_set_convex` with the block list
    replaced by stacked As (nb, m, dim) and bs (nb, m) and one projection
    applied blockwise (or `projection(y, idx)` for heterogeneous sets).
    x0: (..., dim).
    """
    x0b, single, As, bs = _stacked_operands(x0, As, bs, "project_set_convex_stacked")
    nb = As.shape[0]
    x = _consensus_admm(x0b, As, bs, torch.ones((nb,), dtype=As.dtype, device=As.device),
                        torch.arange(nb, device=As.device), _blockwise(projection), rho,
                        max_iter, threshold, stall_tol, lambda v: v, lambda v: v)
    return x[0] if single else x


@full_f32_matmul()
def project_set_convex_sharded(x0, As, bs, projection: Callable, rho: float = 1.0,
                               max_iter: int = 200, threshold: float = 1e-4,
                               stall_tol: float = 1e-5, mesh=None, axis: str = "consensus"):
    """Consensus-ADMM projection with the blocks sharded over a mesh axis.

    Every rank of the axis calls it with the same x0 (..., dim), As (nb,
    m, dim) and bs (nb, m). The blocks are zero-padded to a multiple of
    the axis size (the padding is masked out of every update and
    residual), and each rank takes a contiguous range of them. Each
    iteration exchanges the all-reduced consensus aggregate (O(batch *
    dim)) and the two residuals, read on the host. Every rank returns
    the same x, which matches `project_set_convex_stacked` up to the
    order of the sums. mesh=None runs the stacked form.
    """
    if mesh is None:
        return project_set_convex_stacked(x0, As, bs, projection, rho, max_iter, threshold,
                                          stall_tol)
    x0b, single, As, bs = _stacked_operands(x0, As, bs, "project_set_convex_sharded")
    group, size, index = axis_group(mesh, axis)
    nb = As.shape[0]
    per = -(-nb // size)
    lo, hi = index * per, min((index + 1) * per, nb)
    pad = per - max(hi - lo, 0)
    local_As = torch.cat([As[lo:hi], As.new_zeros((pad,) + tuple(As.shape[1:]))])
    local_bs = torch.cat([bs[lo:hi], bs.new_zeros((pad,) + tuple(bs.shape[1:]))])
    idxs = torch.arange(index * per, (index + 1) * per, device=As.device)
    mask = (idxs < nb).to(As.dtype)
    x = _consensus_admm(
        x0b, local_As, local_bs, mask, idxs, _blockwise(projection), rho, max_iter, threshold,
        stall_tol, lambda v: all_reduce(v, dist.ReduceOp.SUM, group),
        lambda v: all_reduce(v, dist.ReduceOp.MAX, group))
    return x[0] if single else x
