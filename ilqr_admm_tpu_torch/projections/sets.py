"""Intersection projections (counterpart of part of
`ilqr_admm_tpu/projections/sets.py`).

Ported so far: `project_set_convex`, the consensus-ADMM projection onto
an intersection of constraint sets, which is the z-update of the plain
robust SLS fleet. The JAX `lax.while_loop` becomes a Python loop that
reads its stopping test back from the device once per iteration.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul

_EPS = 1e-30


@full_f32_matmul()
def project_set_convex(
    x0: torch.Tensor,
    As: Sequence[torch.Tensor] = (),
    bs: Sequence[torch.Tensor] = (),
    projections: Sequence[Callable] = (),
    rho: float = 1.0,
    max_iter: int = 200,
    threshold: float = 1e-4,
    stall_tol: float = 1e-5,
    batch_dims: int = 0,
):
    """Consensus-ADMM projection onto the intersection of constraint sets.

    Finds the point closest to x0 with A_i x + b_i in set_i for every i,
    where set_i is the image of projection P_i. x0: (..., dim).

    The loop stops after max_iter iterations, or once the primal and
    dual residuals are both below `threshold`, or once both changed by
    less than `stall_tol` relative to the iteration before.

    batch_dims: the number of leading axes of x0 that hold independent
    instances, as under `jax.vmap` of the JAX function. Each instance
    keeps its own residuals and iteration count and stops on its own; a
    stopped instance keeps its iterate. With batch_dims=0 the residuals
    are maxima over all of x0, as in the JAX function called directly.
    The As, bs and projections apply to every instance; a b_i may carry
    the instance axes (it is broadcast against A_i x).
    """
    single = x0.ndim == 1
    x0b = x0[None] if single else x0
    nb = len(projections)
    if nb == 0:
        raise ValueError(
            "project_set_convex needs at least one (A, b, projection) constraint set"
        )
    if len(As) != nb or len(bs) != nb:
        raise ValueError(
            f"As ({len(As)}), bs ({len(bs)}) and projections ({nb}) must have equal lengths"
        )
    if not 0 <= batch_dims < x0b.ndim:
        raise ValueError(f"batch_dims={batch_dims} must lie in [0, {x0b.ndim - 1}]")
    dim = x0b.shape[-1]
    like = dict(dtype=x0b.dtype, device=x0b.device)
    As = [torch.as_tensor(A, **like) for A in As]
    bs = [torch.as_tensor(b, **like) for b in bs]

    l_side = torch.eye(dim, **like)
    for A in As:
        l_side = l_side + rho * (A.T @ A)
    l_inv = torch.linalg.inv(l_side)

    inst = x0b.shape[:batch_dims]
    reduce_dims = tuple(range(batch_dims, x0b.ndim - 1))

    def residual(v):  # max over each instance's rows of the row norms
        n = torch.linalg.vector_norm(v, dim=-1)
        return torch.amax(n, dim=reduce_dims) if reduce_dims else n

    def step(x, zs, lmbs):
        r_side = torch.zeros_like(x0b)
        for i in range(nb):
            r_side = r_side + (zs[i] - bs[i] - lmbs[i]) @ As[i]
        x_new = (x0b + rho * r_side) @ l_inv.T
        zs_new, lmbs_new, prim, dual = [], [], [], []
        for i in range(nb):
            Ax_b = x_new @ As[i].T + bs[i]
            z_new = projections[i](Ax_b + lmbs[i])
            r = Ax_b - z_new
            lmbs_new.append(lmbs[i] + r)
            prim.append(residual(r))
            dual.append(residual(rho * ((z_new - zs[i]) @ As[i])))
            zs_new.append(z_new)
        prim = torch.amax(torch.stack(prim), dim=0)
        dual = torch.amax(torch.stack(dual), dim=0)
        return x_new, zs_new, lmbs_new, prim, dual

    x = x0b
    zs = [x0b @ As[i].T + bs[i] for i in range(nb)]
    lmbs = [torch.zeros_like(z) for z in zs]
    prim = torch.full(inst, 1e5, **like)
    dual = torch.full(inst, 1e5, **like)
    # != the initial residuals, so the stall test cannot fire before iterating
    prev_prim = torch.full(inst, 1e10, **like)
    prev_dual = torch.full(inst, 1e10, **like)
    count = torch.zeros(inst, dtype=torch.int64, device=x0b.device)
    while True:
        converged = (prim < threshold) & (dual < threshold)
        stalled = (torch.abs(prev_prim - prim) / (prev_prim + _EPS) < stall_tol) & (
            torch.abs(prev_dual - dual) / (prev_dual + _EPS) < stall_tol
        )
        active = (count < max_iter) & ~(converged | stalled)
        if not bool(active.any()):
            break
        x_n, zs_n, lmbs_n, prim_n, dual_n = step(x, zs, lmbs)
        if batch_dims == 0:
            x, zs, lmbs = x_n, zs_n, lmbs_n
            prev_prim, prev_dual, prim, dual = prim, dual, prim_n, dual_n
        else:
            def keep(new, old, a=active):
                return torch.where(a.reshape(a.shape + (1,) * (new.ndim - a.ndim)), new, old)

            x = keep(x_n, x)
            zs = [keep(n, o) for n, o in zip(zs_n, zs)]
            lmbs = [keep(n, o) for n, o in zip(lmbs_n, lmbs)]
            prev_prim, prev_dual = keep(prim, prev_prim), keep(dual, prev_dual)
            prim, dual = keep(prim_n, prim), keep(dual_n, dual)
        count = count + active.to(count.dtype)
    return x[0] if single else x
