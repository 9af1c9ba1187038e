"""Intersection and affine-preimage projections (counterpart of
`ilqr_admm_tpu/projections/sets.py`).

- `project_soc`: the projection onto {z : A z + b in SOC} by scaled ADMM;
- `project_set_convex`: consensus ADMM over a list of (A_i, b_i, P_i)
  constraint blocks with a prefactored (I + rho sum A_i^T A_i)^-1;
- `project_outside_rotated_boxes`: the exact projection onto the
  intersection of rotated-box exteriors, with its certificate;
- `project_set_convex_dykstra`: Dykstra's alternating projections.

The JAX `lax.while_loop`s become Python loops that read one stop flag an
iteration from the device (counted in `host_sync_count`);
`project_outside_rotated_boxes` runs its fixed step count and reads
nothing. The iterative ones take `batch_dims`: the number of leading
axes of the input that hold independent instances, as under `jax.vmap`
of the JAX function. Each instance then keeps its own residuals and
iteration count and stops on its own (a stopped instance keeps its
iterate); with batch_dims=0 the stop test is over all of the input, as
in the JAX function called directly. `stats`, when given a dict,
receives the iteration count ("iters", one an instance).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ilqr_admm_tpu_torch.projections.primitives import project_soc_unit
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul

_EPS = 1e-30

# Number of device-to-host reads of stop flags by the loops of this module.
host_sync_count = 0


def _batched(x0: torch.Tensor, batch_dims: int):
    """(x0 with a leading axis if it is a vector, whether it was one, the
    instance shape) after checking batch_dims."""
    single = x0.ndim == 1
    x0b = x0[None] if single else x0
    if not 0 <= batch_dims < x0b.ndim:
        raise ValueError(f"batch_dims={batch_dims} must lie in [0, {x0b.ndim - 1}]")
    return x0b, single, x0b.shape[:batch_dims]


def _row_max(v: torch.Tensor, batch_dims: int) -> torch.Tensor:
    """Max over each instance's leading (row) axes of v (..., rows...)."""
    dims = tuple(range(batch_dims, v.ndim))
    return torch.amax(v, dim=dims) if dims else v


def _keep(active: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(active.reshape(active.shape + (1,) * (new.ndim - active.ndim)), new, old)


def _loop(step, state, proceed, max_iter, batch_dims, stats):
    """Run state = step(state) while proceed(state) for some instance and
    its count is below max_iter: one host read of the flag an iteration.
    With batch_dims > 0 only the instances still going take the step; the
    instances are the leading axes of state[0]."""
    global host_sync_count
    count = torch.zeros(state[0].shape[:batch_dims], dtype=torch.int64, device=state[0].device)
    while True:
        active = (count < max_iter) & proceed(state)
        host_sync_count += 1
        if not bool(active.any()):
            break
        new = step(state)
        state = new if batch_dims == 0 else [_keep(active, n, o) for n, o in zip(new, state)]
        count = count + active.to(count.dtype)
    if stats is not None:
        stats["iters"] = count
    return state


def _admm_stop(tol, stall_tol):
    """The ADMM loops' test to go on: neither converged (both residuals
    below tol) nor stalled (both changed by less than stall_tol
    relative to the iteration before). The state ends with (prim, dual,
    prev_prim, prev_dual)."""
    def proceed(state):
        prim, dual, prev_prim, prev_dual = state[-4:]
        converged = (prim < tol) & (dual < tol)
        stalled = (torch.abs(prev_prim - prim) / (prev_prim + _EPS) < stall_tol) & (
            torch.abs(prev_dual - dual) / (prev_dual + _EPS) < stall_tol)
        return ~(converged | stalled)

    return proceed


def _residual_start(inst, like):
    """(prim, dual, prev_prim, prev_dual) before the first iteration: the
    previous values differ from the current, so the stall test cannot
    fire before iterating."""
    return [torch.full(inst, v, **like) for v in (1e5, 1e5, 1e10, 1e10)]


@full_f32_matmul()
def project_soc(z0: torch.Tensor, A, b, rho: float = 1.0, max_iter: int = 100,
                tol: float = 1e-5, batch_dims: int = 0, stats: Optional[dict] = None):
    """Project z0 onto {z : A z + b in SOC} by scaled ADMM.

    z0: (..., dim); A: (m, dim); b: (m,). Returns the shape of z0. Stops
    after max_iter iterations, or once both residuals are below tol, or
    once both changed by less than 1e-5 relative to the iteration before.
    """
    z0b, single, inst = _batched(z0, batch_dims)
    like = dict(dtype=z0b.dtype, device=z0b.device)
    A, b = torch.as_tensor(A, **like), torch.as_tensor(b, **like)
    l_inv = torch.linalg.inv(torch.eye(z0b.shape[-1], **like) + rho * A.T @ A)

    def step(state):
        z, lmb, prim, dual = state[:4]
        x = project_soc_unit(z @ A.T + b + lmb)
        z_new = (z0b + rho * (x - b - lmb) @ A) @ l_inv.T
        r = z_new @ A.T + b - x
        prim_new = _row_max(torch.linalg.vector_norm(r, dim=-1), batch_dims)
        dual_new = _row_max(rho * torch.linalg.vector_norm(z_new - z, dim=-1), batch_dims)
        return [z_new, lmb + r, prim_new, dual_new, prim, dual]

    lmb = torch.zeros(z0b.shape[:-1] + (A.shape[0],), **like)
    state = _loop(step, [z0b, lmb] + _residual_start(inst, like), _admm_stop(tol, 1e-5),
                  max_iter, batch_dims, stats)
    z = state[0]
    return z[0] if single else z


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
    stats: Optional[dict] = None,
):
    """Consensus-ADMM projection onto the intersection of constraint sets.

    Finds the point closest to x0 with A_i x + b_i in set_i for every i,
    where set_i is the image of projection P_i. x0: (..., dim).

    The loop stops after max_iter iterations, or once the primal and
    dual residuals are both below `threshold`, or once both changed by
    less than `stall_tol` relative to the iteration before.

    batch_dims and stats: see the module docstring. The As, bs and
    projections apply to every instance; a b_i may carry the instance
    axes (it is broadcast against A_i x).
    """
    x0b, single, inst = _batched(x0, batch_dims)
    nb = len(projections)
    if nb == 0:
        raise ValueError(
            "project_set_convex needs at least one (A, b, projection) constraint set"
        )
    if len(As) != nb or len(bs) != nb:
        raise ValueError(
            f"As ({len(As)}), bs ({len(bs)}) and projections ({nb}) must have equal lengths"
        )
    like = dict(dtype=x0b.dtype, device=x0b.device)
    As = [torch.as_tensor(A, **like) for A in As]
    bs = [torch.as_tensor(b, **like) for b in bs]

    l_side = torch.eye(x0b.shape[-1], **like)
    for A in As:
        l_side = l_side + rho * (A.T @ A)
    l_inv = torch.linalg.inv(l_side)

    def residual(v):  # max over each instance's rows of the row norms
        return _row_max(torch.linalg.vector_norm(v, dim=-1), batch_dims)

    def step(state):
        x, zs, lmbs = state[0], state[1:1 + nb], state[1 + nb:1 + 2 * nb]
        prim_old, dual_old = state[-4], state[-3]
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
        return [x_new] + zs_new + lmbs_new + [prim, dual, prim_old, dual_old]

    zs = [x0b @ As[i].T + bs[i] for i in range(nb)]
    lmbs = [torch.zeros_like(z) for z in zs]
    state = _loop(step, [x0b] + zs + lmbs + _residual_start(inst, like),
                  _admm_stop(threshold, stall_tol), max_iter, batch_dims, stats)
    x = state[0]
    return x[0] if single else x


@full_f32_matmul()
def project_outside_rotated_boxes(p: torch.Tensor, As, bs, l: float = 1.0, max_steps: int = 8,
                                  viol_tol: float = 1e-6):
    """Exact projection onto the intersection of rotated-box exteriors.

    Keeps a position p outside every rotated rectangle
    {p : ||A_i p + b_i||_inf <= l} (the car's obstacle constraint). For
    pairwise-disjoint obstacles with non-overlapping dilations it is
    exact: a feasible p stays; a p inside box i goes to the nearest point
    outside box i, the single-coordinate push in box i's frame along the
    axis that is cheapest in the world metric (exact for scaled-rotation
    A_i), which is then outside every other box too. A candidate that
    lands inside another box is pushed again, max_steps pushes in all;
    the loop runs its max_steps steps with no host read (a step with
    nothing to push changes nothing).

    Args:
      p:  (..., d) points (batched over leading axes).
      As: (n_sets, d, d) per-box linear maps into the frame where the box
          is the inf-norm ball of radius l.
      bs: (n_sets, d) per-box offsets.
      l:  inf-norm radius of each box.

    Returns:
      (proj, exact): proj (..., d); exact (...) bool, True where the
      result is certified to be the exact Euclidean projection (feasible,
      at most one box contained p, at most one push).
    """
    single = p.ndim == 1
    x0 = p[None] if single else p
    like = dict(dtype=x0.dtype, device=x0.device)
    As, bs = torch.as_tensor(As, **like), torch.as_tensor(bs, **like)
    Ainvs = torch.linalg.inv(As)  # exact pullback of each box's frame
    # world length of a unit step along frame axis i (column norms): the
    # frame is anisotropic, so the cheapest exit axis minimizes
    # h_i (l - |y_i|) in the world metric, not max |y_i|
    hs = torch.linalg.vector_norm(Ainvs, dim=-2)  # (n_sets, d)
    axes = torch.arange(x0.shape[-1], device=x0.device)

    def to_frames(x):  # (..., n_sets, d): y_i = A_i x + b_i
        return torch.einsum("sij,...j->...si", As, x) + bs

    def violation(x):  # depth inside each box, (l - ||y_i||_inf)_+: (..., n_sets)
        return torch.clamp(l - torch.amax(torch.abs(to_frames(x)), dim=-1), min=0.0)

    def push_out(x, idx):  # exterior projection w.r.t. box idx (...)
        y = to_frames(x)
        y_sel = torch.take_along_dim(y, idx[..., None, None], dim=-2)[..., 0, :]
        exit_cost = hs[idx] * (l - torch.abs(y_sel))
        j = torch.argmin(exit_cost, dim=-1, keepdim=True)  # the first of equals
        sgn = torch.where(y_sel >= 0, 1.0, -1.0).to(x.dtype)
        y_out = torch.where(axes == j, l * sgn, y_sel)
        return torch.einsum("...ij,...j->...i", Ainvs[idx], y_out - bs[idx])

    # pushes land on a box's boundary; the A^-1 / A round trip leaves
    # O(eps) depth, so only violations past viol_tol * l are pushed again
    push_bar = viol_tol * l
    x = x0
    pushes = torch.zeros(x0.shape[:-1], dtype=torch.int64, device=x0.device)
    for _ in range(max_steps):
        v = violation(x)
        any_viol = torch.any(v > push_bar, dim=-1)
        x = torch.where(any_viol[..., None], push_out(x, torch.argmax(v, dim=-1)), x)
        pushes = pushes + any_viol.to(pushes.dtype)

    feasible_now = torch.all(violation(x) <= push_bar, dim=-1)
    exact = feasible_now & (torch.sum(violation(x0) > push_bar, dim=-1) <= 1) & (pushes <= 1)
    if single:
        return x[0], exact[0]
    return x, exact


@full_f32_matmul()
def project_set_convex_dykstra(x0: torch.Tensor, projections: Sequence[Callable] = (),
                               max_iter: int = 200, tol: float = 1e-4, batch_dims: int = 0,
                               stats: Optional[dict] = None):
    """Dykstra's alternating projection onto an intersection of convex sets.

    Unlike plain alternating projection, Dykstra converges to the
    Euclidean projection. x0: (..., dim). Stops after max_iter sweeps, or
    once every point's squared correction change of a sweep is below tol.
    """
    u0, single, _ = _batched(x0, batch_dims)
    nb = len(projections)
    if nb == 0:
        raise ValueError("project_set_convex_dykstra needs at least one projection")

    def step(state):
        u, zs = state[0], list(state[1:1 + nb])
        cI = torch.zeros(u.shape[:-1], dtype=u.dtype, device=u.device)
        for i in range(nb):
            prev_u = u
            u = projections[i](prev_u - zs[i])
            prev_z = zs[i]
            zs[i] = u - (prev_u - prev_z)
            cI = cI + torch.sum((prev_z - zs[i]) ** 2, dim=-1)
        return [u] + zs + [cI]

    def proceed(state):  # any of each instance's points still moving
        go = state[-1] >= tol
        return go if go.ndim == batch_dims else go.flatten(batch_dims).any(-1)

    cI0 = torch.full(u0.shape[:-1], 10.0, dtype=u0.dtype, device=u0.device)
    state = _loop(step, [u0] + [torch.zeros_like(u0) for _ in range(nb)] + [cI0], proceed,
                  max_iter, batch_dims, stats)
    u = state[0]
    return u[0] if single else u
