"""Batched instance solves (counterpart of
`ilqr_admm_tpu/parallel/batch.py`).

Where the JAX package vmaps a single-instance solver over an instance
axis, each `batched_*` function here runs the port's fleet form of that
solver: one loop over a leading fleet axis F, each instance stopping on
its own with one host read an iteration for the whole fleet. Names and
argument order are the JAX package's, with x0s (F, d) and u0s (F, N, m);
`device` defaults to the CUDA card. The user functions and projections
are single-instance and must work under `torch.func.vmap`.

`sharded_instance_solve` and `mc_success_rate` shard a fleet over the
'data' axis of a mesh (`mesh.py`): each rank solves its contiguous
shard, and the only collectives are the gather of the results and the
reduction of the rates. Every rank calls them with the same global
arguments.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.func import vmap
from torch.utils._pytree import tree_flatten, tree_unflatten

from ilqr_admm_tpu_torch.parallel.collectives import all_reduce, gather_packed
from ilqr_admm_tpu_torch.parallel.mesh import axis_group, mesh_device
from ilqr_admm_tpu_torch.problem import ADMMConfig, ILQRConfig, QuadCost
from ilqr_admm_tpu_torch.solvers.admm import admm_fleet, validate_constraint_blocks
from ilqr_admm_tpu_torch.solvers.al_ilqr import ALResult, al_ilqr_fleet_solve
from ilqr_admm_tpu_torch.solvers.boxddp import boxddp_fleet_init, boxddp_fleet_solve
from ilqr_admm_tpu_torch.solvers.ilqr import ILQRState, ilqr_fleet_init, ilqr_fleet_solve
from ilqr_admm_tpu_torch.solvers.lqt import broadcast_rho
from ilqr_admm_tpu_torch.solvers.lqt_admm import (
    blockwise,
    dp_adaptive_update,
    dp_operators,
    dp_sweep,
)
from ilqr_admm_tpu_torch.utils.device import resolve_device
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


@full_f32_matmul()
def batched_lqt_admm_dp(A, B, cost: QuadCost, x0s, project_x: Optional[Callable] = None,
                        project_u: Optional[Callable] = None, rho_x=None, rho_u=None,
                        cfg: ADMMConfig = ADMMConfig(max_iter=200), *, device=None):
    """Solve the same constrained LQT (`lqt_admm_dp`, operator form) from a
    fleet of initial states x0s (F, d).

    The fleet runs the one ADMM loop (`admm.admm_fleet`) in any of its
    modes: plain, accel, Anderson (cfg.anderson_m > 0), or adaptive_rho.
    The DP x-update's affine operators are built once (their Jacobians do
    not depend on x0, only the constant term does, one row an instance);
    with cfg.adaptive_rho each iteration re-runs each instance's backward
    pass at its own penalty scale, as `lqt_admm_dp` does (the operators
    bake the penalty in). Returns (x (F, N*d), u (F, N*m), iters (F,)).
    """
    validate_constraint_blocks(project_x, rho_x, project_u, rho_u)
    device = resolve_device(device)
    A, B, x0s = (torch.as_tensor(t, device=device) for t in (A, B, x0s))
    cost = QuadCost(*(torch.as_tensor(t, device=device) for t in (cost.Q, cost.xd, cost.R)))
    N, d, m = A.shape[0], A.shape[-1], B.shape[-1]
    F, dtype = x0s.shape[0], A.dtype
    kw = dict(dtype=dtype, device=device)
    Qr = broadcast_rho(rho_x, d, N, dtype, device)
    Rr = broadcast_rho(rho_u, m, N, dtype, device)
    rho_wx = rho_wu = None
    if cfg.adaptive_rho:
        update = vmap(functools.partial(dp_adaptive_update, A, B, cost, Qr, Rr))

        def f_argmin(x, u, s):
            # vmap takes no None: a disabled block's target is the zero row
            xs, us, _ = update(x0s, torch.zeros((F, N * d), **kw) if x is None else x,
                               torch.zeros((F, N * m), **kw) if u is None else u, s)
            return xs, us

        if Qr is not None and project_x is not None:
            rho_wx = blockwise(Qr, d, N)
        if Rr is not None and project_u is not None:
            rho_wu = blockwise(Rr, m, N)
    else:
        _, sweep = dp_sweep(A, B, cost, Qr, Rr)
        zx, zu = torch.zeros((N * d,), **kw), torch.zeros((N * m,), **kw)
        consts, jac_x, jac_u = dp_operators(sweep, x0s, zx, zu)

        def f_argmin(x, u):
            xv = zx if x is None else x
            uv = zu if u is None else u
            return tuple(c + xv @ Jx.T + uv @ Ju.T
                         for c, Jx, Ju in zip(consts[:2], jac_x[:2], jac_u[:2]))

    z_x, z_u = torch.zeros((F, N * d), **kw), torch.zeros((F, N * m), **kw)
    x_x, x_u, *_, info = admm_fleet(
        f_argmin, None if project_x is None else vmap(project_x),
        None if project_u is None else vmap(project_u), cfg, z_x, z_u,
        torch.zeros_like(z_x), torch.zeros_like(z_u), rho_weight_x=rho_wx, rho_weight_u=rho_wu)
    return x_x, x_u, info.iters


def batched_ilqr_solve(f: Callable, get_AB: Callable, get_Cs: Callable, cost_fn: Callable,
                       x0s, u0s, cfg: ILQRConfig = ILQRConfig(), method: str = "dp", *,
                       device=None) -> ILQRState:
    """A fleet of iLQR solves (multi-start, scenario sampling): x0s (F, d),
    u0s (F, N, m); method 'dp', 'batch' or 'sls'. Returns the fleet state
    of `ilqr_fleet_solve`."""
    st = ilqr_fleet_init(f, cost_fn, x0s, u0s, device=device)
    return ilqr_fleet_solve(f, get_AB, get_Cs, cost_fn, st, cfg, method)


def batched_boxddp_solve(f: Callable, get_AB: Callable, get_Cs: Callable, cost_fn: Callable,
                         x0s, u0s, u_lower, u_upper, cfg: ILQRConfig = ILQRConfig(),
                         riccati: str = "seq", mask_iters: int = 1, *,
                         device=None) -> ILQRState:
    """A fleet of control-limited boxDDP solves: x0s (F, d), u0s (F, N, m).
    Every instance's controls satisfy the box exactly. riccati='seq' (the
    default) batches each stage's box QP across the fleet; 'parallel' is
    the time-parallel active-set backward."""
    st = boxddp_fleet_init(f, cost_fn, x0s, u0s, u_lower, u_upper, device=device)
    return boxddp_fleet_solve(f, get_AB, get_Cs, cost_fn, st, u_lower, u_upper, cfg=cfg,
                              riccati=riccati, mask_iters=mask_iters)


def batched_al_solve(f: Callable, get_AB: Callable, get_Cs: Callable, cost_fn: Callable,
                     x0s, u0s, ineq=None, eq=None, cfg: ILQRConfig = ILQRConfig(max_iter=30),
                     *, device=None, **al_kwargs) -> ALResult:
    """A fleet of AL-iLQR solves over general stagewise constraints
    (`al_ilqr_fleet_solve`; al_kwargs are its options). Check each
    instance's `.max_violation`."""
    return al_ilqr_fleet_solve(f, get_AB, get_Cs, cost_fn, x0s, u0s, ineq=ineq, eq=eq, cfg=cfg,
                               device=device, **al_kwargs)


def _instance_shards(batched_args, size: int, index: int):
    """Each argument's contiguous shard `index` of `size` along its leading
    (instance) axis; the axis must divide evenly, as under `shard_map`."""
    if not batched_args:
        raise ValueError("a sharded solve needs at least one batched argument")
    shards = []
    for i, a in enumerate(batched_args):
        n = a.shape[0]
        if n % size:
            raise ValueError(f"batched argument {i} has {n} instances, which the mesh axis of "
                             f"size {size} does not divide")
        per = n // size
        shards.append(a[index * per:(index + 1) * per])
    return shards


def sharded_instance_solve(solve_batch_fn: Callable, mesh, *batched_args, axis: str = "data"):
    """Shard a fleet solve over the mesh's instance axis.

    solve_batch_fn(*batched_args) maps leading-axis batches to
    leading-axis results (a tensor, or a tuple, NamedTuple, list or dict
    of them; None entries pass through). Each rank runs it on its
    contiguous shard of every argument, with no cross-instance
    communication, and the results are gathered along the leading axis:
    every rank returns the whole fleet's result, as the JAX call returns
    the global array. The leading axes must be divisible by the axis
    size, and every rank's results must have the same shapes.
    """
    group, size, index = axis_group(mesh, axis)
    out = solve_batch_fn(*_instance_shards(batched_args, size, index))
    leaves, spec = tree_flatten(out)
    pos = [i for i, v in enumerate(leaves) if v is not None]
    for i in pos:
        if not isinstance(leaves[i], torch.Tensor) or leaves[i].ndim == 0:
            raise TypeError("every result of a sharded solve must be a tensor with a leading "
                            f"instance axis; got {type(leaves[i]).__name__} "
                            f"{getattr(leaves[i], 'shape', '')}")
    for i, t in zip(pos, gather_packed([leaves[i] for i in pos], group)):
        leaves[i] = t
    return tree_unflatten(leaves, spec)


def mc_success_rate(success_fn: Callable, mesh, *batched_args, axis: str = "data"):
    """Mesh-reduced Monte-Carlo success rate.

    success_fn(*args) -> (shard_batch,) bool or float per-instance
    successes. With mesh=None, the mean over the whole batch; otherwise
    each rank evaluates its shard and the rate is the all-reduced sum of
    the successes over the all-reduced count (float64), the same on
    every rank. Returns a 0-d tensor.
    """
    if mesh is None:
        return torch.mean(torch.as_tensor(success_fn(*batched_args)).to(torch.float64))
    group, size, index = axis_group(mesh, axis)
    s = torch.as_tensor(success_fn(*_instance_shards(batched_args, size, index)))
    s = s.to(mesh_device(mesh), torch.float64)
    total = all_reduce(torch.stack([s.sum(), torch.tensor(float(s.numel()), dtype=s.dtype,
                                                          device=s.device)]),
                       dist.ReduceOp.SUM, group)
    return total[0] / total[1]
