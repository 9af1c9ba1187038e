"""Batched instance solves (counterpart of
`ilqr_admm_tpu/parallel/batch.py`).

Where the JAX package vmaps a single-instance solver over an instance
axis, each function here runs the port's fleet form of that solver: one
loop over a leading fleet axis F, each instance stopping on its own with
one host read an iteration for the whole fleet. Names and argument order
are the JAX package's, with x0s (F, d) and u0s (F, N, m); `device`
defaults to the CUDA card. The user functions and projections are
single-instance and must work under `torch.func.vmap`.

Not ported yet: `sharded_instance_solve` and `mc_success_rate`, which
need a device mesh (ROADMAP.md, queue 1, the `parallel/` item).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import vmap

from ilqr_admm_tpu_torch.problem import ADMMConfig, ILQRConfig, QuadCost
from ilqr_admm_tpu_torch.solvers.admm import validate_constraint_blocks
from ilqr_admm_tpu_torch.solvers.al_ilqr import ALResult, al_ilqr_fleet_solve
from ilqr_admm_tpu_torch.solvers.batched_ilqr_admm import _admm_fleet, _admm_fleet_anderson
from ilqr_admm_tpu_torch.solvers.boxddp import boxddp_fleet_init, boxddp_fleet_solve
from ilqr_admm_tpu_torch.solvers.ilqr import ILQRState, ilqr_fleet_init, ilqr_fleet_solve
from ilqr_admm_tpu_torch.solvers.lqt import broadcast_rho
from ilqr_admm_tpu_torch.solvers.lqt_admm import dp_operators, dp_sweep
from ilqr_admm_tpu_torch.utils.device import resolve_device
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


@full_f32_matmul()
def batched_lqt_admm_dp(A, B, cost: QuadCost, x0s, project_x: Optional[Callable] = None,
                        project_u: Optional[Callable] = None, rho_x=None, rho_u=None,
                        cfg: ADMMConfig = ADMMConfig(max_iter=200), *, device=None):
    """Solve the same constrained LQT (`lqt_admm_dp`, operator form) from a
    fleet of initial states x0s (F, d).

    The DP x-update's affine operators are built once (their Jacobians do
    not depend on x0, only the constant term does, one row an instance)
    and the fleet's ADMM runs the loop of `ilqr_admm_fleet`: plain, or
    Anderson with cfg.anderson_m > 0. Returns (x (F, N*d), u (F, N*m),
    iters (F,)).
    """
    if cfg.adaptive_rho or cfg.accel:
        raise NotImplementedError(
            "batched_lqt_admm_dp runs the plain and Anderson ADMM loops; adaptive_rho and "
            "accel have no fleet loop yet")
    validate_constraint_blocks(project_x, rho_x, project_u, rho_u)
    device = resolve_device(device)
    A, B, x0s = (torch.as_tensor(t, device=device) for t in (A, B, x0s))
    cost = QuadCost(*(torch.as_tensor(t, device=device) for t in (cost.Q, cost.xd, cost.R)))
    N, d, m = A.shape[0], A.shape[-1], B.shape[-1]
    F, dtype = x0s.shape[0], A.dtype
    kw = dict(dtype=dtype, device=device)
    _, sweep = dp_sweep(A, B, cost, broadcast_rho(rho_x, d, N, dtype, device),
                        broadcast_rho(rho_u, m, N, dtype, device))
    zx, zu = torch.zeros((N * d,), **kw), torch.zeros((N * m,), **kw)
    consts, jac_x, jac_u = dp_operators(sweep, x0s, zx, zu)

    def f_argmin(x, u):
        xv = zx if x is None else x
        uv = zu if u is None else u
        return tuple(c + xv @ Jx.T + uv @ Ju.T
                     for c, Jx, Ju in zip(consts[:2], jac_x[:2], jac_u[:2]))

    loop = _admm_fleet_anderson if cfg.anderson_m > 0 else _admm_fleet
    z_x, z_u = torch.zeros((F, N * d), **kw), torch.zeros((F, N * m), **kw)
    x_x, x_u, *_, iters, _ = loop(
        f_argmin, None if project_x is None else vmap(project_x),
        None if project_u is None else vmap(project_u), (N * d,), (N * m,), cfg, z_x, z_u,
        torch.zeros_like(z_x), torch.zeros_like(z_u),
        torch.ones((F,), dtype=torch.bool, device=device))
    return x_x, x_u, iters


def batched_ilqr_solve(f: Callable, get_AB: Callable, get_Cs: Callable, cost_fn: Callable,
                       x0s, u0s, cfg: ILQRConfig = ILQRConfig(), method: str = "dp", *,
                       device=None) -> ILQRState:
    """A fleet of iLQR solves (multi-start, scenario sampling): x0s (F, d),
    u0s (F, N, m). Returns the fleet state of `ilqr_fleet_solve`."""
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
