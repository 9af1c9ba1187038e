"""Interior-point (log-barrier) iLQR for stagewise conic constraints
(counterpart of `ilqr_admm_tpu/solvers/barrier_ilqr.py`).

Each stagewise cone adds its generalized logarithm to the stage cost,

    elementwise  g(x,u) >= 0           ->  -sum log g_i
    SOC          t(x,u) >= ||v(x,u)||  ->  -log(t^2 - ||v||^2)

and the barrier-augmented problem is solved by the DP iLQR
(`solvers/ilqr.py::ilqr_solve`) along a geometric mu schedule, a Python
loop of solves where the JAX package runs a `lax.scan`. Iterates stay
strictly feasible: an infeasible line-search candidate gives log(<= 0) =
NaN, whose cost `ilqr.nan_to_inf` makes +inf, so it never wins.

The barrier's per-stage gradient and Hessian come from
`torch.func.grad` / `hessian` vmapped over the horizon.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.func import grad, hessian, vmap

from ilqr_admm_tpu_torch.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu_torch.problem import ILQRConfig, SolveStatus
from ilqr_admm_tpu_torch.solvers.ilqr import ILQRState, ilqr_solve
from ilqr_admm_tpu_torch.utils.device import resolve_device
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


def make_barrier(ineq: Optional[Callable] = None, soc: Optional[Callable] = None,
                 eps: float = 0.0) -> Callable:
    """Build a per-stage barrier b(x, u) from cone specs.

    ineq(x, u) -> (k,) residuals, feasible iff all > 0. soc(x, u) -> a
    sequence of (t, v) pairs, feasible iff t > ||v|| (t scalar, v a
    vector; a fixed number of pairs). eps shifts the boundary inward (g >=
    eps).
    """
    if ineq is None and soc is None:
        raise ValueError("make_barrier needs at least one of ineq=/soc=")

    def barrier(x, u):
        b = 0.0
        if ineq is not None:
            b = b - torch.sum(torch.log(ineq(x, u) - eps))
        if soc is not None:
            for t, v in soc(x, u):
                b = b - torch.log((t - eps) ** 2 - torch.sum(v**2))
        return b

    return barrier


def _augment_Cs(get_Cs: Callable, barrier: Callable, mu) -> Callable:
    """Add mu * (gradient, Hessian) of the stagewise barrier to the Taylor
    blocks (model c^T delta + (1/2) delta^T C delta)."""

    def aug(xs, us):
        cts, Cts = get_Cs(xs, us)
        d = xs.shape[-1]

        def per_stage(z):
            return barrier(z[:d], z[d:])

        zs = torch.cat([xs, us], dim=-1)
        return cts + mu * vmap(grad(per_stage))(zs), Cts + mu * vmap(hessian(per_stage))(zs)

    return aug


@full_f32_matmul()
def barrier_ilqr_solve(
    f: Callable,
    get_AB: Callable,
    get_Cs: Callable,
    cost_fn: Callable,
    x0,
    u0,
    barrier: Callable,
    cfg: ILQRConfig = ILQRConfig(max_iter=30),
    mu0: float = 1.0,
    mu_factor: float = 5.0,
    n_barrier: int = 6,
    method: str = "dp",
    riccati: str = "chol",
    *,
    device=None,
) -> ILQRState:
    """Solve min cost s.t. stagewise cones by a log-barrier homotopy:
    n_barrier iLQR solves at mu = mu0 * mu_factor^-i, each from the last.

    u0 must roll out strictly feasibly (a finite barrier); otherwise the
    first solve fails with LINE_SEARCH_FAILED. Returns an ILQRState whose
    cost is the true (barrier-free) cost of the final iterate, iteration
    n_barrier and the status of the last solve. device: where the solve
    runs (default the CUDA card).
    """
    device = resolve_device(device)
    x0, u0 = torch.as_tensor(x0, device=device), torch.as_tensor(u0, device=device)
    mus = mu0 * (mu_factor ** -torch.arange(n_barrier, dtype=x0.dtype, device=device))
    xs, us = rollout_nonlinear(f, x0, u0), u0
    status = int(SolveStatus.RUNNING)
    for mu in mus:
        def aug_cost(xs_, us_, mu=mu):
            return cost_fn(xs_, us_) + mu * vmap(barrier)(xs_, us_).sum()

        c = aug_cost(xs, us)
        st = ILQRState(x_nom=xs, u_nom=us, cost=c, prev_cost=torch.full_like(c, math.inf),
                       iteration=0, status=int(SolveStatus.RUNNING))
        out = ilqr_solve(f, get_AB, _augment_Cs(get_Cs, barrier, mu), aug_cost, st, cfg=cfg,
                         method=method, riccati=riccati)
        xs, us, status = out.x_nom, out.u_nom, out.status
    c = cost_fn(xs, us)
    return ILQRState(x_nom=xs, u_nom=us, cost=c, prev_cost=torch.full_like(c, math.inf),
                     iteration=n_barrier, status=status)
