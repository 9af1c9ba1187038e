"""Augmented-Lagrangian iLQR for general stagewise constraints, state
and control, inequality and equality (counterpart of
`ilqr_admm_tpu/solvers/al_ilqr.py`).

PHR augmented Lagrangian:

    inequality g(x,u) <= 0:  (1/(2 mu)) * (max(0, lam + mu g)^2 - lam^2)
    equality   h(x,u)  = 0:  lam h + (mu/2) h^2

n_al stages, each an iLQR solve of the smooth subproblem
(`solvers/ilqr.py`) followed by the first-order multiplier updates lam <-
max(0, lam + mu g), lam <- lam + mu h and geometric growth of mu while
the max violation exceeds tol_con. The JAX package runs the stages as a
`lax.scan`; here they are a Python loop. Constraint derivatives come from
`torch.func` per stage, vmapped over the horizon.

`al_ilqr_fleet_solve` runs the same stages for a fleet of instances, the
counterpart of `jax.vmap(al_ilqr_solve)`: each stage is one
`ilqr_fleet_solve` with each instance's multipliers and mu as its
per-instance arguments, and the updates vmapped, so every instance grows
its own mu.

Constraints are c(x, u) or c(x, u, t). Under vmap the stage index t is a
0-d tensor, so a time-varying constraint selects with `torch.where`, not
a Python `if`.
"""

from __future__ import annotations

import inspect
import math
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import grad, hessian, jacfwd, vmap

from ilqr_admm_tpu_torch.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu_torch.problem import ILQRConfig, SolveStatus
from ilqr_admm_tpu_torch.solvers.ilqr import (
    ILQRState,
    fleet_state,
    ilqr_fleet_solve,
    ilqr_solve,
)
from ilqr_admm_tpu_torch.utils.device import resolve_device
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


class ALResult(NamedTuple):
    x_nom: torch.Tensor  # (N, d)
    u_nom: torch.Tensor  # (N, m)
    cost: torch.Tensor  # true (unpenalized) cost of the final iterate
    max_violation: torch.Tensor  # max over stages of max(g, |h|)
    lam_ineq: Optional[torch.Tensor]  # (N, k_g) final multipliers
    lam_eq: Optional[torch.Tensor]  # (N, k_h)
    status: object  # SolveStatus of the last inner solve ((F,) tensor for a fleet)


def _al_penalty(g_ineq, lam_g, h_eq, lam_h, mu):
    pen = 0.0
    if g_ineq is not None:
        a = torch.clamp(lam_g + mu * g_ineq, min=0.0)
        pen = pen + torch.sum(a**2 - lam_g**2) / (2.0 * mu)
    if h_eq is not None:
        pen = pen + torch.sum(lam_h * h_eq) + 0.5 * mu * torch.sum(h_eq**2)
    return pen


def _violation(g, h, like):
    """max over stages of max(g, 0) and |h|."""
    v = torch.zeros((), dtype=like.dtype, device=like.device)
    if g is not None:
        v = torch.maximum(v, torch.amax(torch.clamp(g, min=0.0)))
    if h is not None:
        v = torch.maximum(v, torch.amax(torch.abs(h)))
    return v


def _with_t(c):
    """c(x, u) or c(x, u, t) as c(x, u, t)."""
    if c is None or len(inspect.signature(c).parameters) >= 3:
        return c
    return lambda x, u, t: c(x, u)


class _ALProblem:
    """The single-instance pieces of the AL method, written so that the
    fleet can vmap them. The multipliers travel as a tuple `lams` holding
    lam_g and/or lam_h, whichever constraint kinds are given, in that
    order; `params` is lams + (mu,)."""

    def __init__(self, cost_fn, get_Cs, ineq, eq, N, gauss_newton, device):
        self.cost_fn, self.get_Cs = cost_fn, get_Cs
        self.ineq, self.eq = _with_t(ineq), _with_t(eq)
        self.gauss_newton = gauss_newton
        self.ts = torch.arange(N, device=device)

    def split(self, lams):
        """(lam_g or None, lam_h or None) from the tuple."""
        it = iter(lams)
        return (None if self.ineq is None else next(it)), (None if self.eq is None else next(it))

    def zeros(self, x0, u0):
        """Zero multipliers, sized by one call of each constraint at stage 0."""
        N = self.ts.shape[0]
        return tuple(torch.zeros((N, c(x0, u0[0], self.ts[0]).shape[0]), dtype=x0.dtype,
                                 device=x0.device) for c in (self.ineq, self.eq) if c is not None)

    def residuals(self, xs, us):
        g = None if self.ineq is None else vmap(self.ineq)(xs, us, self.ts)
        h = None if self.eq is None else vmap(self.eq)(xs, us, self.ts)
        return g, h

    def violation(self, xs, us):
        return _violation(*self.residuals(xs, us), xs)

    def aug_cost(self, xs, us, *params):
        *lams, mu = params
        lam_g, lam_h = self.split(lams)
        g, h = self.residuals(xs, us)
        return self.cost_fn(xs, us) + _al_penalty(g, lam_g, h, lam_h, mu)

    def aug_Cs(self, xs, us, *params):
        *lams, mu = params
        lam_g, lam_h = self.split(lams)
        ineq, eq = self.ineq, self.eq
        cts, Cts = self.get_Cs(xs, us)
        d = xs.shape[-1]
        zs = torch.cat([xs, us], dim=-1)
        stage = [t for t in (lam_g, lam_h) if t is not None]

        if not self.gauss_newton:
            def ps(z, t, *ab):
                a, b = self.split(ab)
                x, u = z[:d], z[d:]
                g = None if ineq is None else ineq(x, u, t)
                h = None if eq is None else eq(x, u, t)
                return _al_penalty(g, a, h, b, mu)

            grads = vmap(grad(ps))(zs, self.ts, *stage)
            hesss = vmap(hessian(ps))(zs, self.ts, *stage)
            return cts + grads, Cts + hesss

        # Gauss-Newton penalty curvature: the exact gradient J' a without
        # the a_i * grad^2 c_i term, so mu J' D J stays PSD on nonconvex
        # constraints (keep-out sets), where the exact Hessian is
        # indefinite and stalls the line search
        def gn_one(z, t, *ab):
            a_lam, b_lam = self.split(ab)
            grad_ = torch.zeros_like(z)
            hess = torch.zeros((z.shape[0], z.shape[0]), dtype=z.dtype, device=z.device)
            if ineq is not None:
                def cg(zz):
                    return ineq(zz[:d], zz[d:], t)

                g = cg(z)
                Jg = jacfwd(cg)(z).to(z.dtype)
                a = torch.clamp(a_lam + mu * g, min=0.0)
                grad_ = grad_ + Jg.T @ a
                hess = hess + mu * (Jg.T * (a > 0.0).to(z.dtype)) @ Jg
            if eq is not None:
                def ch(zz):
                    return eq(zz[:d], zz[d:], t)

                h = ch(z)
                Jh = jacfwd(ch)(z).to(z.dtype)
                grad_ = grad_ + Jh.T @ (b_lam + mu * h)
                hess = hess + mu * Jh.T @ Jh
            return grad_, hess

        grads, hesss = vmap(gn_one)(zs, self.ts, *stage)
        return cts + grads, Cts + hesss

    def update(self, xs, us, *params, mu_factor, mu_max, tol_con):
        """New multipliers and mu after a stage that ended at (xs, us)."""
        *lams, mu = params
        lam_g, lam_h = self.split(lams)
        g, h = self.residuals(xs, us)
        new = []
        if g is not None:
            new.append(torch.clamp(lam_g + mu * g, min=0.0))
        if h is not None:
            new.append(lam_h + mu * h)
        # grow the penalty only while constraints are materially violated
        viol = _violation(g, h, xs)
        mu = torch.where(viol > tol_con, torch.clamp(mu * mu_factor, max=mu_max), mu)
        return (*new, mu)


def _al_stages(prob, xs, us, params, n_al, solve, over, **update):
    """The n_al stages: solve(xs, us, params) -> (xs, us, status), then
    the multiplier and penalty update, through `over` (the identity, or
    vmap for a fleet). Returns (xs, us, params, status)."""
    def upd(xs_, us_, *p):
        return prob.update(xs_, us_, *p, **update)

    status = int(SolveStatus.RUNNING)
    for _ in range(n_al):
        xs, us, status = solve(xs, us, params)
        params = over(upd)(xs, us, *params)
    return xs, us, params, status


def _start(ineq, eq, u0s):
    if ineq is None and eq is None:
        raise ValueError("al_ilqr_solve needs at least one of ineq=/eq=")
    # u_{N-1} moves no state inside the horizon and DP leaves its gains
    # zero, so the inner solves can never move it off an infeasible value;
    # with R positive definite its stage-optimal value is 0 (a copy: the
    # caller's tensor is left as it is)
    u0s = u0s.clone()
    u0s[..., -1, :] = 0.0
    return u0s


def _result(prob, xs, us, params, status, over):
    lam_g, lam_h = prob.split(params[:-1])
    return ALResult(x_nom=xs, u_nom=us, cost=over(prob.cost_fn)(xs, us),
                    max_violation=over(prob.violation)(xs, us), lam_ineq=lam_g, lam_eq=lam_h,
                    status=status)


@full_f32_matmul()
def al_ilqr_solve(
    f: Callable,
    get_AB: Callable,
    get_Cs: Callable,
    cost_fn: Callable,
    x0,
    u0,
    ineq: Optional[Callable] = None,
    eq: Optional[Callable] = None,
    cfg: ILQRConfig = ILQRConfig(max_iter=30),
    n_al: int = 10,
    mu0: float = 1.0,
    mu_factor: float = 5.0,
    mu_max: float = 1e8,
    tol_con: float = 1e-6,
    method: str = "dp",
    riccati: str = "chol",
    gauss_newton: bool = True,
    *,
    device=None,
) -> ALResult:
    """Solve min cost s.t. stagewise ineq(x,u[,t]) <= 0, eq(x,u[,t]) = 0.

    ineq/eq return fixed-size residual vectors (at least one must be
    given); a 3-argument signature also receives the stage index t. mu
    grows by mu_factor (to mu_max) after each stage whose max violation
    exceeds tol_con. gauss_newton=True (the default) takes the PSD
    Gauss-Newton penalty curvature mu J' D J, needed on nonconvex
    constraints; False the exact Hessian. device: where the solve runs
    (default the CUDA card).
    """
    device = resolve_device(device)
    x0 = torch.as_tensor(x0, device=device)
    u0 = _start(ineq, eq, torch.as_tensor(u0, device=device))
    prob = _ALProblem(cost_fn, get_Cs, ineq, eq, u0.shape[0], gauss_newton, device)
    xs = rollout_nonlinear(f, x0, u0)
    params = prob.zeros(x0, u0) + (torch.tensor(mu0, dtype=x0.dtype, device=device),)

    def solve(xs, us, params):
        def ac(xs_, us_):
            return prob.aug_cost(xs_, us_, *params)

        def aC(xs_, us_):
            return prob.aug_Cs(xs_, us_, *params)

        c = ac(xs, us)
        st = ILQRState(x_nom=xs, u_nom=us, cost=c, prev_cost=torch.full_like(c, math.inf),
                       iteration=0, status=int(SolveStatus.RUNNING))
        out = ilqr_solve(f, get_AB, aC, ac, st, cfg=cfg, method=method, riccati=riccati)
        return out.x_nom, out.u_nom, out.status

    xs, us, params, status = _al_stages(prob, xs, u0, params, n_al, solve, lambda fn: fn,
                                        mu_factor=mu_factor, mu_max=mu_max, tol_con=tol_con)
    return _result(prob, xs, us, params, status, lambda fn: fn)


@full_f32_matmul()
def al_ilqr_fleet_solve(
    f: Callable,
    get_AB: Callable,
    get_Cs: Callable,
    cost_fn: Callable,
    x0s,
    u0s,
    ineq: Optional[Callable] = None,
    eq: Optional[Callable] = None,
    cfg: ILQRConfig = ILQRConfig(max_iter=30),
    n_al: int = 10,
    mu0: float = 1.0,
    mu_factor: float = 5.0,
    mu_max: float = 1e8,
    tol_con: float = 1e-6,
    method: str = "dp",
    riccati: str = "chol",
    gauss_newton: bool = True,
    *,
    device=None,
    stats: dict | None = None,
) -> ALResult:
    """`al_ilqr_solve` of each instance of a fleet: x0s (F, d), u0s (F, N,
    m). Each stage is one `ilqr_fleet_solve` (one host read an inner
    iteration for the whole fleet: at most n_al * cfg.max_iter a solve;
    stats= receives its counts, summed over the stages). Every field
    of the result has a leading F axis; status is (F,). The user functions
    are single-instance and must work under vmap."""
    device = resolve_device(device)
    x0s = torch.as_tensor(x0s, device=device)
    u0s = _start(ineq, eq, torch.as_tensor(u0s, device=device))
    prob = _ALProblem(cost_fn, get_Cs, ineq, eq, u0s.shape[1], gauss_newton, device)
    xs = vmap(rollout_nonlinear, in_dims=(None, 0, 0))(f, x0s, u0s)
    F = x0s.shape[0]
    params = tuple(z.expand((F,) + z.shape).clone() for z in prob.zeros(x0s[0], u0s[0]))
    params += (torch.full((F,), mu0, dtype=x0s.dtype, device=device),)

    def solve(xs, us, params):
        st = fleet_state(xs, us, vmap(prob.aug_cost)(xs, us, *params))
        out = ilqr_fleet_solve(f, get_AB, prob.aug_Cs, prob.aug_cost, st, cfg=cfg, method=method,
                               riccati=riccati, args=params, stats=stats)
        return out.x_nom, out.u_nom, out.status

    xs, us, params, status = _al_stages(prob, xs, u0s, params, n_al, solve, vmap,
                                        mu_factor=mu_factor, mu_max=mu_max, tol_con=tol_con)
    return _result(prob, xs, us, params, status, vmap)
