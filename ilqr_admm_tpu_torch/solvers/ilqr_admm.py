"""Constrained iLQR via ADMM splitting (counterpart of
`ilqr_admm_tpu/solvers/ilqr_admm.py`).

The outer loop relinearizes the dynamics and cost around the nominal; the
inner ADMM's x-update solves the regularized lifted least squares and
line-searches the step, scoring candidates with the augmented (penalty)
cost. z and lambda are warm-started across outer iterations; the outer
loop stops on a small cost change or on oscillation.

The ADMM consensus variables are absolute flattened trajectories
(N*x_dim,) / (N*u_dim,). As in the JAX package, `line_search='inner'`
rolls the alpha grid out in every ADMM iteration, and `'outer'` runs the
ADMM on the linearized prediction with no rollouts and ONE nonlinear
line search an outer step. The candidate rollout is `linesearch_rollout`
when given (the CUDA kernel of `ops/fused_rollout.py` on the main path),
else `torch.func.vmap` of `rollout_nonlinear`.

Each outer iteration ends with one device-to-host read of its stop flags
(`admm.read_flags`), as each ADMM iteration does, unless its tolerances
make every stop test false (all <= 0, as in an MPC tick): then it reads
nothing.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import vmap

from ilqr_admm_tpu_torch.ops.lifted import build_Su
from ilqr_admm_tpu_torch.ops.riccati import ilqr_backward, quad_cost_model
from ilqr_admm_tpu_torch.ops.rollout import rollout_closed_loop, rollout_nonlinear
from ilqr_admm_tpu_torch.ops.sqrt_riccati import ilqr_backward_sqrt
from ilqr_admm_tpu_torch.problem import ADMMConfig, SolveStatus
from ilqr_admm_tpu_torch.solvers.admm import admm_solve, read_flags, validate_constraint_blocks
from ilqr_admm_tpu_torch.solvers.ilqr import nan_to_inf, take
from ilqr_admm_tpu_torch.solvers.lqt import block_diag_stacked, blockdiag_matmul, broadcast_rho
from ilqr_admm_tpu_torch.solvers.lqt_admm import cho_factor, cho_solve
from ilqr_admm_tpu_torch.utils.device import resolve_device
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


class ILQRADMMResult(NamedTuple):
    x_nom: torch.Tensor
    u_nom: torch.Tensor
    cost: torch.Tensor
    outer_iters: int
    status: int  # SolveStatus
    cost_log: torch.Tensor  # (max_iter,) outer-iteration costs (inf beyond)
    # final ADMM consensus/dual state: warm-start the next solve with these
    z_x: torch.Tensor = None
    z_u: torch.Tensor = None
    lmb_x: torch.Tensor = None
    lmb_u: torch.Tensor = None


def _default_alphas(dtype, device):
    return (10.0 ** torch.linspace(0.0, -5.0, 50, dtype=dtype, device=device))[:20]


def _penalty(d, P):
    """sum_a d[a, t]^T P_t d[a, t] for each candidate a: d (A, N, k), P (N, k, k)."""
    return torch.einsum("ati,tij,atj->a", d, P, d)


def outer_can_stop(outer_tol, osc_tol) -> bool:
    """Whether an outer stop test can pass: |cost change| and |window mean
    change| are >= 0 or NaN, so with both tolerances <= 0 (an MPC tick's
    bounded iterations) neither is ever below its tolerance."""
    return outer_tol > 0 or osc_tol > 0


def _outer_status(cost_new, cost, cost_log, it, outer_tol, osc_tol) -> int:
    """CONVERGED on a cost change below outer_tol, OSCILLATING when the
    means of the last two windows of four costs differ by less than
    osc_tol, else RUNNING. The windows are padded with +inf before the
    first cost, so |inf - inf| is NaN and NaN < tol is False, as in the
    JAX package. Without `outer_can_stop` the status is RUNNING, with no
    host read."""
    if not outer_can_stop(outer_tol, osc_tol):
        return SolveStatus.RUNNING
    converged = torch.abs(cost_new - cost) < outer_tol
    recent = torch.cat([torch.full((8,), math.inf, dtype=cost_log.dtype,
                                   device=cost_log.device), cost_log])[it + 1 : it + 9]
    osc = torch.abs(torch.mean(recent[4:]) - torch.mean(recent[:4])) < osc_tol
    conv, oscillating = read_flags(converged, osc)
    if conv:
        return SolveStatus.CONVERGED
    return SolveStatus.OSCILLATING if oscillating else SolveStatus.RUNNING


def _outer_loop(body, cost_fn, x_nom0, u_nom0, warm, max_iter, outer_tol, osc_tol):
    """The outer iteration: body(x_nom, u_nom, z_x, z_u, l_x, l_u) ->
    (x_new, u_new, z_x, z_u, l_x, l_u), stopped by `_outer_status`."""
    N, d = x_nom0.shape
    m = u_nom0.shape[-1]
    kw = dict(dtype=x_nom0.dtype, device=x_nom0.device)
    cost = cost_fn(x_nom0, u_nom0)
    if warm is None:
        warm = (torch.zeros((N * d,), **kw), torch.zeros((N * m,), **kw),
                torch.zeros((N * d,), **kw), torch.zeros((N * m,), **kw))
    z_x, z_u, l_x, l_u = warm
    cost_log = torch.full((max_iter,), math.inf, **kw)
    x_nom, u_nom = x_nom0, u_nom0
    it, status = 0, SolveStatus.RUNNING
    while it < max_iter and status == SolveStatus.RUNNING:
        x_new, u_new, z_x, z_u, l_x, l_u = body(x_nom, u_nom, z_x, z_u, l_x, l_u)
        cost_new = cost_fn(x_new, u_new)
        cost_log[it] = cost_new
        status = _outer_status(cost_new, cost, cost_log, it, outer_tol, osc_tol)
        x_nom, u_nom, cost = x_new, u_new, cost_new
        it += 1
    if status == SolveStatus.RUNNING:
        status = SolveStatus.MAX_ITER
    return ILQRADMMResult(
        x_nom=x_nom, u_nom=u_nom, cost=cost, outer_iters=it, status=int(status),
        cost_log=cost_log, z_x=z_x, z_u=z_u, lmb_x=l_x, lmb_u=l_u,
    )


def _ilqr_admm_impl(
    f: Callable,
    get_AB: Callable,
    cost_fn: Callable,
    x_nom0,
    u_nom0,
    get_Cs: Optional[Callable] = None,
    quad_cost=None,  # QuadCost when the cost is quadratic (get_Cs None)
    project_x: Optional[Callable] = None,
    project_u: Optional[Callable] = None,
    rho_x=None,
    rho_u=None,
    max_iter: int = 20,
    max_admm_iter: int = 20,
    alphas=None,
    alpha: float = 1.0,
    tol: float = 1e-3,
    outer_tol: float = 1e-3,
    osc_tol: float = 1e-3,
    method: str = "batch",
    riccati: str = "chol",
    warm=None,
    unroll: int = 8,
    linesearch_rollout=None,
    line_search: str = "inner",
    anderson_m: int = 0,
) -> ILQRADMMResult:
    validate_constraint_blocks(project_x, rho_x, project_u, rho_u)
    if line_search not in ("inner", "outer"):
        raise ValueError(f"line_search must be 'inner' or 'outer', got {line_search!r}")
    if method == "dp":
        if line_search != "inner":
            raise ValueError(
                "line_search='outer' is only supported with method='batch' "
                "(the dp x-update's line search is closed-loop by design)"
            )
        return _ilqr_admm_dp(
            f, get_AB, cost_fn, x_nom0, u_nom0, get_Cs, quad_cost,
            project_x, project_u, rho_x, rho_u, max_iter, max_admm_iter,
            alphas, alpha, tol, outer_tol, osc_tol, riccati, warm, anderson_m,
        )
    if method != "batch":
        raise ValueError(f"method must be 'dp' or 'batch', got {method!r}")
    N, d = x_nom0.shape
    m = u_nom0.shape[-1]
    dtype, device = x_nom0.dtype, x_nom0.device
    if alphas is None:
        alphas = _default_alphas(dtype, device)

    Qr = broadcast_rho(rho_x, d, N, dtype, device)
    Rr = broadcast_rho(rho_u, m, N, dtype, device)
    Qr_on = Qr is not None and project_x is not None
    Rr_l = block_diag_stacked(Rr) if (Rr is not None and project_u is not None) else None
    admm_cfg = ADMMConfig(max_iter=max_admm_iter, alpha=alpha, tol=tol, anderson_m=anderson_m)

    def rollout(x0, us_c):
        if linesearch_rollout is not None:
            return linesearch_rollout(x0, us_c)
        return vmap(lambda us: rollout_nonlinear(f, x0, us))(us_c)

    def candidates(x_nom, u_nom, delta_u, tx, tu):
        """Roll out u_nom + alpha delta_u for every alpha and return the
        one of least cost plus penalties toward the targets tx (N, d) /
        tu (N, m) (either None)."""
        us_c = u_nom[None] + alphas[:, None, None] * delta_u[None]
        xs_c = rollout(x_nom[0], us_c)
        costs = nan_to_inf(vmap(cost_fn)(xs_c, us_c))
        # the penalties blockwise: the dense (Nd, Nd) form would cost
        # (Nd)^2 a candidate where the blocks need N d^2
        if tx is not None:
            costs = costs + _penalty(xs_c - tx[None], Qr)
        if tu is not None:
            costs = costs + _penalty(us_c - tu[None], Rr)
        ind = torch.argmin(costs)
        return take(xs_c, ind), take(us_c, ind)

    def body(x_nom, u_nom, z_x, z_u, l_x, l_u):
        A, B = get_AB(x_nom, u_nom)
        Su = build_Su(A, B)
        x_nom_f, u_nom_f = x_nom.reshape(-1), u_nom.reshape(-1)
        # Su^T blockdiag(P) as (blockdiag(P^T) Su)^T: the JAX package's
        # dense product, without the (Nd, Nd) operator
        if get_Cs is not None:
            cts, Cts = get_Cs(x_nom, u_nom)
            SuTQ = blockdiag_matmul(0.5 * Cts[:, :d, :d].transpose(-1, -2), Su).T
            l_side = SuTQ @ Su + 0.5 * block_diag_stacked(Cts[:, d:, d:])
            r_side = Su.T @ (-0.5 * cts[:, :d].reshape(-1)) - 0.5 * cts[:, d:].reshape(-1)
        else:
            SuTQ = blockdiag_matmul(quad_cost.Q.transpose(-1, -2), Su).T
            Rlift = block_diag_stacked(quad_cost.R)
            l_side = SuTQ @ Su + Rlift
            r_side = SuTQ @ (quad_cost.lifted_xd() - x_nom_f) + Rlift @ (-u_nom_f)
        SuTQr = None
        if Qr_on:
            SuTQr = blockdiag_matmul(Qr.transpose(-1, -2), Su).T
            l_side = l_side + SuTQr @ Su
        if Rr_l is not None:
            l_side = l_side + Rr_l
        cf = cho_factor(l_side)

        def rhs(x, u):
            add_r = torch.zeros_like(r_side)
            if SuTQr is not None and x is not None:
                add_r = add_r + SuTQr @ (x - x_nom_f)
            if Rr_l is not None and u is not None:
                add_r = add_r + Rr_l @ (u - u_nom_f)
            return r_side + add_r

        def f_argmin(x, u):
            delta_u = cho_solve(cf, rhs(x, u)).reshape(N, m)
            xs, us = candidates(
                x_nom, u_nom, delta_u,
                x.reshape(N, d) if Qr_on and x is not None else None,
                u.reshape(N, m) if Rr_l is not None and u is not None else None,
            )
            return xs.reshape(-1), us.reshape(-1)

        if line_search == "outer":
            # one multi-RHS solve for an explicit inverse, then a GEMV an
            # ADMM iteration (l_side is rho-regularized SPD)
            Minv = cho_solve(cf, torch.eye(N * m, dtype=dtype, device=device))

        def f_argmin_lin(x, u):
            # SQP-style x-update on the linearized prediction, no rollouts
            delta_u = Minv @ rhs(x, u)
            return x_nom_f + Su @ delta_u, u_nom_f + delta_u

        x_x, x_u, _, l_x_n, l_u_n, z_x_n, z_u_n, _info = admm_solve(
            f_argmin if line_search == "inner" else f_argmin_lin,
            project_x, project_u, (N * d,), (N * m,), admm_cfg,
            z_x_init=z_x, z_u_init=z_u, lmb_x_init=l_x, lmb_u_init=l_u,
            dtype=dtype, device=device,
        )
        if line_search == "outer":
            # ONE nonlinear line search globalizes the linear-model step;
            # candidates scored by the true cost plus penalties toward the
            # final consensus targets
            x_new, u_new = candidates(
                x_nom, u_nom, (x_u - u_nom_f).reshape(N, m),
                (z_x_n - l_x_n).reshape(N, d) if Qr_on else None,
                (z_u_n - l_u_n).reshape(N, m) if Rr_l is not None else None,
            )
        else:
            x_new, u_new = x_x.reshape(N, d), x_u.reshape(N, m)
        return x_new, u_new, z_x_n, z_u_n, l_x_n, l_u_n

    return _outer_loop(body, cost_fn, x_nom0, u_nom0, warm, max_iter, outer_tol, osc_tol)


def _ilqr_admm_dp(
    f, get_AB, cost_fn, x_nom0, u_nom0, get_Cs, quad_cost,
    project_x, project_u, rho_x, rho_u, max_iter, max_admm_iter,
    alphas, alpha, tol, outer_tol, osc_tol, riccati="chol", warm=None, anderson_m=0,
) -> ILQRADMMResult:
    """DP (Riccati) x-update iLQR-ADMM: O(N) memory, closed-loop line search."""
    backward = ilqr_backward_sqrt if riccati == "sqrt" else ilqr_backward
    N, d = x_nom0.shape
    m = u_nom0.shape[-1]
    dtype, device = x_nom0.dtype, x_nom0.device
    if alphas is None:
        alphas = _default_alphas(dtype, device)

    Qr = broadcast_rho(rho_x, d, N, dtype, device)
    Rr = broadcast_rho(rho_u, m, N, dtype, device)
    has_x = project_x is not None and Qr is not None
    has_u = project_u is not None and Rr is not None
    admm_cfg = ADMMConfig(max_iter=max_admm_iter, alpha=alpha, tol=tol, anderson_m=anderson_m)

    def body(x_nom, u_nom, z_x, z_u, l_x, l_u):
        A, B = get_AB(x_nom, u_nom)
        if get_Cs is not None:
            cts, Cts = get_Cs(x_nom, u_nom)
        else:
            cts, Cts = quad_cost_model(quad_cost.Q, quad_cost.xd, quad_cost.R, x_nom, u_nom)

        def f_argmin(x, u):
            # augment the quadratic model with the ADMM penalties (delta
            # coordinates around the nominal)
            cts_a, Cts_a = cts.clone(), Cts.clone()
            if has_x and x is not None:
                cts_a[:, :d] += 2.0 * torch.einsum("tij,tj->ti", Qr, x_nom - x.reshape(N, d))
                Cts_a[:, :d, :d] += 2.0 * Qr
            if has_u and u is not None:
                cts_a[:, d:] += 2.0 * torch.einsum("tij,tj->ti", Rr, u_nom - u.reshape(N, m))
                Cts_a[:, d:, d:] += 2.0 * Rr
            K, k = backward(A, B, Cts_a, cts_a)

            def rollout_alpha(a):
                return rollout_closed_loop(f, x_nom[0], K, a * k, x_nom, u_nom)

            xs_c, us_c = vmap(rollout_alpha)(alphas)
            costs = nan_to_inf(vmap(cost_fn)(xs_c, us_c))
            if has_x and x is not None:
                costs = costs + _penalty(xs_c - x.reshape(N, d), Qr)
            if has_u and u is not None:
                costs = costs + _penalty(us_c - u.reshape(N, m), Rr)
            ind = torch.argmin(costs)
            return take(xs_c, ind).reshape(-1), take(us_c, ind).reshape(-1)

        x_x, x_u, _, l_x_n, l_u_n, z_x_n, z_u_n, _info = admm_solve(
            f_argmin, project_x, project_u, (N * d,), (N * m,), admm_cfg,
            z_x_init=z_x, z_u_init=z_u, lmb_x_init=l_x, lmb_u_init=l_u,
            dtype=dtype, device=device,
        )
        return x_x.reshape(N, d), x_u.reshape(N, m), z_x_n, z_u_n, l_x_n, l_u_n

    return _outer_loop(body, cost_fn, x_nom0, u_nom0, warm, max_iter, outer_tol, osc_tol)


def _to_device(x, device):
    return None if x is None else torch.as_tensor(x, device=device)


def ilqr_admm(f, get_AB, cost_fn, x_nom0, u_nom0, *, device=None, **kwargs) -> ILQRADMMResult:
    """Run constrained iLQR-ADMM from a nominal trajectory guess.

    The keyword arguments of the JAX package's `ilqr_admm`: get_Cs or
    quad_cost, project_x / project_u with rho_x / rho_u, max_iter,
    max_admm_iter, alphas, alpha, tol, outer_tol, osc_tol, method ('batch'
    lifted least squares, or 'dp' Riccati with riccati='chol' | 'sqrt'),
    warm (z_x, z_u, lmb_x, lmb_u), linesearch_rollout (an optional
    callable (x0 (d,), u_cands (A, N, m)) -> xs (A, N, d) for the batch
    method, e.g. `ops/fused_rollout.make_fused_linesearch_rollout`),
    line_search ('inner' | 'outer', batch method only) and anderson_m.
    unroll is accepted and has no effect.

    device: where the solve runs (default the CUDA card); x_nom0, u_nom0,
    alphas and warm are moved there. f, get_AB, get_Cs and cost_fn must
    work on that device. Every product runs in full f32 (TF32 off).
    """
    device = resolve_device(device)
    x_nom0, u_nom0 = _to_device(x_nom0, device), _to_device(u_nom0, device)
    kwargs["alphas"] = _to_device(kwargs.get("alphas"), device)
    if kwargs.get("warm") is not None:
        kwargs["warm"] = tuple(_to_device(w, device) for w in kwargs["warm"])
    with full_f32_matmul():
        return _ilqr_admm_impl(f, get_AB, cost_fn, x_nom0, u_nom0, **kwargs)


def _rescale_dual(lmb, rho_old, rho_new, dim, N):
    """Scaled-dual transport across a penalty change: keep the unscaled
    dual y = P lambda continuous, lambda_new = P_new^{-1} P_old lambda_old
    (blockwise)."""
    if rho_old is None or rho_new is None:
        return lmb
    P_old = broadcast_rho(rho_old, dim, N, lmb.dtype, lmb.device)
    P_new = broadcast_rho(rho_new, dim, N, lmb.dtype, lmb.device)
    y = torch.einsum("nij,nj->ni", P_old, lmb.reshape(N, dim))
    return torch.linalg.solve(P_new, y[..., None])[..., 0].reshape(-1)


def ilqr_admm_continuation(f, get_AB, cost_fn, x_nom0, u_nom0, phases, **kwargs) -> ILQRADMMResult:
    """Penalty-continuation iLQR-ADMM: chain solves over a rho schedule.

    phases: a sequence of dicts, each with per-phase overrides (at least
    {'max_iter': ...}, plus any of rho_x, rho_u, max_admm_iter, tol,
    outer_tol, osc_tol). Later phases start from the previous phase's
    nominal and ADMM state, with the scaled duals rescaled so that the
    unscaled duals are continuous across the penalty change. Shared
    settings, device included, go in **kwargs.
    """
    if not phases:
        raise ValueError("phases must be a non-empty sequence of dicts")
    N, d = x_nom0.shape
    m = u_nom0.shape[-1]
    res = prev = None
    x_nom, u_nom = x_nom0, u_nom0
    warm = kwargs.pop("warm", None)
    for ph in phases:
        kw = dict(kwargs)
        kw.update(ph)
        if res is not None:
            lmb_x = _rescale_dual(res.lmb_x, prev.get("rho_x", kwargs.get("rho_x")),
                                  kw.get("rho_x", kwargs.get("rho_x")), d, N)
            lmb_u = _rescale_dual(res.lmb_u, prev.get("rho_u", kwargs.get("rho_u")),
                                  kw.get("rho_u", kwargs.get("rho_u")), m, N)
            warm = (res.z_x, res.z_u, lmb_x, lmb_u)
            x_nom, u_nom = res.x_nom, res.u_nom
        res = ilqr_admm(f, get_AB, cost_fn, x_nom, u_nom, warm=warm, **kw)
        prev = kw
    return res
