"""Constrained iLQR-ADMM over a fleet of instances: the counterpart of
`jax.vmap(ilqr_admm)` (`benchmarks/bench_arm_admm.py`, semantics pinned
by `tests/test_batched_ilqr_admm.py`).

`ilqr_admm` (`solvers/ilqr_admm.py`) is a host loop that reads its stop
flags after each outer step and each ADMM iteration, so it cannot be
vmapped. Here one solve carries a leading fleet axis F through the same
loops, as a vmapped `while_loop` does: the outer loop runs while any
instance is RUNNING, the inner ADMM while any instance taking part in it
is; an instance that has left keeps its carry (`torch.where` on its own
mask), and an instance whose outer loop has ended takes no part in later
inner loops. Each instance keeps its own residual norms and stop tests
(`admm.stop_tests`, the single-instance rules). One host read of a flag
serves the whole fleet: a solve counts one read an outer step and one an
ADMM iteration, as many as its slowest instance alone would, whatever F.

The x-update runs batched over the fleet: `get_AB` vmapped, `build_Su`
vmapped, the normal equations with Su^T Q blockwise, one batched
Cholesky of (F, N*m, N*m) and batched solves. The inner line search
rolls the (F, A, N, m) candidates out as one time loop of the vmapped
step over F*A rows. `line_search='outer'` keeps the explicit inverse a
fleet, (F, N*m, N*m), and runs one line search an outer step.

Three `torch.profiler` ranges split a solve's time: PROFILE_LINEARIZE
(linearization, normal equations, Cholesky and, in the outer mode, the
inverse), PROFILE_ADMM (each ADMM iteration) and PROFILE_ROLLOUT (each
line search: rollout, costs and argmin; inside PROFILE_ADMM in the inner
mode).

Not ported to the fleet yet (ROADMAP.md, queue 1): method='dp',
anderson_m > 0 and a fused `linesearch_rollout`.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.func import vmap
from torch.profiler import record_function

from ilqr_admm_tpu_torch.ops.lifted import build_Su
from ilqr_admm_tpu_torch.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu_torch.problem import ADMMConfig, SolveStatus
from ilqr_admm_tpu_torch.solvers.admm import read_flags, stop_tests, validate_constraint_blocks
from ilqr_admm_tpu_torch.solvers.ilqr import nan_to_inf
from ilqr_admm_tpu_torch.solvers.ilqr_admm import ILQRADMMResult, _default_alphas, _to_device
from ilqr_admm_tpu_torch.solvers.lqt import block_diag_stacked, broadcast_rho
from ilqr_admm_tpu_torch.solvers.lqt_admm import cho_factor
from ilqr_admm_tpu_torch.utils.device import resolve_device
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul

PROFILE_LINEARIZE = "ilqr_admm_fleet.linearize"
PROFILE_ADMM = "ilqr_admm_fleet.admm_iteration"
PROFILE_ROLLOUT = "ilqr_admm_fleet.rollout"


def _keep(mask, new, old):
    """new where the instance's mask is set, else old: mask (F,)."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


def _norm(r):
    """Each instance's 2-norm: (F, ...) -> (F,)."""
    return torch.sqrt(torch.sum(r * r, dim=tuple(range(1, r.ndim))))


def _bd_matmul(blocks, M):
    """block_diag(blocks) @ M for each instance: blocks (N, d, d) shared or
    (F, N, d, d), M (F, N*d, k)."""
    N, d = blocks.shape[-3], blocks.shape[-1]
    F, k = M.shape[0], M.shape[-1]
    eq = "tij,ftjk->ftik" if blocks.ndim == 3 else "ftij,ftjk->ftik"
    return torch.einsum(eq, blocks, M.reshape(F, N, d, k)).reshape(F, N * d, k)


def _block_diag(blocks):
    """Each instance's dense block-diagonal: (F, N, e, e) -> (F, N*e, N*e)."""
    F, N, e, _ = blocks.shape
    out = blocks.new_zeros((F, N, e, N, e))
    idx = torch.arange(N, device=blocks.device)
    out[:, idx, :, idx, :] = blocks.transpose(0, 1)  # the indexed axes come first
    return out.reshape(F, N * e, N * e)


def _mv(M, v):
    """M @ v for each instance: M (F, n, k) or (n, k), v (F, k) -> (F, n)."""
    return (M @ v[..., None])[..., 0]


def _cho_solve(U, rhs):
    """Solve with each instance's upper Cholesky factor: U (F, n, n), rhs (F, n)."""
    return torch.cholesky_solve(rhs[..., None], U, upper=True)[..., 0]


def _admm_fleet(f_argmin, project_x, project_u, shape_x, shape_u, cfg: ADMMConfig, z_x, z_u,
                lmb_x, lmb_u, part):
    """The plain branch of `admm.admm_solve` for each instance of a fleet.

    part (F,): the instances that take part. Each iterates until its own
    stop (converged, stalled or cfg.max_iter) and then keeps its carry;
    the loop ends when none is left, after one host read an iteration.
    Returns (x_x, x_u, lmb_x, lmb_u, z_x, z_u, iters (F,), the fleet's
    iteration count).
    """
    has_x, has_u = project_x is not None, project_u is not None
    F = part.shape[0]
    kw = dict(dtype=z_u.dtype, device=z_u.device)
    out = (torch.zeros((F,) + tuple(shape_x), **kw), torch.zeros((F,) + tuple(shape_u), **kw))
    prim = torch.full((F,), 1e6, **kw)
    dual = torch.full((F,), 1e6, **kw)
    zero = torch.zeros((F,), **kw)
    iters = torch.zeros((F,), dtype=torch.int64, device=part.device)
    live = part
    k, running = 0, True
    while k < cfg.max_iter and running:
        with record_function(PROFILE_ADMM):
            out_new = f_argmin(z_x - lmb_x if has_x else None, z_u - lmb_u if has_u else None)
            x_x, x_u = out_new
            prim_new, dual_new = zero, zero
            if has_x:
                z_x_new = project_x(cfg.alpha * x_x + (1.0 - cfg.alpha) * z_x + lmb_x)
                r_x = x_x - z_x_new
                prim_new = prim_new + _norm(r_x)
                dual_new = dual_new + _norm(z_x_new - z_x)
                z_x, lmb_x = _keep(live, z_x_new, z_x), _keep(live, lmb_x + r_x, lmb_x)
            if has_u:
                z_u_new = project_u(cfg.alpha * x_u + (1.0 - cfg.alpha) * z_u + lmb_u)
                r_u = x_u - z_u_new
                prim_new = prim_new + _norm(r_u)
                dual_new = dual_new + _norm(z_u_new - z_u)
                z_u, lmb_u = _keep(live, z_u_new, z_u), _keep(live, lmb_u + r_u, lmb_u)
            converged, stalled = stop_tests(prim, dual, prim_new, dual_new, cfg)
            out = tuple(_keep(live, n, o) for n, o in zip(out_new, out))
            prim, dual = _keep(live, prim_new, prim), _keep(live, dual_new, dual)
            iters = iters + live.to(iters.dtype)
            live = live & ~(converged | stalled) & (iters < cfg.max_iter)
            k += 1
            (running,) = read_flags(torch.any(live))
    return out[0], out[1], lmb_x, lmb_u, z_x, z_u, iters, k


def _fleet_impl(f, get_AB, cost_fn, x_nom0, u_nom0, get_Cs=None, quad_cost=None,
                project_x=None, project_u=None, rho_x=None, rho_u=None, max_iter=20,
                max_admm_iter=20, alphas=None, alpha=1.0, tol=1e-3, outer_tol=1e-3,
                osc_tol=1e-3, method="batch", riccati="chol", warm=None, unroll=8,
                linesearch_rollout=None, line_search="inner", anderson_m=0, stats=None):
    validate_constraint_blocks(project_x, rho_x, project_u, rho_u)
    if line_search not in ("inner", "outer"):
        raise ValueError(f"line_search must be 'inner' or 'outer', got {line_search!r}")
    if method not in ("batch", "dp"):
        raise ValueError(f"method must be 'dp' or 'batch', got {method!r}")
    for name, unsupported in (("method='dp'", method == "dp"), ("anderson_m > 0", anderson_m > 0),
                              ("linesearch_rollout", linesearch_rollout is not None)):
        if unsupported:
            raise NotImplementedError(
                f"ilqr_admm_fleet does not run {name} yet (ROADMAP.md, queue 1); "
                f"solve the instances one by one with ilqr_admm")
    F, N, d = x_nom0.shape
    m = u_nom0.shape[-1]
    dtype, device = x_nom0.dtype, x_nom0.device
    kw = dict(dtype=dtype, device=device)
    if alphas is None:
        alphas = _default_alphas(dtype, device)
    Qr = broadcast_rho(rho_x, d, N, dtype, device)
    Rr = broadcast_rho(rho_u, m, N, dtype, device)
    Qr_on = Qr is not None and project_x is not None
    Rr_l = block_diag_stacked(Rr) if (Rr is not None and project_u is not None) else None
    cfg = ADMMConfig(max_iter=max_admm_iter, alpha=alpha, tol=tol)
    fleet_cost = vmap(cost_fn)

    def candidates(x_nom, u_nom, delta_u, tx, tu):
        """Roll out u_nom + alpha delta_u for every instance and alpha, and
        keep each instance's candidate of least cost plus penalties toward
        its targets tx (F, N, d) / tu (F, N, m) (either None)."""
        with record_function(PROFILE_ROLLOUT):
            us_c = u_nom[:, None] + alphas[None, :, None, None] * delta_u[:, None]  # (F, A, N, m)
            n_a = us_c.shape[1]
            x0s = x_nom[:, None, 0].expand(F, n_a, d).reshape(F * n_a, d)
            xs_c = vmap(lambda x0, us: rollout_nonlinear(f, x0, us))(
                x0s, us_c.reshape(F * n_a, N, m)).reshape(F, n_a, N, d)
            costs = nan_to_inf(vmap(fleet_cost)(xs_c, us_c))  # (F, A)
            if tx is not None:
                dx = xs_c - tx[:, None]
                costs = costs + torch.einsum("fati,tij,fatj->fa", dx, Qr, dx)
            if tu is not None:
                du = us_c - tu[:, None]
                costs = costs + torch.einsum("fati,tij,fatj->fa", du, Rr, du)
            ind = torch.argmin(costs, dim=1)
            rows = torch.arange(F, device=device)
            return xs_c[rows, ind], us_c[rows, ind]

    def linearize(x_nom, u_nom):
        """Each instance's lifted normal equations around its nominal:
        (upper Cholesky factor, Su, SuTQr or None, r_side, the explicit
        inverse in the outer mode or None)."""
        A, B = vmap(get_AB)(x_nom, u_nom)
        Su = vmap(build_Su)(A, B)  # (F, N*d, N*m)
        x_nom_f, u_nom_f = x_nom.reshape(F, -1), u_nom.reshape(F, -1)
        # Su^T blockdiag(P) as (blockdiag(P^T) Su)^T, without the (Nd, Nd)
        # operator, as `ilqr_admm` forms it
        if get_Cs is not None:
            cts, Cts = vmap(get_Cs)(x_nom, u_nom)
            SuTQ = _bd_matmul(0.5 * Cts[..., :d, :d].transpose(-1, -2), Su).transpose(-1, -2)
            l_side = SuTQ @ Su + 0.5 * _block_diag(Cts[..., d:, d:])
            r_side = (_mv(Su.transpose(-1, -2), -0.5 * cts[..., :d].reshape(F, -1))
                      - 0.5 * cts[..., d:].reshape(F, -1))
        else:
            SuTQ = _bd_matmul(quad_cost.Q.transpose(-1, -2), Su).transpose(-1, -2)
            Rlift = block_diag_stacked(quad_cost.R)
            l_side = SuTQ @ Su + Rlift
            r_side = _mv(SuTQ, quad_cost.lifted_xd() - x_nom_f) + _mv(Rlift, -u_nom_f)
        SuTQr = None
        if Qr_on:
            SuTQr = _bd_matmul(Qr.transpose(-1, -2), Su).transpose(-1, -2)
            l_side = l_side + SuTQr @ Su
        if Rr_l is not None:
            l_side = l_side + Rr_l
        cf = cho_factor(l_side)
        Minv = None
        if line_search == "outer":
            # one multi-RHS solve for each instance's explicit inverse, then
            # a batched GEMV an ADMM iteration
            eye = torch.eye(N * m, **kw).expand(F, N * m, N * m)
            Minv = torch.cholesky_solve(eye, cf, upper=True)
        return cf, Su, SuTQr, r_side, Minv

    def body(x_nom, u_nom, z_x, z_u, l_x, l_u, active):
        with record_function(PROFILE_LINEARIZE):
            cf, Su, SuTQr, r_side, Minv = linearize(x_nom, u_nom)
        x_nom_f, u_nom_f = x_nom.reshape(F, -1), u_nom.reshape(F, -1)

        def rhs(x, u):
            add_r = torch.zeros_like(r_side)
            if SuTQr is not None and x is not None:
                add_r = add_r + _mv(SuTQr, x - x_nom_f)
            if Rr_l is not None and u is not None:
                add_r = add_r + _mv(Rr_l, u - u_nom_f)
            return r_side + add_r

        def f_argmin(x, u):
            delta_u = _cho_solve(cf, rhs(x, u)).reshape(F, N, m)
            xs, us = candidates(
                x_nom, u_nom, delta_u,
                x.reshape(F, N, d) if Qr_on and x is not None else None,
                u.reshape(F, N, m) if Rr_l is not None and u is not None else None,
            )
            return xs.reshape(F, -1), us.reshape(F, -1)

        def f_argmin_lin(x, u):
            delta_u = _mv(Minv, rhs(x, u))
            return x_nom_f + _mv(Su, delta_u), u_nom_f + delta_u

        x_x, x_u, l_x_n, l_u_n, z_x_n, z_u_n, iters, n_iter = _admm_fleet(
            f_argmin if line_search == "inner" else f_argmin_lin,
            project_x, project_u, (N * d,), (N * m,), cfg, z_x, z_u, l_x, l_u, active)
        if line_search == "outer":
            x_new, u_new = candidates(
                x_nom, u_nom, (x_u - u_nom_f).reshape(F, N, m),
                (z_x_n - l_x_n).reshape(F, N, d) if Qr_on else None,
                (z_u_n - l_u_n).reshape(F, N, m) if Rr_l is not None else None,
            )
        else:
            x_new, u_new = x_x.reshape(F, N, d), x_u.reshape(F, N, m)
        return x_new, u_new, z_x_n, z_u_n, l_x_n, l_u_n, iters, n_iter

    # the outer loop of `ilqr_admm._outer_loop`, an instance a row
    cost = fleet_cost(x_nom0, u_nom0)
    if warm is None:
        warm = (torch.zeros((F, N * d), **kw), torch.zeros((F, N * m), **kw),
                torch.zeros((F, N * d), **kw), torch.zeros((F, N * m), **kw))
    z_x, z_u, l_x, l_u = warm
    cost_log = torch.full((F, max_iter), math.inf, **kw)
    pad = torch.full((F, 8), math.inf, **kw)
    outer_iters = torch.zeros((F,), dtype=torch.int64, device=device)
    admm_iters = torch.zeros((F,), dtype=torch.int64, device=device)
    status = torch.full((F,), int(SolveStatus.RUNNING), dtype=torch.int64, device=device)
    active = status == SolveStatus.RUNNING
    x_nom, u_nom = x_nom0, u_nom0
    k, fleet_admm_iters, running = 0, 0, True
    while k < max_iter and running:
        x_new, u_new, z_x_n, z_u_n, l_x_n, l_u_n, iters, n_iter = body(
            x_nom, u_nom, z_x, z_u, l_x, l_u, active)
        fleet_admm_iters += n_iter
        cost_new = fleet_cost(x_new, u_new)
        cost_log[:, k] = torch.where(active, cost_new, cost_log[:, k])
        # CONVERGED on a small cost change, OSCILLATING when the means of the
        # last two windows of four costs differ by less than osc_tol (as in
        # `ilqr_admm._outer_status`; the +inf padding makes early windows NaN)
        converged = torch.abs(cost_new - cost) < outer_tol
        recent = torch.cat([pad, cost_log], dim=1)[:, k + 1 : k + 9]
        osc = torch.abs(torch.mean(recent[:, 4:], 1) - torch.mean(recent[:, :4], 1)) < osc_tol
        new_status = torch.where(converged, int(SolveStatus.CONVERGED),
                                 torch.where(osc, int(SolveStatus.OSCILLATING),
                                             int(SolveStatus.RUNNING)))
        status = torch.where(active, new_status, status)
        x_nom, u_nom = _keep(active, x_new, x_nom), _keep(active, u_new, u_nom)
        cost = torch.where(active, cost_new, cost)
        z_x, z_u = _keep(active, z_x_n, z_x), _keep(active, z_u_n, z_u)
        l_x, l_u = _keep(active, l_x_n, l_x), _keep(active, l_u_n, l_u)
        outer_iters = outer_iters + active.to(outer_iters.dtype)
        admm_iters = admm_iters + iters
        active = status == SolveStatus.RUNNING
        k += 1
        (running,) = read_flags(torch.any(active))
    status = torch.where(active, int(SolveStatus.MAX_ITER), status)
    if stats is not None:
        stats.update(outer_steps=k, fleet_admm_iters=fleet_admm_iters, admm_iters=admm_iters)
    return ILQRADMMResult(
        x_nom=x_nom, u_nom=u_nom, cost=cost, outer_iters=outer_iters, status=status,
        cost_log=cost_log, z_x=z_x, z_u=z_u, lmb_x=l_x, lmb_u=l_u,
    )


def ilqr_admm_fleet(f: Callable, get_AB: Callable, cost_fn: Callable, x_nom0, u_nom0, *,
                    device=None, stats: Optional[dict] = None, **kwargs) -> ILQRADMMResult:
    """Run constrained iLQR-ADMM on a fleet of instances at once.

    x_nom0 (F, N, d), u_nom0 (F, N, m): each instance's nominal guess.
    f, get_AB, get_Cs and cost_fn are the single-instance functions of
    `ilqr_admm`; they are vmapped over the fleet (and f over the line
    search's candidates), so they must work under `torch.func.vmap`.
    quad_cost, rho_x, rho_u and alphas are shared by the fleet.
    project_x / project_u take the fleet's rows, (F, N*d) / (F, N*m),
    and project each row (an elementwise clamp does).

    The other keyword arguments are those of `ilqr_admm`: max_iter,
    max_admm_iter, alpha, tol, outer_tol, osc_tol, method='batch', warm
    (z_x, z_u, lmb_x, lmb_u, each with the fleet axis) and line_search
    ('inner' | 'outer'). method='dp', anderson_m > 0 and
    linesearch_rollout raise NotImplementedError.

    Per instance it computes what `ilqr_admm` computes. The result's
    fields carry the fleet axis: x_nom (F, N, d), u_nom (F, N, m), cost
    (F,), outer_iters (F,) and status (F,) int64 tensors, cost_log (F,
    max_iter), z_x ... (F, N*dim). stats: a dict, if given, receives
    outer_steps and fleet_admm_iters (the fleet's iterations, each a host
    read) and admm_iters (F,), each instance's own ADMM iterations.

    device: where the solve runs (default the CUDA card); x_nom0, u_nom0,
    alphas and warm are moved there. Every product runs in full f32.
    """
    device = resolve_device(device)
    x_nom0, u_nom0 = _to_device(x_nom0, device), _to_device(u_nom0, device)
    kwargs["alphas"] = _to_device(kwargs.get("alphas"), device)
    if kwargs.get("warm") is not None:
        kwargs["warm"] = tuple(_to_device(w, device) for w in kwargs["warm"])
    with full_f32_matmul():
        return _fleet_impl(f, get_AB, cost_fn, x_nom0, u_nom0, stats=stats, **kwargs)
