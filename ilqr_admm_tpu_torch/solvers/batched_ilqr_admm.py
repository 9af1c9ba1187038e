"""Constrained iLQR-ADMM over a fleet of instances: the counterpart of
`jax.vmap(ilqr_admm)` (`benchmarks/bench_arm_admm.py`, semantics pinned
by `tests/test_batched_ilqr_admm.py`).

`ilqr_admm` (`solvers/ilqr_admm.py`) is a host loop that reads its stop
flags after each outer step and each ADMM iteration, so it cannot be
vmapped. Here one solve carries a leading fleet axis F through the same
loops, as a vmapped `while_loop` does: the outer loop runs while any
instance is RUNNING, the inner ADMM (`admm.admm_fleet`, the loop of
`admm_solve` with the fleet axis) while any instance taking part in it
is; an instance that has left keeps its carry (`torch.where` on its own
mask), and an instance whose outer loop has ended takes no part in later
inner loops. Each instance keeps its own residual norms and stop tests.
One host read of a flag serves the whole fleet: a solve counts one read
an outer step and one an ADMM iteration, as many as its slowest instance
alone would, whatever F.

The batch method's x-update runs batched over the fleet: `get_AB`
vmapped, `build_Su` vmapped, the normal equations with Su^T Q blockwise,
one batched Cholesky of (F, N*m, N*m) and batched solves. The line
search rolls the (F, A, N, m) candidates out as one time loop of the
vmapped step over F*A rows, or, given `linesearch_rollout`, in one call
of it on the fleet (`ops/fused_rollout.py`: the CUDA kernel's F * A
blocks in one launch, the counterpart of the Pallas kernel under
`jax.vmap`). `line_search='outer'` keeps the explicit
inverse a fleet, (F, N*m, N*m), and runs one line search an outer step.
The dp method (the body of `ilqr_admm._ilqr_admm_dp`) vmaps the Riccati
pass over the fleet on the penalty-augmented cost model and rolls the
closed-loop candidates out for every instance and alpha. With
anderson_m > 0 each instance's ADMM is Anderson-accelerated on its own
memory.

With tolerances that no stop test can pass (`admm.can_stop`,
`ilqr_admm.outer_can_stop`: all <= 0, as in an MPC tick) the loops run
their full counts and read nothing on the host.

Three `torch.profiler` ranges split a solve's time: PROFILE_LINEARIZE
(linearization, normal equations, Cholesky and, in the outer mode, the
inverse), PROFILE_ADMM (each ADMM iteration) and PROFILE_ROLLOUT (each
line search: rollout, costs and argmin; inside PROFILE_ADMM in the inner
mode).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.func import vmap
from torch.profiler import record_function

from ilqr_admm_tpu_torch.ops.lifted import build_Su
from ilqr_admm_tpu_torch.ops.riccati import ilqr_backward, quad_cost_model
from ilqr_admm_tpu_torch.ops.rollout import rollout_closed_loop, rollout_nonlinear
from ilqr_admm_tpu_torch.ops.sqrt_riccati import ilqr_backward_sqrt
from ilqr_admm_tpu_torch.problem import ADMMConfig, SolveStatus
from ilqr_admm_tpu_torch.solvers.admm import (
    _mv,
    admm_fleet,
    keep,
    read_flags,
    validate_constraint_blocks,
)
from ilqr_admm_tpu_torch.solvers.ilqr import nan_to_inf
from ilqr_admm_tpu_torch.solvers.ilqr_admm import (
    ILQRADMMResult,
    _default_alphas,
    _to_device,
    outer_can_stop,
)
from ilqr_admm_tpu_torch.solvers.lqt import block_diag_stacked, broadcast_rho
from ilqr_admm_tpu_torch.solvers.lqt_admm import cho_factor
from ilqr_admm_tpu_torch.utils.device import resolve_device
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul

PROFILE_LINEARIZE = "ilqr_admm_fleet.linearize"
PROFILE_ADMM = "ilqr_admm_fleet.admm_iteration"
PROFILE_ROLLOUT = "ilqr_admm_fleet.rollout"


def _bd_matmul(blocks, M):
    """block_diag(blocks) @ M for each instance: blocks (N, d, d) shared or
    (F, N, d, d), M (F, N*d, k)."""
    N, d = blocks.shape[-3], blocks.shape[-1]
    F, k = M.shape[0], M.shape[-1]
    eq = "tij,ftjk->ftik" if blocks.ndim == 3 else "ftij,ftjk->ftik"
    return torch.einsum(eq, blocks, M.reshape(F, N, d, k)).reshape(F, N * d, k)


def _cho_solve(U, rhs):
    """Solve with each instance's upper Cholesky factor: U (F, n, n), rhs
    (F, n) or (F, n, k). Two triangular solves (cuBLAS batched trsm on a
    card): `torch.cholesky_solve` of a batch goes through MAGMA, which
    synchronizes with the host and aborts a CUDA graph capture."""
    vec = rhs.ndim == U.ndim - 1
    y = torch.linalg.solve_triangular(U.transpose(-1, -2), rhs[..., None] if vec else rhs,
                                      upper=False)
    x = torch.linalg.solve_triangular(U, y, upper=True)
    return x[..., 0] if vec else x


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
    if method == "dp" and line_search != "inner":
        raise ValueError("line_search='outer' is only supported with method='batch' "
                         "(the dp x-update's line search is closed-loop by design)")
    F, N, d = x_nom0.shape
    m = u_nom0.shape[-1]
    dtype, device = x_nom0.dtype, x_nom0.device
    kw = dict(dtype=dtype, device=device)
    if alphas is None:
        alphas = _default_alphas(dtype, device)
    Qr = broadcast_rho(rho_x, d, N, dtype, device)
    Rr = broadcast_rho(rho_u, m, N, dtype, device)
    Qr_on = Qr is not None and project_x is not None
    Rr_on = Rr is not None and project_u is not None
    Rr_l = block_diag_stacked(Rr) if Rr_on else None
    cfg = ADMMConfig(max_iter=max_admm_iter, alpha=alpha, tol=tol, anderson_m=anderson_m)

    def admm(f_argmin, z_x, z_u, l_x, l_u, active):
        """The fleet's ADMM on the instances still running their outer
        loop: (x_x, x_u, lmb_x, lmb_u, z_x, z_u, iters (F,), the fleet's
        iteration count)."""
        x_x, x_u, _, l_x_n, l_u_n, z_x_n, z_u_n, info = admm_fleet(
            f_argmin, project_x, project_u, cfg, z_x, z_u, l_x, l_u, part=active,
            profile=PROFILE_ADMM)
        return x_x, x_u, l_x_n, l_u_n, z_x_n, z_u_n, info.iters, info.fleet_iters
    fleet_cost = vmap(cost_fn)
    rows = torch.arange(F, device=device)
    backward = ilqr_backward_sqrt if riccati == "sqrt" else ilqr_backward

    def pick(xs_c, us_c, tx, tu):
        """Each instance's candidate (F, A, ...) of least cost plus
        penalties toward its targets tx (F, N, d) / tu (F, N, m) (either
        None)."""
        costs = nan_to_inf(vmap(fleet_cost)(xs_c, us_c))  # (F, A)
        if tx is not None:
            dx = xs_c - tx[:, None]
            costs = costs + torch.einsum("fati,tij,fatj->fa", dx, Qr, dx)
        if tu is not None:
            du = us_c - tu[:, None]
            costs = costs + torch.einsum("fati,tij,fatj->fa", du, Rr, du)
        ind = torch.argmin(costs, dim=1)
        return xs_c[rows, ind], us_c[rows, ind]

    def candidates(x_nom, u_nom, delta_u, tx, tu):
        """Roll out u_nom + alpha delta_u for every instance and alpha and
        `pick` each instance's best."""
        with record_function(PROFILE_ROLLOUT):
            us_c = u_nom[:, None] + alphas[None, :, None, None] * delta_u[:, None]  # (F, A, N, m)
            if linesearch_rollout is not None:
                # every instance's candidates from its own x0 in one call
                xs_c = linesearch_rollout(x_nom[:, 0].contiguous(), us_c.contiguous())
            else:
                n_a = us_c.shape[1]
                x0s = x_nom[:, None, 0].expand(F, n_a, d).reshape(F * n_a, d)
                xs_c = vmap(lambda x0, us: rollout_nonlinear(f, x0, us))(
                    x0s, us_c.reshape(F * n_a, N, m)).reshape(F, n_a, N, d)
            return pick(xs_c, us_c, tx, tu)

    def closed_loop(x_n, u_n, K, k, a):
        return rollout_closed_loop(f, x_n[0], K, a * k, x_n, u_n)

    # over the alphas, then over the instances: (F, A, N, .) candidates
    closed_loop_candidates = vmap(vmap(closed_loop, in_dims=(None, None, None, None, 0)),
                                  in_dims=(0, 0, 0, 0, None))

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
            l_side = SuTQ @ Su + 0.5 * block_diag_stacked(Cts[..., d:, d:])
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
            Minv = _cho_solve(cf, torch.eye(N * m, **kw).expand(F, N * m, N * m))
        return cf, Su, SuTQr, r_side, Minv

    def dp_model(x_nom, u_nom):
        """Each instance's dynamics and quadratic cost model."""
        A, B = vmap(get_AB)(x_nom, u_nom)
        if get_Cs is not None:
            cts, Cts = vmap(get_Cs)(x_nom, u_nom)
        else:
            cts, Cts = vmap(lambda x, u: quad_cost_model(quad_cost.Q, quad_cost.xd, quad_cost.R,
                                                         x, u))(x_nom, u_nom)
        return A, B, cts, Cts

    def body_dp(x_nom, u_nom, z_x, z_u, l_x, l_u, active):
        """The outer step of `ilqr_admm._ilqr_admm_dp` for every instance."""
        with record_function(PROFILE_LINEARIZE):
            A, B, cts, Cts = dp_model(x_nom, u_nom)

        def f_argmin(x, u):
            # the quadratic model augmented with the ADMM penalties (delta
            # coordinates around each nominal)
            cts_a, Cts_a = cts.clone(), Cts.clone()
            if Qr_on and x is not None:
                cts_a[..., :d] += 2.0 * torch.einsum("tij,ftj->fti", Qr, x_nom - x.reshape(F, N, d))
                Cts_a[..., :d, :d] += 2.0 * Qr
            if Rr_on and u is not None:
                cts_a[..., d:] += 2.0 * torch.einsum("tij,ftj->fti", Rr, u_nom - u.reshape(F, N, m))
                Cts_a[..., d:, d:] += 2.0 * Rr
            K, k = vmap(backward)(A, B, Cts_a, cts_a)
            with record_function(PROFILE_ROLLOUT):
                xs_c, us_c = closed_loop_candidates(x_nom, u_nom, K, k, alphas)
                xs, us = pick(xs_c, us_c,
                              x.reshape(F, N, d) if Qr_on and x is not None else None,
                              u.reshape(F, N, m) if Rr_on and u is not None else None)
            return xs.reshape(F, -1), us.reshape(F, -1)

        x_x, x_u, l_x_n, l_u_n, z_x_n, z_u_n, iters, n_iter = admm(
            f_argmin, z_x, z_u, l_x, l_u, active)
        return x_x.reshape(F, N, d), x_u.reshape(F, N, m), z_x_n, z_u_n, l_x_n, l_u_n, iters, n_iter

    def body_batch(x_nom, u_nom, z_x, z_u, l_x, l_u, active):
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

        x_x, x_u, l_x_n, l_u_n, z_x_n, z_u_n, iters, n_iter = admm(
            f_argmin if line_search == "inner" else f_argmin_lin, z_x, z_u, l_x, l_u, active)
        if line_search == "outer":
            x_new, u_new = candidates(
                x_nom, u_nom, (x_u - u_nom_f).reshape(F, N, m),
                (z_x_n - l_x_n).reshape(F, N, d) if Qr_on else None,
                (z_u_n - l_u_n).reshape(F, N, m) if Rr_l is not None else None,
            )
        else:
            x_new, u_new = x_x.reshape(F, N, d), x_u.reshape(F, N, m)
        return x_new, u_new, z_x_n, z_u_n, l_x_n, l_u_n, iters, n_iter

    body = body_dp if method == "dp" else body_batch

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
        x_nom, u_nom = keep(active, x_new, x_nom), keep(active, u_new, u_nom)
        cost = torch.where(active, cost_new, cost)
        z_x, z_u = keep(active, z_x_n, z_x), keep(active, z_u_n, z_u)
        l_x, l_u = keep(active, l_x_n, l_x), keep(active, l_u_n, l_u)
        outer_iters = outer_iters + active.to(outer_iters.dtype)
        admm_iters = admm_iters + iters
        active = status == SolveStatus.RUNNING
        k += 1
        if outer_can_stop(outer_tol, osc_tol):
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
    max_admm_iter, alpha, tol, outer_tol, osc_tol, method ('batch' or
    'dp' with riccati='chol' | 'sqrt'), warm (z_x, z_u, lmb_x, lmb_u, each
    with the fleet axis), line_search ('inner' | 'outer', batch method
    only), anderson_m and linesearch_rollout: for the batch method, a
    callable (x0s (F, d), u_cands (F, A, N, m)) -> xs (F, A, N, d) that
    rolls every instance's candidates out at once, e.g.
    `ops/fused_rollout.make_fused_linesearch_rollout` (the dp method's line
    search is closed-loop and does not use it).

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
