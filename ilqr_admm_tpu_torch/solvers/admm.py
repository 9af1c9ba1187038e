"""Generic two-block scaled ADMM solver (counterpart of
`ilqr_admm_tpu/solvers/admm.py`).

x-update from a caller-supplied `f_argmin` closure, z-update from
projection operators with over-relaxation, scaled dual update
lambda += (x - z), and two stopping rules: absolute primal/dual residual
tolerance and relative stall, plus a hard iteration cap. Optional
residual weights, residual-balancing adaptive penalties, Nesterov
acceleration with restart, and safeguarded Anderson acceleration, as in
the JAX package.

The JAX package runs each solve as one `lax.while_loop` on the device.
Here each loop is a Python loop that stops on the same status: every
iteration ends with one device-to-host read of its stop flags
(`read_flags`, counted in `host_sync_count`). Everything else stays on
the device.
"""

from __future__ import annotations

import inspect
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ilqr_admm_tpu_torch.problem import ADMMConfig, SolveStatus
from ilqr_admm_tpu_torch.utils.device import resolve_device

_EPS = 1e-30

# Number of device-to-host reads of stop flags (`read_flags`) in this process.
host_sync_count = 0


def read_flags(*flags: torch.Tensor) -> list[bool]:
    """The values of 0-dim bool tensors on the host, in one read (one sync
    on a CUDA device). The solvers' loops stop on these."""
    global host_sync_count
    host_sync_count += 1
    return [bool(v) for v in torch.stack(flags).tolist()]


def stop_tests(prim, dual, prim_new, dual_new, cfg: ADMMConfig):
    """The plain loop's stop rules, elementwise: (converged, stalled) for
    the residuals before (prim, dual) and after (prim_new, dual_new) an
    iteration. Converged: both residuals below cfg.tol; stalled: both
    changed by less than cfg.stall relative to the iteration before."""
    converged = (prim_new < cfg.tol) & (dual_new < cfg.tol)
    prim_change = torch.abs(prim - prim_new) / (prim + _EPS)
    dual_change = torch.abs(dual - dual_new) / (dual + _EPS)
    return converged, (prim_change < cfg.stall) & (dual_change < cfg.stall)


def _stop_status(converged, stalled) -> int:
    conv, stall = read_flags(converged, stalled)
    if conv:
        return SolveStatus.CONVERGED
    return SolveStatus.STALLED if stall else SolveStatus.RUNNING


class ADMMInfo(NamedTuple):
    iters: int  # iterations executed
    prim_res: torch.Tensor
    dual_res: torch.Tensor
    status: int  # SolveStatus value
    logs: torch.Tensor  # (max_iter, 2) primal/dual residual history (0 beyond iters)


def _norm(x):
    return torch.sqrt(torch.sum(x * x))


def _rho_is_zero(rho) -> bool:
    """All-zero penalty (the reference-style 'off' spelling)."""
    if isinstance(rho, torch.Tensor):
        return bool(torch.all(rho == 0))
    return bool(np.all(np.asarray(rho) == 0))


def validate_constraint_blocks(project_x, rho_x, project_u, rho_u):
    """Each ADMM constraint block needs BOTH its projection and penalty.

    A projection without a (nonzero) rho would be silently ignored by
    the x-update; a nonzero rho without its projection would inject a
    zero-target penalty that biases the solution. rho=0 with no
    projection is the explicit 'off' and is accepted.
    """
    for name, proj, rho in (
        ("x", project_x, rho_x), ("u", project_u, rho_u),
    ):
        if proj is not None and (rho is None or _rho_is_zero(rho)):
            raise ValueError(
                f"project_{name} is set but rho_{name}={rho!r}: the "
                f"projection would be silently ignored by the x-update; "
                f"pass a nonzero rho_{name}"
            )
        if proj is None and rho is not None and not _rho_is_zero(rho):
            raise ValueError(
                f"rho_{name}={rho!r} is set but project_{name} is None: "
                f"this would inject a zero-target penalty that biases "
                f"the solution; pass project_{name} or drop rho_{name}"
            )


def _make_plain_step(f_argmin, project_x, project_u, cfg, wx, wu, zero):
    """One plain scaled-ADMM iteration as a function of (z, lambda).

    Returns (out, z_x_new, z_u_new, lmb_x_new, lmb_u_new, prim, dual), the
    fixed-point map T(v) that the Anderson loop wraps. KEEP IN SYNC with
    the plain branch of `admm_solve`'s loop: the certificates require the
    two to define identical iterations."""
    has_x = project_x is not None
    has_u = project_u is not None

    def step(z_x, z_u, lmb_x, lmb_u):
        reg_x = z_x - lmb_x if has_x else None
        reg_u = z_u - lmb_u if has_u else None
        out = f_argmin(reg_x, reg_u)
        x_x, x_u = out[0], out[1]
        prim, dual = zero, zero
        z_x_new, lmb_x_new = z_x, lmb_x
        z_u_new, lmb_u_new = z_u, lmb_u
        if has_x:
            z_rel = cfg.alpha * x_x + (1.0 - cfg.alpha) * z_x
            z_x_new = project_x(z_rel + lmb_x)
            r = x_x - z_x_new
            lmb_x_new = lmb_x + r
            prim = prim + _norm(wx(r))
            dual = dual + _norm(wx(z_x_new - z_x))
        if has_u:
            z_rel = cfg.alpha * x_u + (1.0 - cfg.alpha) * z_u
            z_u_new = project_u(z_rel + lmb_u)
            r = x_u - z_u_new
            lmb_u_new = lmb_u + r
            prim = prim + _norm(wu(r))
            dual = dual + _norm(wu(z_u_new - z_u))
        return out, z_x_new, z_u_new, lmb_x_new, lmb_u_new, prim, dual

    return step


def _admm_solve_anderson(
    plain_step, shape_x, shape_u, cfg, z_x, z_u, lmb_x, lmb_u, zeros_out,
    dtype, device, has_x=True, has_u=True,
):
    """Safeguarded type-II Anderson acceleration of the ADMM map.

    The fixed-point variable is v = (z_x, z_u, lambda_x, lambda_u) of the
    enabled blocks, flattened; one plain iteration is T(v), g = T(v) - v.
    The last `anderson_m` secant pairs feed a regularized least squares
    for the mixing weights gamma, v+ = v + g - (dV + dG)^T gamma. The
    memory is cleared, and a plain step taken, whenever ||g|| exceeds
    `anderson_safeguard` x the best residual since the last restart.
    Convergence is declared only on a plain step's residuals, and the
    returned iterate is the best plain evaluation seen (the converging one
    on convergence).
    """
    sx = math.prod(shape_x) if has_x else 0
    su = math.prod(shape_u) if has_u else 0
    D = 2 * (sx + su)
    m = cfg.anderson_m
    z_x_const, z_u_const, l_x_const, l_u_const = z_x, z_u, lmb_x, lmb_u
    kw = dict(dtype=dtype, device=device)

    def pack(zx, zu, lx, lu):
        parts = []
        if has_x:
            parts.append(zx.reshape(-1))
        if has_u:
            parts.append(zu.reshape(-1))
        if has_x:
            parts.append(lx.reshape(-1))
        if has_u:
            parts.append(lu.reshape(-1))
        return torch.cat(parts)

    def unpack(v):
        zx = v[:sx].reshape(shape_x) if has_x else z_x_const
        zu = v[sx : sx + su].reshape(shape_u) if has_u else z_u_const
        lx = v[sx + su : 2 * sx + su].reshape(shape_x) if has_x else l_x_const
        lu = v[2 * sx + su :].reshape(shape_u) if has_u else l_u_const
        return zx, zu, lx, lu

    big = torch.tensor(1e6, **kw)
    inf = torch.tensor(math.inf, **kw)
    logs = torch.zeros((cfg.max_iter, 2), **kw)
    eye_m = torch.eye(m, **kw)
    eps = torch.finfo(dtype).eps

    v = pack(z_x, z_u, lmb_x, lmb_u)
    ret = (zeros_out, z_x, z_u, lmb_x, lmb_u)
    ret_score = (inf, big, big)
    prim, dual = big, big
    mem_dv = torch.zeros((m, D), **kw)
    mem_dg = torch.zeros((m, D), **kw)
    prev_v = torch.zeros((D,), **kw)
    prev_g = torch.zeros((D,), **kw)
    has_prev = torch.tensor(False, device=device)
    best = inf
    flat_prev = torch.tensor(False, device=device)
    j, status = 0, SolveStatus.RUNNING
    while j < cfg.max_iter and status == SolveStatus.RUNNING:
        out, zx_n, zu_n, lx_n, lu_n, prim_new, dual_new = plain_step(*unpack(v))
        v_plain = pack(zx_n, zu_n, lx_n, lu_n)
        g = v_plain - v
        gnorm = _norm(g)

        restart = has_prev & (gnorm > cfg.anderson_safeguard * best)
        push = has_prev & ~restart
        mem_dv_p = torch.roll(mem_dv, -1, dims=0)
        mem_dv_p[-1] = v - prev_v
        mem_dg_p = torch.roll(mem_dg, -1, dims=0)
        mem_dg_p[-1] = g - prev_g
        zero_dv = torch.zeros_like(mem_dv)
        mem_dv = torch.where(push, mem_dv_p, torch.where(restart, zero_dv, mem_dv))
        mem_dg = torch.where(push, mem_dg_p, torch.where(restart, zero_dv, mem_dg))

        # type-II LS for the mixing weights; zero (unfilled) rows drop out
        # through the Tikhonov term, and an all-zero memory gives gamma = 0,
        # i.e. the plain step
        gram = mem_dg @ mem_dg.T
        reg = cfg.anderson_reg * torch.trace(gram) + 1e-30
        gam = torch.linalg.solve(gram + reg * eye_m, mem_dg @ g)
        v_aa = v + g - (mem_dv + mem_dg).T @ gam
        # near the dtype's residual floor the secant pairs are noise: take
        # plain steps below a machine-precision-scaled floor
        noise_floor = 1e3 * eps * (1.0 + _norm(v_plain))
        use_aa = (gnorm > noise_floor) & ~restart
        v_next = torch.where(use_aa, v_aa, v_plain)

        best = torch.where(restart, inf, torch.minimum(best, gnorm))
        logs[j] = torch.stack([prim_new, dual_new])
        converged = (prim_new < cfg.tol) & (dual_new < cfg.tol)
        prim_change = torch.abs(prim - prim_new) / (prim + _EPS)
        dual_change = torch.abs(dual - dual_new) / (dual + _EPS)
        # a restart re-enters the plain map, so residuals can repeat
        # across the revert without being a stall; and Anderson's
        # residuals are non-monotone, so STALLED needs two consecutive
        # flat iterations
        flat = (prim_change < cfg.stall) & (dual_change < cfg.stall) & ~restart
        stalled = flat & flat_prev
        # the returned iterate is the best plain evaluation by combined
        # residual, or the converging one
        score_new = prim_new + dual_new
        take = (score_new < ret_score[0]) | converged
        ret = tuple(
            _select(take, new, old)
            for new, old in zip((out, zx_n, zu_n, lx_n, lu_n), ret)
        )
        ret_score = tuple(
            torch.where(take, new, old)
            for new, old in zip((score_new, prim_new, dual_new), ret_score)
        )
        prim, dual = prim_new, dual_new
        prev_v, prev_g = v, g
        has_prev = ~restart
        flat_prev = flat
        v = v_next
        j += 1
        status = _stop_status(converged, stalled)

    out, z_x, z_u, lmb_x, lmb_u = ret
    if status == SolveStatus.RUNNING:
        status = SolveStatus.MAX_ITER
    # info reports the returned iterate's residuals; logs keep the history
    _score, prim, dual = ret_score
    info = ADMMInfo(iters=j, prim_res=prim, dual_res=dual, status=int(status), logs=logs)
    x_x, x_u = out[0], out[1]
    aux = out[2] if len(out) > 2 else None
    return x_x, x_u, aux, lmb_x, lmb_u, z_x, z_u, info


def _select(cond, new, old):
    """torch.where over a (possibly nested) tuple of tensors and Nones.
    Parts that `old` lacks (the zero carry has no aux) count as zeros,
    as the JAX package's traced zero carry holds them."""
    if isinstance(new, (tuple, list)):
        old = tuple(old or ()) + (None,) * (len(new) - len(old or ()))
        return type(new)(_select(cond, n, o) for n, o in zip(new, old))
    if new is None:
        return None
    return torch.where(cond, new, torch.zeros_like(new) if old is None else old)


def _accepts_rho_scale(f_argmin) -> bool:
    """Whether f_argmin can be called as f_argmin(reg_x, reg_u, rho_scale)."""
    try:
        inspect.signature(f_argmin).bind(None, None, None)
    except TypeError:
        return False
    except ValueError:  # no signature to inspect: let the call decide
        return True
    return True


def admm_solve(
    f_argmin: Callable,
    project_x: Optional[Callable],
    project_u: Optional[Callable],
    shape_x,
    shape_u,
    cfg: ADMMConfig,
    z_x_init=None,
    z_u_init=None,
    lmb_x_init=None,
    lmb_u_init=None,
    weight_x: Optional[Callable] = None,
    weight_u: Optional[Callable] = None,
    rho_weight_x: Optional[Callable] = None,
    rho_weight_u: Optional[Callable] = None,
    dtype=torch.float32,
    device=None,
):
    """Run scaled two-block ADMM.

    f_argmin(reg_x, reg_u) -> (x_x, x_u[, aux]): the x-update, with reg_*
    the (z - lambda) targets; a block whose projection is None is
    disabled and its reg is passed as None. With `cfg.adaptive_rho`
    f_argmin takes a third argument, the penalty scale (a 0-dim tensor).

    project_x / project_u: z-update projections on tensors of shape_x /
    shape_u. weight_x / weight_u: optional r -> weighted r inside the
    residual norms. rho_weight_x / rho_weight_u: r -> rho_base r for the
    adaptive-rho balancing rule and the accel restart monitor (identity
    when omitted).

    device: where the iterates live; by default that of the first init
    given, else the CUDA card. Returns (x_x, x_u, aux, lmb_x, lmb_u, z_x,
    z_u, info: ADMMInfo). With max_iter = 0 the x-update is never called,
    and x_x, x_u are zeros of shape_x, shape_u and aux is None.
    """
    has_x = project_x is not None
    has_u = project_u is not None
    if not (has_x or has_u):
        raise ValueError("at least one of project_x / project_u is required")

    wx = weight_x if weight_x is not None else (lambda r: r)
    wu = weight_u if weight_u is not None else (lambda r: r)
    rwx = rho_weight_x if rho_weight_x is not None else (lambda r: r)
    rwu = rho_weight_u if rho_weight_u is not None else (lambda r: r)
    adaptive = cfg.adaptive_rho
    if adaptive and cfg.rho_freq < 1:
        raise ValueError(f"rho_freq must be >= 1, got {cfg.rho_freq}")
    accel = cfg.accel
    if accel and adaptive:
        raise ValueError(
            "accel=True is incompatible with adaptive_rho=True: the "
            "momentum sequence assumes a fixed penalty (each rho change "
            "would invalidate the accumulated extrapolation)"
        )
    anderson = cfg.anderson_m > 0
    if anderson and (accel or adaptive):
        raise ValueError(
            "anderson_m > 0 is incompatible with accel/adaptive_rho: "
            "Anderson extrapolates the fixed-point map of a *fixed* ADMM "
            "iteration (momentum or penalty changes would alter the map "
            "mid-memory)"
        )
    # The JAX package infers the x-update's output shapes by tracing it;
    # calling it here would run one x-update (a rollout batch on the
    # line-search paths) more a solve, so the signature is checked instead
    # and the zero carry is built from shape_x and shape_u.
    if adaptive and not _accepts_rho_scale(f_argmin):
        raise ValueError(
            "adaptive_rho=True requires an f_argmin accepting "
            "(reg_x, reg_u, rho_scale); this x-update takes only "
            "(reg_x, reg_u) — adaptive penalties are supported by "
            "the batch LQT (lqt_admm_batch(use_qr=False)), DP LQT "
            "(lqt_admm_dp) and robust-SLS (sls_admm) x-updates"
        )

    inits = (z_x_init, z_u_init, lmb_x_init, lmb_u_init)
    if device is None:
        given = [t for t in inits if isinstance(t, torch.Tensor)]
        device = given[0].device if given else resolve_device(None)
    kw = dict(dtype=dtype, device=device)

    def init(t, shape):
        return torch.zeros(shape, **kw) if t is None else torch.as_tensor(t, device=device)

    z_x, z_u = init(z_x_init, shape_x), init(z_u_init, shape_u)
    lmb_x, lmb_u = init(lmb_x_init, shape_x), init(lmb_u_init, shape_u)
    zeros_out = (torch.zeros(shape_x, **kw), torch.zeros(shape_u, **kw))
    zero = torch.zeros((), **kw)
    one = torch.ones((), **kw)

    if anderson:
        plain_step = _make_plain_step(f_argmin, project_x, project_u, cfg, wx, wu, zero)
        return _admm_solve_anderson(
            plain_step, tuple(shape_x), tuple(shape_u), cfg, z_x, z_u, lmb_x, lmb_u,
            zeros_out, dtype, device, has_x=has_x, has_u=has_u,
        )

    big = torch.tensor(1e6, **kw)
    logs = torch.zeros((cfg.max_iter, 2), **kw)
    out = zeros_out
    prim, dual = big, big
    s = one
    if accel:
        # the z/lmb slots hold the extrapolated (hat) iterates the x-update
        # uses; *_prev the last accepted (z, lmb), a_mom the momentum
        # coefficient and c_prev the combined restart residual
        z_x_prev, z_u_prev, lmb_x_prev, lmb_u_prev = z_x, z_u, lmb_x, lmb_u
        a_mom = one
        c_prev = torch.tensor(math.inf, **kw)
        ok_prev = torch.tensor(True, device=device)

    j, status = 0, SolveStatus.RUNNING
    while j < cfg.max_iter and status == SolveStatus.RUNNING:
        reg_x = z_x - lmb_x if has_x else None
        reg_u = z_u - lmb_u if has_u else None
        out = f_argmin(reg_x, reg_u, s) if adaptive else f_argmin(reg_x, reg_u)
        x_x, x_u = out[0], out[1]

        prim_new, dual_new, dual_bal, c_new = zero, zero, zero, zero
        if has_x:
            z_relaxed = cfg.alpha * x_x + (1.0 - cfg.alpha) * z_x
            z_x_new = project_x(z_relaxed + lmb_x)
            r_x = x_x - z_x_new
            lmb_x_new = lmb_x + r_x
            prim_new = prim_new + _norm(wx(r_x))
            # dual residual against the last *accepted* z in accel mode
            dual_new = dual_new + _norm(wx(z_x_new - (z_x_prev if accel else z_x)))
            if adaptive:
                dual_bal = dual_bal + _norm(rwx(z_x_new - z_x))
            if accel:
                dl, dz = lmb_x_new - lmb_x, z_x_new - z_x
                c_new = c_new + torch.sum(dl * rwx(dl)) + torch.sum(dz * rwx(dz))
            lmb_x, z_x = lmb_x_new, z_x_new
        if has_u:
            z_relaxed = cfg.alpha * x_u + (1.0 - cfg.alpha) * z_u
            z_u_new = project_u(z_relaxed + lmb_u)
            r_u = x_u - z_u_new
            lmb_u_new = lmb_u + r_u
            prim_new = prim_new + _norm(wu(r_u))
            dual_new = dual_new + _norm(wu(z_u_new - (z_u_prev if accel else z_u)))
            if adaptive:
                dual_bal = dual_bal + _norm(rwu(z_u_new - z_u))
            if accel:
                dl, dz = lmb_u_new - lmb_u, z_u_new - z_u
                c_new = c_new + torch.sum(dl * rwu(dl)) + torch.sum(dz * rwu(dz))
            lmb_u, z_u = lmb_u_new, z_u_new

        if accel:
            # accept: extrapolate; reject: revert to the last accepted pair,
            # reset the momentum, inflate the monitor by 1/eta
            ok = c_new < cfg.accel_eta * c_prev
            a_next = torch.where(ok, 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * a_mom * a_mom)), one)
            beta = torch.where(ok, (a_mom - 1.0) / a_next, zero)

            def _mix(z_new, z_prev):
                hat = z_new + beta * (z_new - z_prev)
                return torch.where(ok, hat, z_prev), torch.where(ok, z_new, z_prev)

            z_x, z_x_prev = _mix(z_x, z_x_prev)
            z_u, z_u_prev = _mix(z_u, z_u_prev)
            lmb_x, lmb_x_prev = _mix(lmb_x, lmb_x_prev)
            lmb_u, lmb_u_prev = _mix(lmb_u, lmb_u_prev)
            c_prev = torch.where(ok, c_new, c_prev / cfg.accel_eta)
            a_mom = a_next

        logs[j] = torch.stack([prim_new, dual_new])

        converged, stalled = stop_tests(prim, dual, prim_new, dual_new, cfg)
        if accel:
            # only an accepted step may converge: on a reject the returned
            # state is the reverted previous (z, lambda). Across a restart
            # the residuals repeat exactly: a stall needs two consecutive
            # accepted steps
            converged = converged & ok
            stalled = stalled & ok & ok_prev
            ok_prev = ok

        if adaptive:
            # residual balancing (Boyd et al. 2011, 3.4.1) every rho_freq
            # iterations until rho_freeze_after; scaled duals rescale by
            # the inverse factor
            dual_true = s * dual_bal
            fac = torch.where(
                prim_new > cfg.rho_mu * dual_true,
                torch.tensor(cfg.rho_tau, **kw),
                torch.where(dual_true > cfg.rho_mu * prim_new,
                            torch.tensor(1.0 / cfg.rho_tau, **kw), one),
            )
            adapt_now = j % cfg.rho_freq == cfg.rho_freq - 1 and j < cfg.rho_freeze_after
            if not adapt_now:
                fac = one
            s_new = torch.clamp(s * fac, cfg.rho_scale_min, cfg.rho_scale_max)
            rescale = s / s_new
            lmb_x = lmb_x * rescale
            lmb_u = lmb_u * rescale
            s = s_new

        prim, dual = prim_new, dual_new
        j += 1
        status = _stop_status(converged, stalled)

    if accel:  # the last *accepted* iterates
        z_x, z_u, lmb_x, lmb_u = z_x_prev, z_u_prev, lmb_x_prev, lmb_u_prev
    if status == SolveStatus.RUNNING:
        status = SolveStatus.MAX_ITER
    info = ADMMInfo(iters=j, prim_res=prim, dual_res=dual, status=int(status), logs=logs)
    x_x, x_u = out[0], out[1]
    aux = out[2] if len(out) > 2 else None
    return x_x, x_u, aux, lmb_x, lmb_u, z_x, z_u, info
