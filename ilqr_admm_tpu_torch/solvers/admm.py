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
iteration ends with one device-to-host read of its stop flag
(`read_status`, counted in `host_sync_count`), unless no stop test can
pass (`can_stop`: tol and stall <= 0), when it runs max_iter iterations
without a read. Everything else stays on the device.

The loop is written once, over a leading fleet axis F (`admm_fleet`):
the counterpart of `jax.vmap` of the JAX package's loop, which the fleet
solvers run (`ilqr_admm_fleet`, `batched_lqt_admm_dp`). Each instance
keeps its own residuals, stop tests, restart state, penalty scale and
Anderson memory; one that has stopped keeps its carry, and the loop runs
while any instance runs, one host read an iteration for the whole fleet.
`admm_solve` is its F = 1 case, on single-instance functions.
"""

from __future__ import annotations

import contextlib
import inspect
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ilqr_admm_tpu_torch.problem import ADMMConfig, SolveStatus
from ilqr_admm_tpu_torch.utils.device import resolve_device

_EPS = 1e-30

# Number of device-to-host reads of stop flags (`read_flags`, `read_status`)
# in this process.
host_sync_count = 0

RUNNING, CONVERGED, STALLED, MAX_ITER = (
    int(s) for s in (SolveStatus.RUNNING, SolveStatus.CONVERGED, SolveStatus.STALLED,
                     SolveStatus.MAX_ITER))


def read_flags(*flags: torch.Tensor) -> list[bool]:
    """The values of 0-dim bool tensors on the host, in one read (one sync
    on a CUDA device). The solvers' loops stop on these."""
    global host_sync_count
    host_sync_count += 1
    return [bool(v) for v in torch.stack(flags).tolist()]


def read_status(status: torch.Tensor) -> int:
    """The value of a 0-dim integer status tensor on the host, in one read
    (counted with the flag reads)."""
    global host_sync_count
    host_sync_count += 1
    return int(status)


def stop_tests(prim, dual, prim_new, dual_new, cfg: ADMMConfig):
    """The plain loop's stop rules, elementwise: (converged, stalled) for
    the residuals before (prim, dual) and after (prim_new, dual_new) an
    iteration. Converged: both residuals below cfg.tol; stalled: both
    changed by less than cfg.stall relative to the iteration before."""
    converged = (prim_new < cfg.tol) & (dual_new < cfg.tol)
    prim_change = torch.abs(prim - prim_new) / (prim + _EPS)
    dual_change = torch.abs(dual - dual_new) / (dual + _EPS)
    return converged, (prim_change < cfg.stall) & (dual_change < cfg.stall)


def can_stop(cfg: ADMMConfig) -> bool:
    """Whether a stop test can pass. Residual norms and their relative
    changes are >= 0 or NaN, so with cfg.tol <= 0 and cfg.stall <= 0
    neither `r < tol` nor `change < stall` is ever true: the loop runs
    cfg.max_iter iterations and its flags need no read (the bounded
    iterations of an MPC tick)."""
    return cfg.tol > 0 or cfg.stall > 0


class ADMMInfo(NamedTuple):
    iters: int  # iterations executed
    prim_res: torch.Tensor
    dual_res: torch.Tensor
    status: int  # SolveStatus value
    logs: torch.Tensor  # (max_iter, 2) primal/dual residual history (0 beyond iters)


class FleetADMMInfo(NamedTuple):
    iters: torch.Tensor  # (F,) int64: each instance's iterations
    prim_res: torch.Tensor  # (F,)
    dual_res: torch.Tensor  # (F,)
    status: torch.Tensor  # (F,) int64 SolveStatus values (MAX_ITER for one that took no part)
    logs: torch.Tensor  # (F, max_iter, 2) each instance's residuals (0 beyond its iters)
    fleet_iters: int  # the loop's iterations (a host read each when its flags are read)


def _norm(r):
    """Each instance's 2-norm: (F, ...) -> (F,)."""
    return torch.sqrt(torch.sum(r * r, dim=tuple(range(1, r.ndim))))


def _rowsum(r):
    return torch.sum(r, dim=tuple(range(1, r.ndim)))


def _rows(v, like):
    """v (F,) shaped to broadcast over the trailing axes of `like`."""
    return v.reshape(v.shape + (1,) * (like.ndim - 1))


def _mv(M, v):
    """M @ v for each instance: M (F, n, k) or (n, k), v (F, k) -> (F, n)."""
    return (M @ v[..., None])[..., 0]


def keep(mask, new, old):
    """new where the instance's mask is set, else old: mask (F,)."""
    return torch.where(_rows(mask, new), new, old)


def _keep_tree(mask, new, old):
    """`keep` over a (possibly nested) tuple of tensors and Nones. Parts
    that `old` lacks (the zero carry has no aux) count as zeros, as the
    JAX package's traced zero carry holds them."""
    if isinstance(new, (tuple, list)):
        old = tuple(old or ()) + (None,) * (len(new) - len(old or ()))
        return type(new)(_keep_tree(mask, n, o) for n, o in zip(new, old))
    if new is None:
        return None
    return keep(mask, new, torch.zeros_like(new) if old is None else old)


def _map_tree(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, t) for t in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _lift(tree):
    """A single instance's tensors as a fleet of one."""
    return _map_tree(lambda t: t[None], tree)


def _drop(tree):
    """A fleet of one's tensors as the single instance's."""
    return _map_tree(lambda t: t[0], tree)


def _on_row(fn):
    """A function of one instance's tensor on a fleet of one."""
    return None if fn is None else (lambda r: fn(r[0])[None])


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


def _accepts_rho_scale(f_argmin) -> bool:
    """Whether f_argmin can be called as f_argmin(reg_x, reg_u, rho_scale)."""
    try:
        inspect.signature(f_argmin).bind(None, None, None)
    except TypeError:
        return False
    except ValueError:  # no signature to inspect: let the call decide
        return True
    return True


def _check_modes(cfg: ADMMConfig, f_argmin):
    """The exclusions between accel, adaptive_rho and Anderson, and the
    x-update that adaptive_rho needs."""
    adaptive, accel = cfg.adaptive_rho, cfg.accel
    if adaptive and cfg.rho_freq < 1:
        raise ValueError(f"rho_freq must be >= 1, got {cfg.rho_freq}")
    if accel and adaptive:
        raise ValueError(
            "accel=True is incompatible with adaptive_rho=True: the "
            "momentum sequence assumes a fixed penalty (each rho change "
            "would invalidate the accumulated extrapolation)"
        )
    if cfg.anderson_m > 0 and (accel or adaptive):
        raise ValueError(
            "anderson_m > 0 is incompatible with accel/adaptive_rho: "
            "Anderson extrapolates the fixed-point map of a *fixed* ADMM "
            "iteration (momentum or penalty changes would alter the map "
            "mid-memory)"
        )
    # The JAX package infers the x-update's output shapes by tracing it;
    # calling it here would run one x-update (a rollout batch on the
    # line-search paths) more a solve, so the signature is checked instead
    # and the zero carry is built from the iterates' shapes.
    if adaptive and not _accepts_rho_scale(f_argmin):
        raise ValueError(
            "adaptive_rho=True requires an f_argmin accepting "
            "(reg_x, reg_u, rho_scale); this x-update takes only "
            "(reg_x, reg_u) — adaptive penalties are supported by "
            "the batch LQT (lqt_admm_batch(use_qr=False)), DP LQT "
            "(lqt_admm_dp) and robust-SLS (sls_admm) x-updates"
        )


class _Stops:
    """Each instance's iteration count and status, and the fleet's host
    read. Without a mask (one instance that takes part) every iteration
    the loop runs is that instance's own, so its count is the loop's and
    its status the flag read last."""

    def __init__(self, cfg: ADMMConfig, live, masked: bool, reads: bool):
        self.cfg, self.live, self.masked, self.reads = cfg, live, masked, reads
        self.iters = torch.zeros(live.shape, dtype=torch.int64, device=live.device)
        self.status = torch.where(live, RUNNING, MAX_ITER)
        self.k, self.code = 0, RUNNING

    def update(self, converged, stalled) -> bool:
        """Record an iteration's stop tests (each (F,)); whether the loop
        goes on."""
        stop = torch.where(converged, CONVERGED, torch.where(stalled, STALLED, RUNNING))
        self.k += 1
        if self.masked:
            self.iters = self.iters + self.live.to(torch.int64)
            stop = torch.where((stop == RUNNING) & (self.iters >= self.cfg.max_iter), MAX_ITER,
                               stop)
            self.status = torch.where(self.live, stop, self.status)
            self.live = self.status == RUNNING
            flag = torch.where(torch.any(self.live), RUNNING, self.status[0])
        else:
            flag = stop[0]
        if self.reads:
            self.code = read_status(flag)
        return self.k < self.cfg.max_iter and self.code == RUNNING

    def finish(self) -> int:
        """The status read last (MAX_ITER if still RUNNING): for one
        instance its own."""
        host = MAX_ITER if self.code == RUNNING else self.code
        if not self.masked:
            self.iters = torch.full_like(self.iters, self.k)
            self.status = torch.full_like(self.status, host)
        return host


def _plain_loop(f_argmin, project_x, project_u, cfg, z_x, z_u, lmb_x, lmb_u, stops, sel, ranged,
                wx, wu, rwx, rwu):
    """The plain, accel and adaptive-rho iterations (`admm_fleet`)."""
    has_x, has_u = project_x is not None, project_u is not None
    adaptive, accel = cfg.adaptive_rho, cfg.accel
    F = stops.live.shape[0]
    kw = dict(dtype=z_u.dtype, device=z_u.device)
    zero, one = torch.zeros((F,), **kw), torch.ones((F,), **kw)
    out = (torch.zeros_like(z_x), torch.zeros_like(z_u))
    prim = dual = torch.full((F,), 1e6, **kw)
    logs = torch.zeros((F, cfg.max_iter, 2), **kw)
    s = one
    if accel:
        # the z/lmb slots hold the extrapolated (hat) iterates the x-update
        # uses; *_prev the last accepted (z, lmb), a_mom the momentum
        # coefficient and c_prev the combined restart residual
        z_x_prev, z_u_prev, lmb_x_prev, lmb_u_prev = z_x, z_u, lmb_x, lmb_u
        a_mom = one
        c_prev = torch.full((F,), math.inf, **kw)
        ok_prev = torch.ones((F,), dtype=torch.bool, device=kw["device"])

    go = cfg.max_iter > 0
    while go:
        live = stops.live
        with ranged():
            reg_x = z_x - lmb_x if has_x else None
            reg_u = z_u - lmb_u if has_u else None
            out_new = f_argmin(reg_x, reg_u, s) if adaptive else f_argmin(reg_x, reg_u)
            x_x, x_u = out_new[0], out_new[1]

            prim_new, dual_new, dual_bal, c_new = zero, zero, zero, zero
            z_x_new, lmb_x_new, z_u_new, lmb_u_new = z_x, lmb_x, z_u, lmb_u
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
                    c_new = c_new + _rowsum(dl * rwx(dl)) + _rowsum(dz * rwx(dz))
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
                    c_new = c_new + _rowsum(dl * rwu(dl)) + _rowsum(dz * rwu(dz))

            converged, stalled = stop_tests(prim, dual, prim_new, dual_new, cfg)
            if accel:
                # accept: extrapolate; reject: revert to the last accepted
                # pair, reset the momentum, inflate the monitor by 1/eta
                ok = c_new < cfg.accel_eta * c_prev
                a_next = torch.where(ok, 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * a_mom * a_mom)), one)
                beta = torch.where(ok, (a_mom - 1.0) / a_next, zero)

                def mix(z_new, z_prev):
                    hat = z_new + _rows(beta, z_new) * (z_new - z_prev)
                    return keep(ok, hat, z_prev), keep(ok, z_new, z_prev)

                z_x_new, z_x_acc = mix(z_x_new, z_x_prev)
                z_u_new, z_u_acc = mix(z_u_new, z_u_prev)
                lmb_x_new, lmb_x_acc = mix(lmb_x_new, lmb_x_prev)
                lmb_u_new, lmb_u_acc = mix(lmb_u_new, lmb_u_prev)
                # only an accepted step may converge: on a reject the
                # returned state is the reverted previous (z, lambda).
                # Across a restart the residuals repeat exactly: a stall
                # needs two consecutive accepted steps
                converged = converged & ok
                stalled = stalled & ok & ok_prev
                z_x_prev, z_u_prev = sel(live, z_x_acc, z_x_prev), sel(live, z_u_acc, z_u_prev)
                lmb_x_prev = sel(live, lmb_x_acc, lmb_x_prev)
                lmb_u_prev = sel(live, lmb_u_acc, lmb_u_prev)
                c_prev = sel(live, torch.where(ok, c_new, c_prev / cfg.accel_eta), c_prev)
                a_mom, ok_prev = sel(live, a_next, a_mom), sel(live, ok, ok_prev)

            if adaptive:
                # residual balancing (Boyd et al. 2011, 3.4.1) every rho_freq
                # iterations until rho_freeze_after; scaled duals rescale by
                # the inverse factor
                dual_true = s * dual_bal
                fac = torch.where(
                    prim_new > cfg.rho_mu * dual_true, torch.full_like(s, cfg.rho_tau),
                    torch.where(dual_true > cfg.rho_mu * prim_new,
                                torch.full_like(s, 1.0 / cfg.rho_tau), one),
                )
                j = stops.k
                if not (j % cfg.rho_freq == cfg.rho_freq - 1 and j < cfg.rho_freeze_after):
                    fac = one
                s_new = torch.clamp(s * fac, cfg.rho_scale_min, cfg.rho_scale_max)
                rescale = s / s_new
                lmb_x_new = lmb_x_new * _rows(rescale, lmb_x_new)
                lmb_u_new = lmb_u_new * _rows(rescale, lmb_u_new)
                s = sel(live, s_new, s)

            logs[:, stops.k] = sel(live, torch.stack([prim_new, dual_new], dim=1), logs[:, stops.k])
            z_x, z_u = sel(live, z_x_new, z_x), sel(live, z_u_new, z_u)
            lmb_x, lmb_u = sel(live, lmb_x_new, lmb_x), sel(live, lmb_u_new, lmb_u)
            out = _keep_tree(live, out_new, out) if stops.masked else out_new
            prim, dual = sel(live, prim_new, prim), sel(live, dual_new, dual)
            go = stops.update(converged, stalled)

    if accel:  # the last *accepted* iterates
        z_x, z_u, lmb_x, lmb_u = z_x_prev, z_u_prev, lmb_x_prev, lmb_u_prev
    return out, z_x, z_u, lmb_x, lmb_u, prim, dual, logs


def _anderson_loop(f_argmin, project_x, project_u, cfg, z_x, z_u, lmb_x, lmb_u, stops, sel,
                   ranged, wx, wu):
    """Safeguarded type-II Anderson acceleration of the ADMM map, each
    instance on its own memory.

    The fixed-point variable is v = (z_x, z_u, lambda_x, lambda_u) of the
    enabled blocks, flattened; one plain iteration is T(v), g = T(v) - v.
    The last `anderson_m` secant pairs feed a regularized least squares
    for the mixing weights gamma, v+ = v + g - (dV + dG)^T gamma. The
    memory is cleared, and a plain step taken, whenever ||g|| exceeds
    `anderson_safeguard` x the best residual since the last restart.
    Convergence is declared only on a plain step's residuals, and the
    returned iterate is the best plain evaluation seen (the converging one
    on convergence), its residuals those of the info.
    """
    has_x, has_u = project_x is not None, project_u is not None
    F = stops.live.shape[0]
    kw = dict(dtype=z_u.dtype, device=z_u.device)
    sx = z_x[0].numel() if has_x else 0
    su = z_u[0].numel() if has_u else 0
    D, m = 2 * (sx + su), cfg.anderson_m
    consts = (z_x, z_u, lmb_x, lmb_u)

    def pack(zx, zu, lx, lu):
        parts = [t for t, on in ((zx, has_x), (zu, has_u), (lx, has_x), (lu, has_u)) if on]
        return torch.cat([t.reshape(F, -1) for t in parts], dim=1)

    def unpack(v):
        zx = v[:, :sx].reshape(consts[0].shape) if has_x else consts[0]
        zu = v[:, sx:sx + su].reshape(consts[1].shape) if has_u else consts[1]
        lx = v[:, sx + su:2 * sx + su].reshape(consts[2].shape) if has_x else consts[2]
        lu = v[:, 2 * sx + su:].reshape(consts[3].shape) if has_u else consts[3]
        return zx, zu, lx, lu

    def plain_step(zx, zu, lx, lu):
        """One plain scaled-ADMM iteration, as `_plain_loop`'s."""
        out = f_argmin(zx - lx if has_x else None, zu - lu if has_u else None)
        x_x, x_u = out[0], out[1]
        prim = dual = torch.zeros((F,), **kw)
        if has_x:
            zx_n = project_x(cfg.alpha * x_x + (1.0 - cfg.alpha) * zx + lx)
            r = x_x - zx_n
            lx, prim, dual = lx + r, prim + _norm(wx(r)), dual + _norm(wx(zx_n - zx))
            zx = zx_n
        if has_u:
            zu_n = project_u(cfg.alpha * x_u + (1.0 - cfg.alpha) * zu + lu)
            r = x_u - zu_n
            lu, prim, dual = lu + r, prim + _norm(wu(r)), dual + _norm(wu(zu_n - zu))
            zu = zu_n
        return out, zx, zu, lx, lu, prim, dual

    inf = torch.full((F,), math.inf, **kw)
    big = torch.full((F,), 1e6, **kw)
    logs = torch.zeros((F, cfg.max_iter, 2), **kw)
    eye_m = torch.eye(m, **kw)
    eps = torch.finfo(kw["dtype"]).eps
    v = pack(z_x, z_u, lmb_x, lmb_u)
    ret = ((torch.zeros_like(z_x), torch.zeros_like(z_u)), z_x, z_u, lmb_x, lmb_u)
    ret_score = (inf, big, big)
    prim, dual = big, big
    mem_dv = torch.zeros((F, m, D), **kw)
    mem_dg = torch.zeros((F, m, D), **kw)
    prev_v = torch.zeros((F, D), **kw)
    prev_g = torch.zeros((F, D), **kw)
    no = torch.zeros((F,), dtype=torch.bool, device=kw["device"])
    has_prev, flat_prev, best = no, no, inf
    go = cfg.max_iter > 0
    while go:
        live = stops.live
        with ranged():
            out, zx_n, zu_n, lx_n, lu_n, prim_new, dual_new = plain_step(*unpack(v))
            v_plain = pack(zx_n, zu_n, lx_n, lu_n)
            g = v_plain - v
            gnorm = _norm(g)
            restart = has_prev & (gnorm > cfg.anderson_safeguard * best)
            push = has_prev & ~restart
            mem_dv_p = torch.cat([mem_dv[:, 1:], (v - prev_v)[:, None]], dim=1)
            mem_dg_p = torch.cat([mem_dg[:, 1:], (g - prev_g)[:, None]], dim=1)
            cleared = torch.zeros_like(mem_dv)
            mem_dv_n = keep(push, mem_dv_p, keep(restart, cleared, mem_dv))
            mem_dg_n = keep(push, mem_dg_p, keep(restart, cleared, mem_dg))
            # type-II LS for the mixing weights; zero (unfilled) rows drop
            # out through the Tikhonov term, and an all-zero memory gives
            # gamma = 0, i.e. the plain step
            gram = mem_dg_n @ mem_dg_n.transpose(-1, -2)
            reg = cfg.anderson_reg * torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1) + 1e-30
            gam = torch.linalg.solve(gram + reg[:, None, None] * eye_m, _mv(mem_dg_n, g))
            v_aa = v + g - _mv((mem_dv_n + mem_dg_n).transpose(-1, -2), gam)
            # near the dtype's residual floor the secant pairs are noise:
            # take plain steps below a machine-precision-scaled floor
            use_aa = (gnorm > 1e3 * eps * (1.0 + _norm(v_plain))) & ~restart
            v_next = keep(use_aa, v_aa, v_plain)
            best_n = torch.where(restart, inf, torch.minimum(best, gnorm))

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
            take = live & ((score_new < ret_score[0]) | converged)
            ret = _keep_tree(take, (out, zx_n, zu_n, lx_n, lu_n), ret)
            ret_score = tuple(torch.where(take, n, o)
                              for n, o in zip((score_new, prim_new, dual_new), ret_score))

            logs[:, stops.k] = sel(live, torch.stack([prim_new, dual_new], dim=1), logs[:, stops.k])
            prim, dual = sel(live, prim_new, prim), sel(live, dual_new, dual)
            prev_v, prev_g = sel(live, v, prev_v), sel(live, g, prev_g)
            has_prev, flat_prev = sel(live, ~restart, has_prev), sel(live, flat, flat_prev)
            mem_dv, mem_dg = sel(live, mem_dv_n, mem_dv), sel(live, mem_dg_n, mem_dg)
            best = sel(live, best_n, best)
            v = sel(live, v_next, v)
            go = stops.update(converged, stalled)

    out, z_x, z_u, lmb_x, lmb_u = ret
    _score, prim, dual = ret_score
    return out, z_x, z_u, lmb_x, lmb_u, prim, dual, logs


def _run(f_argmin, project_x, project_u, cfg, z_x, z_u, lmb_x, lmb_u, part, weight_x, weight_u,
         rho_weight_x, rho_weight_u, profile):
    """`admm_fleet` and the status read last (see `_Stops.finish`)."""
    if project_x is None and project_u is None:
        raise ValueError("at least one of project_x / project_u is required")
    _check_modes(cfg, f_argmin)
    F = z_u.shape[0]
    masked = part is not None or F > 1
    live = torch.ones((F,), dtype=torch.bool, device=z_u.device) if part is None else part
    stops = _Stops(cfg, live, masked, can_stop(cfg))
    sel = keep if masked else (lambda mask, new, old: new)
    ranged = (lambda: record_function(profile)) if profile else contextlib.nullcontext
    ident = lambda r: r  # noqa: E731
    wx, wu = weight_x or ident, weight_u or ident
    if cfg.anderson_m > 0:
        res = _anderson_loop(f_argmin, project_x, project_u, cfg, z_x, z_u, lmb_x, lmb_u, stops,
                             sel, ranged, wx, wu)
    else:
        res = _plain_loop(f_argmin, project_x, project_u, cfg, z_x, z_u, lmb_x, lmb_u, stops, sel,
                          ranged, wx, wu, rho_weight_x or ident, rho_weight_u or ident)
    out, z_x, z_u, lmb_x, lmb_u, prim, dual, logs = res
    host = stops.finish()
    info = FleetADMMInfo(iters=stops.iters, prim_res=prim, dual_res=dual, status=stops.status,
                         logs=logs, fleet_iters=stops.k)
    aux = out[2] if len(out) > 2 else None
    return (out[0], out[1], aux, lmb_x, lmb_u, z_x, z_u, info), host


def admm_fleet(
    f_argmin: Callable,
    project_x: Optional[Callable],
    project_u: Optional[Callable],
    cfg: ADMMConfig,
    z_x: torch.Tensor,
    z_u: torch.Tensor,
    lmb_x: torch.Tensor,
    lmb_u: torch.Tensor,
    *,
    part: Optional[torch.Tensor] = None,
    weight_x: Optional[Callable] = None,
    weight_u: Optional[Callable] = None,
    rho_weight_x: Optional[Callable] = None,
    rho_weight_u: Optional[Callable] = None,
    profile: Optional[str] = None,
):
    """`admm_solve` for each instance of a fleet, the counterpart of
    `jax.vmap` of the JAX package's loop.

    Every iterate carries a leading fleet axis F: z_x (F, *shape_x), z_u
    (F, *shape_u) and the scaled duals lmb_x, lmb_u start the loop (a
    disabled block's stay as given). f_argmin(reg_x, reg_u[, rho_scale])
    -> (x_x, x_u[, aux]) takes and returns the fleet's rows (reg None for
    a disabled block; rho_scale (F,), each instance's, with
    cfg.adaptive_rho; aux tensors with the F axis, nested in tuples);
    project_*, weight_* and rho_weight_* map the fleet's rows to rows.

    part (F,) bool: the instances that take part (default all); the
    others keep their carry and report 0 iterations. Each instance
    iterates until its own stop (converged, stalled or cfg.max_iter) and
    then keeps its carry; the loop ends when none is left, after one host
    read an iteration for the whole fleet, or runs cfg.max_iter
    iterations without a read when no stop test can pass
    (`can_stop`). profile: a `torch.profiler` range around each
    iteration.

    Returns (x_x, x_u, aux, lmb_x, lmb_u, z_x, z_u, FleetADMMInfo), each
    with the fleet axis, as `admm_solve` returns them for one instance.
    """
    return _run(f_argmin, project_x, project_u, cfg, z_x, z_u, lmb_x, lmb_u, part, weight_x,
                weight_u, rho_weight_x, rho_weight_u, profile)[0]


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

    This is `admm_fleet` on a fleet of one: one host read an iteration.
    """
    if project_x is None and project_u is None:
        raise ValueError("at least one of project_x / project_u is required")
    # the mode checks read the caller's x-update, not the fleet wrapper's
    _check_modes(cfg, f_argmin)
    inits = (z_x_init, z_u_init, lmb_x_init, lmb_u_init)
    if device is None:
        given = [t for t in inits if isinstance(t, torch.Tensor)]
        device = given[0].device if given else resolve_device(None)
    kw = dict(dtype=dtype, device=device)

    def init(t, shape):
        return (torch.zeros(shape, **kw) if t is None else torch.as_tensor(t, device=device))[None]

    z_x, z_u = init(z_x_init, shape_x), init(z_u_init, shape_u)
    lmb_x, lmb_u = init(lmb_x_init, shape_x), init(lmb_u_init, shape_u)
    if cfg.adaptive_rho:
        def fleet_f(reg_x, reg_u, s):
            return _lift(f_argmin(_drop(reg_x), _drop(reg_u), s[0]))
    else:
        def fleet_f(reg_x, reg_u):
            return _lift(f_argmin(_drop(reg_x), _drop(reg_u)))
    (x_x, x_u, aux, lmb_x, lmb_u, z_x, z_u, info), host = _run(
        fleet_f, _on_row(project_x), _on_row(project_u), cfg, z_x, z_u, lmb_x, lmb_u, None,
        _on_row(weight_x), _on_row(weight_u), _on_row(rho_weight_x), _on_row(rho_weight_u), None)
    single = ADMMInfo(iters=info.fleet_iters, prim_res=info.prim_res[0], dual_res=info.dual_res[0],
                      status=host, logs=info.logs[0])
    return x_x[0], x_u[0], _drop(aux), lmb_x[0], lmb_u[0], z_x[0], z_u[0], single
