"""Robust iLQR (iSLS-ADMM): nonlinear chance-constrained synthesis
(counterpart of `ilqr_admm_tpu/solvers/isls_admm.py`).

An outer relinearization loop; the decision variable of each inner ADMM
is the matrix [du_ff | Phi_u[:, :p]], the feedforward delta and the
response columns of the first p initial-state coordinates. The x-update
line-searches the feedforward column only; residual norms are
penalty-weighted; the projections receive the nominal, so that they can
shift deltas into absolute coordinates.

As in `solvers/ilqr_admm.py`, the JAX `lax.while_loop`s are host loops:
each outer step and each ADMM iteration ends in one read of its stop
flags (`admm.read_flags`). Every product runs in full f32 (TF32 off),
the counterpart of the JAX wrapper's "highest" matmul precision.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import vmap

from ilqr_admm_tpu_torch.chance import make_box_chance_projection
from ilqr_admm_tpu_torch.ops.lifted import build_Su, build_Sx
from ilqr_admm_tpu_torch.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu_torch.problem import ADMMConfig, SolveStatus
from ilqr_admm_tpu_torch.solvers.admm import admm_solve, validate_constraint_blocks
from ilqr_admm_tpu_torch.solvers.ilqr import nan_to_inf, take
from ilqr_admm_tpu_torch.solvers.ilqr_admm import _default_alphas, _outer_status, _to_device
from ilqr_admm_tpu_torch.solvers.lqt import block_diag_stacked, broadcast_rho
from ilqr_admm_tpu_torch.solvers.lqt_admm import cho_factor, cho_solve
from ilqr_admm_tpu_torch.utils.device import resolve_device
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


class ISLSResult(NamedTuple):
    du: torch.Tensor  # (N*m,) feedforward delta (~0 at convergence)
    phi_u: torch.Tensor  # (N*m, p) robust response columns
    x_nom: torch.Tensor
    u_nom: torch.Tensor
    cost: torch.Tensor
    outer_iters: int
    status: int  # SolveStatus
    cost_log: torch.Tensor  # (k_max,) outer-iteration costs (inf beyond)


def _isls_admm_impl(
    f: Callable,
    get_AB: Callable,
    cost_fn: Callable,
    x_nom0,
    u_nom0,
    robust_dim: int,
    get_Cs: Optional[Callable] = None,
    quad_cost=None,
    project_x: Optional[Callable] = None,
    project_u: Optional[Callable] = None,
    rho_x=None,
    rho_u=None,
    k_max: int = 20,
    max_admm_iter: int = 20,
    alphas=None,
    alpha: float = 1.0,
    tol: float = 1e-3,
    outer_tol: float = 1e-4,
    osc_tol: float = 1e-3,
    joint_alpha: Optional[float] = None,
    u_bounds=None,
    x0_var=None,
    chance_method: str = "chi",
    feasible_iterate: Optional[bool] = None,
    anderson_m: int = 0,
) -> ISLSResult:
    N, d = x_nom0.shape
    m = u_nom0.shape[-1]
    p = robust_dim
    dtype, device = x_nom0.dtype, x_nom0.device

    if joint_alpha is not None:
        if project_u is not None:
            raise ValueError("pass either joint_alpha or project_u, not both")
        if u_bounds is None or x0_var is None:
            raise ValueError("joint_alpha requires u_bounds=(lo, hi) and x0_var")
        project_u, _cal = make_box_chance_projection(
            x0_var, p, u_bounds[0], u_bounds[1], joint_alpha=joint_alpha, n_rows=N * m,
            method=chance_method, shifted=True, device=device, dtype=dtype,
        )
    # as in sls_admm: the z-side controller by default only without an
    # x-block, whose constraints the u-side z-iterate alone does not keep
    if feasible_iterate is None:
        feasible_iterate = joint_alpha is not None and project_x is None
    validate_constraint_blocks(project_x, rho_x, project_u, rho_u)
    if alphas is None:
        alphas = _default_alphas(dtype, device)

    Qr = broadcast_rho(rho_x, d, N, dtype, device)
    Rr = broadcast_rho(rho_u, m, N, dtype, device)
    Qr_l = block_diag_stacked(Qr) if (Qr is not None and project_x is not None) else None
    Rr_l = block_diag_stacked(Rr) if (Rr is not None and project_u is not None) else None
    admm_cfg = ADMMConfig(max_iter=max_admm_iter, alpha=alpha, tol=tol, stall_tol=1e-3,
                          anderson_m=anderson_m)

    def body(x_nom, u_nom, z_x, z_u):
        A, B = get_AB(x_nom, u_nom)
        Su = build_Su(A, B)
        Sx = build_Sx(A, p).reshape(N * d, p)
        x_nom_f, u_nom_f = x_nom.reshape(-1), u_nom.reshape(-1)
        if get_Cs is not None:
            cts, Cts = get_Cs(x_nom, u_nom)
            SuTQ = Su.T @ (0.5 * block_diag_stacked(Cts[:, :d, :d]))
            l_side = SuTQ @ Su + 0.5 * block_diag_stacked(Cts[:, d:, d:])
            r_side_ff = Su.T @ (-0.5 * cts[:, :d].reshape(-1)) - 0.5 * cts[:, d:].reshape(-1)
        else:
            Rlift = block_diag_stacked(quad_cost.R)
            SuTQ = Su.T @ block_diag_stacked(quad_cost.Q)
            l_side = SuTQ @ Su + Rlift
            r_side_ff = SuTQ @ (quad_cost.lifted_xd() - x_nom_f) + Rlift @ (-u_nom_f)
        r_side_fb = -SuTQ @ Sx
        SuTQr = None
        if Qr_l is not None:
            SuTQr = Su.T @ Qr_l
            l_side = l_side + SuTQr @ Su
            r_side_fb = r_side_fb - SuTQr @ Sx
        if Rr_l is not None:
            l_side = l_side + Rr_l
        cf = cho_factor(l_side)
        r_side = torch.cat([r_side_ff[:, None], r_side_fb], dim=-1)

        def f_argmin(x, u):
            add_r = torch.zeros_like(r_side)
            if SuTQr is not None and x is not None:
                add_r = add_r + SuTQr @ x
            if Rr_l is not None and u is not None:
                add_r = add_r + Rr_l @ u
            dU = cho_solve(cf, r_side + add_r)  # (N*m, p+1)
            dX = Su @ dU
            dX[:, 1:] += Sx
            # the line search moves the feedforward column only
            delta_u = dU[:, 0].reshape(N, m)
            us_c = u_nom[None] + alphas[:, None, None] * delta_u[None]
            xs_c = vmap(lambda us: rollout_nonlinear(f, x_nom[0], us))(us_c)
            ind = torch.argmin(nan_to_inf(vmap(cost_fn)(xs_c, us_c)))
            dU[:, 0] = (take(us_c, ind) - u_nom).reshape(-1)
            dX[:, 0] = (take(xs_c, ind) - x_nom).reshape(-1)
            return dX, dU

        if project_x is None and project_u is None:
            # unconstrained robust synthesis: the ADMM is one x-update
            x_x, x_u = f_argmin(None, None)
            return x_x, x_u, z_x, z_u
        px = (lambda y: project_x(y, x_nom)) if project_x is not None else None
        pu = (lambda y: project_u(y, u_nom)) if project_u is not None else None
        x_x, x_u, _, _, _, z_x_n, z_u_n, _info = admm_solve(
            f_argmin, px, pu, (N * d, p + 1), (N * m, p + 1), admm_cfg,
            z_x_init=z_x, z_u_init=z_u,
            weight_x=(lambda r: Qr_l @ r) if Qr_l is not None else None,
            weight_u=(lambda r: Rr_l @ r) if Rr_l is not None else None,
            dtype=dtype, device=device,
        )
        return x_x, x_u, z_x_n, z_u_n

    kw = dict(dtype=dtype, device=device)
    x_nom, u_nom = x_nom0, u_nom0
    cost = cost_fn(x_nom, u_nom)
    z_x = torch.zeros((N * d, p + 1), **kw)
    z_u = torch.zeros((N * m, p + 1), **kw)
    U_last = torch.zeros((N * m, p + 1), **kw)
    cost_log = torch.full((k_max,), math.inf, **kw)
    it, status = 0, SolveStatus.RUNNING
    while it < k_max and status == SolveStatus.RUNNING:
        x_x, U_last, z_x, z_u = body(x_nom, u_nom, z_x, z_u)
        u_new = u_nom + U_last[:, 0].reshape(N, m)
        x_new = x_nom + x_x[:, 0].reshape(N, d)
        cost_new = cost_fn(x_new, u_new)
        cost_log[it] = cost_new
        status = _outer_status(cost_new, cost, cost_log, it, outer_tol, osc_tol)
        x_nom, u_nom, cost = x_new, u_new, cost_new
        it += 1
    if status == SolveStatus.RUNNING:
        status = SolveStatus.MAX_ITER

    # the final [du | phi_u] from the last x-update, or the projected
    # z-iterate when the returned controller must be feasible. The z-side
    # feedforward is a delta against the nominal before the last x-step,
    # and u_nom includes that step, so it is subtracted: u_nom + du is the
    # projected value.
    if feasible_iterate and project_u is not None:
        du, phi_u = z_u[:, 0] - U_last[:, 0], z_u[:, 1:]
    else:
        du, phi_u = U_last[:, 0], U_last[:, 1:]
    return ISLSResult(du=du, phi_u=phi_u, x_nom=x_nom, u_nom=u_nom, cost=cost,
                      outer_iters=it, status=int(status), cost_log=cost_log)


def isls_admm(f, get_AB, cost_fn, x_nom0, u_nom0, robust_dim: int, *, device=None,
              **kwargs) -> ISLSResult:
    """Run robust iSLS-ADMM from a nominal trajectory guess.

    The keyword arguments of the JAX package's `isls_admm`: get_Cs or
    quad_cost, project_x / project_u with rho_x / rho_u, k_max,
    max_admm_iter, alphas, alpha, tol, outer_tol, osc_tol, joint_alpha
    with u_bounds and x0_var (and chance_method), feasible_iterate and
    anderson_m. A projection is called as proj(z_plus_lambda, nominal):
    z_plus_lambda is ((N*dim), p+1), column 0 the feedforward delta and
    columns 1..p the response map, and nominal the current (N, dim)
    nominal trajectory.

    joint_alpha: the turnkey joint chance-constraint calibration (see
    `chance.py`); with u_bounds=(lower, upper) and x0_var the shifted SOC
    `project_u` is built here (it excludes passing project_u), and the
    returned controller is the projected z-iterate unless
    feasible_iterate=False or an x-block is present.

    device: where the solve runs (default the CUDA card); x_nom0, u_nom0
    and alphas are moved there. f, get_AB, get_Cs, cost_fn and the
    projections must work on that device. Every product runs in full f32.
    """
    device = resolve_device(device)
    x_nom0, u_nom0 = _to_device(x_nom0, device), _to_device(u_nom0, device)
    kwargs["alphas"] = _to_device(kwargs.get("alphas"), device)
    with full_f32_matmul():
        return _isls_admm_impl(f, get_AB, cost_fn, x_nom0, u_nom0, robust_dim, **kwargs)
