"""Constrained LQT via ADMM splitting, batch and DP x-updates
(counterpart of `ilqr_admm_tpu/solvers/lqt_admm.py`).

The z-update projections act on flattened lifted vectors (N*x_dim,) /
(N*u_dim,). These are the x-updates that accept `admm_solve`'s rho_scale,
so they are how the adaptive-rho branch of `admm_solve` is held against
the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import jacfwd, vmap

from ilqr_admm_tpu_torch.ops.lifted import build_Su, sw_x0
from ilqr_admm_tpu_torch.ops.riccati import lqt_backward, lqt_backward_ff
from ilqr_admm_tpu_torch.problem import ADMMConfig, QuadCost
from ilqr_admm_tpu_torch.solvers.admm import admm_solve, validate_constraint_blocks
from ilqr_admm_tpu_torch.solvers.lqt import (
    block_diag_stacked,
    blockdiag_matmul,
    broadcast_rho,
    sqrt_psd_stacked,
)
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


def cho_factor(M):
    """Upper Cholesky factor of M, read from its upper triangle as
    `jax.scipy.linalg.cho_factor` does; no error check (and no host sync)."""
    return torch.linalg.cholesky_ex(M, upper=True).L


def cho_solve(U, rhs):
    """Solve with an upper Cholesky factor; rhs (n,) or (n, k)."""
    if rhs.ndim == 1:
        return torch.cholesky_solve(rhs[:, None], U, upper=True)[:, 0]
    return torch.cholesky_solve(rhs, U, upper=True)


def blockwise(P, dim, N):
    """r -> blockdiag(P) r for r (N*dim,), or for each row of a fleet's r
    (F, N*dim), without the dense operator."""
    def apply(r):
        blocks = r.reshape(*r.shape[:-1], N, dim)
        return torch.einsum("nij,...nj->...ni", P, blocks).reshape(r.shape)

    return apply


@full_f32_matmul()
def lqt_admm_batch(
    A, B, cost: QuadCost, x0,
    project_x: Optional[Callable] = None,
    project_u: Optional[Callable] = None,
    rho_x=None,
    rho_u=None,
    cfg: ADMMConfig = ADMMConfig(),
    use_qr: bool = False,
):
    """Constrained LQT, lifted least-squares x-update (one solve an iteration).

    Returns (x_flat (N*x_dim,), u_flat (N*u_dim,), info). use_qr=True
    factors the stacked square-root system [sqrt(Q) Su; sqrt(R);
    sqrt(Qr) Su; sqrt(Rr)] by QR instead of the normal equations
    (cond(G) instead of cond(G)^2). Runs on the device of A.
    """
    validate_constraint_blocks(project_x, rho_x, project_u, rho_u)
    if use_qr:
        return _lqt_admm_batch_qr(A, B, cost, x0, project_x, project_u, rho_x, rho_u, cfg)
    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    dtype, device = A.dtype, A.device

    Qr = broadcast_rho(rho_x, d, N, dtype, device)
    Rr = broadcast_rho(rho_u, m, N, dtype, device)

    Su = build_Su(A, B)
    Qlift = block_diag_stacked(cost.Q)
    Rlift = block_diag_stacked(cost.R)
    SuTQ = Su.T @ Qlift
    l_side = SuTQ @ Su + Rlift
    free = sw_x0(A, x0).reshape(-1)
    r_side = SuTQ @ (cost.lifted_xd() - free)

    # warm start z from the unconstrained optimum
    u_unc = cho_solve(cho_factor(l_side), r_side)
    z_u0 = u_unc
    z_x0 = free + Su @ u_unc

    SuTQr = SuTQr_Su = None
    if Qr is not None:
        SuTQr = Su.T @ block_diag_stacked(Qr)
        SuTQr_Su = SuTQr @ Su
    Rr_l = block_diag_stacked(Rr) if Rr is not None else None

    rho_wx = rho_wu = None
    if cfg.adaptive_rho:
        # the normal matrix depends on the current rho scale: refactor
        # l_side + s * reg_mat in each x-update
        reg_mat = torch.zeros_like(l_side)
        if SuTQr_Su is not None:
            reg_mat = reg_mat + SuTQr_Su
            Qr_l = block_diag_stacked(Qr)
            rho_wx = lambda r: Qr_l @ r  # noqa: E731
        if Rr_l is not None:
            reg_mat = reg_mat + Rr_l
            rho_wu = lambda r: Rr_l @ r  # noqa: E731

        def f_argmin(x, u, s):
            r = r_side
            if SuTQr is not None:
                r = r - s * (SuTQr @ free)
                if x is not None:
                    r = r + s * (SuTQr @ x)
            if Rr_l is not None and u is not None:
                r = r + s * (Rr_l @ u)
            u_hat = cho_solve(cho_factor(l_side + s * reg_mat), r)
            return free + Su @ u_hat, u_hat

    else:
        if SuTQr_Su is not None:
            l_side = l_side + SuTQr_Su
            r_side = r_side - SuTQr @ free
            if cfg.accel:  # rho-weight the accel restart monitor a block
                rho_wx = blockwise(Qr, d, N)
        if Rr_l is not None:
            l_side = l_side + Rr_l
            if cfg.accel:
                rho_wu = blockwise(Rr, m, N)
        cf = cho_factor(l_side)

        def f_argmin(x, u):
            r = r_side
            if SuTQr is not None and x is not None:
                r = r + SuTQr @ x
            if Rr_l is not None and u is not None:
                r = r + Rr_l @ u
            u_hat = cho_solve(cf, r)
            return free + Su @ u_hat, u_hat

    x_x, x_u, _, _, _, _, _, info = admm_solve(
        f_argmin, project_x, project_u, (N * d,), (N * m,), cfg,
        z_x_init=z_x0, z_u_init=z_u0,
        rho_weight_x=rho_wx, rho_weight_u=rho_wu, dtype=dtype, device=device,
    )
    return x_x, x_u, info


def _lqt_admm_batch_qr(A, B, cost, x0, project_x, project_u, rho_x, rho_u, cfg):
    """QR (square-root) x-update variant of the batch LQT-ADMM."""
    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    dtype, device = A.dtype, A.device

    Qr = broadcast_rho(rho_x, d, N, dtype, device)
    Rr = broadcast_rho(rho_u, m, N, dtype, device)

    Su = build_Su(A, B)
    free = sw_x0(A, x0).reshape(-1)
    xd = cost.lifted_xd()

    # block square roots kept stacked; blockdiag_matmul applies them blockwise
    sqQ = sqrt_psd_stacked(cost.Q)
    sqR = block_diag_stacked(sqrt_psd_stacked(cost.R))
    rows = [blockdiag_matmul(sqQ, Su), sqR]
    sqQr = sqRr = None
    if Qr is not None and project_x is not None:
        sqQr = sqrt_psd_stacked(Qr)
        rows.append(blockdiag_matmul(sqQr, Su))
    if Rr is not None and project_u is not None:
        sqRr = block_diag_stacked(sqrt_psd_stacked(Rr))
        rows.append(sqRr)
    Qf, Rf = torch.linalg.qr(torch.cat(rows, dim=0))  # reduced

    # stacked rhs c with G^T c = r_side; u = Rf^{-1} Qf^T c
    c0 = blockdiag_matmul(sqQ, xd - free)
    zeros_R = torch.zeros((N * m,), dtype=dtype, device=device)

    def solve_ls(c_parts):
        c = torch.cat(c_parts, dim=0)
        return torch.linalg.solve_triangular(Rf, (Qf.T @ c)[:, None], upper=True)[:, 0]

    # warm start: regularized LS with zero-centered targets
    warm_parts = [c0, zeros_R]
    if sqQr is not None:
        warm_parts.append(torch.zeros((N * d,), dtype=dtype, device=device))
    if sqRr is not None:
        warm_parts.append(zeros_R)
    u_unc = solve_ls(warm_parts)

    def f_argmin(x, u):
        parts = [c0, zeros_R]
        if sqQr is not None:
            parts.append(blockdiag_matmul(sqQr, (x if x is not None else free) - free))
        if sqRr is not None:
            parts.append(sqRr @ (u if u is not None else zeros_R))
        u_hat = solve_ls(parts)
        return free + Su @ u_hat, u_hat

    x_x, x_u, _, _, _, _, _, info = admm_solve(
        f_argmin, project_x, project_u, (N * d,), (N * m,), cfg,
        z_x_init=free + Su @ u_unc, z_u_init=u_unc, dtype=dtype, device=device,
    )
    return x_x, x_u, info


def _closed_loop(A, B, K, k, x0):
    """x_{t+1} = A_t x_t + B_t (K_t x_t + k_t); returns flat (xs, us)."""
    xs, us = [], []
    xt = x0
    for t in range(A.shape[0]):
        ut = K[t] @ xt + k[t]
        xs.append(xt)
        us.append(ut)
        xt = A[t] @ xt + B[t] @ ut
    return torch.stack(xs).reshape(-1), torch.stack(us).reshape(-1)


def dp_sweep(A, B, cost: QuadCost, Qr, Rr):
    """The Riccati DP x-update of `lqt_admm_dp`: one backward pass with the
    penalties, and sweep(x0, xr_flat, ur_flat) -> (xs, us, k), the
    feedforward re-sweep for the ADMM targets and the closed loop from x0
    (affine in x0 and the targets). Returns (gains, sweep)."""
    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    zxr = torch.zeros((N, d), dtype=A.dtype, device=A.device)
    zur = torch.zeros((N, m), dtype=A.dtype, device=A.device)
    gains = lqt_backward(A, B, cost.Q, cost.xd, cost.R, Qr=Qr, xr=zxr, Rr=Rr, ur=zur)

    def sweep(x0, x_flat, u_flat):
        k = lqt_backward_ff(
            gains, A, B, cost.Q, cost.xd,
            Qr=Qr, xr=x_flat.reshape(N, d), Rr=Rr, ur=u_flat.reshape(N, m),
        )
        xs, us = _closed_loop(A, B, gains.K, k, x0)
        return xs, us, k

    return gains, sweep


def dp_operators(sweep, x0, zx_f, zu_f):
    """`dp_sweep`'s sweep as exact affine operators of the targets: (consts,
    jac_x, jac_u), each a tuple over (xs, us, k), with sweep(x0, x, u) =
    consts + jac_x @ x + jac_u @ u. x0 (d,), or a fleet's (F, d): consts
    then have a leading F axis. The Jacobians do not depend on x0."""
    if x0.ndim == 1:
        consts, one = sweep(x0, zx_f, zu_f), x0
    else:
        consts, one = vmap(sweep, in_dims=(0, None, None))(x0, zx_f, zu_f), x0[0]
    # in the working dtype: jacfwd carries products with Python floats
    # into the tangents as float64
    jac_x = tuple(J.to(zx_f.dtype) for J in jacfwd(lambda x: sweep(one, x, zu_f))(zx_f))
    jac_u = tuple(J.to(zx_f.dtype) for J in jacfwd(lambda u: sweep(one, zx_f, u))(zu_f))
    return consts, jac_x, jac_u


@full_f32_matmul()
def lqt_admm_dp(
    A, B, cost: QuadCost, x0,
    project_x: Optional[Callable] = None,
    project_u: Optional[Callable] = None,
    rho_x=None,
    rho_u=None,
    cfg: ADMMConfig = ADMMConfig(max_iter=2000),
    operator_form: bool = True,
):
    """Constrained LQT, Riccati DP x-update.

    One Riccati pass up front caches (K, Quu, Quu_inv, Qux); each ADMM
    iteration is the feedforward re-sweep plus the closed-loop rollout.
    operator_form=True precomputes that affine map of the ADMM targets as
    exact operators (one `torch.func.jacfwd`), so an iteration is a few
    matvecs; False keeps O(N) memory. With `cfg.adaptive_rho` each
    iteration re-runs the whole backward pass with s-scaled penalties.

    Returns (x_flat, u_flat, (K, k), info). Runs on the device of A.
    """
    validate_constraint_blocks(project_x, rho_x, project_u, rho_u)
    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    dtype, device = A.dtype, A.device

    Qr = broadcast_rho(rho_x, d, N, dtype, device)
    Rr = broadcast_rho(rho_u, m, N, dtype, device)

    if cfg.adaptive_rho:
        return _lqt_admm_dp_adaptive(A, B, cost, x0, project_x, project_u, Qr, Rr, cfg)

    gains, sweep0 = dp_sweep(A, B, cost, Qr, Rr)

    def sweep(x_flat, u_flat):
        return sweep0(x0, x_flat, u_flat)

    zx_f = torch.zeros((N * d,), dtype=dtype, device=device)
    zu_f = torch.zeros((N * m,), dtype=dtype, device=device)

    if operator_form:
        consts, jac_x, jac_u = dp_operators(sweep0, x0, zx_f, zu_f)

        def f_argmin(x, u):
            xv = x if x is not None else zx_f
            uv = u if u is not None else zu_f
            xs, us, k = (c + Jx @ xv + Ju @ uv for c, Jx, Ju in zip(consts, jac_x, jac_u))
            return xs, us, (gains.K, k)

    else:

        def f_argmin(x, u):
            xs, us, k = sweep(x if x is not None else zx_f, u if u is not None else zu_f)
            return xs, us, (gains.K, k)

    x_x, x_u, aux, _, _, _, _, info = admm_solve(
        f_argmin, project_x, project_u, (N * d,), (N * m,), cfg, dtype=dtype, device=device
    )
    return x_x, x_u, aux, info


def dp_adaptive_update(A, B, cost, Qr, Rr, x0, x_flat, u_flat, s):
    """The adaptive-rho DP x-update of one instance: the whole backward
    pass with s-scaled Qr/Rr toward the targets (x_flat, u_flat; None
    for a disabled block), then the closed-loop rollout from x0. Returns
    (xs, us, (K, k)); vmappable over (x0, x_flat, u_flat, s)."""
    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    kw = dict(dtype=A.dtype, device=A.device)
    xr = torch.zeros((N, d), **kw) if x_flat is None else x_flat.reshape(N, d)
    ur = torch.zeros((N, m), **kw) if u_flat is None else u_flat.reshape(N, m)
    g = lqt_backward(
        A, B, cost.Q, cost.xd, cost.R,
        Qr=None if Qr is None else s * Qr, xr=xr,
        Rr=None if Rr is None else s * Rr, ur=ur,
    )
    xs, us = _closed_loop(A, B, g.K, g.k, x0)
    return xs, us, (g.K, g.k)


def _lqt_admm_dp_adaptive(A, B, cost, x0, project_x, project_u, Qr, Rr, cfg):
    """Adaptive-rho DP x-update: each ADMM iteration re-runs the whole
    backward pass with s-scaled Qr/Rr, then the closed-loop rollout."""
    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    dtype, device = A.dtype, A.device

    def f_argmin(x_flat, u_flat, s):
        return dp_adaptive_update(A, B, cost, Qr, Rr, x0, x_flat, u_flat, s)

    rho_wx = blockwise(Qr, d, N) if Qr is not None and project_x is not None else None
    rho_wu = blockwise(Rr, m, N) if Rr is not None and project_u is not None else None

    x_x, x_u, aux, _, _, _, _, info = admm_solve(
        f_argmin, project_x, project_u, (N * d,), (N * m,), cfg,
        rho_weight_x=rho_wx, rho_weight_u=rho_wu, dtype=dtype, device=device,
    )
    return x_x, x_u, aux, info
