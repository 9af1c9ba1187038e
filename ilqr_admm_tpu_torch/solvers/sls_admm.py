"""Robust SLS-ADMM: constrained response-map synthesis (counterpart of
`ilqr_admm_tpu/solvers/sls_admm.py`).

The decision variable is the matrix [du | Phi_u[:, :p]], feedforward plus
the response-map columns of the first p initial-state coordinates, so
the x-update is one multi-right-hand-side prefactored solve. Residual
norms are penalty-weighted. `joint_alpha` builds the chance-constraint
projection from a joint confidence level (`chance.py`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ilqr_admm_tpu_torch.chance import make_box_chance_projection
from ilqr_admm_tpu_torch.ops.lifted import build_Su, build_Sx
from ilqr_admm_tpu_torch.problem import ADMMConfig, QuadCost
from ilqr_admm_tpu_torch.solvers.admm import admm_solve, validate_constraint_blocks
from ilqr_admm_tpu_torch.solvers.lqt import block_diag_stacked, broadcast_rho, lqt_solve_sls
from ilqr_admm_tpu_torch.solvers.lqt_admm import cho_factor, cho_solve
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


@full_f32_matmul()
def sls_admm(
    A, B, cost: QuadCost,
    project_x: Optional[Callable] = None,
    project_u: Optional[Callable] = None,
    rho_x=None,
    rho_u=None,
    robust_dim: Optional[int] = None,
    cfg: ADMMConfig = ADMMConfig(max_iter=5000, stall_tol=1e-2),
    joint_alpha: Optional[float] = None,
    u_bounds=None,
    x0_var=None,
    chance_method: str = "chi",
    feasible_iterate: Optional[bool] = None,
):
    """Solve the robust SLS problem with ADMM.

    robust_dim: number of leading initial-state coordinates the synthesis
    is robust to (default x_dim // 2, the position block). Projections
    receive (rows, robust_dim + 1) matrices whose rows are [du_i, phi_i].

    joint_alpha: the turnkey joint chance-constraint calibration (see
    `chance.py`): with u_bounds=(lower, upper) and x0_var (the variance
    of the robust initial-state block) the SOC tightening comes from the
    joint level (default chance_method='chi', psi = chi_p^{-1}(joint_alpha);
    'sidak' and 'bonferroni' correct per-row levels) and the SOC
    `project_u` is built here; it excludes passing project_u.

    feasible_iterate: return the z-side (projected) u-block instead of
    the x-update's output; the z-iterate lies in the constraint sets by
    construction, the x-iterate only at convergence. Default: True with
    joint_alpha and no x-block, else False.

    Returns (du (Nm,), phi_u (Nm, Nd), info); phi_u splices the optimized
    robust columns into the unconstrained response map. Runs on the
    device of A.
    """
    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    dtype, device = A.dtype, A.device
    p = d // 2 if robust_dim is None else robust_dim

    if joint_alpha is not None:
        if project_u is not None:
            raise ValueError("pass either joint_alpha or project_u, not both")
        if u_bounds is None or x0_var is None:
            raise ValueError("joint_alpha requires u_bounds=(lo, hi) and x0_var")
        project_u, _cal = make_box_chance_projection(
            x0_var, p, u_bounds[0], u_bounds[1], joint_alpha=joint_alpha, n_rows=N * m,
            method=chance_method, device=device, dtype=dtype,
        )
    # the z-side by default only without an x-block: with a state
    # projection the u-side z-iterate alone is not dynamics-consistent
    # with the x-side constraints
    if feasible_iterate is None:
        feasible_iterate = joint_alpha is not None and project_x is None
    validate_constraint_blocks(project_x, rho_x, project_u, rho_u)

    # unconstrained synthesis for the non-robust columns
    PHI_U_unc, _ = lqt_solve_sls(A, B, cost)

    Su = build_Su(A, B)
    Sx = build_Sx(A, p).reshape(-1, p)  # the first p columns of Sw

    Qr = broadcast_rho(rho_x, d, N, dtype, device)
    Rr = broadcast_rho(rho_u, m, N, dtype, device)
    Qr_l = block_diag_stacked(Qr) if Qr is not None else None
    Rr_l = block_diag_stacked(Rr) if Rr is not None else None

    SuTQ = Su.T @ block_diag_stacked(cost.Q)
    l_side = SuTQ @ Su + block_diag_stacked(cost.R)
    r_side_ff = SuTQ @ cost.lifted_xd()
    r_side_fb = -SuTQ @ Sx

    SuTQr = None
    reg_mat = torch.zeros_like(l_side)
    reg_fb = torch.zeros_like(r_side_fb)
    if Qr_l is not None and project_x is not None:
        SuTQr = Su.T @ Qr_l
        reg_mat = reg_mat + SuTQr @ Su
        reg_fb = -SuTQr @ Sx
    if Rr_l is not None and project_u is not None:
        reg_mat = reg_mat + Rr_l

    weight_x = (lambda r: Qr_l @ r) if Qr_l is not None else None
    weight_u = (lambda r: Rr_l @ r) if Rr_l is not None else None
    shapes = ((N * d, p + 1), (N * m, p + 1))

    if cfg.adaptive_rho:
        # the penalty scale s multiplies the whole regularizer: refactor
        # the (Nm, Nm) normal matrix in each x-update
        r_side0 = torch.cat([r_side_ff[:, None], r_side_fb], dim=-1)

        def f_argmin(x, u, s):
            r = r_side0.clone()
            r[:, 1:] += s * reg_fb
            if SuTQr is not None and x is not None:
                r = r + s * (SuTQr @ x)
            if Rr_l is not None and u is not None:
                r = r + s * (Rr_l @ u)
            U = cho_solve(cho_factor(l_side + s * reg_mat), r)
            X = Su @ U
            X[:, 1:] += Sx
            return X, U

        x_x, x_u, _, _, _, _, z_u, info = admm_solve(
            f_argmin, project_x, project_u, *shapes, cfg,
            weight_x=weight_x, weight_u=weight_u,
            rho_weight_x=weight_x, rho_weight_u=weight_u, dtype=dtype, device=device,
        )
    else:
        cf = cho_factor(l_side + reg_mat)
        r_side = torch.cat([r_side_ff[:, None], r_side_fb + reg_fb], dim=-1)  # (Nm, p+1)

        def f_argmin(x, u):
            r = r_side
            if SuTQr is not None and x is not None:
                r = r + SuTQr @ x
            if Rr_l is not None and u is not None:
                r = r + Rr_l @ u
            U = cho_solve(cf, r)
            X = Su @ U
            X[:, 1:] += Sx
            return X, U

        x_x, x_u, _, _, _, _, z_u, info = admm_solve(
            f_argmin, project_x, project_u, *shapes, cfg,
            weight_x=weight_x, weight_u=weight_u, dtype=dtype, device=device,
        )
    out_u = z_u if (feasible_iterate and project_u is not None) else x_u
    du = out_u[:, 0]
    phi_u = torch.cat([out_u[:, 1 : p + 1], PHI_U_unc[:, p:]], dim=-1)
    return du, phi_u, info
