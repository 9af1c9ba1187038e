"""LQT helpers and the SLS synthesis (counterpart of part of
`ilqr_admm_tpu/solvers/lqt.py`).

Ported so far: the penalty broadcast, the block-diagonal lift, the
lifted normal equations and `lqt_solve_sls`. The batch and DP solvers
come with a later slice.
"""

from __future__ import annotations

import torch

from ilqr_admm_tpu_torch.ops.lifted import build_Su, build_Sw
from ilqr_admm_tpu_torch.ops.sls_synthesis import sls_synthesize
from ilqr_admm_tpu_torch.problem import QuadCost
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


def broadcast_rho(rho, dim: int, N: int, dtype: torch.dtype | None = None, device=None):
    """Broadcast an ADMM penalty spec to stacked (N, dim, dim) blocks.

    Accepts: None | scalar | (dim, dim) | (N, dim, dim). Returns None or
    an (N, dim, dim) tensor.
    """
    if rho is None:
        return None
    rho = torch.as_tensor(rho, dtype=dtype, device=device)
    if rho.ndim == 0:
        eye = torch.eye(dim, dtype=rho.dtype, device=rho.device)
        return (rho * eye).expand(N, dim, dim)
    if rho.ndim == 2:
        return rho.expand(N, dim, dim)
    return rho


def block_diag_stacked(blocks: torch.Tensor) -> torch.Tensor:
    """Dense block-diagonal (N*d, N*d) from stacked (N, d, d) blocks."""
    return torch.block_diag(*blocks)


@full_f32_matmul()
def lifted_normal_eqs(A, B, cost: QuadCost, Qr=None, Rr=None) -> dict:
    """The dense lifted pieces of the batch and SLS paths.

    Returns a dict with Su (Nd, Nm), Sw (Nd, Nd), SuTQ (Nm, Nd),
    l_side = Su^T (Q + Qr) Su + R + Rr, SuTQr (Nm, Nd) or None, and
    Rr (the lifted Rr) or None.
    """
    Su = build_Su(A, B)
    Sw = build_Sw(A)
    SuTQ = Su.T @ block_diag_stacked(cost.Q)
    l_side = SuTQ @ Su + block_diag_stacked(cost.R)
    SuTQr = None
    if Qr is not None:
        SuTQr = Su.T @ block_diag_stacked(Qr)
        l_side = l_side + SuTQr @ Su
    Rr_lift = None
    if Rr is not None:
        Rr_lift = block_diag_stacked(Rr)
        l_side = l_side + Rr_lift
    return dict(Su=Su, Sw=Sw, SuTQ=SuTQ, l_side=l_side, SuTQr=SuTQr, Rr=Rr_lift)


@full_f32_matmul()
def lqt_solve_sls(A, B, cost: QuadCost):
    """SLS synthesis: causal feedback map Phi_u and feedforward du.

    Returns (PHI_U (Nm, Nd), du (Nm,)).
    """
    x_dim, u_dim = A.shape[-1], B.shape[-1]
    eqs = lifted_normal_eqs(A, B, cost)
    r_ff = eqs["SuTQ"] @ cost.lifted_xd()
    r_fb = -eqs["SuTQ"] @ eqs["Sw"]
    return sls_synthesize(eqs["l_side"], r_ff, r_fb, u_dim, x_dim)
