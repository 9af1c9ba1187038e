"""Linear-quadratic tracking solvers: batch least squares, Riccati DP,
SLS (counterpart of `ilqr_admm_tpu/solvers/lqt.py`).

Every public function of the JAX module is ported: the penalty
broadcast, the block-diagonal helpers, the lifted normal equations, the
batch, DP and SLS solvers (per-step and dense lifted costs), the SLS
controller and the receding-horizon replanning operator.
"""

from __future__ import annotations

import torch

from ilqr_admm_tpu_torch.ops.lifted import build_Su, build_Sw, sw_x0
from ilqr_admm_tpu_torch.ops.parallel_riccati import lqt_backward_parallel
from ilqr_admm_tpu_torch.ops.riccati import DPGains, lqt_backward
from ilqr_admm_tpu_torch.ops.sls_synthesis import sls_synthesize
from ilqr_admm_tpu_torch.ops.sqrt_riccati import eigh_rayleigh
from ilqr_admm_tpu_torch.problem import QuadCost
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


def broadcast_rho(rho, dim: int, N: int, dtype: torch.dtype | None = None, device=None):
    """Broadcast an ADMM penalty spec to stacked (N, dim, dim) blocks.

    Accepts: None | scalar | (dim, dim) | (N, dim, dim). Returns None or
    an (N, dim, dim) tensor.
    """
    if rho is None:
        return None
    if isinstance(rho, (int, float)) and dtype is not None:
        # a Python number scales the identity made on the device: no
        # host-to-device copy (which a CUDA graph capture refuses)
        return (torch.eye(dim, dtype=dtype, device=device) * rho).expand(N, dim, dim)
    rho = torch.as_tensor(rho, dtype=dtype, device=device)
    if rho.ndim == 0:
        eye = torch.eye(dim, dtype=rho.dtype, device=rho.device)
        return (rho * eye).expand(N, dim, dim)
    if rho.ndim == 2:
        return rho.expand(N, dim, dim)
    return rho


def block_diag_stacked(blocks: torch.Tensor) -> torch.Tensor:
    """Dense block-diagonal (N*d, N*e) from stacked (N, d, e) blocks, or
    each instance's from a fleet's (F, N, d, e), in one select against
    the identity's pattern (`torch.block_diag(*blocks)` copies block by
    block: N launches on a card). It takes no indexed write, so it runs
    under `torch.func.vmap` (the fleet's lifted iLQR steps)."""
    *lead, N, d, e = blocks.shape
    diag = torch.eye(N, dtype=torch.bool, device=blocks.device)[:, None, :, None]
    out = torch.where(diag, blocks[..., None, :], blocks.new_zeros(()))
    return out.reshape(*lead, N * d, N * e)


def sqrt_psd_stacked(blocks: torch.Tensor) -> torch.Tensor:
    """Symmetric PSD square roots of stacked (N, d, d) blocks (eigh-based)."""
    w, V = eigh_rayleigh(blocks)
    w = torch.sqrt(torch.clamp(w, min=0.0))
    return torch.einsum("tij,tj,tkj->tik", V, w, V)


def blockdiag_matmul(blocks: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """block_diag(blocks) @ M without the dense (N*d, N*d) operator.

    blocks: (N, d, d); M: (N*d,) or (N*d, k).
    """
    N, d = blocks.shape[0], blocks.shape[-1]
    if M.ndim == 1:
        return torch.einsum("tij,tj->ti", blocks, M.reshape(N, d)).reshape(-1)
    k = M.shape[-1]
    return torch.einsum("tij,tjk->tik", blocks, M.reshape(N, d, k)).reshape(N * d, k)


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


def _chol_solve(l_side, rhs):
    return torch.cholesky_solve(rhs[:, None], torch.linalg.cholesky(l_side))[:, 0]


@full_f32_matmul()
def lqt_solve_batch(A, B, cost: QuadCost, x0, use_qr: bool = False):
    """Open-loop optimum by lifted least squares.

    use_qr=True QR-factors the square-root system G = [sqrt(Q) Su;
    sqrt(R)] and back-substitutes, so accuracy degrades with cond(G)
    rather than cond(G)^2 = cond(Su^T Q Su + R). Returns (xs (N, d),
    us (N, m)).
    """
    N, m = A.shape[0], B.shape[-1]
    Su = build_Su(A, B)
    free = sw_x0(A, x0).reshape(-1)
    if use_qr:
        sqQ = sqrt_psd_stacked(cost.Q)
        sqR = block_diag_stacked(sqrt_psd_stacked(cost.R))
        G = torch.cat([blockdiag_matmul(sqQ, Su), sqR], dim=0)
        c = torch.cat([
            blockdiag_matmul(sqQ, cost.lifted_xd() - free),
            torch.zeros(N * m, dtype=A.dtype, device=A.device),
        ])
        Qf, Rf = torch.linalg.qr(G)
        u_opt = torch.linalg.solve_triangular(Rf, (Qf.T @ c)[:, None], upper=True)[:, 0]
    else:
        SuTQ = Su.T @ block_diag_stacked(cost.Q)
        l_side = SuTQ @ Su + block_diag_stacked(cost.R)
        u_opt = _chol_solve(l_side, SuTQ @ (cost.lifted_xd() - free))
    x_opt = free + Su @ u_opt
    return x_opt.reshape(N, -1), u_opt.reshape(N, m)


def lqt_solve_dp(
    A, B, cost: QuadCost,
    Qr=None, xr=None, Rr=None, ur=None,
    time_parallel=None,
    fast_inverse: bool = False,
) -> DPGains:
    """LQT Riccati DP; the feedback law is u_t = K_t x_t + k_t.

    time_parallel: None = sequential recursion; 'flat' = associative
    scan; an int L >= 2 = two-level blocked scan with block size L (see
    `ops/parallel_riccati.py`). fast_inverse (time-parallel paths only):
    closed-form adjugate combine inverses (state dim <= 4).
    """
    if time_parallel is None:
        return lqt_backward(A, B, cost.Q, cost.xd, cost.R, Qr=Qr, xr=xr, Rr=Rr, ur=ur)
    if time_parallel == "flat":
        block_size = None
    elif isinstance(time_parallel, bool) or not isinstance(time_parallel, int) or time_parallel < 2:
        # True would silently mean block_size=1 (N sequential combines,
        # strictly worse than the sequential recursion)
        raise ValueError(
            "time_parallel must be None, 'flat', or an int block "
            f"size >= 2, got {time_parallel!r}"
        )
    else:
        block_size = time_parallel
    return lqt_backward_parallel(
        A, B, cost.Q, cost.xd, cost.R, Qr=Qr, xr=xr, Rr=Rr, ur=ur,
        block_size=block_size, fast_inverse=fast_inverse,
    )


@full_f32_matmul()
def lqt_solve_batch_full(A, B, Q_full, xd_full, R_full, x0):
    """Batch LQT with a dense lifted cost (cross-timestep correlations).

    Q_full: (N*d, N*d); xd_full: (N*d,); R_full: (N*m, N*m). Returns
    (xs (N, d), us (N, m)).
    """
    N, m = A.shape[0], B.shape[-1]
    Su = build_Su(A, B)
    SuTQ = Su.T @ Q_full
    free = sw_x0(A, x0).reshape(-1)
    u_opt = _chol_solve(SuTQ @ Su + R_full, SuTQ @ (xd_full - free))
    x_opt = free + Su @ u_opt
    return x_opt.reshape(N, -1), u_opt.reshape(N, m)


@full_f32_matmul()
def lqt_solve_sls_full(A, B, Q_full, xd_full, R_full):
    """SLS synthesis with a dense lifted cost. Returns (PHI_U, du)."""
    x_dim, u_dim = A.shape[-1], B.shape[-1]
    Su = build_Su(A, B)
    SuTQ = Su.T @ Q_full
    return sls_synthesize(SuTQ @ Su + R_full, SuTQ @ xd_full, -SuTQ @ build_Sw(A), u_dim, x_dim)


@full_f32_matmul()
def sls_controller(A, B, PHI_U, du):
    """Time-domain gains (K, k) from the response map:
    K = Phi_u Phi_x^{-1}, k = (I - K Su) du."""
    Su = build_Su(A, B)
    PHI_X = build_Sw(A) + Su @ PHI_U
    K = torch.linalg.solve(PHI_X.T, PHI_U.T).T
    eye = torch.eye(Su.shape[-1], dtype=Su.dtype, device=Su.device)
    return K, (eye - K @ Su) @ du


@full_f32_matmul()
def replanning_matrix(A, B, cost: QuadCost, K):
    """Receding-horizon feedforward replanning operator
    M = (I - K Su)(Su^T Q Su + R)^{-1} Su^T Q, so that
    k_new = k + M (xd_new - xd_old)."""
    eqs = lifted_normal_eqs(A, B, cost)
    Su = eqs["Su"]
    rhs = torch.linalg.solve(eqs["l_side"], eqs["SuTQ"])
    eye = torch.eye(Su.shape[-1], dtype=Su.dtype, device=Su.device)
    return (eye - K @ Su) @ rhs


def replan_feedforward(k, replan_matrix, xd_new, xd_old):
    return k + replan_matrix @ (xd_new - xd_old)
