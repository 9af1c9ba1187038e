"""Riccati backward passes (counterpart of `ilqr_admm_tpu/ops/riccati.py`).

- `lqt_backward`: the LQT Riccati recursion, per-step cost, optional
  ADMM regularizers; returns `DPGains`.
- `lqt_backward_ff`: the feedforward-only re-sweep with cached blocks.
- `ilqr_backward`: the general iLQR recursion over (Cts, cts) with Cux
  cross terms, Levenberg `reg` and the full-DDP `fzz` term.
- `quad_cost_model`: (cts, Cts) of the quadratic cost around a nominal.

The JAX package runs each recursion as a `lax.scan`; here it is a Python
loop over t with the same per-step algebra and the same Cholesky solves.
Terms that do not depend on the value function (the stage cost blocks)
are formed for all t at once before the loop.

Cost convention (no 1/2): sum_t (x_t - xd_t)^T Q_t (x_t - xd_t) + u_t^T
R_t u_t, plus sum_t (x_t - xr_t)^T Qr_t (x_t - xr_t) + (u_t - ur_t)^T
Rr_t (u_t - ur_t) for the regularizers. Every pass leaves the final-step
gains at zero (K_{N-1} = 0, k_{N-1} = 0).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


class DPGains(NamedTuple):
    """Feedback gains and the cached quadratic-model blocks.

    K: (N, u, x); k: (N, u); Quu / Quu_inv: (N, u, u); Qux: (N, u, x).
    """

    K: torch.Tensor
    k: torch.Tensor
    Quu: torch.Tensor
    Quu_inv: torch.Tensor
    Qux: torch.Tensor


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def _mv(M, v):
    """Stacked matrix-vector product (..., i, j) x (..., j) -> (..., i)."""
    return (M @ v[..., None])[..., 0]


def _cholesky(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where M is not positive definite (as the
    JAX package's `cho_factor` gives), with no host read: the error flag
    of `torch.linalg.cholesky` is read on the host."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))


def _cho_solve(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(L L^T)^{-1} rhs as two triangular solves (cuBLAS trsm on a card,
    also when vmapped; `torch.cholesky_solve` of a batch may go through
    MAGMA, which synchronizes with the host)."""
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def _pad_last(arr: torch.Tensor) -> torch.Tensor:
    """Append one all-zero step (the final-step gains)."""
    return torch.cat([arr, torch.zeros_like(arr[:1])], dim=0)


def _stack_reversed(items) -> torch.Tensor:
    """Stack per-step tensors collected from t = N-2 down to 0 in time order."""
    return torch.stack(items[::-1], dim=0)


def _lqt_linear_terms(Q, xd, Qr, xr, Rr, ur, m):
    """Linear stage terms of the LQT cost for every t: cx (N, x), cu (N, u).

    A regularizer weight without its target (xr or ur None) pulls toward 0.
    """
    cx = -2.0 * _mv(Q, xd)
    cu = torch.zeros((Q.shape[0], m), dtype=Q.dtype, device=Q.device)
    if Qr is not None and xr is not None:
        cx = cx - 2.0 * _mv(Qr, xr)
    if Rr is not None and ur is not None:
        cu = cu - 2.0 * _mv(Rr, ur)
    return cx, cu


@full_f32_matmul()
def lqt_backward(
    A: torch.Tensor,
    B: torch.Tensor,
    Q: torch.Tensor,
    xd: torch.Tensor,
    R: torch.Tensor,
    Qr: Optional[torch.Tensor] = None,
    xr: Optional[torch.Tensor] = None,
    Rr: Optional[torch.Tensor] = None,
    ur: Optional[torch.Tensor] = None,
) -> DPGains:
    """LQT Riccati backward pass (no cross terms, per-step cost).

    A (N,x,x), B (N,x,u), Q (N,x,x), xd (N,x), R (N,u,u). Optional ADMM
    regularizers: Qr (N,x,x) with targets xr (N,x); Rr (N,u,u) with
    targets ur (N,u). Returns DPGains with all per-step blocks.
    """
    N, m = A.shape[0], B.shape[-1]
    cx, cu = _lqt_linear_terms(Q, xd, Qr, xr, Rr, ur, m)
    Cxx = 2.0 * Q if Qr is None else 2.0 * Q + 2.0 * Qr
    Cuu = 2.0 * R if Rr is None else 2.0 * R + 2.0 * Rr
    AT, BT = A.transpose(-1, -2), B.transpose(-1, -2)
    eye = torch.eye(m, dtype=A.dtype, device=A.device)

    V, v = Cxx[-1], cx[-1]
    Ks, ks, Quus, Quu_invs, Quxs = [], [], [], [], []
    for t in range(N - 2, -1, -1):
        qx = cx[t] + AT[t] @ v
        qu = cu[t] + BT[t] @ v
        VA = V @ A[t]
        Qxx = Cxx[t] + AT[t] @ VA
        Qux = BT[t] @ VA
        Quu = Cuu[t] + BT[t] @ V @ B[t]

        L = torch.linalg.cholesky(_sym(Quu))
        sol = -torch.cholesky_solve(torch.cat([Qux, qu[:, None]], dim=-1), L)
        Kt, kt = sol[:, :-1], sol[:, -1]
        KtT = Kt.T
        V = Qxx + Qux.T @ Kt + KtT @ Qux + KtT @ Quu @ Kt
        v = qx + Qux.T @ kt + KtT @ qu + KtT @ (Quu @ kt)
        Ks.append(Kt)
        ks.append(kt)
        Quus.append(Quu)
        Quu_invs.append(torch.cholesky_solve(eye, L))
        Quxs.append(Qux)
    return DPGains(*(_pad_last(_stack_reversed(x)) for x in (Ks, ks, Quus, Quu_invs, Quxs)))


@full_f32_matmul()
def lqt_backward_ff(
    gains: DPGains,
    A: torch.Tensor,
    B: torch.Tensor,
    Q: torch.Tensor,
    xd: torch.Tensor,
    Qr: Optional[torch.Tensor] = None,
    xr: Optional[torch.Tensor] = None,
    Rr: Optional[torch.Tensor] = None,
    ur: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Feedforward-only re-sweep with the cached Quu/Quu_inv/Qux/K.

    Only the linear cost terms change between DP-ADMM iterations.
    Returns k (N, u).
    """
    N, m = A.shape[0], B.shape[-1]
    cx, cu = _lqt_linear_terms(Q, xd, Qr, xr, Rr, ur, m)
    AT, BT = A.transpose(-1, -2), B.transpose(-1, -2)
    KT, QuxT = gains.K.transpose(-1, -2), gains.Qux.transpose(-1, -2)

    v = cx[-1]
    ks = []
    for t in range(N - 2, -1, -1):
        qx = cx[t] + AT[t] @ v
        qu = cu[t] + BT[t] @ v
        kt = -(gains.Quu_inv[t] @ qu)
        v = qx + QuxT[t] @ kt + KT[t] @ qu + KT[t] @ (gains.Quu[t] @ kt)
        ks.append(kt)
    return _pad_last(_stack_reversed(ks))


@full_f32_matmul()
def ilqr_backward(
    A: torch.Tensor,
    B: torch.Tensor,
    Cts: torch.Tensor,
    cts: torch.Tensor,
    reg: float | torch.Tensor = 0.0,
    fzz: torch.Tensor | None = None,
):
    """General iLQR Riccati backward pass over a quadratic cost model.

    Cts: (N, x+u, x+u) Hessians (the Cxx, Cuu and Cux blocks are used);
    cts: (N, x+u) gradients. `reg` adds reg * I to Quu. fzz: optional
    (N, x, x+u, x+u) dynamics Hessians for full DDP; the stage model then
    gains sum_i v'_i (f_i)_zz with v' the next stage's value gradient.
    Returns (K (N, u, x), k (N, u)) with zero final-step gains.
    """
    d, m = A.shape[-1], B.shape[-1]
    N = A.shape[0]
    AT, BT = A.transpose(-1, -2), B.transpose(-1, -2)
    regI = reg * torch.eye(m, dtype=A.dtype, device=A.device)

    V, v = Cts[-1][:d, :d], cts[-1][:d]
    Ks, ks = [], []
    for t in range(N - 2, -1, -1):
        Ct, ct = Cts[t], cts[t]
        qx = ct[:d] + AT[t] @ v
        qu = ct[d:] + BT[t] @ v
        VA = V @ A[t]
        Qxx = Ct[:d, :d] + AT[t] @ VA
        Qux = Ct[d:, :d] + BT[t] @ VA
        Quu = Ct[d:, d:] + BT[t] @ V @ B[t] + regI
        if fzz is not None:
            T = torch.einsum("i,ijk->jk", v, fzz[t])
            Qxx = Qxx + T[:d, :d]
            Qux = Qux + T[d:, :d]
            Quu = Quu + T[d:, d:]

        L = _cholesky(_sym(Quu))
        sol = -_cho_solve(L, torch.cat([Qux, qu[:, None]], dim=-1))
        Kt, kt = sol[:, :-1], sol[:, -1]
        KtT = Kt.T
        V = Qxx + KtT @ Quu @ Kt + Qux.T @ Kt + KtT @ Qux
        v = qx + KtT @ qu + KtT @ (Quu @ kt) + Qux.T @ kt
        Ks.append(Kt)
        ks.append(kt)
    return _pad_last(_stack_reversed(Ks)), _pad_last(_stack_reversed(ks))


@full_f32_matmul()
def quad_cost_model(Q, xd, R, x_nom, u_nom):
    """(cts, Cts) Taylor blocks of the quadratic cost around a nominal:
    Cxx = 2Q, Cuu = 2R, Cux = 0, cx = 2Q(x_nom - xd), cu = 2R u_nom."""
    N, d, m = Q.shape[0], Q.shape[-1], R.shape[-1]
    Cts = torch.zeros((N, d + m, d + m), dtype=Q.dtype, device=Q.device)
    Cts[:, :d, :d] = 2.0 * Q
    Cts[:, d:, d:] = 2.0 * R
    cx = 2.0 * _mv(Q, x_nom - xd)
    cu = 2.0 * _mv(R, u_nom)
    return torch.cat([cx, cu], dim=-1), Cts
