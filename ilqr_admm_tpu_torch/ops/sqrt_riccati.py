"""Square-root (array-form) Riccati backward pass (counterpart of
`ilqr_admm_tpu/ops/sqrt_riccati.py`), f32-stable at stiff weights.

The value Hessian is propagated as a factor S with V = S S^T: each step
is one QR of the pre-array

        [ Cuu^{1/2}   0        ]            [ X11  X12 ]
    T = [ S^T B       S^T A    ]  ,  qr(T) =[ 0    X22 ]  (R factor)
        [ 0           Cxx^{1/2}]            [ 0    0   ]

with X11^T X11 = Quu, X11^T X12 = Qux and X22^T X22 = V_new, so
K = -X11^{-1} X12 and the new factor is X22. Cross terms Cux != 0 are
removed by per-step completion of squares (M = Cuu^{-1} Cux, A_bar =
A - B M, Cxx_bar = Cxx - Cux^T M, cx_bar = cx - M^T cu; K = K~ - M),
which needs Cuu > 0. The linear terms (v, k) are propagated unfactored.

Three phases, as in the JAX package: the factor chain (a loop over t with
`torch.linalg.qr`), the gains (the pre-arrays re-factored by the
unrolled Householder `_qr_r`, batched over all steps at once), and the
linear chain (a loop over t).
"""

from __future__ import annotations

import torch

from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


def eigh_rayleigh(M):
    """(w, V): eigenvectors V of symmetric (..., n, n) blocks and their
    eigenvalues w, taken as the Rayleigh quotients diag(V^T M V).

    On a CUDA card, torch's batched float32 `eigh` (cuSOLVER) leaves the
    eigenvalues of an all-zero block unwritten: they hold whatever the
    memory held, NaN included (seen on an H100 with torch 2.11 and CUDA
    12.8: a (100, n, n) float32 batch, n = 2 to 9, with zero blocks, after
    NaN tensors were freed; float64 and single blocks were right). Its
    eigenvectors are right, so the eigenvalues are taken from them.
    """
    _, V = torch.linalg.eigh(M)
    return torch.sum(V * (M @ V), dim=-2), V


def _sqrt_psd(M):
    """Symmetric PSD square roots of (..., n, n) blocks (eigh-based;
    handles zero blocks)."""
    w, V = eigh_rayleigh(M)
    return (V * torch.sqrt(torch.clamp(w, min=0.0))[..., None, :]) @ V.transpose(-1, -2)


def _mm(a, b):
    """Small matmul as broadcast-multiply-sum (the JAX package's exact-f32
    form on the TPU's vector unit)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def _mv(a, v):
    """Small matvec as broadcast-multiply-sum (see `_mm`)."""
    return torch.sum(a * v[..., None, :], dim=-1)


def _qr_r(Ain):
    """Householder QR of (..., M, n) pre-arrays, R factor only, unrolled
    over the n columns in plain elementwise arithmetic."""
    n = Ain.shape[-1]
    R = Ain.clone()
    eps = torch.finfo(Ain.dtype).tiny * 1e8
    for j in range(n):
        x = R[..., j:, j]
        normx = torch.sqrt(torch.sum(x * x, dim=-1))
        x0 = x[..., 0]
        # sign chosen to avoid cancellation; guard zero columns
        alpha = -torch.sign(torch.where(x0 == 0, torch.ones_like(x0), x0)) * normx
        v = x.clone()
        v[..., 0] = v[..., 0] - alpha
        vnorm = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        v = torch.where(vnorm > eps, v / torch.clamp(vnorm, min=eps), torch.zeros_like(v))
        # R[j:, j:] -= 2 v (v' R[j:, j:])
        tail = R[..., j:, j:]
        w = torch.sum(v[..., :, None] * tail, dim=-2)
        R[..., j:, j:] = tail - 2.0 * v[..., :, None] * w[..., None, :]
    return torch.triu(R[..., :n, :n])


def _solve_upper(U, rhs):
    """Unrolled upper-triangular solve U x = rhs; U (..., m, m), rhs (..., m, k)."""
    m = U.shape[-1]
    rows = [None] * m
    for i in range(m - 1, -1, -1):
        acc = rhs[..., i, :]
        for j in range(i + 1, m):
            acc = acc - U[..., i, j, None] * rows[j]
        rows[i] = acc / U[..., i, i, None]
    return torch.stack(rows, dim=-2)


def _solve_lower(L, rhs):
    """Unrolled lower-triangular solve L x = rhs (see `_solve_upper`)."""
    m = L.shape[-1]
    rows = [None] * m
    for i in range(m):
        acc = rhs[..., i, :]
        for j in range(i):
            acc = acc - L[..., i, j, None] * rows[j]
        rows[i] = acc / L[..., i, i, None]
    return torch.stack(rows, dim=-2)


@full_f32_matmul()
def ilqr_backward_sqrt(A: torch.Tensor, B: torch.Tensor, Cts: torch.Tensor, cts: torch.Tensor):
    """Array-form iLQR backward pass.

    Same (K, k) contract as `riccati.ilqr_backward`: (K (N, u, x), k (N, u))
    with zero final-step gains; one QR of an ((m + 2d) x (m + d))
    pre-array a step instead of forming and factoring Quu. Nonzero Cux is
    handled by completion of squares (requires Cuu > 0).
    """
    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    dtype = torch.promote_types(A.dtype, Cts.dtype)
    A, B, Cts, cts = (t.to(dtype) for t in (A, B, Cts, cts))

    # per-step cross-term elimination: M = Cuu^{-1} Cux
    Cxx, Cuu, Cux = Cts[:, :d, :d], Cts[:, d:, d:], Cts[:, d:, :d]
    U = torch.linalg.cholesky_ex(0.5 * (Cuu + Cuu.transpose(-1, -2)), upper=True).L
    Ms = torch.cholesky_solve(Cux, U, upper=True)
    Cxx_bar = Cxx - Cux.transpose(-1, -2) @ Ms
    Cxx_bar = 0.5 * (Cxx_bar + Cxx_bar.transpose(-1, -2))
    A_bar = A - torch.einsum("tij,tjk->tik", B, Ms)
    cx_bar = cts[:, :d] - torch.einsum("tji,tj->ti", Ms, cts[:, d:])

    Cxx_sqrt = _sqrt_psd(Cxx_bar)
    Cuu_sqrt = _sqrt_psd(Cuu)

    # terminal value from the raw state blocks: the final-step gains are
    # zero by convention, so no elimination at step N-1
    S = _sqrt_psd(Cts[-1, :d, :d])  # V = S S^T
    v = cts[-1, :d]

    # 1. factor chain: S_t from S_{t+1}, keeping each step's pre-array
    zeros_md = torch.zeros((m, d), dtype=dtype, device=A.device)
    zeros_dm = torch.zeros((d, m), dtype=dtype, device=A.device)
    pres = [None] * (N - 1)
    for t in range(N - 2, -1, -1):
        ST = S.T
        pre = torch.cat([
            torch.cat([Cuu_sqrt[t], zeros_md], dim=1),
            torch.cat([_mm(ST, B[t]), _mm(ST, A_bar[t])], dim=1),
            torch.cat([zeros_dm, Cxx_sqrt[t]], dim=1),
        ], dim=0)
        R = torch.linalg.qr(pre, mode="r").R
        S = R[m:, m:].T  # V_new = X22^T X22
        pres[t] = pre

    # 2. gains from the exact Householder R of every pre-array at once
    R = _qr_r(torch.stack(pres))
    X11s, X12s = R[:, :m, :m], R[:, :m, m:]
    K_raw = -_solve_upper(X11s, X12s)

    # 3. linear chain
    Ks, ks = [None] * (N - 1), [None] * (N - 1)
    for t in range(N - 2, -1, -1):
        At, Bt, Kt, X11, cu = A_bar[t], B[t], K_raw[t], X11s[t], cts[t, d:]
        qu = cu + _mv(Bt.T, v)
        kt = -_solve_upper(X11, _solve_lower(X11.T, qu[:, None]))[:, 0]
        v = cx_bar[t] + _mv(Kt.T, cu) + _mv((At + _mm(Bt, Kt)).T, v)
        # map the gains back to the original controls: u = u~ - M x
        Ks[t], ks[t] = Kt - Ms[t], kt
    K = torch.cat([torch.stack(Ks), torch.zeros((1, m, d), dtype=dtype, device=A.device)])
    k = torch.cat([torch.stack(ks), torch.zeros((1, m), dtype=dtype, device=A.device)])
    return K, k
