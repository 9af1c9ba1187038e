"""Time-parallel Riccati recursion (counterpart of
`ilqr_admm_tpu/ops/parallel_riccati.py`).

Each element represents a conditional value function between two steps,
parametrized by (A, b, C, eta, J), and composition (eliminating the
middle state) is associative:

    M   = (I + C1 J2)^{-1}
    A   = A2 M A1
    b   = A2 M (b1 + C1 eta2) + b2
    C   = A2 M C1 A2^T + C2
    eta = A1^T M^T (eta2 - J2 b1) + eta1
    J   = A1^T M^T J2 A1 + J1

so the value functions come from a suffix scan: flat (`associative_scan`,
O(log N) depth, O(N log N) combines) or two-level blocked
(`_blocked_suffix_scan`, O(N) combines with the L sequential level-1
steps batched over the blocks). Gain extraction is then independent per
step. The suffix scan keeps the JAX operand order: a reverse scan hands
`fn` (later, earlier), so it is called with `lambda a, b: comb(b, a)`.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ilqr_admm_tpu_torch.ops.riccati import DPGains, _mv
from ilqr_admm_tpu_torch.ops.scan import associative_scan
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


def _minor_det(M, r, c, n):
    """Determinant of the (n-1)x(n-1) minor of stacked (..., n, n) M with
    row r and column c removed (cofactor expansion written out)."""
    rows = [i for i in range(n) if i != r]
    cols = [j for j in range(n) if j != c]
    k = n - 1
    if k == 0:
        return torch.ones(M.shape[:-2], dtype=M.dtype, device=M.device)
    if k == 1:
        return M[..., rows[0], cols[0]]
    if k == 2:
        return (
            M[..., rows[0], cols[0]] * M[..., rows[1], cols[1]]
            - M[..., rows[0], cols[1]] * M[..., rows[1], cols[0]]
        )
    a, b, c3 = (M[..., rows[0], cols[j]] for j in range(3))
    d1, e, f = (M[..., rows[1], cols[j]] for j in range(3))
    g, h, i_ = (M[..., rows[2], cols[j]] for j in range(3))
    return a * (e * i_ - f * h) - b * (d1 * i_ - f * g) + c3 * (d1 * h - e * g)


def inv_small(M):
    """Closed-form (adjugate) stacked inverse for trailing dim <= 4.

    Relative error ~ eps * cond(M): use only where cond(M) is modest. A
    per-matrix scalar scaling guards the determinant against overflow
    without changing the cancellation structure.
    """
    n = M.shape[-1]
    if n > 4:
        raise ValueError(f"inv_small supports trailing dim <= 4, got {n}")
    if n == 1:
        return 1.0 / M
    s = torch.amax(torch.abs(M), dim=(-2, -1), keepdim=True)
    Mh = M / s
    # adj[i, j] = (-1)^{i+j} minor_det(j, i)  (transposed cofactors)
    adj = torch.stack(
        [
            torch.stack(
                [((-1.0) ** (r + c)) * _minor_det(Mh, r, c, n) for r in range(n)], dim=-1
            )
            for c in range(n)
        ],
        dim=-2,
    )
    det = sum(Mh[..., 0, j] * adj[..., j, 0] for j in range(n))
    return adj / det[..., None, None] / s


def _bmm(a, b):
    """Stacked tiny matmul as a broadcast-multiply-sum (exact f32, no TF32)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def _combine(e1, e2, fast_inverse: bool = False):
    """Composition of conditional-value-function elements; e1 covers the
    earlier interval, e2 the later one. Broadcasts over leading dims."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    d = A1.shape[-1]
    I = torch.eye(d, dtype=A1.dtype, device=A1.device)
    mm = _bmm if d <= 4 else torch.matmul

    T = I + mm(C1, J2)
    M = inv_small(T) if fast_inverse else torch.linalg.solve(T, I.expand_as(T))
    A2M = mm(A2, M)
    MT = M.transpose(-1, -2)
    A1T = A1.transpose(-1, -2)

    A = mm(A2M, A1)
    b = mm(A2M, b1[..., None] + mm(C1, eta2[..., None]))[..., 0] + b2
    C = mm(mm(A2M, C1), A2.transpose(-1, -2)) + C2
    eta = mm(A1T, mm(MT, eta2[..., None] - mm(J2, b1[..., None])))[..., 0] + eta1
    J = mm(A1T, mm(MT, mm(J2, A1))) + J1
    return (A, b, C, eta, J)


def _identity_elems(prefix, d, dtype, device=None):
    """Identity of `_combine`: (I, 0, 0, 0, 0) with leading shape `prefix`."""
    prefix = tuple(prefix)
    I = torch.eye(d, dtype=dtype, device=device).expand(prefix + (d, d))
    z_m = torch.zeros(prefix + (d, d), dtype=dtype, device=device)
    z_v = torch.zeros(prefix + (d,), dtype=dtype, device=device)
    return (I, z_v, z_m, z_v, z_m)


def _blocked_suffix_scan(combine, identity, elems, N, block_size):
    """Inclusive suffix scan result[t] = e_t o e_{t+1} o ... o e_{N-1} in
    two levels: O(N) combines in all.

    Level 1: within each of nb = ceil(N/L) blocks, a reverse sequential
    scan of depth L, each step one (nb,)-batched combine. Level 2: an
    exclusive reverse scan over the nb block totals. Finish: one batched
    combine joining every local suffix with its block's exclusive suffix.
    combine(earlier, later) broadcasts over leading dims; identity(prefix)
    builds identity elements; elems is a tuple of (N, ...) tensors.
    """
    L = block_size
    nb = -(-N // L)
    pad = nb * L - N

    def pad_elem(x, ident_x):
        if pad == 0:
            return x
        return torch.cat([x, ident_x.expand((pad,) + tuple(x.shape[1:]))], dim=0)

    elems = tuple(pad_elem(x, ix) for x, ix in zip(elems, identity(())))
    # (N_pad, ...) -> (L, nb, ...): block-major rows, scan over the L axis
    by_j = tuple(x.reshape((nb, L) + tuple(x.shape[1:])).transpose(0, 1) for x in elems)

    carry = identity((nb,))
    r = [None] * L
    for j in range(L - 1, -1, -1):
        carry = combine(tuple(x[j] for x in by_j), carry)  # e_j o (suffix of later js)
        r[j] = carry
    r = tuple(torch.stack(parts, dim=0) for parts in zip(*r))  # (L, nb, ...)

    totals = tuple(x[0] for x in r)  # suffix of the whole block, per block
    carry = identity(())
    S = [None] * nb
    for i in range(nb - 1, -1, -1):
        S[i] = carry  # EXCLUSIVE suffix
        carry = combine(tuple(x[i] for x in totals), carry)
    S = tuple(torch.stack(parts, dim=0) for parts in zip(*S))  # (nb, ...)

    res = combine(r, S)  # (L, nb, ...) against (nb, ...)
    return tuple(
        x.transpose(0, 1).reshape((nb * L,) + tuple(x.shape[2:]))[:N] for x in res
    )


def _suffix_scan(elems, N, d, dtype, device, block_size, fast_inverse):
    """Flat (block_size None) or blocked inclusive suffix scan of the elements."""
    comb = functools.partial(_combine, fast_inverse=fast_inverse)
    if block_size is None:
        return associative_scan(lambda a, b: comb(b, a), elems, reverse=True)
    return _blocked_suffix_scan(
        comb, lambda p: _identity_elems(p, d, dtype, device), elems, N, block_size
    )


def lqt_backward_parallel(
    A: torch.Tensor,
    B: torch.Tensor,
    Q: torch.Tensor,
    xd: torch.Tensor,
    R: torch.Tensor,
    Qr: Optional[torch.Tensor] = None,
    xr: Optional[torch.Tensor] = None,
    Rr: Optional[torch.Tensor] = None,
    ur: Optional[torch.Tensor] = None,
    block_size: Optional[int] = None,
    fast_inverse: bool = False,
) -> DPGains:
    """LQT Riccati via a suffix scan. Same contract as `lqt_backward`.

    block_size=None runs the flat associative scan; block_size=L the
    two-level blocked scan. fast_inverse=True replaces the combine's LU
    solve with the closed-form adjugate `inv_small` (state dim <= 4), at
    adjugate accuracy (relative error ~ eps * cond(I + C J)).
    """
    if block_size is not None and (
        isinstance(block_size, bool) or not isinstance(block_size, int) or block_size < 1
    ):
        raise ValueError(f"block_size must be a positive int, got {block_size!r}")
    if fast_inverse and A.shape[-1] > 4:
        raise ValueError(
            f"fast_inverse=True uses the closed-form adjugate inverse, which "
            f"supports state dim <= 4 (got d={A.shape[-1]}); use the default "
            "LU combine for larger states"
        )
    with full_f32_matmul():
        elems, U, s = value_elements(
            A, B, Q, xd, R, Qr=Qr, xr=xr, Rr=Rr, ur=ur, fast_inverse=fast_inverse
        )
        scanned = _suffix_scan(
            elems, A.shape[0], A.shape[-1], A.dtype, A.device, block_size, fast_inverse
        )
        return gains_from_scanned(A, B, U, s, scanned, fast_inverse=fast_inverse)


@full_f32_matmul()
def value_elements(
    A, B, Q, xd, R, Qr=None, xr=None, Rr=None, ur=None, fast_inverse: bool = False,
):
    """Scan elements (A, b, C, eta, J) of the LQT problem, plus the control
    Hessians and targets (U, s) for gain extraction.

    fast_inverse inverts the (N, m, m) control Hessians with `inv_small`
    (m <= 4) instead of batched LU solves.
    """
    N, d, m = A.shape[0], A.shape[-1], B.shape[-1]
    like = dict(dtype=A.dtype, device=A.device)
    zQr = torch.zeros((N, d, d), **like) if Qr is None else Qr
    zxr = torch.zeros((N, d), **like) if xr is None else xr
    zRr = torch.zeros((N, m, m), **like) if Rr is None else Rr
    zur = torch.zeros((N, m), **like) if ur is None else ur

    X = 2.0 * Q + 2.0 * zQr  # (N, d, d) state-cost Hessians
    eta_all = 2.0 * torch.einsum("tij,tj->ti", Q, xd) + 2.0 * torch.einsum(
        "tij,tj->ti", zQr, zxr
    )
    U = 2.0 * R + 2.0 * zRr  # (N, m, m) control-cost Hessians
    s = 2.0 * torch.einsum("tij,tj->ti", zRr, zur)  # linear control targets
    return value_elements_general(A, B, X, eta_all, U, s, fast_inverse=fast_inverse)


@full_f32_matmul()
def value_elements_general(A, B, X, eta_all, U, s, fast_inverse: bool = False, drift=None):
    """Scan elements from a general stage-quadratic model without cross terms:

        cost_t = (1/2) x' X_t x - eta_t' x + (1/2) u' U_t u - s_t' u.

    drift: optional (N, d) affine term x_{t+1} = A x + B u + d_t (the
    terminal row is unused); it enters only the b element here, plus a
    qu correction in `gains_from_scanned` (pass the same drift there).
    """
    d = A.shape[-1]
    like = dict(dtype=A.dtype, device=A.device)
    BT = B[:-1].transpose(-1, -2)
    if fast_inverse:
        Uinv = inv_small(U[:-1])
        Uinv_s = torch.einsum("tij,tj->ti", Uinv, s[:-1])
        Uinv_BT = Uinv @ BT
    else:
        Uinv_s = torch.linalg.solve(U[:-1], s[:-1][..., None])[..., 0]
        Uinv_BT = torch.linalg.solve(U[:-1], BT)
    elem_b = torch.einsum("tij,tj->ti", B[:-1], Uinv_s)
    if drift is not None:
        elem_b = elem_b + drift[:-1]
    zero_m = torch.zeros((1, d, d), **like)
    elems = (
        torch.cat([A[:-1], zero_m], 0),
        torch.cat([elem_b, torch.zeros((1, d), **like)], 0),
        torch.cat([B[:-1] @ Uinv_BT, zero_m], 0),
        eta_all,
        X,
    )
    return elems, U, s


@full_f32_matmul()
def gains_from_scanned(A, B, U, s, scanned, fast_inverse: bool = False, drift=None) -> DPGains:
    """Per-step gains from the scanned value functions V_{t+1} = (J, eta),
    independently for every t.

    fast_inverse: adjugate inverses of the (m, m) Quu blocks (m <= 4)
    instead of batched Cholesky. drift: the (N, d) term passed to
    `value_elements_general`; shifts qu by B' J_{t+1} d_t.
    """
    J_all, eta_val = scanned[4], scanned[3]
    Jn = J_all[1:]
    etan = eta_val[1:]
    if drift is not None:
        etan = etan - torch.einsum("tij,tj->ti", Jn, drift[:-1])

    BT = B[:-1].transpose(-1, -2)
    BTJ = BT @ Jn
    Quu = U[:-1] + BTJ @ B[:-1]
    Qux = BTJ @ A[:-1]
    qu = -s[:-1] - torch.einsum("tij,tj->ti", BT, etan)
    if fast_inverse:
        Quu = 0.5 * (Quu + Quu.transpose(-1, -2))
        Quu_inv = inv_small(Quu)
        K = -(Quu_inv @ Qux)
        k = -torch.einsum("tij,tj->ti", Quu_inv, qu)
    else:
        L = torch.linalg.cholesky(0.5 * (Quu + Quu.transpose(-1, -2)))
        sol = -torch.cholesky_solve(torch.cat([Qux, qu[..., None]], dim=-1), L)
        K, k = sol[..., :-1], sol[..., -1]
        eye = torch.eye(Quu.shape[-1], dtype=Quu.dtype, device=Quu.device)
        Quu_inv = torch.cholesky_solve(eye.expand_as(Quu), L)

    def pad(arr):
        return torch.cat([arr, torch.zeros_like(arr[:1])], dim=0)

    return DPGains(K=pad(K), k=pad(k), Quu=pad(Quu), Quu_inv=pad(Quu_inv), Qux=pad(Qux))


@full_f32_matmul()
def rollout_closed_loop_parallel(A, B, K, k, x0):
    """Closed-loop linear rollout via an associative scan (O(log N) depth).

    x_{t+1} = (A_t + B_t K_t) x_t + B_t k_t is an affine recurrence whose
    prefix composition (M, v) o (M', v') = (M' M, M' v + v') is
    associative. Returns (xs (N, d), us (N, m)), as `rollout_closed_loop`
    on linear dynamics.
    """
    Acl = A + B @ K
    bcl = torch.einsum("tij,tj->ti", B, k)

    def comb(a, b):
        M1, v1 = a
        M2, v2 = b
        return M2 @ M1, torch.einsum("tij,tj->ti", M2, v1) + v2

    Ms, vs = associative_scan(comb, (Acl, bcl))
    xs_tail = torch.einsum("tij,j->ti", Ms[:-1], x0) + vs[:-1]
    xs = torch.cat([x0[None], xs_tail], dim=0)
    us = torch.einsum("tij,tj->ti", K, xs) + k
    return xs, us


@full_f32_matmul()
def ilqr_value_elements(A, B, Cts, cts, fast_inverse=False, drift=None):
    """Scan elements of the general iLQR model (with cross terms).

    Completion of squares removes the Cux cross term stage by stage; the
    final stage is left as it is (u_{N-1} is unused and the terminal value
    function stays (Cxx[-1], cx[-1])). Returns (elems, U, s, A_t, Kc): scan
    the elements, then `gains_from_scanned(A_t, B, U, s, scanned,
    drift=drift)`, and map the v-gains back as K = K_v - Kc.
    """
    d, m = A.shape[-1], B.shape[-1]
    Cxx, Cuu, Cux = Cts[:, :d, :d], Cts[:, d:, d:], Cts[:, d:, :d]
    cx, cu = cts[:, :d], cts[:, d:]

    Kc = _bmm(inv_small(Cuu), Cux) if m <= 4 else torch.linalg.solve(Cuu, Cux)
    Kc = torch.cat([Kc[:-1], torch.zeros_like(Kc[-1:])], dim=0)  # (N, m, d)
    A_t = A - _bmm(B, Kc)
    X = Cxx - _bmm(Cux.transpose(-1, -2), Kc)
    X = 0.5 * (X + X.transpose(-1, -2))
    cx_t = cx - torch.einsum("tji,tj->ti", Kc, cu)  # cx - Kc' cu

    elems, U, s = value_elements_general(
        A_t, B, X, -cx_t, Cuu, -cu, fast_inverse=fast_inverse, drift=drift
    )
    return elems, U, s, A_t, Kc


def ilqr_backward_parallel(
    A: torch.Tensor,
    B: torch.Tensor,
    Cts: torch.Tensor,
    cts: torch.Tensor,
    block_size: Optional[int] = None,
    fast_inverse: bool = False,
    return_value: bool = False,
    drift=None,
):
    """Time-parallel iLQR Riccati over a general quadratic cost model.

    Same (Cts, cts) contract and (K, k) output as `ilqr_backward`; the
    recursion runs as a suffix scan (flat, or blocked with block_size=L).
    Cux cross terms are removed by completion of squares; K = K_v - Kc.
    return_value=True also returns the per-stage cost-to-go (J (N, d, d),
    eta (N, d)) with V_t(x) = (1/2) x' J_t x - eta_t' x.
    """
    if fast_inverse and A.shape[-1] > 4:
        raise ValueError(f"fast_inverse=True supports state dim <= 4 (got d={A.shape[-1]})")
    with full_f32_matmul():
        elems, U, s, A_t, Kc = ilqr_value_elements(
            A, B, Cts, cts, fast_inverse=fast_inverse, drift=drift
        )
        scanned = _suffix_scan(
            elems, A.shape[0], A.shape[-1], A.dtype, A.device, block_size, fast_inverse
        )
        gains = gains_from_scanned(A_t, B, U, s, scanned, fast_inverse=fast_inverse, drift=drift)
    if return_value:
        return gains.K - Kc, gains.k, scanned[4], scanned[3]
    return gains.K - Kc, gains.k
