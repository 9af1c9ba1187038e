"""Small box-constrained QP, the stage solver of control-limited DDP
(counterpart of `ilqr_admm_tpu/ops/boxqp.py`).

Solves   min_u  (1/2) u^T H u + g^T u   s.t.  lb <= u <= ub
for strictly convex H of small dimension (control dims, m <= ~8), as a
fixed-iteration program with no data-dependent control flow and no host
read: `boxqp` by projected Newton on a fixed 4-step backtracking grid,
`boxqp_enum` exactly, by enumerating the 3^m active sets as one batched
solve. Both run every product in full f32 (the JAX package's
`highest_precision`).
"""

from __future__ import annotations

import functools
import itertools

import torch

from ilqr_admm_tpu_torch.ops.parallel_riccati import inv_small
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul

# projected-Newton backtracking grid
_ALPHAS = (1.0, 0.5, 0.25, 0.1)


def box_bounds(b, m, like):
    """A bound (a number or (m,)) as an (m,) tensor beside `like`; a number
    is filled on the device (no host-to-device copy)."""
    if isinstance(b, (int, float)):
        return torch.full((m,), float(b), dtype=like.dtype, device=like.device)
    return torch.as_tensor(b, dtype=like.dtype, device=like.device).expand(m)


def _masked_solve(H, free, rhs):
    """Solve H_ff x_f = rhs_f on the free subspace, zeros on clamped dims.

    M = F H F + (I - F) with F = diag(free), so the clamped rows decouple
    to the identity: one fixed-shape solve whatever the active set. H
    (..., m, m), free (..., m), rhs (..., m) or (..., m, k). The adjugate
    inverse (`inv_small`) for m <= 4, else a linear solve, as in the JAX
    package.
    """
    m = H.shape[-1]
    F = free.to(H.dtype)
    eye = torch.eye(m, dtype=H.dtype, device=H.device)
    M = H * F[..., :, None] * F[..., None, :] + eye * (1.0 - F)[..., None, :]
    vec = rhs.ndim == F.ndim
    Fr = F if vec else F[..., :, None]
    rhs_m = (rhs * Fr)[..., None] if vec else rhs * Fr
    x = inv_small(M) @ rhs_m if m <= 4 else torch.linalg.solve(M, rhs_m)
    x = x[..., 0] if vec else x
    return x * Fr


@full_f32_matmul()
def boxqp(H, g, lb, ub, u0=None, n_iters: int = 12, eps: float = 1e-9):
    """Projected-Newton box QP. Returns (u, free_mask (bool m,)).

    `free_mask` marks dimensions NOT clamped at a bound by the KKT test
    (at a bound with the gradient pushing outward); the boxDDP backward
    pass zeroes feedback on the clamped complement.
    """
    m = H.shape[-1]
    lb, ub = box_bounds(lb, m, H), box_bounds(ub, m, H)
    u = torch.zeros_like(lb) if u0 is None else torch.as_tensor(u0, dtype=H.dtype)
    u = torch.clamp(u, lb, ub)

    def obj(v):  # v (..., m)
        return 0.5 * torch.sum((v @ H.T) * v, dim=-1) + v @ g

    def clamped(v, grad):
        return ((v <= lb + eps) & (grad > 0)) | ((v >= ub - eps) & (grad < 0))

    for _ in range(n_iters):
        grad = H @ u + g
        du = _masked_solve(H, ~clamped(u, grad), -grad)
        cands = torch.stack([torch.clamp(u + a * du, lb, ub) for a in _ALPHAS])
        vals = obj(cands)
        ind = torch.argmin(vals)
        best = torch.index_select(cands, 0, ind.reshape(1))[0]
        u = torch.where(torch.amin(vals) < obj(u), best, u)
    grad = H @ u + g
    return u, ~clamped(u, grad)


@functools.lru_cache(maxsize=None)
def _combos(m, device):
    """(3^m, m) int: 0 = free, 1 = at lb, 2 = at ub, in itertools order;
    made once a (m, device), so a stage's QP copies nothing to the card."""
    return torch.tensor(list(itertools.product((0, 1, 2), repeat=m)), device=device)


@full_f32_matmul()
def boxqp_enum(H, g, lb, ub, eps: float = 1e-7):
    """EXACT small box QP by KKT active-set enumeration.

    Every dimension is free, clamped at lb, or clamped at ub: 3^m cases,
    each one masked solve on the free subspace plus a KKT check (free
    solution inside the box, clamped gradients pointing outward), all as
    one batched step. The strictly convex objective makes the
    KKT-consistent case the unique optimum, picked by a masked argmin.

    `eps` is scale-relative: the tests use eps * (1 + max|g| + max|H|), so
    f32 roundoff on ill-scaled H cannot reject every case. If it still
    does, the answer is the best *clipped* candidate by objective, never
    a silent pick of the all-free case. Returns (u, free_mask).
    """
    m = H.shape[-1]
    lb, ub = box_bounds(lb, m, H), box_bounds(ub, m, H)
    combos = _combos(m, H.device)
    F = combos == 0  # (K, m)
    zero = torch.zeros((), dtype=H.dtype, device=H.device)
    u_c = torch.where(combos == 1, lb, zero) + torch.where(combos == 2, ub, zero)

    rhs = -(g + u_c @ H.T)  # (K, m); H symmetric
    u_f = _masked_solve(H.expand(F.shape[0], m, m), F, rhs)
    Ff = F.to(H.dtype)
    u = u_f * Ff + u_c * (1.0 - Ff)

    scale = 1.0 + torch.amax(torch.abs(g)) + torch.amax(torch.abs(H))
    tol = eps * scale
    grad = u @ H.T + g
    ok_free = torch.where(F, (u >= lb - tol) & (u <= ub + tol), True)
    ok_lo = torch.where(combos == 1, grad >= -tol, True)
    ok_hi = torch.where(combos == 2, grad <= tol, True)
    feas = torch.all(ok_free & ok_lo & ok_hi, dim=-1)

    u_clip = torch.clamp(u, lb, ub)
    obj_clip = 0.5 * torch.einsum("ki,ij,kj->k", u_clip, H, u_clip) + u_clip @ g
    obj = torch.where(feas, obj_clip, torch.full_like(obj_clip, float("inf")))
    best = torch.where(torch.any(feas), torch.argmin(obj), torch.argmin(obj_clip))
    idx = best.reshape(1)
    return torch.index_select(u_clip, 0, idx)[0], torch.index_select(F, 0, idx)[0]
