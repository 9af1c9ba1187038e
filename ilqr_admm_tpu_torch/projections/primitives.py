"""Euclidean projection primitives (counterpart of
`ilqr_admm_tpu/projections/primitives.py`).

Every operator of the JAX module: boxes, halfspace pairs and affine
preimages, the quadratic and inf-norm shells, the unit ball, the
second-order cone, the causality mask, soft-thresholding and the
weighted-l1 ball. Each is branchless (`torch.where` masks), so it runs
on any device and under `torch.func` transforms. The last axis is the
vector dimension, leading axes are batch; the `_batch` names are
aliases kept for the JAX package's API.

`torch.where` differentiates the branch it did not select too (its
gradient there is zero times that branch's derivative), so every
denominator is guarded by _EPS, as in the JAX package, and a gradient
through the selected branch stays finite.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-30


def project_bound(x: torch.Tensor, l, u) -> torch.Tensor:
    """Box projection: l <= P(x) <= u; a None bound is open."""
    if l is not None:
        x = torch.maximum(x, torch.as_tensor(l, dtype=x.dtype, device=x.device))
    if u is not None:
        x = torch.minimum(x, torch.as_tensor(u, dtype=x.dtype, device=x.device))
    return x


def _like(v, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=x.dtype, device=x.device)


def project_linear(x: torch.Tensor, a, l, u) -> torch.Tensor:
    """Project x so that l <= a.x <= u (a halfspace pair); batched over
    the leading axes of x."""
    a = _like(a, x)
    aTx = torch.sum(x * a, dim=-1, keepdim=True)
    aTa = torch.sum(a * a, dim=-1, keepdim=True) + _EPS
    l, u = _like(l, x), _like(u, x)
    mu = torch.where(aTx > u, aTx - u, torch.where(aTx < l, aTx - l, 0.0))
    return x - mu * a / aTa


project_linear_batch = project_linear


def project_multilinear(x: torch.Tensor, A, l, u) -> torch.Tensor:
    """Clip Ax into [l, u] and pull the change back through A (lands on
    the boundary, not necessarily at the least-norm point)."""
    A = _like(A, x)
    Ax = x @ A.T if x.ndim > 1 else A @ x
    tmp = project_bound(Ax, l, u)
    AAT_inv = torch.linalg.inv(A @ A.T)
    mu = (Ax - tmp) @ AAT_inv.T
    return x - mu @ A


def project_affine(x: torch.Tensor, a, b, l, u) -> torch.Tensor:
    """Project x so that l <= a.x + b <= u."""
    return project_linear(x, a, l - b, u - b)


def project_quadratic(x: torch.Tensor, l, u) -> torch.Tensor:
    """Project onto the shell l <= 0.5 ||x||^2 <= u (an annulus); batched
    over the leading axes.

    x ~ 0 with l > 0 has no unique nearest point: it goes to the inner
    shell along the first coordinate, a point on the shell instead of
    the infeasible zero vector.
    """
    l, u = _like(l, x), _like(u, x)
    val = 0.5 * torch.sum(x * x, dim=-1, keepdim=True)
    nrm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    hi = x * torch.sqrt(2.0 * u) / (nrm + _EPS)  # val > u implies nrm > 0
    e1 = torch.zeros_like(x)
    e1[..., 0] = 1.0
    dir_lo = torch.where(nrm > 1e-12, x / (nrm + _EPS), e1)
    lo = dir_lo * torch.sqrt(2.0 * l)
    return torch.where(val > u, hi, torch.where(val < l, lo, x))


project_quadratic_batch = project_quadratic


def project_quadratic_b(x: torch.Tensor, b, l, u) -> torch.Tensor:
    """Project so that l <= 0.5 x.x + b.x <= u (the shell of
    `project_quadratic` centred at -b)."""
    b = _like(b, x)
    const = 0.5 * torch.sum(b**2)
    return project_quadratic(x + b, l + const, u + const) - b


def project_soc_unit(zt: torch.Tensor) -> torch.Tensor:
    """Second-order-cone projection of stacked [z, t] onto ||z|| <= t.

    zt: (..., d+1) with z = zt[..., :-1], t = zt[..., -1]. Where
    n = ||z|| lies in (-t, t) from outside, the scaling branch
    0.5 (n + t) / n applies; below the polar cone the result is 0.
    """
    z = zt[..., :-1]
    t = zt[..., -1:]
    n = torch.linalg.vector_norm(z, dim=-1, keepdim=True)
    scale = 0.5 * (n + t) / (n + _EPS)
    inside = n <= t
    polar = n <= -t
    z_out = torch.where(inside, z, torch.where(polar, 0.0, scale * z))
    t_out = torch.where(inside, t, torch.where(polar, 0.0, 0.5 * (n + t)))
    return torch.cat([z_out, t_out], dim=-1)


def project_soc_unit_batch(z: torch.Tensor, t: torch.Tensor):
    """(z, t) interface of `project_soc_unit`: z (..., d), t (...)."""
    out = project_soc_unit(torch.cat([z, t[..., None]], dim=-1))
    return out[..., :-1], out[..., -1]


def project_unit_ball(x: torch.Tensor) -> torch.Tensor:
    """Project into the unit ball."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return torch.where(n <= 1.0, x, x / (n + _EPS))


def project_square(x: torch.Tensor, l, u) -> torch.Tensor:
    """Project onto the inf-norm shell l <= ||x||_inf <= u: inside the
    inner box the largest-magnitude coordinate (the first of equals, as
    `jnp.argmax` picks) is pushed out to +-l; then clip into [-u, u]."""
    absx = torch.abs(x)
    inf_norm = torch.amax(absx, dim=-1, keepdim=True)
    j = torch.argmax(absx, dim=-1, keepdim=True)
    onehot = torch.arange(x.shape[-1], device=x.device) == j
    sgn = torch.where(x >= 0, 1.0, -1.0).to(x.dtype)
    l, u = _like(l, x), _like(u, x)
    z = torch.where(inf_norm < l, torch.where(onehot, l * sgn, x), x)
    return project_bound(z, -u, u)


project_square_batch = project_square


def project_square_c(x: torch.Tensor, c, l, u) -> torch.Tensor:
    """Inf-norm shell centred at c."""
    c = _like(c, x)
    return project_square(x - c, l, u) + c


def project_block_lower_triangular(z: torch.Tensor, x_dim: int, u_dim: int, N: int) -> torch.Tensor:
    """Zero the block-diagonal rows that enforce strict causality: for
    each time step i, z[i*u_dim, i*x_dim:(i+1)*x_dim] = 0."""
    rows = torch.arange(z.shape[0], device=z.device)
    cols = torch.arange(z.shape[1], device=z.device)
    mask = ((rows % u_dim) == 0)[:, None] & ((rows // u_dim)[:, None] == (cols // x_dim)[None, :])
    return torch.where(mask, 0.0, z)


def prox_l1(v: torch.Tensor, thresh) -> torch.Tensor:
    """Soft-thresholding, the prox of thresh * ||.||_1."""
    return torch.sign(v) * torch.clamp(torch.abs(v) - thresh, min=0.0)


def prox_l1_box(v: torch.Tensor, thresh, lower, upper) -> torch.Tensor:
    """Prox of thresh * ||.||_1 plus the indicator of [lower, upper]: the
    clip of the soft-threshold (exact for separable scalars)."""
    return project_bound(prox_l1(v, thresh), lower, upper)


def project_weighted_l1(x: torch.Tensor, w, r) -> torch.Tensor:
    """Exact projection onto the weighted-l1 ball {v : sum_i w_i |v_i| <= r}.

    lambda* solves sum_i w_i max(|x_i| - lambda w_i, 0) = r, which is
    piecewise linear with breakpoints |x_i| / w_i; the valid segment is
    picked over the descending sort. Acts on the last axis of x.

    w: positive weights broadcastable to x's last axis; a zero weight
    makes the set unbounded in that coordinate and is rejected, whether
    given as a list, an array or a tensor. r: scalar or radius per
    vector, broadcastable to x's leading axes.
    """
    if isinstance(w, torch.Tensor):
        positive = bool(torch.all(w > 0.0))
    else:
        positive = bool(np.all(np.asarray(w, np.float64) > 0.0))
    if not positive:
        raise ValueError(f"weights must be strictly positive, got {w}")
    w = torch.as_tensor(w, dtype=x.dtype, device=x.device).expand(x.shape)
    r = torch.as_tensor(r, dtype=x.dtype, device=x.device)[..., None]
    a = torch.abs(x)
    z = a / w  # breakpoints
    order = torch.argsort(-z, dim=-1, stable=True)
    z_s = torch.take_along_dim(z, order, dim=-1)
    p_wa = torch.cumsum(torch.take_along_dim(w * a, order, dim=-1), dim=-1)
    p_w2 = torch.cumsum(torch.take_along_dim(w * w, order, dim=-1), dim=-1)
    lam_k = (p_wa - r) / p_w2
    # the valid k is the largest with z_s[k] > lam_k (support of lambda*)
    k_star = torch.sum(z_s > lam_k, dim=-1, keepdim=True) - 1
    lam = torch.take_along_dim(lam_k, torch.clamp(k_star, min=0), dim=-1)
    lam = torch.clamp(lam, min=0.0)
    inside = torch.sum(w * a, dim=-1, keepdim=True) <= r
    return torch.where(inside, x, prox_l1(x, lam * w))


projections = {
    "SOC": project_soc_unit,
    "bound": project_bound,
    "linear": project_linear,
    "quadratic": project_quadratic,
    "square": project_square,
}
