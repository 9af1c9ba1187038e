"""Euclidean projection primitives (counterpart of part of
`ilqr_admm_tpu/projections/primitives.py`).

Ported so far: the box projection (the z-update of the LQT fleet), the
second-order-cone projection, soft-thresholding and the weighted-l1
ball (the z-updates of the robust SLS fleet). The last axis is the
vector dimension, leading axes are batch.
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


def prox_l1(v: torch.Tensor, thresh) -> torch.Tensor:
    """Soft-thresholding, the prox of thresh * ||.||_1."""
    return torch.sign(v) * torch.clamp(torch.abs(v) - thresh, min=0.0)


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
