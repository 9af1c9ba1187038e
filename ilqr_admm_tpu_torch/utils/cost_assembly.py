"""Cost assembly helpers (counterpart of `ilqr_admm_tpu/utils/cost_assembly.py`).

Only what the box-constrained LQT-ADMM fleet needs is ported: the
via-point cost, its stacking helpers and the n-th order integrator.
Per-timestep costs stay stacked (N, d, d), as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ilqr_admm_tpu_torch.problem import QuadCost


def _as_index(seq, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(seq), dtype=torch.long, device=device)


def find_mus(zs, seq) -> torch.Tensor:
    """Stack via-point targets along the horizon: xd = zs[seq] flattened.

    zs: (n_via, d), seq: (N,) int. Returns (N*d,).
    """
    zs = torch.as_tensor(zs)
    return zs[_as_index(seq, zs.device)].reshape(-1)


def find_precs(Qs, seq, sqrt: bool = False):
    """Per-timestep precision matrices Q_t = Qs[seq[t]], stacked (N, d, d).

    With sqrt=True also returns symmetric PSD square roots S with
    S @ S = Q_t (eigh-based, like the JAX version).
    """
    Qs = torch.as_tensor(Qs)
    precs = Qs[_as_index(seq, Qs.device)]
    if sqrt:
        w, V = torch.linalg.eigh(precs)
        w = torch.sqrt(torch.clamp(w, min=0.0))
        return precs, torch.einsum("tij,tj,tkj->tik", V, w, V)
    return precs


def viapoint_cost(
    zs, Qs, seq, u_std, u_dim: int, *, device=None, dtype: torch.dtype | None = None
) -> QuadCost:
    """Build a QuadCost from via-point specs; R_t = u_std * I_{u_dim}.

    device/dtype default to those of `Qs`.
    """
    Q = find_precs(torch.as_tensor(Qs, dtype=dtype, device=device), seq)
    zs = torch.as_tensor(zs, dtype=Q.dtype, device=Q.device)
    xd = zs[_as_index(seq, Q.device)]
    N = xd.shape[0]
    eye = torch.eye(u_dim, dtype=Q.dtype, device=Q.device)
    R = (u_std * eye).expand(N, u_dim, u_dim)
    return QuadCost(Q=Q, xd=xd, R=R)


def get_double_integrator_AB(
    nb_dim: int,
    nb_deriv: int = 2,
    dt: float = 0.01,
    *,
    device=None,
    dtype: torch.dtype = torch.float64,
):
    """Discrete n-th order integrator (exact ZOH).

    Returns A (nb_dim*nb_deriv, nb_dim*nb_deriv), B (nb_dim*nb_deriv, nb_dim).
    """
    A1 = np.zeros((nb_deriv, nb_deriv))
    for i in range(nb_deriv):
        A1 += np.diag(np.ones(nb_deriv - i), i) * dt**i / math.factorial(i)
    B1 = np.zeros((nb_deriv, 1))
    for i in range(1, nb_deriv + 1):
        B1[nb_deriv - i, 0] = dt**i / math.factorial(i)
    return (
        torch.tensor(np.kron(A1, np.eye(nb_dim)), dtype=dtype, device=device),
        torch.tensor(np.kron(B1, np.eye(nb_dim)), dtype=dtype, device=device),
    )
