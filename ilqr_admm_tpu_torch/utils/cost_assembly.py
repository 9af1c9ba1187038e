"""Cost assembly helpers (counterpart of `ilqr_admm_tpu/utils/cost_assembly.py`).

The via-point cost and its stacking helpers, the n-th order integrator,
the lifted-matrix and nullspace helpers, the augmented-state cost
helpers and `run_once`. Per-timestep costs stay stacked (N, d, d), as in
the JAX package. These run once at problem setup; the lifted-matrix
helpers return float64 CPU tensors unless given a device and dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ilqr_admm_tpu_torch.ops.sqrt_riccati import eigh_rayleigh
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
        w, V = eigh_rayleigh(precs)
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


def selection_matrix(m: int, n: int, horizon: int, *, device=None,
                     dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Block lower-triangular ones mask ((horizon+1)m, (horizon+1)n)."""
    rows = np.arange(horizon + 1)
    mask = (rows[:, None] >= rows[None, :]).astype(float)
    return torch.tensor(np.kron(mask, np.ones((m, n))), dtype=dtype, device=device)


def construct_Z(d: int, N: int, *, device=None, dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Block down-shift operator Z: (d(N+1), d(N+1)), ones where i == j + d."""
    Z = np.zeros((d * (N + 1), d * (N + 1)))
    i, j = np.indices(Z.shape)
    Z[i == d + j] = 1.0
    return torch.tensor(Z, dtype=dtype, device=device)


def nullspace_matrix(J) -> torch.Tensor:
    """I - pinv(J) J."""
    J = torch.as_tensor(J)
    return torch.eye(J.shape[-1], dtype=J.dtype, device=J.device) - torch.linalg.pinv(J) @ J


def nullspace_matrix2(J) -> torch.Tensor:
    """N N^T with N an orthonormal nullspace basis (scipy's `null_space`)."""
    import scipy.linalg

    J = torch.as_tensor(J)
    Nmat = scipy.linalg.null_space(J.detach().cpu().numpy())
    return torch.tensor(Nmat @ Nmat.T, dtype=J.dtype, device=J.device)


def augment_Qt(Q) -> torch.Tensor:
    """[[Q, 0], [0, 1]]: Q padded to (n+1, n+1) with a unit corner."""
    Q = torch.as_tensor(Q)
    n = Q.shape[0]
    out = torch.eye(n + 1, dtype=Q.dtype, device=Q.device)
    out[:n, :n] = Q
    return out


def augment_mut(mu) -> torch.Tensor:
    """I_{n+1} with -mu in the last row's first n entries."""
    mu = torch.as_tensor(mu)
    n = mu.shape[0]
    M = torch.eye(n + 1, dtype=mu.dtype, device=mu.device)
    M[n, :-1] = -mu
    return M


def find_augmented_precs(zs, Qs, seq) -> torch.Tensor:
    """Stacked augmented precisions M_t Q~_t M_t^T, (N, d+1, d+1)."""
    zs, Qs = torch.as_tensor(zs), torch.as_tensor(Qs)
    blocks = []
    for s in np.asarray(seq):
        M = augment_mut(zs[s])
        blocks.append(M @ augment_Qt(Qs[s]) @ M.T)
    return torch.stack(blocks)


def batch_cost_vars(zs, Qs, seq):
    """(mu, Q) pair for end-effector-space tasks: (find_mus, find_precs)."""
    return find_mus(zs, seq), find_precs(Qs, seq)


def run_once(f):
    """Memoizing run-once decorator: the first call's result is returned
    by every later call. A first call that raises is not remembered."""

    def wrapper(*args, **kwargs):
        if not wrapper.has_run:
            wrapper.result = f(*args, **kwargs)
            wrapper.has_run = True
        return wrapper.result

    wrapper.has_run = False
    wrapper.result = None
    return wrapper
