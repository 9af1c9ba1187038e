"""Trajectory rollouts (counterpart of `ilqr_admm_tpu/ops/rollout.py`).

The JAX package runs each rollout as a `lax.scan`; here each is a Python
loop over t. All are single-instance. Trajectories are x_0..x_{N-1} (N
states); optional additive process noise is a pre-sampled argument
`ws (N, x_dim)`. `unroll` is accepted for the JAX signature and has no
effect (it only unrolls the TPU scan body).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


def _collect(f, x0, N, control, ws):
    """x_{t+1} = f(x_t, u_t) + w_t with u_t = control(t, x_t); returns
    (xs (N, x), us (N, u)), the states before each step."""
    xs, us = [], []
    x = x0
    for t in range(N):
        u = control(t, x)
        xs.append(x)
        us.append(u)
        x = f(x, u)
        if ws is not None:
            x = x + ws[t]
    return torch.stack(xs, dim=0), torch.stack(us, dim=0)


@full_f32_matmul()
def rollout_linear(
    A: torch.Tensor, B: torch.Tensor, x0: torch.Tensor, us: torch.Tensor,
    ws: Optional[torch.Tensor] = None, unroll: int = 1,
) -> torch.Tensor:
    """Open-loop linear rollout: returns xs (N, x_dim), xs[0] = x0."""
    xs = []
    x = x0
    for t in range(us.shape[0]):
        xs.append(x)
        x = A[t] @ x + B[t] @ us[t]
        if ws is not None:
            x = x + ws[t]
    return torch.stack(xs, dim=0)


@full_f32_matmul()
def rollout_nonlinear(
    f: Callable, x0: torch.Tensor, us: torch.Tensor, ws: Optional[torch.Tensor] = None,
    unroll: int = 1,
) -> torch.Tensor:
    """Open-loop nonlinear rollout with f(x, u) -> x_next (single sample)."""
    return _collect(f, x0, us.shape[0], lambda t, x: us[t], ws)[0]


@full_f32_matmul()
def rollout_closed_loop(
    f: Callable,
    x0: torch.Tensor,
    K: torch.Tensor,
    k: torch.Tensor,
    x_nom: Optional[torch.Tensor] = None,
    u_nom: Optional[torch.Tensor] = None,
    ws: Optional[torch.Tensor] = None,
    unroll: int = 1,
):
    """Per-step feedback rollout: u_t = K_t (x_t - x_nom_t) + k_t + u_nom_t.

    Without nominals this is the LQT DP controller; with them the iLQR
    line-search rollout. Returns (xs (N, x), us (N, u)).
    """
    def control(t, x):
        dx = x if x_nom is None else x - x_nom[t]
        # expanded matvec, as in the JAX package: exact elementwise f32
        u = torch.sum(K[t] * dx[None, :], dim=-1) + k[t]
        return u if u_nom is None else u + u_nom[t]

    return _collect(f, x0, K.shape[0], control, ws)


def _history_rollout(f, x0, K, k, x_dim, u_dim, N, x_nom, u_nom, ws):
    """History feedback u_t = K[t, 0:t+1] . (x_{0:t} - x_nom_{0:t}) + k_t
    (+ u_nom_t); K is the lifted causal gain (N*u, N*x)."""
    K4 = K.reshape(N, u_dim, N, x_dim)
    k2 = k.reshape(N, u_dim)
    steps = torch.arange(N, device=K.device)[:, None]
    hist = torch.zeros((N, x_dim), dtype=K.dtype, device=K.device)

    def control(t, x):
        nonlocal hist
        dx = x if x_nom is None else x - x_nom[t]
        # out of place, so that torch.func.vmap can batch the rollout over
        # line-search candidates
        hist = torch.where(steps == t, dx, hist)
        u = torch.einsum("unj,nj->u", K4[t], hist) + k2[t]
        return u if u_nom is None else u + u_nom[t]

    return _collect(f, x0, N, control, ws)


@full_f32_matmul()
def rollout_sls(
    f: Callable,
    x0: torch.Tensor,
    K: torch.Tensor,
    k: torch.Tensor,
    x_dim: int,
    u_dim: int,
    ws: Optional[torch.Tensor] = None,
):
    """History-feedback SLS rollout: u_t = K[t, 0:t+1] . x_{0:t} + k_t.

    K is the lifted causal gain (N*u, N*x), k is (N*u,). Returns (xs, us).
    """
    N = K.shape[0] // u_dim
    return _history_rollout(f, x0, K, k, x_dim, u_dim, N, None, None, ws)


@full_f32_matmul()
def rollout_sls_delta(
    f: Callable,
    x0: torch.Tensor,
    K: torch.Tensor,
    k: torch.Tensor,
    x_nom: torch.Tensor,
    u_nom: torch.Tensor,
    ws: Optional[torch.Tensor] = None,
):
    """SLS rollout around a nominal, history feedback on the deltas:
    u_t = K[t, 0:t+1] . (x_{0:t} - x_nom_{0:t}) + k_t + u_nom_t."""
    N, x_dim = x_nom.shape
    return _history_rollout(f, x0, K, k, x_dim, u_nom.shape[-1], N, x_nom, u_nom, ws)
