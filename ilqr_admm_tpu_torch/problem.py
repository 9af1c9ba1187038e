"""Problem data as torch modules (counterpart of `ilqr_admm_tpu/problem.py`).

The JAX package keeps problem data in pytrees; here they are
`nn.Module`s that hold their arrays as buffers, so `.to(device, dtype)`
moves them as a unit. The solver configs are frozen dataclasses, as in
the JAX package, and `SolveStatus` is the same `IntEnum`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch
from torch import nn


class QuadCost(nn.Module):
    """Per-timestep quadratic tracking cost.

    cost(x, u) = sum_t (x_t - xd_t)^T Q_t (x_t - xd_t) + u_t^T R_t u_t

    (no 1/2 factor, as in the JAX package).

    Q:  (N, x_dim, x_dim)
    xd: (N, x_dim)
    R:  (N, u_dim, u_dim)
    """

    def __init__(self, Q: torch.Tensor, xd: torch.Tensor, R: torch.Tensor):
        super().__init__()
        self.register_buffer("Q", Q)
        self.register_buffer("xd", xd)
        self.register_buffer("R", R)

    @property
    def N(self) -> int:
        return self.Q.shape[0]

    @property
    def x_dim(self) -> int:
        return self.Q.shape[-1]

    @property
    def u_dim(self) -> int:
        return self.R.shape[-1]

    def forward(self, xs: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
        """Cost of (possibly batched) trajectories.

        xs: (..., N, x_dim); us: (..., N, u_dim). Returns (...,).
        Written as broadcast-multiply-sum, like the JAX version, so the
        quadratic forms are exact elementwise f32 with no matmul in them.
        """
        dx = xs - self.xd
        Qdx = torch.sum(self.Q * dx[..., :, None, :], dim=-1)
        Rus = torch.sum(self.R * us[..., :, None, :], dim=-1)
        cx = torch.sum(dx * Qdx, dim=(-2, -1))
        cu = torch.sum(us * Rus, dim=(-2, -1))
        return cx + cu

    def lifted_Q(self) -> torch.Tensor:
        """Dense (N*x, N*x) block-diagonal lifted Q."""
        return torch.block_diag(*self.Q)

    def lifted_R(self) -> torch.Tensor:
        """Dense (N*u, N*u) block-diagonal lifted R."""
        return torch.block_diag(*self.R)

    def lifted_xd(self) -> torch.Tensor:
        return self.xd.reshape(-1)


@dataclasses.dataclass
class LQTProblem:
    """Linear(ized) quadratic tracking problem.

    A: (N, x_dim, x_dim), x_{t+1} = A_t x_t + B_t u_t
    B: (N, x_dim, u_dim)
    cost: QuadCost
    """

    A: torch.Tensor
    B: torch.Tensor
    cost: QuadCost

    @property
    def N(self) -> int:
        return self.A.shape[0]

    @property
    def x_dim(self) -> int:
        return self.A.shape[-1]

    @property
    def u_dim(self) -> int:
        return self.B.shape[-1]


def host_f64(A, B, cost: QuadCost, dtype: torch.dtype):
    """(A, B, cost) rounded to `dtype`, then lifted exactly to f64 on the host.

    The port's one-time setups run on these: they describe the problem
    that the working dtype holds, at f64 accuracy (setup at reduced
    precision converges to the optimum of a perturbed problem).
    """
    cpu, f64 = torch.device("cpu"), torch.float64

    def data(t):
        return torch.as_tensor(t).to(cpu, dtype).to(f64)

    return data(A), data(B), QuadCost(data(cost.Q), data(cost.xd), data(cost.R))


def broadcast_AB(A, B, N: int):
    """Accept (x,x)/(N,x,x) A and (x,u)/(N,x,u) B, return (N, ., .) tensors."""
    A = torch.as_tensor(A)
    B = torch.as_tensor(B)
    if A.ndim == 2:
        A = A.expand((N,) + tuple(A.shape))
    if B.ndim == 2:
        B = B.expand((N,) + tuple(B.shape))
    return A, B


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    """Config for the generic two-block scaled ADMM solver.

    The fields and defaults of the JAX package's `ADMMConfig`:
    max_iter, relaxation alpha, absolute tolerance and the relative-stall
    tolerance; residual-balancing adaptive penalties (adaptive_rho with
    rho_mu, rho_tau, rho_freq, rho_freeze_after and the scale clip; the
    x-update must then accept a third rho_scale argument); Nesterov
    acceleration with adaptive restart (accel, accel_eta); safeguarded
    type-II Anderson acceleration (anderson_m > 0, anderson_reg,
    anderson_safeguard). accel, adaptive_rho and Anderson exclude each
    other.
    """

    max_iter: int = 20
    alpha: float = 1.0
    tol: float = 1e-3
    stall_tol: Optional[float] = None  # defaults to tol when None
    log: bool = False
    adaptive_rho: bool = False
    rho_mu: float = 10.0
    rho_tau: float = 2.0
    rho_freq: int = 4
    rho_freeze_after: int = 100
    rho_scale_min: float = 1e-3
    rho_scale_max: float = 1e3
    accel: bool = False
    accel_eta: float = 1.02
    anderson_m: int = 0
    anderson_reg: float = 1e-10
    anderson_safeguard: float = 10.0

    @property
    def stall(self) -> float:
        return self.tol if self.stall_tol is None else self.stall_tol


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    """Config for the iLQR outer loop."""

    max_iter: int = 100
    max_line_search_iter: int = 50
    tol_fun: float = 1e-5
    tol_grad: float = 1e-4
    # line-search grid alphas = 10^linspace(0, alpha_min_exp, 50)[:n]
    alpha_min_exp: float = -5.0


class SolveStatus(enum.IntEnum):
    """Structured solver statuses."""

    RUNNING = 0
    CONVERGED = 1
    STALLED = 2
    MAX_ITER = 3
    LINE_SEARCH_FAILED = 4
    OSCILLATING = 5


def line_search_alphas(cfg: ILQRConfig, dtype=torch.float32, device=None) -> torch.Tensor:
    """The parallel line-search step grid, 10^linspace(0, alpha_min_exp, 50)[:n]."""
    n = cfg.max_line_search_iter
    return 10.0 ** torch.linspace(0.0, cfg.alpha_min_exp, 50, dtype=dtype, device=device)[:n]
