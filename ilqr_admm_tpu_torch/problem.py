"""Problem data as torch modules (counterpart of `ilqr_admm_tpu/problem.py`).

The JAX package keeps problem data in pytrees; here they are
`nn.Module`s that hold their arrays as buffers, so `.to(device, dtype)`
moves them as a unit. The solver configs and `SolveStatus` are not
ported yet.
"""

from __future__ import annotations

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
