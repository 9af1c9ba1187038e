"""n-th order point-mass integrator plant.

Counterpart of `ilqr_admm_tpu/models/double_integrator.py`: linear and
time-invariant, the fixture of the LQT-ADMM fleet.
"""

from __future__ import annotations

import torch
from torch import nn

from ilqr_admm_tpu_torch.utils.cost_assembly import get_double_integrator_AB


class DoubleIntegrator(nn.Module):
    """x = [pos (nb_dim), vel (nb_dim), ...] up to nb_deriv derivatives."""

    def __init__(
        self,
        nb_dim: int = 1,
        nb_deriv: int = 2,
        dt: float = 0.01,
        *,
        device=None,
        dtype: torch.dtype = torch.float64,
    ):
        super().__init__()
        self.nb_dim = nb_dim
        self.nb_deriv = nb_deriv
        self.dt = dt
        A, B = get_double_integrator_AB(nb_dim, nb_deriv, dt, device=device, dtype=dtype)
        self.register_buffer("A", A)
        self.register_buffer("B", B)
        self.x_dim = nb_dim * nb_deriv
        self.u_dim = nb_dim

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return self.A @ x + self.B @ u

    def forward(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return self.step(x, u)

    def AB(self, N: int):
        """Stacked (N, x, x), (N, x, u) dynamics for the solver core."""
        return (
            self.A.expand((N,) + tuple(self.A.shape)),
            self.B.expand((N,) + tuple(self.B.shape)),
        )
