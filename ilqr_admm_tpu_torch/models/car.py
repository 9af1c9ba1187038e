"""2D car plants and the car-parking cost (counterpart of
`ilqr_admm_tpu/models/car.py`).

- `CarFrontWheel`: the front-wheel kinematic car of the control-limited
  DDP car-parking problem. State [x, y, heading, front-wheel velocity],
  control [front-wheel angle, acceleration]. Its step has a compiled twin
  in `csrc/linesearch_rollout.cu` (`CarFrontWheelStep`), which
  `ops/fused_rollout.py` launches.
- `CarSimple`: kinematic car with steering-rate control, closed-form and
  autodiff Jacobians.
- `CarParkingCost`: pseudo-Huber parking cost, an `nn.Module` holding its
  weights as buffers.

Derivatives come from `torch.func` (jacfwd, grad, hessian) vmapped over
the horizon, as the JAX package takes them from `jax.jacfwd`/`grad`/
`hessian`. The JAX step's `_asin` hook is gone: it exists there only
because Pallas on the TPU has no asin, and torch and CUDA both have one.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.func import grad, hessian, jacfwd, vmap


def _jacobians(step, xs, us):
    """vmap(jacfwd(step)) along a trajectory, in the dtype of xs:
    `torch.func.jacfwd` carries a product with a Python float into the
    tangent as float64, so an f32 step would give f64 Jacobians."""
    A, B = vmap(jacfwd(step, argnums=(0, 1)))(xs, us)
    return A.to(xs.dtype), B.to(xs.dtype)


class CarFrontWheel:
    """Front-axle kinematic car; s = [x, y, theta, v], u = [wheel_angle, accel]."""

    x_dim = 4
    u_dim = 2

    def __init__(self, dt: float = 0.03, dist: float = 2.0):
        self.dt = dt
        self.dist = dist

    def step(self, s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        dt, dist = self.dt, self.dist
        w, a = u[0], u[1]
        x, y, o, v = s[0], s[1], s[2], s[3]
        f = dt * v  # front-wheel rolling distance
        ins = dist**2 - (torch.sin(w) * f) ** 2
        b = f * torch.cos(w) + dist - torch.sqrt(ins)  # back-wheel rolling distance
        do = torch.asin(torch.sin(w) * f / dist)
        return torch.stack([x + b * torch.cos(o), y + b * torch.sin(o), o + do, v + a * dt])

    def __call__(self, s, u):
        return self.step(s, u)

    def step_cols(self, s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """`step` over candidate columns: s (4, A), u (2, A) -> (4, A).

        `step` is written in elementwise ops on the component rows, so it
        already maps them across the trailing candidate axis."""
        return self.step(s, u)

    def get_AB(self, xs: torch.Tensor, us: torch.Tensor):
        """(A, B) Jacobians along a trajectory: (N, 4, 4), (N, 4, 2)."""
        return _jacobians(self.step, xs, us)


class CarSimple:
    """Kinematic car with steering-rate input; x = [x, y, theta, v], u = [steer, dv].

    theta wraps modulo 2 pi in `step`; the Jacobians differentiate the
    unwrapped dynamics, as the reference's closed-form `get_AB` does.
    """

    x_dim = 4
    u_dim = 2

    def __init__(self, dt: float = 0.03):
        self.dt = dt

    def step_unwrapped(self, x, u):
        """Dynamics without the theta wrap: the differentiable twin, and
        the one to solve with (the wrap's jump blows up line-search
        candidates that dip theta below 0)."""
        dt = self.dt
        return torch.stack([
            x[0] + dt * x[3] * torch.cos(x[2]),
            x[1] + dt * x[3] * torch.sin(x[2]),
            x[2] + dt * x[3] * u[0],
            x[3] + dt * u[1],
        ])

    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        s = self.step_unwrapped(x, u)
        # torch.remainder is floor-mod, as jnp's %
        return torch.stack([s[0], s[1], torch.remainder(s[2], 2.0 * math.pi), s[3]])

    def __call__(self, x, u):
        return self.step(x, u)

    def get_AB(self, xs: torch.Tensor, us: torch.Tensor):
        """Closed-form Jacobians of the unwrapped dynamics, on the last
        axis (no in-place writes), so they batch and vmap."""
        dt = self.dt
        th, v = xs[..., 2], xs[..., 3]
        one, zero = torch.ones_like(th), torch.zeros_like(th)
        sin, cos = torch.sin(th), torch.cos(th)

        def rows(*r):
            return torch.stack([torch.stack(row, dim=-1) for row in r], dim=-2)

        A = rows((one, zero, -dt * v * sin, dt * cos),
                 (zero, one, dt * v * cos, dt * sin),
                 (zero, zero, one, dt * us[..., 0]),
                 (zero, zero, zero, one))
        B = rows((zero, zero), (zero, zero), (dt * v, zero), (zero, torch.full_like(th, dt)))
        return A, B

    def get_AB_autodiff(self, xs, us):
        return _jacobians(self.step_unwrapped, xs, us)


def pseudo_huber(x, p):
    """Smooth absolute value: sqrt(x^2 + p^2) - p."""
    return torch.sqrt(x**2 + p**2) - p


class CarParkingCost(nn.Module):
    """Car-parking cost: control quadratic plus pseudo-Huber running and
    final terms; cost(xs (..., N, 4), us (..., N, 2)) -> (...,).

    The defaults are the control-limited DDP car-parking weights. The
    weights are buffers: build on a device and dtype, or move with `.to`.
    """

    def __init__(
        self,
        cu=(1e-2, 1e-4),
        cf=(0.1, 0.1, 1.0, 0.3),
        pf=(0.01, 0.01, 0.01, 1.0),
        cx=(1e-3, 1e-3),
        px=(0.1, 0.1),
        *,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        for name, w in (("cu", cu), ("cf", cf), ("pf", pf), ("cx", cx), ("px", px)):
            self.register_buffer(name, torch.as_tensor(w, dtype=dtype, device=device).clone())

    def stage(self, x: torch.Tensor, u: torch.Tensor, is_final) -> torch.Tensor:
        """Stage cost of one (x (4,), u (2,)); the final terms where is_final."""
        lu = torch.sum(self.cu * u**2)
        lx = torch.sum(self.cx * pseudo_huber(x[:2], self.px))
        lf = torch.sum(self.cf * pseudo_huber(x, self.pf))
        return lu + lx + torch.where(is_final, lf, torch.zeros_like(lf))

    def forward(self, xs: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
        N = xs.shape[-2]
        is_final = torch.arange(N, device=xs.device) == N - 1
        c = vmap(self.stage)(
            xs.reshape(-1, xs.shape[-1]),
            us.reshape(-1, us.shape[-1]),
            is_final.expand(xs.shape[:-1]).reshape(-1),
        ).reshape(xs.shape[:-1])
        total = torch.sum(c, dim=-1)
        # +inf, not the reference's 1e6: a NaN trajectory must never win a
        # line search
        return torch.where(torch.isnan(total), torch.full_like(total, math.inf), total)

    def get_Cs(self, xs: torch.Tensor, us: torch.Tensor):
        """Taylor blocks (cts (N, x+u), Cts (N, x+u, x+u)) of the stage
        cost around a nominal: gradients and Hessians w.r.t. [x; u],
        symmetrized, NaNs zeroed."""
        N = xs.shape[0]
        is_final = torch.arange(N, device=xs.device) == N - 1

        def stage_xu(xu, fin):
            return self.stage(xu[:4], xu[4:], fin)

        xu = torch.cat([xs, us], dim=-1)
        cts = vmap(grad(stage_xu))(xu, is_final)
        Cts = vmap(hessian(stage_xu))(xu, is_final)
        Cts = 0.5 * (Cts + Cts.transpose(-1, -2))
        cts = torch.where(torch.isnan(cts), torch.zeros_like(cts), cts)
        Cts = torch.where(torch.isnan(Cts), torch.zeros_like(Cts), Cts)
        return cts, Cts
