"""Planar-arm kinematics and dynamics (counterpart of
`ilqr_admm_tpu/models/arm.py`).

A closed-form kinematic chain of revolute z-joints with links along the
local x axis. The state is x = [q, q_dot, p_ee], p_ee the 3-D
end-effector position (z = 0 for the planar chain); the control is
u = q_ddot, through a discrete double integrator on the joints:

    q+ = q + q_dot dt + u dt^2 / 2;  q_dot+ = q_dot + u dt;  p+ = fk(q+).

Every function is written in ops on the last axis, so each also takes
leading batch axes and works under `torch.func.vmap` (the fleet solver
maps `step` over instances and line-search candidates). The link lengths
and the integrator blocks are cached per dtype and device, so a step on
the card copies nothing from the host.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Sequence

import torch
from torch.func import jacfwd, vmap

from ilqr_admm_tpu_torch.utils.cost_assembly import get_double_integrator_AB

# the port's copy of the JAX package's `assets/planar_3dof.urdf`
PLANAR_3DOF_URDF = str(Path(__file__).resolve().parents[1] / "assets" / "planar_3dof.urdf")


class PlanarArm:
    """n-link planar arm, revolute z-joints, links along local x."""

    def __init__(self, link_lengths: Sequence[float] = (1.0, 1.0, 1.0), dt: float = 0.01):
        self.link_lengths = tuple(float(v) for v in link_lengths)
        self.q_dim = len(self.link_lengths)
        self.p_dim = 3  # [x, y, z] with z == 0, as in the reference state
        self.x_dim = 2 * self.q_dim + self.p_dim
        self.u_dim = self.q_dim
        self.dt = dt
        self._consts = {}

    @property
    def lengths(self) -> torch.Tensor:
        return torch.tensor(self.link_lengths, dtype=torch.float64)

    def _const(self, like: torch.Tensor):
        """(lengths (n,), A2 (2n, 2n), B2 (2n, n)) in the dtype and on the
        device of `like`."""
        key = (like.dtype, like.device)
        if key not in self._consts:
            kw = dict(dtype=like.dtype, device=like.device)
            A2, B2 = get_double_integrator_AB(self.q_dim, 2, self.dt, **kw)
            self._consts[key] = (torch.tensor(self.link_lengths, **kw), A2, B2)
        return self._consts[key]

    # ----------------------------------------------------------------- FK
    def fk(self, q: torch.Tensor) -> torch.Tensor:
        """End-effector position (..., 3) for joint angles q (..., q_dim)."""
        lengths = self._const(q)[0]
        c = torch.cumsum(q, dim=-1)
        x = torch.sum(lengths * torch.cos(c), dim=-1)
        y = torch.sum(lengths * torch.sin(c), dim=-1)
        return torch.stack([x, y, torch.zeros_like(x)], dim=-1)

    def fk_links(self, q: torch.Tensor) -> torch.Tensor:
        """All frame positions (..., q_dim + 1, 2): base, joints..., ee."""
        lengths = self._const(q)[0]
        c = torch.cumsum(q, dim=-1)
        xs = torch.cumsum(lengths * torch.cos(c), dim=-1)
        ys = torch.cumsum(lengths * torch.sin(c), dim=-1)
        pts = torch.stack([xs, ys], dim=-1)
        return torch.cat([torch.zeros_like(pts[..., :1, :]), pts], dim=-2)

    def jacobian(self, q: torch.Tensor) -> torch.Tensor:
        """Translational frame Jacobian (..., 3, q_dim), world-aligned:
        J[0, j] = -sum_{k>=j} l_k sin(c_k), J[1, j] = sum_{k>=j} l_k cos(c_k)."""
        lengths = self._const(q)[0]
        c = torch.cumsum(q, dim=-1)
        sk = lengths * torch.sin(c)
        ck = lengths * torch.cos(c)
        # suffix sums over k >= j
        jx = -torch.flip(torch.cumsum(torch.flip(sk, (-1,)), dim=-1), (-1,))
        jy = torch.flip(torch.cumsum(torch.flip(ck, (-1,)), dim=-1), (-1,))
        return torch.stack([jx, jy, torch.zeros_like(jx)], dim=-2)

    # ------------------------------------------------------------ dynamics
    def step(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        n, dt = self.q_dim, self.dt
        q = x[..., :n]
        qd = x[..., n : 2 * n]
        q_new = q + qd * dt + 0.5 * u * dt**2
        qd_new = qd + u * dt
        return torch.cat([q_new, qd_new, self.fk(q_new)], dim=-1)

    def __call__(self, x, u):
        return self.step(x, u)

    def initial_state(self, q0) -> torch.Tensor:
        q0 = torch.as_tensor(q0)
        return torch.cat([q0, torch.zeros_like(q0), self.fk(q0)], dim=-1)

    def get_AB(self, xs: torch.Tensor, us: torch.Tensor):
        """Linearization along a trajectory: A (N, d, d), B (N, d, u).

        The reference's hand-assembled linearization: the double-integrator
        block on (q, q_dot), the ee rows from the frame Jacobian at the
        *next* q. The blocks are joined with `cat`, so that the function
        works under `torch.func.vmap`.
        """
        n, dt = self.q_dim, self.dt
        N = xs.shape[-2]
        lead = xs.shape[:-2]
        _, A2, B2 = self._const(xs)
        q_next = xs[..., :n] + xs[..., n : 2 * n] * dt + 0.5 * us * dt**2
        J = self.jacobian(q_next)  # (..., N, 3, n)
        zeros = xs.new_zeros(lead + (N, 2 * n, self.p_dim))
        top = torch.cat([A2.expand(lead + (N, 2 * n, 2 * n)), zeros], dim=-1)
        bottom = torch.cat([J, J * dt, xs.new_zeros(lead + (N, self.p_dim, self.p_dim))], dim=-1)
        A = torch.cat([top, bottom], dim=-2)
        B = torch.cat([B2.expand(lead + (N, 2 * n, n)), 0.5 * J * dt**2], dim=-2)
        return A, B

    def get_AB_autodiff(self, xs: torch.Tensor, us: torch.Tensor):
        """Exact forward-mode Jacobians of `step` (an independent derivative
        path), in the dtype of xs: `torch.func.jacfwd` carries products
        with Python floats into the tangents as float64."""
        A, B = vmap(jacfwd(self.step, argnums=(0, 1)))(xs, us)
        return A.to(xs.dtype), B.to(xs.dtype)


_FLOAT_RE = re.compile(r'origin\s+xyz="([\d\.\+\-eE ]+)"')
# full <joint ...>...</joint> elements only: splitting on '<joint' would
# leak the next link's <visual>/<inertial> origins into the joint block
_JOINT_RE = re.compile(r"<joint\b.*?</joint>", re.DOTALL)


def load_planar_arm_urdf(path: str = PLANAR_3DOF_URDF, dt: float = 0.01) -> PlanarArm:
    """A PlanarArm from a planar z-revolute URDF chain: the positive x
    offsets of consecutive joint origins are the link lengths (enough
    for the 3-DoF benchmark asset, the default)."""
    with open(path) as fh:
        text = fh.read()
    lengths = []
    for joint_block in _JOINT_RE.findall(text):
        m = _FLOAT_RE.search(joint_block)
        if m:
            x = float(m.group(1).split()[0])
            if x > 0:
                lengths.append(x)
    if not lengths:
        raise ValueError(f"no link lengths found in {path}")
    return PlanarArm(lengths, dt=dt)
