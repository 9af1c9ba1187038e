"""Carry problem data over from the JAX package to the port.

Takes the JAX package's problem data as numpy arrays (`np.asarray` of
the JAX arrays) and builds the port's objects from copies, so the two
packages can be fed the same problem. Imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ilqr_admm_tpu_torch.models.arm import PlanarArm
from ilqr_admm_tpu_torch.models.car import CarFrontWheel, CarParkingCost
from ilqr_admm_tpu_torch.ops.riccati import DPGains
from ilqr_admm_tpu_torch.problem import QuadCost
from ilqr_admm_tpu_torch.solvers.mpc import MPCConstrainedState, MPCState


def array_from_numpy(a, *, device, dtype) -> torch.Tensor:
    """A tensor copy of one array of problem data: a penalty rho_x
    (N, x, x), a bound vector (N*x,) or initial states (batch, x)."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def quadcost_from_numpy(Q, xd, R, *, device, dtype) -> QuadCost:
    """QuadCost from stacked Q (N, x, x), xd (N, x) and R (N, u, u)."""
    kw = dict(device=device, dtype=dtype)
    return QuadCost(Q=array_from_numpy(Q, **kw), xd=array_from_numpy(xd, **kw),
                    R=array_from_numpy(R, **kw))


def dynamics_from_numpy(A, B, *, device, dtype):
    """(A (N, x, x), B (N, x, u)) tensors from the stacked dynamics."""
    kw = dict(device=device, dtype=dtype)
    return array_from_numpy(A, **kw), array_from_numpy(B, **kw)


def dpgains_from_numpy(K, k, Quu, Quu_inv, Qux, *, device, dtype) -> DPGains:
    """DPGains from stacked K (N, u, x), k (N, u), Quu and Quu_inv (N, u, u)
    and Qux (N, u, x), e.g. the fields of the JAX package's `DPGains`."""
    kw = dict(device=device, dtype=dtype)
    return DPGains(*(array_from_numpy(a, **kw) for a in (K, k, Quu, Quu_inv, Qux)))


def car_from_numpy(dt, dist=None) -> CarFrontWheel:
    """CarFrontWheel with the JAX plant's dt and dist (default 2.0)."""
    return CarFrontWheel(dt=float(dt)) if dist is None else CarFrontWheel(float(dt), float(dist))


def arm_from_numpy(lengths, dt) -> PlanarArm:
    """PlanarArm with the JAX plant's link lengths (its `lengths`) and dt."""
    return PlanarArm(tuple(float(v) for v in np.asarray(lengths).reshape(-1)), dt=float(dt))


def car_parking_cost_from_numpy(cu, cf, pf, cx, px, *, device, dtype) -> CarParkingCost:
    """CarParkingCost from the weights of a JAX `CarParkingCost` (its
    cu, cf, pf, cx and px attributes, or the sequences it was built from)."""
    kw = dict(device=device, dtype=dtype)
    return CarParkingCost(*(array_from_numpy(w, **kw) for w in (cu, cf, pf, cx, px)), **kw)


def admm_warm_from_numpy(z_x, z_u, lmb_x, lmb_u, *, device, dtype):
    """The `warm` tuple of `ilqr_admm` from a JAX `ILQRADMMResult`'s
    flattened z_x (N*x,), z_u (N*u,), lmb_x and lmb_u."""
    kw = dict(device=device, dtype=dtype)
    return tuple(array_from_numpy(a, **kw) for a in (z_x, z_u, lmb_x, lmb_u))


def mpc_state_from_numpy(x_nom, u_nom, *, device, dtype) -> MPCState:
    """The port's MPCState from a JAX `MPCState`'s x_nom (N, x) and u_nom
    (N, u) (with a leading fleet axis for a fleet's state), e.g. to start
    both packages from the same warm start partway through a run."""
    kw = dict(device=device, dtype=dtype)
    return MPCState(x_nom=array_from_numpy(x_nom, **kw), u_nom=array_from_numpy(u_nom, **kw))


def mpc_constrained_state_from_numpy(x_nom, u_nom, z_x, z_u, lmb_x, lmb_u, *, device,
                                     dtype) -> MPCConstrainedState:
    """The port's MPCConstrainedState from the fields of a JAX
    `MPCConstrainedState`: x_nom (N, x), u_nom (N, u) and the flattened
    z_x, z_u, lmb_x, lmb_u (N*dim,)."""
    kw = dict(device=device, dtype=dtype)
    return MPCConstrainedState(*(array_from_numpy(a, **kw)
                                 for a in (x_nom, u_nom, z_x, z_u, lmb_x, lmb_u)))


def facade_from_numpy(cls, x_dim: int, u_dim: int, N: int, *, A=None, B=None, viapoint=None,
                      device, dtype):
    """A port facade (`facade.SLS` or `facade.iSLS`) holding a JAX facade's
    state: its dynamics A, B (2-D or stacked, e.g. `np.asarray(sls.A)`)
    and its via-point cost viapoint = (zs, Qs, seq, u_std), the arguments
    of `set_quadratic_cost`. The tensors are made with `dtype` on
    `device`; `dtype` is the default dtype while they are made."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        obj = cls(x_dim, u_dim, N, device=device)
        if A is not None:
            obj.AB = [np.asarray(A), np.asarray(B)]
        if viapoint is not None:
            zs, Qs, seq, u_std = viapoint
            obj.set_quadratic_cost(np.asarray(zs), np.asarray(Qs), np.asarray(seq), float(u_std))
    finally:
        torch.set_default_dtype(prev)
    return obj


def nominal_from_numpy(x_nom, u_nom, *, device, dtype):
    """(x_nom (N, x), u_nom (N, u)) tensors from a JAX facade's
    `nominal_values`, for the port facade's `nominal_values` setter."""
    kw = dict(device=device, dtype=dtype)
    return array_from_numpy(x_nom, **kw), array_from_numpy(u_nom, **kw)


def implicit_theta_from_numpy(theta: dict, *, device, dtype, requires_grad=()) -> dict:
    """The `theta` dict of `solvers/implicit.py::lqt_admm_implicit` from
    numpy arrays or floats (Q, R, xd, x0, and px / pu when present); the
    keys named in requires_grad become leaves that require grad."""
    out = {}
    for key, value in theta.items():
        t = array_from_numpy(value, device=device, dtype=dtype)
        out[key] = t.requires_grad_() if key in requires_grad else t
    return out
