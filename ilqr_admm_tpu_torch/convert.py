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
