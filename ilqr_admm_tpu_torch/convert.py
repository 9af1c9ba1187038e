"""Carry problem data over from the JAX package to the port.

Takes the JAX package's problem data as numpy arrays (`np.asarray` of
the JAX arrays) and builds the port's objects from copies, so the two
packages can be fed the same problem. Imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ilqr_admm_tpu_torch.problem import QuadCost


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def quadcost_from_numpy(Q, xd, R, *, device, dtype) -> QuadCost:
    """QuadCost from stacked Q (N, x, x), xd (N, x) and R (N, u, u)."""
    return QuadCost(
        Q=_tensor(Q, device, dtype), xd=_tensor(xd, device, dtype), R=_tensor(R, device, dtype)
    )


def dynamics_from_numpy(A, B, *, device, dtype):
    """(A (N, x, x), B (N, x, u)) tensors from the stacked dynamics."""
    return _tensor(A, device, dtype), _tensor(B, device, dtype)
