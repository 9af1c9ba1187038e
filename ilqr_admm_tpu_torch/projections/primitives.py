"""Euclidean projection primitives (counterpart of part of
`ilqr_admm_tpu/projections/primitives.py`).

Only the box projection is ported; it is the z-update of the fused
fleet. The last axis is the vector dimension, leading axes are batch.
"""

from __future__ import annotations

import torch


def project_bound(x: torch.Tensor, l, u) -> torch.Tensor:
    """Box projection: l <= P(x) <= u; a None bound is open."""
    if l is not None:
        x = torch.maximum(x, torch.as_tensor(l, dtype=x.dtype, device=x.device))
    if u is not None:
        x = torch.minimum(x, torch.as_tensor(u, dtype=x.dtype, device=x.device))
    return x
