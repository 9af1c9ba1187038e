"""ADMM argument checks (counterpart of part of `ilqr_admm_tpu/solvers/admm.py`).

The generic ADMM solver comes with a later slice; the fused fleet only
needs the constraint-block validation.
"""

from __future__ import annotations

import numpy as np
import torch


def _rho_is_zero(rho) -> bool:
    """All-zero penalty (the reference-style 'off' spelling)."""
    if isinstance(rho, torch.Tensor):
        return bool(torch.all(rho == 0))
    return bool(np.all(np.asarray(rho) == 0))


def validate_constraint_blocks(project_x, rho_x, project_u, rho_u):
    """Each ADMM constraint block needs BOTH its projection and penalty.

    A projection without a (nonzero) rho would be silently ignored by
    the x-update; a nonzero rho without its projection would inject a
    zero-target penalty that biases the solution. rho=0 with no
    projection is the explicit 'off' and is accepted.
    """
    for name, proj, rho in (
        ("x", project_x, rho_x), ("u", project_u, rho_u),
    ):
        if proj is not None and (rho is None or _rho_is_zero(rho)):
            raise ValueError(
                f"project_{name} is set but rho_{name}={rho!r}: the "
                f"projection would be silently ignored by the x-update; "
                f"pass a nonzero rho_{name}"
            )
        if proj is None and rho is not None and not _rho_is_zero(rho):
            raise ValueError(
                f"rho_{name}={rho!r} is set but project_{name} is None: "
                f"this would inject a zero-target penalty that biases "
                f"the solution; pass project_{name} or drop rho_{name}"
            )
