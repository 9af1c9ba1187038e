"""projections of the PyTorch port (see the package docstring)."""

from ilqr_admm_tpu_torch.projections.primitives import (
    project_bound,
    project_soc_unit,
    project_soc_unit_batch,
    project_weighted_l1,
    prox_l1,
)
from ilqr_admm_tpu_torch.projections.sets import project_set_convex

__all__ = [
    "project_bound",
    "project_soc_unit",
    "project_soc_unit_batch",
    "prox_l1",
    "project_weighted_l1",
    "project_set_convex",
]
