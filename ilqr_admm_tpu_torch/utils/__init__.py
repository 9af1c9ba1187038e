"""utils of the PyTorch port (counterpart of `ilqr_admm_tpu/utils/__init__.py`)."""

from ilqr_admm_tpu_torch.utils.cost_assembly import (
    augment_mut,
    augment_Qt,
    batch_cost_vars,
    construct_Z,
    find_augmented_precs,
    find_mus,
    find_precs,
    get_double_integrator_AB,
    nullspace_matrix,
    nullspace_matrix2,
    run_once,
    selection_matrix,
    viapoint_cost,
)
from ilqr_admm_tpu_torch.utils.trajopt import TrajOpt

__all__ = [
    "TrajOpt",
    "find_mus",
    "find_precs",
    "get_double_integrator_AB",
    "run_once",
    "selection_matrix",
    "construct_Z",
    "nullspace_matrix",
    "nullspace_matrix2",
    "augment_Qt",
    "augment_mut",
    "find_augmented_precs",
    "batch_cost_vars",
    "viapoint_cost",
]
