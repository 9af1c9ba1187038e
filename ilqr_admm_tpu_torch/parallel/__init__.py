"""Fleets and the scale-out layer (counterpart of `ilqr_admm_tpu/parallel/`):
the batched front ends of `batch.py`, and on `torch.distributed` the
instance-sharded solves (`batch.py`), the consensus-sharded projection
(`consensus.py`), the time-sharded Riccati (`time_sharded.py`), the
meshes (`mesh.py`) and the multi-process runtime (`distributed.py`)."""

from ilqr_admm_tpu_torch.parallel.batch import (
    batched_al_solve,
    batched_boxddp_solve,
    batched_ilqr_solve,
    batched_lqt_admm_dp,
    mc_success_rate,
    sharded_instance_solve,
)
from ilqr_admm_tpu_torch.parallel.consensus import (
    project_set_convex_sharded,
    project_set_convex_stacked,
)
from ilqr_admm_tpu_torch.parallel.mesh import instance_sharding, make_mesh
from ilqr_admm_tpu_torch.parallel.time_sharded import (
    lqt_backward_time_sharded,
    time_sharded_suffix_scan,
)

__all__ = [
    "project_set_convex_stacked",
    "project_set_convex_sharded",
    "make_mesh",
    "instance_sharding",
    "batched_lqt_admm_dp",
    "batched_ilqr_solve",
    "sharded_instance_solve",
    "mc_success_rate",
    "lqt_backward_time_sharded",
    "time_sharded_suffix_scan",
    "batched_al_solve",
    "batched_boxddp_solve",
]
