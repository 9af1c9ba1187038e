"""Fleets of instances (counterpart of `ilqr_admm_tpu/parallel/`): the
batched front ends of `batch.py`. The mesh-sharded solves are not ported
yet."""

from ilqr_admm_tpu_torch.parallel.batch import (
    batched_al_solve,
    batched_boxddp_solve,
    batched_ilqr_solve,
    batched_lqt_admm_dp,
)

__all__ = ["batched_al_solve", "batched_boxddp_solve", "batched_ilqr_solve",
           "batched_lqt_admm_dp"]
