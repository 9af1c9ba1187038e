"""solvers of the PyTorch port (see the package docstring)."""

from ilqr_admm_tpu_torch.solvers.batched import make_batched_lqt_admm
from ilqr_admm_tpu_torch.solvers.batched_sls import make_batched_sls_admm
from ilqr_admm_tpu_torch.solvers.lqt import lifted_normal_eqs, lqt_solve_sls

__all__ = ["lifted_normal_eqs", "lqt_solve_sls", "make_batched_lqt_admm", "make_batched_sls_admm"]
