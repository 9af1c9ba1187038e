"""ilqr_admm_tpu_torch: the PyTorch and CUDA port of `ilqr_admm_tpu`.

Module paths mirror the JAX package, so `ilqr_admm_tpu/ops/lifted.py`
has its counterpart in `ilqr_admm_tpu_torch/ops/lifted.py`; the
exceptions are the kernel modules `ops/pallas_admm.py` and
`ops/pallas_sls.py`, whose counterparts are `ops/fused_admm.py` and
`ops/fused_sls.py`. The JAX package stays as the reference; this package
imports torch, numpy and scipy and never jax.

Ported so far:

- slice 1, the box-constrained LQT-ADMM fleet: `make_fused_lqt_admm`,
  whose ADMM loop is the CUDA kernel `csrc/admm_u_only.cu`;
- slice 2, the robust SLS-ADMM scenario fleet: `make_fused_sls_admm`
  (`ops/fused_sls.py`, the counterpart of `ops/pallas_sls.py`), whose
  ADMM loop is the CUDA kernel `csrc/sls_admm.cu`, and its plain torch
  twin `make_batched_sls_admm` with the SOC, weighted-l1 and consensus
  projections and the SLS synthesis `lqt_solve_sls`;
- slice 3, the state-and-control-box LQT-ADMM fleet: `make_fused_lqt_admm`
  with `x_lower`/`x_upper`, whose ADMM loop is the CUDA kernel
  `csrc/admm_box.cu`, and the plain torch fleet `make_batched_lqt_admm`
  (`solvers/batched.py`) in its fixed-count, early-stop and Anderson
  modes.

The kernels are built with nvcc at first use on a CUDA tensor. Importing
the package builds and loads nothing.
"""

from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.ops.fused_admm import make_fused_lqt_admm
from ilqr_admm_tpu_torch.ops.fused_sls import make_fused_sls_admm
from ilqr_admm_tpu_torch.problem import QuadCost
from ilqr_admm_tpu_torch.solvers.batched import make_batched_lqt_admm
from ilqr_admm_tpu_torch.solvers.batched_sls import make_batched_sls_admm
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost

__all__ = [
    "DoubleIntegrator",
    "QuadCost",
    "make_batched_lqt_admm",
    "make_batched_sls_admm",
    "make_fused_lqt_admm",
    "make_fused_sls_admm",
    "viapoint_cost",
]
