"""ilqr_admm_tpu_torch: the PyTorch and CUDA port of `ilqr_admm_tpu`.

Module paths mirror the JAX package, so `ilqr_admm_tpu/ops/lifted.py`
has its counterpart in `ilqr_admm_tpu_torch/ops/lifted.py`; the
exceptions are the kernel modules `ops/pallas_admm.py`,
`ops/pallas_sls.py`, `ops/pallas_riccati.py` and `ops/pallas_rollout.py`,
whose counterparts are `ops/fused_admm.py`, `ops/fused_sls.py`,
`ops/fused_riccati.py` and `ops/fused_rollout.py`.
The JAX package stays as the reference; this package imports torch,
numpy and scipy and never jax.

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
  modes;
- slice 4, the LQT Riccati core: the sequential and time-parallel
  Riccati passes (`ops/riccati.py`, `ops/parallel_riccati.py`), the
  rollouts, the LQT solvers (`lqt_solve_dp` and the rest of
  `solvers/lqt.py`), and `lqt_backward_parallel_fused`, whose blocked
  scan is the CUDA kernels of `csrc/riccati_scan.cu`;
- slice 5, the nonlinear constrained solver on the control-limited car:
  `models/car.py`, the ADMM solver `solvers/admm.py`, the square-root
  Riccati pass, iLQR, the constrained LQT and robust SLS ADMM solvers,
  and `ilqr_admm`, whose line-search rollout is the CUDA kernel
  `csrc/linesearch_rollout.cu` behind `make_fused_linesearch_rollout`;
- the 3DoF arm: `models/arm.py` (`PlanarArm`, its URDF loader
  and the asset), the fleet solver `ilqr_admm_fleet`
  (`solvers/batched_ilqr_admm.py`, the counterpart of `jax.vmap` of
  `ilqr_admm`), `chance.py` (joint chance-constraint calibration, also
  behind `sls_admm(joint_alpha=...)`) and robust iLQR `isls_admm`. No
  TPU kernel lies on these paths (the JAX package's rollout and Riccati
  kernels refuse the arm's state dimension, 9), so they run plain torch.

The kernels are built with nvcc at first use on a CUDA tensor. Importing
the package builds and loads nothing. Entry points that take a `device`
run on the CUDA card unless the caller passes another (the CPU runs the
plain torch versions of the kernels).
"""

from ilqr_admm_tpu_torch.models.arm import PlanarArm
from ilqr_admm_tpu_torch.models.car import CarFrontWheel, CarParkingCost
from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.ops.fused_admm import make_fused_lqt_admm
from ilqr_admm_tpu_torch.ops.fused_riccati import lqt_backward_parallel_fused
from ilqr_admm_tpu_torch.ops.fused_rollout import make_fused_linesearch_rollout
from ilqr_admm_tpu_torch.ops.fused_sls import make_fused_sls_admm
from ilqr_admm_tpu_torch.ops.riccati import DPGains
from ilqr_admm_tpu_torch.problem import QuadCost
from ilqr_admm_tpu_torch.solvers.batched import make_batched_lqt_admm
from ilqr_admm_tpu_torch.solvers.batched_ilqr_admm import ilqr_admm_fleet
from ilqr_admm_tpu_torch.solvers.batched_sls import make_batched_sls_admm
from ilqr_admm_tpu_torch.solvers.ilqr_admm import ilqr_admm
from ilqr_admm_tpu_torch.solvers.isls_admm import isls_admm
from ilqr_admm_tpu_torch.solvers.lqt import lqt_solve_dp
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost

__all__ = [
    "CarFrontWheel",
    "CarParkingCost",
    "DPGains",
    "DoubleIntegrator",
    "PlanarArm",
    "QuadCost",
    "ilqr_admm",
    "ilqr_admm_fleet",
    "isls_admm",
    "lqt_backward_parallel_fused",
    "lqt_solve_dp",
    "make_batched_lqt_admm",
    "make_batched_sls_admm",
    "make_fused_linesearch_rollout",
    "make_fused_lqt_admm",
    "make_fused_sls_admm",
    "viapoint_cost",
]
