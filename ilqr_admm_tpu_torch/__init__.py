"""ilqr_admm_tpu_torch: the PyTorch and CUDA port of `ilqr_admm_tpu`.

Module paths mirror the JAX package, so `ilqr_admm_tpu/ops/lifted.py`
has its counterpart in `ilqr_admm_tpu_torch/ops/lifted.py`; the one
exception is the kernel module `ops/pallas_admm.py`, whose counterpart
is `ops/fused_admm.py`. The JAX package stays as the reference; this
package imports torch, numpy and scipy and never jax.

Ported so far (slice 1): the box-constrained LQT-ADMM fleet,
`make_fused_lqt_admm`, whose ADMM loop is a hand-written CUDA kernel
(`csrc/admm_u_only.cu`) built with nvcc at first use on a CUDA tensor.
Importing the package builds and loads nothing.
"""

from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.ops.fused_admm import make_fused_lqt_admm
from ilqr_admm_tpu_torch.problem import QuadCost
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost

__all__ = ["DoubleIntegrator", "QuadCost", "make_fused_lqt_admm", "viapoint_cost"]
