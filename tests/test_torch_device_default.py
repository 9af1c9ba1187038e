"""The port's entry points run on the CUDA card unless the caller asks for
the CPU: with no `device` argument each one targets CUDA, and on a box
without a card it raises instead of quietly solving on the CPU.
"""

import numpy as np
import pytest
import torch

from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.ops.fused_admm import make_fused_lqt_admm
from ilqr_admm_tpu_torch.ops.fused_riccati import lqt_backward_parallel_fused
from ilqr_admm_tpu_torch.ops.fused_sls import make_fused_sls_admm
from ilqr_admm_tpu_torch.solvers.batched import make_batched_lqt_admm
from ilqr_admm_tpu_torch.solvers.batched_sls import make_batched_sls_admm
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.utils.device import resolve_device

N = 8


def _problem():
    plant = DoubleIntegrator(1, 2, dt=1.0 / N, dtype=torch.float32)
    zs = np.stack([np.zeros(2), [1.0, 0.0]]).astype(np.float32)
    Qs = np.stack([np.zeros((2, 2)), np.eye(2) * 1e3]).astype(np.float32)
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    A, B = plant.AB(N)
    return A, B, viapoint_cost(zs, Qs, seq, 1e-2, 1, dtype=torch.float32)


ENTRY_POINTS = {
    "make_fused_lqt_admm": lambda A, B, c, **kw: make_fused_lqt_admm(
        A, B, c, u_lower=-5.0, u_upper=5.0, rho_u=0.1, n_iters=4, batch_tile=4, **kw),
    "make_fused_sls_admm": lambda A, B, c, **kw: make_fused_sls_admm(
        A, B, c, (), (), (), rho_u=1.0, n_iters=4, batch_tile=4, z_update="diamond",
        diamond_w=(1.0, 0.2), **kw),
    "make_batched_lqt_admm": lambda A, B, c, **kw: make_batched_lqt_admm(
        A, B, c, project_u=lambda u: u.clamp(-5.0, 5.0), rho_u=0.1, n_iters=4, **kw),
    "make_batched_sls_admm": lambda A, B, c, **kw: make_batched_sls_admm(
        A, B, c, project_u=lambda y, p: y, rho_u=1.0, n_iters=4, **kw),
    "lqt_backward_parallel_fused": lambda A, B, c, **kw: lqt_backward_parallel_fused(
        A, B, c.Q, c.xd, c.R, nb=4, **kw),
}


def _tensors(result):
    if isinstance(result, torch.nn.Module):
        return [b for b in result.buffers()]
    return list(result)


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_no_device_means_the_card(name):
    A, B, cost = _problem()
    build = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert all(t.device.type == "cuda" for t in _tensors(build(A, B, cost)))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(A, B, cost)
    # the CPU only when asked for
    assert all(t.device.type == "cpu" for t in _tensors(build(A, B, cost, device="cpu")))


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    if not torch.cuda.is_available():
        for device in (None, "cuda", "cuda:0"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                resolve_device(device)
