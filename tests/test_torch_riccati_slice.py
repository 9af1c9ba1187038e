"""The whole Riccati slice on the CPU at full width: the problem of
`benchmarks/bench_parallel_riccati.py:36-44` at N = 10,000, nb = 128.

`lqt_backward_parallel_fused(..., device="cpu")` (the plain versions of
the kernels, f32) and then `rollout_closed_loop_parallel` from x0 must
pass the gates of `utils/certify.py::certify_riccati` against the f64
sequential oracle: K within 5e-5 relative, k within atol = rtol = 2e-4,
Quu within 1e-4 (`tests/test_pallas_riccati.py:46-52`), and the
closed-loop tracking cost within 1e-4 of the oracle's. The JAX package's
XLA blocked path on the same f32 data passes the same gates, and the two
agree.
"""

import numpy as np
import jax.numpy as jnp
import torch

from ilqr_admm_tpu.ops.parallel_riccati import lqt_backward_parallel
from ilqr_admm_tpu.utils.cost_assembly import get_double_integrator_AB
from ilqr_admm_tpu_torch.ops.fused_riccati import lqt_backward_parallel_fused
from ilqr_admm_tpu_torch.ops.riccati import DPGains
from ilqr_admm_tpu_torch.utils.certify import certify_riccati, riccati_gate_failures

torch.set_num_threads(2)

N, NB, D, M = 10_000, 128, 4, 2


def _bench_problem():
    """bench_parallel_riccati.py's problem at N = 10,000, as f32 numpy."""
    A2, B2 = get_double_integrator_AB(2, 2, dt=0.01)
    A = np.broadcast_to(np.asarray(A2), (N, D, D)).astype(np.float32)
    B = np.broadcast_to(np.asarray(B2), (N, D, M)).astype(np.float32)
    Q = np.broadcast_to(np.eye(D) * 1e2, (N, D, D)).astype(np.float32)
    xd = np.zeros((N, D), np.float32)
    xd[-1, 0] = 1.0
    R = np.broadcast_to(np.eye(M) * 1e-2, (N, M, M)).astype(np.float32)
    x0 = np.random.default_rng(0).normal(0.0, 0.1, size=D)
    return (A, B, Q, xd, R), x0


def test_riccati_slice_meets_the_gates_at_full_width():
    data, x0 = _bench_problem()
    tdata = [torch.tensor(a) for a in data]
    gains = lqt_backward_parallel_fused(*tdata, nb=NB, device="cpu")
    assert gains.K.shape == (N, M, D) and gains.K.dtype == torch.float32
    cert = certify_riccati(*tdata, gains, x0)
    assert riccati_gate_failures(cert) == [], cert

    L = -(-N // NB)
    xla = lqt_backward_parallel(*map(jnp.asarray, data), block_size=L, fast_inverse=True)
    xla_t = DPGains(*(torch.tensor(np.asarray(x)) for x in xla))
    cert_xla = certify_riccati(*tdata, xla_t, x0)
    assert riccati_gate_failures(cert_xla) == [], cert_xla
    assert float((gains.K - xla_t.K).abs().max() / xla_t.K.abs().max()) < 5e-5
    np.testing.assert_allclose(gains.k.numpy(), xla_t.k.numpy(), atol=2e-4, rtol=2e-4)
