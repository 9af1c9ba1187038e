"""The whole of slice 1 on the CPU: the bench problem at N=100, batch 256.

`make_fused_lqt_admm` in f32 on CPU tensors must meet the bench gates
through the port's own certificates (`utils/certify.py`) and agree with
the JAX package's Pallas kernel run in interpret mode. A subprocess in
which jax cannot be imported must import every module of the port.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import torch

from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu.ops.pallas_admm import make_pallas_lqt_admm
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.convert import dynamics_from_numpy, quadcost_from_numpy
from ilqr_admm_tpu_torch.ops.fused_admm import make_fused_lqt_admm
from ilqr_admm_tpu_torch.utils.certify import certify, gate_failures

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
N, BATCH, ITERS, RHO_U, U_MAX = 100, 256, 100, 0.1, 5.0


def _bench_problem():
    """bench.py's problem (bench.py:107-120, 150) at batch 256."""
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])]).astype(jnp.float32)
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3]).astype(jnp.float32)
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)
    A, B = A.astype(jnp.float32), B.astype(jnp.float32)
    x0s = np.random.default_rng(0).normal(0.0, 0.1, size=(BATCH, d)).astype(np.float32)
    return A, B, cost, x0s


def test_slice_meets_bench_gates_and_matches_pallas():
    A, B, cost, x0s = _bench_problem()
    kw = dict(u_lower=-U_MAX, u_upper=U_MAX, rho_u=RHO_U, n_iters=ITERS)
    tA, tB = dynamics_from_numpy(np.asarray(A), np.asarray(B), device="cpu", dtype=torch.float32)
    tcost = quadcost_from_numpy(
        np.asarray(cost.Q), np.asarray(cost.xd), np.asarray(cost.R),
        device="cpu", dtype=torch.float32,
    )
    x, u, _, z_u = make_fused_lqt_admm(tA, tB, tcost, batch_tile=64, **kw,
                                       device="cpu")(torch.tensor(x0s))
    assert x.shape == (BATCH, 2 * N) and u.shape == (BATCH, N) and z_u.shape == (BATCH, N)
    assert all(bool(torch.isfinite(t).all()) for t in (x, u, z_u))

    cert = certify(tA, tB, tcost, torch.tensor(x0s), u, z_u, -U_MAX, U_MAX)
    assert gate_failures(cert) == [], cert
    assert cert["max_violation"] == 0.0
    assert cert["converged_frac"] >= 0.99

    # The Pallas kernel's main loop rounds its products through bf16x3
    # (~2^-16 relative), which holds its iterate up to ~7e-4 from the
    # exact-f32 one (pallas_admm.py:76-79); 2e-3 leaves room for that.
    x_p, u_p, _, zu_p = make_pallas_lqt_admm(A, B, cost, batch_tile=BATCH, interpret=True, **kw)(
        jnp.asarray(x0s)
    )
    jax.block_until_ready(u_p)
    for got, want in ((x, x_p), (u, u_p), (z_u, zu_p)):
        assert np.abs(got.numpy() - np.asarray(want)).max() < 2e-3


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke.py, import with jax absent."""
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        sys.modules["jax"] = None  # any `import jax` now raises ImportError
        import ilqr_admm_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            ilqr_admm_tpu_torch.__path__, "ilqr_admm_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        for name in ("ops.riccati", "ops.parallel_riccati", "ops.scan", "ops.fused_riccati",
                     "ops.rollout", "solvers.lqt", "utils.device", "models.car",
                     "ops.fused_rollout", "ops.sqrt_riccati", "solvers.admm", "solvers.ilqr",
                     "solvers.ilqr_admm", "solvers.lqt_admm", "solvers.sls_admm",
                     "models.arm", "chance", "solvers.isls_admm", "solvers.batched_ilqr_admm"):
            assert "ilqr_admm_tpu_torch." + name in names, name
        import chip_smoke
        leaked = sorted(m for m in sys.modules if m == "ilqr_admm_tpu" or m.startswith("ilqr_admm_tpu."))
        assert not leaked, leaked
        print(len(names))
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 28
