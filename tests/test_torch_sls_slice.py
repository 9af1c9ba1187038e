"""The whole of slice 2 on the CPU, and its jax-free certificates.

The robust SLS fleet of `benchmarks/bench_pallas_sls.py` at its full
width (N = 100, robust_dim 1, bounds U(2, 4), rho_u = 1.0, 200
iterations, the serving configuration `diamond_ee` on a sorted fleet),
cut to 16 instances, through `make_fused_sls_admm` in f32 on CPU
tensors, must meet the bench's gates through the port's certificates
(`utils/certify.py`), with 2 oracle instances for time's sake. The
certificates themselves are held against `benchmarks/_oracles.py` on the
same iterate.
"""

import os
import sys

import numpy as np
import pytest
import torch
from scipy.stats import norm

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks._oracles import _project_diamond, sls_qp as j_sls_qp  # noqa: E402
from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator  # noqa: E402
from ilqr_admm_tpu_torch.ops.fused_sls import make_fused_sls_admm  # noqa: E402
from ilqr_admm_tpu_torch.utils import certify as cert_mod  # noqa: E402
from ilqr_admm_tpu_torch.utils.certify import (  # noqa: E402
    certify_sls,
    oracle_indices,
    project_diamond,
    sls_gate_failures,
    sls_primal_residuals,
    sls_qp,
)
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost  # noqa: E402

torch.set_num_threads(2)

C_COEF = float(norm.ppf(0.95)) * 0.1


def _problem(N):
    """The bench's problem (bench_pallas_sls.py:56-65) in the port, f32."""
    plant = DoubleIntegrator(1, 2, dt=1.0 / N, dtype=torch.float32)
    zs = np.array([[0.0, 0.0], [1.0, 0.0]], np.float32)
    Qs = np.stack([np.zeros((2, 2)), np.eye(2) * 1e3]).astype(np.float32)
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, 1, dtype=torch.float32)
    A, B = plant.AB(N)
    return A, B, cost


def _solve(N, batch, **overrides):
    A, B, cost = _problem(N)
    kw = dict(rho_u=1.0, robust_dim=1, n_iters=200, batch_tile=8, z_update="diamond",
              diamond_w=(1.0, C_COEF), stop_tol=3e-3, check_every=16)
    kw.update(overrides)
    bounds = np.sort(np.random.default_rng(0).uniform(2.0, 4.0, batch)).astype(np.float32)
    bounds = torch.tensor(bounds)
    du, phi_u, U = make_fused_sls_admm(A, B, cost, (), (), (), **kw, device="cpu")(bounds)
    return (A, B, cost), bounds, du, phi_u, U


def test_slice_meets_sls_bench_gates():
    (A, B, cost), bounds, du, phi_u, U = _solve(100, 16)
    assert U.shape == (16, 100, 2) and phi_u.shape == (16, 100, 200) and du.shape == (16, 100)
    assert all(bool(torch.isfinite(t).all()) for t in (du, phi_u, U))
    cert = certify_sls(A, B, cost, bounds, U, C_COEF, n_oracle=2)
    assert cert["oracle_indices"] == [0, 15]
    assert sls_gate_failures(cert) == [], cert
    assert cert["converged_frac"] == 1.0


def test_certificates_match_benchmark_oracles():
    """project_diamond and sls_qp against benchmarks/_oracles.py on the
    same iterate (N=20, 2 instances): the diamond projections agree to
    1e-12, the oracle costs to 1e-9 relative (scipy's trust-constr runs
    on the same f64 data, built by each package's own Su and Sx)."""
    (A, B, cost), bounds, _, _, U = _solve(20, 8, stop_tol=0.0, n_iters=60, batch_tile=4)
    U64, b64 = U.double().numpy(), bounds.double().numpy()
    mine = project_diamond(U64, C_COEF, b64[:, None])
    for i in range(8):
        np.testing.assert_allclose(mine[i], _project_diamond(U64[i], C_COEF, b64[i]),
                                   rtol=1e-12, atol=1e-12)
    prim = sls_primal_residuals(U, bounds, C_COEF)
    np.testing.assert_allclose(prim, np.linalg.norm((U64 - mine).reshape(8, -1), axis=-1))

    idx = [1, 6]
    got = sls_qp(A, B, cost, bounds[idx], U[idx], C_COEF)
    want = j_sls_qp({
        "A": A.double().numpy(), "B": B.double().numpy(), "Q": cost.Q.double().numpy(),
        "R": cost.R.double().numpy(), "xd": cost.lifted_xd().double().numpy(),
        "bounds": b64[idx], "U": U64[idx], "c": C_COEF,
    })
    np.testing.assert_allclose(got["prim"], want["prim"], rtol=1e-12)
    np.testing.assert_allclose(got["j_z"], want["j_z"], rtol=1e-12)
    np.testing.assert_allclose(got["j_star"], want["j_star"], rtol=1e-9)
    assert np.all(got["j_star"] <= got["j_z"])


def test_gates_catch_a_bad_iterate():
    """An iterate pushed off the diamond fails converged_frac; each gate
    reports its own failure."""
    _, bounds, _, _, U = _solve(20, 8, stop_tol=0.0, n_iters=60, batch_tile=4)
    bad = U.clone()
    bad[:, :, 0] += 0.01 * torch.sign(bad[:, :, 0])
    assert np.all(sls_primal_residuals(bad, bounds, C_COEF) >= cert_mod.SLS_PRIMAL_TOL)
    cert = {"converged_frac": 0.5, "cost_gap_median": 2e-4, "cost_gap_max": 2e-3}
    failures = sls_gate_failures(cert)
    assert len(failures) == 3 and all(k in " ".join(failures) for k in cert)
    assert sls_gate_failures({"converged_frac": 0.99, "cost_gap_median": 1e-4,
                              "cost_gap_max": 1e-3}) == []


@pytest.mark.parametrize("batch,want", [(1024, [0, 146, 292, 438, 584, 730, 876, 1023]),
                                        (16, [0, 15])])
def test_oracle_indices_spread_like_the_bench(batch, want):
    """bench_pallas_sls.py:143: np.linspace over the (sorted) fleet."""
    assert oracle_indices(batch, len(want)).tolist() == want
