"""The whole of slice 3 on the CPU: the state-bounded bench fleet.

The bench problem (bench.py:107-120) with a velocity box |v| <= 1.3
(position free), |u| <= 5, rho_x = 10, rho_u = 0.1 and 200 iterations,
at batch 64: `make_fused_lqt_admm` in f32 on CPU tensors must meet the
certificates of `utils/certify.py` and agree with the JAX package's
Pallas kernel run in interpret mode on the same numpy inputs. The port's
f64 oracle `state_box_qp` must find the optimum that a tightly converged
JAX fleet finds.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu.ops.lifted import build_Su, build_Sx
from ilqr_admm_tpu.ops.pallas_admm import make_pallas_lqt_admm
from ilqr_admm_tpu.projections import project_bound
from ilqr_admm_tpu.solvers.batched import make_batched_lqt_admm
from ilqr_admm_tpu.solvers.lqt import block_diag_stacked
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.convert import array_from_numpy, dynamics_from_numpy, quadcost_from_numpy
from ilqr_admm_tpu_torch.ops.fused_admm import make_fused_lqt_admm
from ilqr_admm_tpu_torch.utils import certify
from ilqr_admm_tpu_torch.utils.certify import (
    certify_state_box,
    state_box_gate_failures,
    state_box_qp,
)

torch.set_num_threads(2)

U_MAX, V_MAX, RHO_X, RHO_U = 5.0, 1.3, 10.0, 0.1


def _bench_problem(N, batch, seed=0):
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])]).astype(jnp.float32)
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3]).astype(jnp.float32)
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)
    A, B = A.astype(jnp.float32), B.astype(jnp.float32)
    x0s = np.random.default_rng(seed).normal(0.0, 0.1, size=(batch, d)).astype(np.float32)
    return A, B, cost, x0s


def _port(A, B, cost, dtype=torch.float32):
    tA, tB = dynamics_from_numpy(np.asarray(A), np.asarray(B), device="cpu", dtype=dtype)
    tcost = quadcost_from_numpy(
        np.asarray(cost.Q), np.asarray(cost.xd), np.asarray(cost.R), device="cpu", dtype=dtype
    )
    return tA, tB, tcost


def _velocity_box(N):
    return np.tile([-np.inf, -V_MAX], N), np.tile([np.inf, V_MAX], N)


def test_slice_meets_certificates_and_matches_pallas():
    N, batch = 100, 64
    A, B, cost, x0s = _bench_problem(N, batch)
    x_lower, x_upper = _velocity_box(N)
    kw = dict(u_lower=-U_MAX, u_upper=U_MAX, rho_x=RHO_X, rho_u=RHO_U, n_iters=200)
    tA, tB, tcost = _port(A, B, cost)
    xl_t = array_from_numpy(x_lower, device="cpu", dtype=torch.float32)
    xu_t = array_from_numpy(x_upper, device="cpu", dtype=torch.float32)
    solver = make_fused_lqt_admm(tA, tB, tcost, x_lower=xl_t, x_upper=xu_t, batch_tile=32, **kw,
                                 device="cpu")
    x, u, z_x, z_u = solver(torch.tensor(x0s))
    assert x.shape == z_x.shape == (batch, 2 * N) and u.shape == z_u.shape == (batch, N)
    assert all(bool(torch.isfinite(t).all()) for t in (x, u, z_x, z_u))

    cert = certify_state_box(tA, tB, tcost, torch.tensor(x0s), x, u, z_x, z_u, -U_MAX, U_MAX,
                             x_lower, x_upper, n_oracle=8)
    assert state_box_gate_failures(cert) == [], cert
    assert cert["oracle_failures"] == []
    assert cert["max_violation_x"] == cert["max_violation_u"] == 0.0
    assert cert["converged_frac"] == 1.0
    assert cert["state_violation_max"] < 1e-5

    # The Pallas kernel runs the unfolded iteration with bf16x3 products
    # (~2^-16 relative) on r, which reaches |r| ~ 33 while |u| <= 5: its
    # iterate sits up to ~3e-2 from the folded f32 one, so the JAX
    # package's own Pallas-vs-XLA tolerance of this path applies
    # (tests/test_pallas_admm.py:122-123).
    x_p, u_p, zx_p, zu_p = make_pallas_lqt_admm(
        A, B, cost, x_lower=x_lower, x_upper=x_upper, batch_tile=batch, interpret=True, **kw
    )(jnp.asarray(x0s))
    jax.block_until_ready(u_p)
    for got, want in ((x, x_p), (u, u_p), (z_x, zx_p), (z_u, zu_p)):
        assert np.abs(got.numpy() - np.asarray(want)).max() < 5e-2


def test_state_box_qp_finds_the_fleets_optimum():
    """state_box_qp's optimum against a JAX f64 fleet run to tol 1e-10:
    the same optimal cost within 1e-6 relative, every instance's SLSQP
    run a success, and a feasible fleet iterate. The oracle is handed
    the fleet's optimum as the iterate under test but starts from the
    clipped unconstrained optimum, which violates the velocity box, so
    it must find the optimum itself."""
    N, batch = 50, 4
    A, B, cost, x0s = _bench_problem(N, batch, seed=1)
    A64, B64 = A.astype(jnp.float64), B.astype(jnp.float64)
    x_lower, x_upper = _velocity_box(N)
    fleet = make_batched_lqt_admm(
        A64, B64, cost, project_x=lambda x: jnp.clip(x, x_lower, x_upper),
        project_u=lambda u: project_bound(u, -U_MAX, U_MAX), rho_x=RHO_X, rho_u=RHO_U,
        n_iters=20000, tol=1e-10,
    )
    _, u_star = fleet(jnp.asarray(x0s, jnp.float64))
    u_star = np.asarray(u_star)

    # J(u) of the fleet's optimum, with the JAX package's own operators
    Su = np.asarray(build_Su(A64, B64))
    Sx = np.asarray(build_Sx(A64)).reshape(N * 2, 2)
    Q = np.asarray(block_diag_stacked(cost.Q.astype(jnp.float64)))
    R = np.asarray(block_diag_stacked(cost.R.astype(jnp.float64)))
    xd = np.asarray(cost.lifted_xd(), np.float64)
    x_star = x0s.astype(np.float64) @ Sx.T + u_star @ Su.T
    j_fleet = np.einsum("bi,ij,bj->b", x_star - xd, Q, x_star - xd) + np.einsum(
        "bi,ij,bj->b", u_star, R, u_star)
    assert np.abs(x_star[:, 1::2]).max() <= V_MAX + 1e-7

    orc = state_box_qp(*_port(A, B, cost, torch.float64), torch.tensor(x0s), torch.tensor(u_star),
                       -U_MAX, U_MAX, x_lower, x_upper)
    assert orc["success"].all(), orc["message"]
    free = x0s.astype(np.float64) @ Sx.T
    start = np.clip(np.linalg.solve(Su.T @ Q @ Su + R, Su.T @ Q @ (xd[None] - free).T).T,
                    -U_MAX, U_MAX)
    assert np.abs((free + start @ Su.T)[:, 1::2]).max() > V_MAX + 0.1
    np.testing.assert_allclose(orc["j_star"], j_fleet, rtol=1e-6)
    np.testing.assert_allclose(orc["j_z"], j_fleet, rtol=1e-12)
    assert orc["state_violation"].max() < 1e-7


def test_an_oracle_that_stops_early_fails_the_gates(monkeypatch):
    """SLSQP cut at 2 iterations does not succeed; certify_state_box
    lists those instances, and the gates fail on them whatever the gap."""
    N, batch = 30, 8
    A, B, cost, x0s = _bench_problem(N, batch, seed=2)
    x_lower, x_upper = _velocity_box(N)
    tA, tB, tcost = _port(A, B, cost)
    solver = make_fused_lqt_admm(tA, tB, tcost, u_lower=-U_MAX, u_upper=U_MAX, x_lower=x_lower,
                                 x_upper=x_upper, rho_x=RHO_X, rho_u=RHO_U, n_iters=200,
                                 batch_tile=8, device="cpu")
    x, u, z_x, z_u = solver(torch.tensor(x0s))
    args = (tA, tB, tcost, torch.tensor(x0s), x, u, z_x, z_u, -U_MAX, U_MAX, x_lower, x_upper)
    assert certify_state_box(*args, n_oracle=2)["oracle_failures"] == []
    monkeypatch.setattr(certify, "state_box_qp",
                        functools.partial(certify.state_box_qp, maxiter=2))
    cert = certify_state_box(*args, n_oracle=2)
    assert len(cert["oracle_failures"]) == 2
    assert "Iteration limit" in cert["oracle_failures"][0]
    failures = state_box_gate_failures(cert)
    assert sum(f.startswith("oracle failed on instance") for f in failures) == 2
