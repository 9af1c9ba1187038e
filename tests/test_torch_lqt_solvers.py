"""Port vs JAX package: the LQT solvers of `solvers/lqt.py` in float64.

A via-point problem on the 2-D double integrator and a random dense
lifted cost, made with numpy from a seed, go through both packages; the
results must agree to 1e-9 relative. The batch, DP and SLS solvers must
also agree with each other in cost.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.problem import QuadCost as JQuadCost
from ilqr_admm_tpu.solvers import lqt as jl
from ilqr_admm_tpu_torch.convert import dynamics_from_numpy, quadcost_from_numpy
from ilqr_admm_tpu_torch.ops.rollout import rollout_closed_loop, rollout_sls
from ilqr_admm_tpu_torch.solvers import lqt as tl
from ilqr_admm_tpu_torch.utils.cost_assembly import get_double_integrator_AB

torch.set_num_threads(2)

N, D, M = 24, 4, 2
TOL = 1e-9
F64 = torch.float64


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _problem(seed=0):
    """Two via-points on the 2-D double integrator, numpy f64."""
    A2, B2 = (t.numpy() for t in get_double_integrator_AB(2, 2, dt=0.1))
    rng = np.random.default_rng(seed)
    A = np.broadcast_to(A2, (N, D, D)).copy()
    B = np.broadcast_to(B2, (N, D, M)).copy()
    Q = np.zeros((N, D, D))
    Q[N // 2] = np.diag([1e2, 1e2, 0.0, 0.0])
    Q[-1] = np.diag([1e3, 1e3, 1e1, 1e1])
    xd = np.zeros((N, D))
    xd[N // 2, :2] = rng.normal(size=2)
    xd[-1, :2] = rng.normal(size=2)
    R = np.tile(np.eye(M) * 1e-2, (N, 1, 1))
    return A, B, Q, xd, R, rng.normal(size=D)


def _both(A, B, Q, xd, R):
    jax_side = (jnp.asarray(A), jnp.asarray(B), JQuadCost(jnp.asarray(Q), jnp.asarray(xd),
                                                           jnp.asarray(R)))
    kw = dict(device="cpu", dtype=F64)
    port = (*dynamics_from_numpy(A, B, **kw), quadcost_from_numpy(Q, xd, R, **kw))
    return jax_side, port


def _cost(Q, xd, R, xs, us):
    dx = xs - xd
    return float(np.einsum("ti,tij,tj->", dx, Q, dx) + np.einsum("ti,tij,tj->", us, R, us))


@pytest.mark.parametrize("use_qr", [False, True])
def test_lqt_solve_batch_matches_jax(use_qr):
    A, B, Q, xd, R, x0 = _problem()
    (jA, jB, jcost), (tA, tB, tcost) = _both(A, B, Q, xd, R)
    want = jl.lqt_solve_batch(jA, jB, jcost, jnp.asarray(x0), use_qr=use_qr)
    got = tl.lqt_solve_batch(tA, tB, tcost, torch.tensor(x0), use_qr=use_qr)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel(g.numpy(), w) < TOL


@pytest.mark.parametrize(
    "time_parallel,fast_inverse",
    [(None, False), ("flat", False), ("flat", True), (5, False), (8, True), (2, False)],
)
def test_lqt_solve_dp_matches_jax(time_parallel, fast_inverse):
    """Every form against the JAX package's sequential DP (the flat JAX
    program is not compiled here: see tests/test_torch_parallel_riccati.py)."""
    A, B, Q, xd, R, _ = _problem(1)
    (jA, jB, jcost), (tA, tB, tcost) = _both(A, B, Q, xd, R)
    rng = np.random.default_rng(2)
    Qr, xr = np.tile(np.eye(D) * 0.3, (N, 1, 1)), rng.normal(size=(N, D))
    Rr, ur = np.tile(np.eye(M) * 0.1, (N, 1, 1)), rng.normal(size=(N, M))
    want = jl.lqt_solve_dp(jA, jB, jcost, *map(jnp.asarray, (Qr, xr, Rr, ur)))
    got = tl.lqt_solve_dp(tA, tB, tcost, *map(torch.tensor, (Qr, xr, Rr, ur)),
                          time_parallel=time_parallel, fast_inverse=fast_inverse)
    for name, g, w in zip(got._fields, got, want):
        assert _rel(g.numpy(), w) < TOL, name


@pytest.mark.parametrize("bad", [True, False, 1, 0, -3, "blocked", 2.5])
def test_lqt_solve_dp_rejects_bad_time_parallel(bad):
    A, B, Q, xd, R, _ = _problem()
    _, (tA, tB, tcost) = _both(A, B, Q, xd, R)
    with pytest.raises(ValueError, match="time_parallel"):
        tl.lqt_solve_dp(tA, tB, tcost, time_parallel=bad)


def test_batch_dp_and_sls_agree_in_cost():
    A, B, Q, xd, R, x0 = _problem(3)
    _, (tA, tB, tcost) = _both(A, B, Q, xd, R)
    x0t = torch.tensor(x0)
    xs_b, us_b = tl.lqt_solve_batch(tA, tB, tcost, x0t)
    g = tl.lqt_solve_dp(tA, tB, tcost, time_parallel="flat")

    def plant(x, u, t=iter(range(N))):
        i = next(t)
        return tA[i] @ x + tB[i] @ u

    xs_d, us_d = rollout_closed_loop(plant, x0t, g.K, g.k)
    PHI_U, du = tl.lqt_solve_sls(tA, tB, tcost)
    K, k = tl.sls_controller(tA, tB, PHI_U, du)

    def plant2(x, u, t=iter(range(N))):
        i = next(t)
        return tA[i] @ x + tB[i] @ u

    xs_s, us_s = rollout_sls(plant2, x0t, K, k, D, M)
    costs = [_cost(Q, xd, R, xs.numpy(), us.numpy())
             for xs, us in ((xs_b, us_b), (xs_d, us_d), (xs_s, us_s))]
    assert max(costs) - min(costs) < 1e-8 * max(1.0, abs(costs[0]))
    assert torch.allclose(us_d, us_b, atol=1e-8) and torch.allclose(us_s, us_b, atol=1e-8)


def test_sls_controller_and_replanning_match_jax():
    A, B, Q, xd, R, _ = _problem(4)
    (jA, jB, jcost), (tA, tB, tcost) = _both(A, B, Q, xd, R)
    PHI_j, du_j = jl.lqt_solve_sls(jA, jB, jcost)
    PHI_t, du_t = tl.lqt_solve_sls(tA, tB, tcost)
    K_j, k_j = jl.sls_controller(jA, jB, PHI_j, du_j)
    K_t, k_t = tl.sls_controller(tA, tB, PHI_t, du_t)
    assert _rel(K_t.numpy(), K_j) < TOL and _rel(k_t.numpy(), k_j) < TOL
    M_j = jl.replanning_matrix(jA, jB, jcost, K_j)
    M_t = tl.replanning_matrix(tA, tB, tcost, K_t)
    assert _rel(M_t.numpy(), M_j) < TOL
    xd_new = xd.reshape(-1) + 0.1
    k_new_j = jl.replan_feedforward(k_j, M_j, jnp.asarray(xd_new), jnp.asarray(xd.reshape(-1)))
    k_new_t = tl.replan_feedforward(k_t, M_t, torch.tensor(xd_new), torch.tensor(xd.reshape(-1)))
    assert _rel(k_new_t.numpy(), k_new_j) < TOL
    # replanning reproduces the feedforward of a re-synthesis at the new target
    _, (tA2, tB2, tcost2) = _both(A, B, Q, xd_new.reshape(N, D), R)
    _, k_re = tl.sls_controller(tA2, tB2, *tl.lqt_solve_sls(tA2, tB2, tcost2))
    assert _rel(k_new_t.numpy(), k_re.numpy()) < 1e-8


def test_full_lifted_cost_solvers_match_jax_and_the_per_step_ones():
    A, B, Q, xd, R, x0 = _problem(5)
    (jA, jB, _), (tA, tB, tcost) = _both(A, B, Q, xd, R)
    rng = np.random.default_rng(6)
    G = rng.normal(size=(N * D, N * D)) * 0.1
    Q_full = G @ G.T + np.kron(np.eye(N), np.eye(D))  # correlates steps
    R_full = np.kron(np.eye(N), np.eye(M)) * 0.05
    xd_full = rng.normal(size=N * D)
    want = jl.lqt_solve_batch_full(jA, jB, *map(jnp.asarray, (Q_full, xd_full, R_full, x0)))
    got = tl.lqt_solve_batch_full(tA, tB, *map(torch.tensor, (Q_full, xd_full, R_full, x0)))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < TOL
    want = jl.lqt_solve_sls_full(jA, jB, *map(jnp.asarray, (Q_full, xd_full, R_full)))
    got = tl.lqt_solve_sls_full(tA, tB, *map(torch.tensor, (Q_full, xd_full, R_full)))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < TOL
    # block-diagonal lifted costs are the per-step problem
    blk = [tl.block_diag_stacked(torch.tensor(a)) for a in (Q, R)]
    xs_f, us_f = tl.lqt_solve_batch_full(tA, tB, blk[0], torch.tensor(xd.reshape(-1)), blk[1],
                                         torch.tensor(x0))
    xs, us = tl.lqt_solve_batch(tA, tB, tcost, torch.tensor(x0))
    assert torch.allclose(us_f, us, atol=1e-9) and torch.allclose(xs_f, xs, atol=1e-9)


def test_sqrt_psd_and_blockdiag_matmul_match_jax():
    rng = np.random.default_rng(7)
    G = rng.normal(size=(5, 3, 3))
    P = np.einsum("tij,tkj->tik", G, G)
    S = tl.sqrt_psd_stacked(torch.tensor(P))
    assert _rel(S.numpy(), jl.sqrt_psd_stacked(jnp.asarray(P))) < TOL
    assert torch.allclose(S @ S, torch.tensor(P), atol=1e-10)
    for Mx in (rng.normal(size=15), rng.normal(size=(15, 4))):
        got = tl.blockdiag_matmul(torch.tensor(P), torch.tensor(Mx))
        assert _rel(got.numpy(), jl.blockdiag_matmul(jnp.asarray(P), jnp.asarray(Mx))) < 1e-12
