"""Port vs JAX package: the SLS synthesis and the plain robust SLS fleet.

`ops/sls_synthesis.py`, `solvers/lqt.py::lifted_normal_eqs` and
`lqt_solve_sls` get the same seeded float64 problems through both
packages and agree to 1e-10 relative (the two factor and solve the same
systems, in another order of sums). `solvers/batched_sls.py` runs the
same fleet through both packages in float64, in its fixed-count and its
per-instance early-stop (`tol > 0`) modes.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.stats import norm

from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu.ops import sls_synthesis as js
from ilqr_admm_tpu.projections import project_set_convex as j_project_set_convex
from ilqr_admm_tpu.projections import project_soc_unit as j_project_soc_unit
from ilqr_admm_tpu.projections import project_weighted_l1 as j_project_weighted_l1
from ilqr_admm_tpu.solvers import lqt as jlqt
from ilqr_admm_tpu.solvers.batched_sls import make_batched_sls_admm as j_make_batched_sls_admm
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.convert import dynamics_from_numpy, quadcost_from_numpy
from ilqr_admm_tpu_torch.ops import sls_synthesis as ts
from ilqr_admm_tpu_torch.projections.primitives import project_soc_unit, project_weighted_l1
from ilqr_admm_tpu_torch.projections.sets import project_set_convex
from ilqr_admm_tpu_torch.solvers import lqt as tlqt
from ilqr_admm_tpu_torch.solvers.batched_sls import make_batched_sls_admm

torch.set_num_threads(2)

F64 = torch.float64
TOL = 1e-10
PSI = float(norm.ppf(0.95))
C_COEF = PSI * 0.1


def close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1.0))


def _problem(N=20):
    """The double-integrator via-point problem of the SLS benches, in f64."""
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)
    return A.astype(jnp.float64), B.astype(jnp.float64), cost


def _port(A, B, cost, dtype=F64):
    tA, tB = dynamics_from_numpy(np.asarray(A), np.asarray(B), device="cpu", dtype=dtype)
    tcost = quadcost_from_numpy(
        np.asarray(cost.Q), np.asarray(cost.xd), np.asarray(cost.R), device="cpu", dtype=dtype
    )
    return tA, tB, tcost


def _spd(M, seed=0):
    G = np.random.default_rng(seed).normal(size=(M, M))
    return G @ G.T + M * np.eye(M)


def test_causal_trailing_solve_matches_jax_and_direct_solves():
    M, c = 24, 3
    l_side = _spd(M)
    rhs = np.random.default_rng(1).normal(size=(5, M, c))
    starts = np.array([0, 3, 7, 12, 23])
    Lr = ts.causal_cholesky_factors(torch.tensor(l_side))
    close(Lr, js.causal_cholesky_factors(jnp.asarray(l_side)))
    got = ts.causal_trailing_solve(Lr, torch.tensor(rhs), torch.tensor(starts))
    want = js.causal_trailing_solve(jnp.asarray(Lr.numpy()), jnp.asarray(rhs), jnp.asarray(starts))
    close(got, want)
    for i, s in enumerate(starts):  # each block solves its trailing system
        ref = np.linalg.solve(l_side[s:, s:], rhs[i, s:])
        close(got[i, s:], ref, 1e-9)
        assert not got[i, :s].any()


def test_sls_synthesize_matches_jax():
    N, u_dim, x_dim = 8, 2, 3
    M = N * u_dim
    rng = np.random.default_rng(2)
    l_side, r_ff, r_fb = _spd(M, 3), rng.normal(size=M), rng.normal(size=(M, N * x_dim))
    phi, du = ts.sls_synthesize(torch.tensor(l_side), torch.tensor(r_ff), torch.tensor(r_fb),
                                u_dim, x_dim)
    phi_j, du_j = js.sls_synthesize(jnp.asarray(l_side), jnp.asarray(r_ff), jnp.asarray(r_fb),
                                    u_dim, x_dim)
    close(phi, phi_j)
    close(du, du_j)


@pytest.mark.parametrize("with_regularizers", [False, True], ids=["plain", "Qr-Rr"])
def test_lifted_normal_eqs_matches_jax(with_regularizers):
    A, B, cost = _problem(12)
    tA, tB, tcost = _port(A, B, cost)
    kw_j, kw_t = {}, {}
    if with_regularizers:
        Qr = np.random.default_rng(4).uniform(0.1, 1.0, (12, 2, 2))
        Qr = Qr @ np.swapaxes(Qr, 1, 2)
        kw_j = dict(Qr=jnp.asarray(Qr), Rr=jlqt.broadcast_rho(0.5, 1, 12))
        kw_t = dict(Qr=torch.tensor(Qr), Rr=tlqt.broadcast_rho(0.5, 1, 12, F64))
    got = tlqt.lifted_normal_eqs(tA, tB, tcost, **kw_t)
    want = jlqt.lifted_normal_eqs(A, B, cost, **kw_j)
    for key in ("Su", "Sw", "SuTQ", "l_side", "SuTQr", "Rr"):
        if want[key] is None:
            assert got[key] is None, key
        else:
            close(got[key], want[key])


def test_lqt_solve_sls_matches_jax():
    """N=100, the width of the SLS benches."""
    A, B, cost = _problem(100)
    phi, du = tlqt.lqt_solve_sls(*_port(A, B, cost))
    phi_j, du_j = jlqt.lqt_solve_sls(A, B, cost)
    assert phi.shape == (100, 200) and du.shape == (100,)
    close(phi, phi_j)
    close(du, du_j)


def _weighted_l1_pair():
    w = np.array([1.0, C_COEF])

    def j_proj(y, bounds):
        return j_project_weighted_l1(y, jnp.asarray(w), bounds[:, None])

    def t_proj(y, bounds):
        return project_weighted_l1(y, torch.tensor(w), bounds[:, None])

    return j_proj, t_proj


@pytest.mark.parametrize("tol", [0.0, 1e-8], ids=["fixed-count", "early-stop"])
def test_batched_sls_weighted_l1_matches_jax(tol):
    """The fleet with the exact diamond projection, both modes, f64. The
    early-stop fleet freezes each instance at tol; the frozen iterates
    match (tests/test_batched_sls.py:68-104 at N=20)."""
    A, B, cost = _problem(20)
    j_proj, t_proj = _weighted_l1_pair()
    kw = dict(rho_u=1.0, robust_dim=1, n_iters=300, tol=tol)
    bounds = np.random.default_rng(0).uniform(1.5, 3.0, 6)
    du_j, phi_j, U_j = j_make_batched_sls_admm(A, B, cost, project_u=j_proj, **kw)(
        jnp.asarray(bounds))
    du, phi, U = make_batched_sls_admm(*_port(A, B, cost), project_u=t_proj, **kw, device="cpu")(
        torch.tensor(bounds))
    assert U.dtype == F64 and phi.shape == (6, 20, 40)
    close(U, U_j, 1e-9)
    close(du, du_j, 1e-9)
    close(phi, phi_j, 1e-9)


def test_batched_sls_early_stop_matches_fixed_count():
    """tol > 0 lands on the fixed-count fixed point (the JAX test's claim)."""
    A, B, cost = _problem(20)
    _, t_proj = _weighted_l1_pair()
    tA, tB, tcost = _port(A, B, cost)
    kw = dict(project_u=t_proj, rho_u=1.0, robust_dim=1, n_iters=800)
    bounds = torch.tensor(np.random.default_rng(1).uniform(1.5, 3.0, 5))
    _, _, U_f = make_batched_sls_admm(tA, tB, tcost, **kw, device="cpu")(bounds)
    _, _, U_s = make_batched_sls_admm(tA, tB, tcost, tol=1e-8, **kw, device="cpu")(bounds)
    np.testing.assert_allclose(U_s.numpy(), U_f.numpy(), atol=1e-6)


def test_batched_sls_consensus_matches_jax():
    """The fleet of bench_sls_fleet.py with its consensus-SOC projection
    (30 inner iterations, stall exit on, per instance as under vmap)."""
    A, B, cost = _problem(20)
    mu = np.array([1.0, 0.0])
    Au = np.diag(np.sqrt([0.0, 0.01]))
    As = [np.concatenate([Au, (-mu / PSI)[None]], 0), np.concatenate([Au, (mu / PSI)[None]], 0)]

    def j_soc(y, bound):
        b = jnp.concatenate([jnp.zeros(2), (bound / PSI)[None]])
        return j_project_set_convex(y, [jnp.asarray(a) for a in As], [b, b],
                                    [j_project_soc_unit] * 2, rho=10.0, max_iter=30,
                                    threshold=0.0)

    def t_soc(y, bounds):
        b = torch.zeros(y.shape[0], 1, 3, dtype=y.dtype)
        b[:, 0, 2] = bounds / PSI
        return project_set_convex(y, [torch.tensor(a) for a in As], [b, b],
                                  [project_soc_unit] * 2, rho=10.0, max_iter=30, threshold=0.0,
                                  batch_dims=1)

    kw = dict(rho_u=1.0, robust_dim=1, n_iters=40)
    bounds = np.random.default_rng(2).uniform(2.0, 4.0, 4)
    _, _, U_j = j_make_batched_sls_admm(
        A, B, cost, project_u=lambda y, p: jax.vmap(j_soc)(y, p), **kw)(jnp.asarray(bounds))
    _, _, U = make_batched_sls_admm(*_port(A, B, cost), project_u=t_soc, **kw, device="cpu")(
        torch.tensor(bounds))
    close(U, U_j, 1e-9)


def test_batched_sls_state_block_matches_jax():
    """A state projection block (rho_x, SuTQr) beside the control block."""
    A, B, cost = _problem(12)
    _, t_proj = _weighted_l1_pair()
    j_u, _ = _weighted_l1_pair()
    kw = dict(rho_x=0.5, rho_u=1.0, robust_dim=1, n_iters=60)
    bounds = np.array([2.0, 3.0])
    _, _, U_j = j_make_batched_sls_admm(
        A, B, cost, project_x=lambda y, p: jnp.clip(y, -2.0, 2.0), project_u=j_u, **kw
    )(jnp.asarray(bounds))
    _, _, U = make_batched_sls_admm(
        *_port(A, B, cost), project_x=lambda y, p: y.clamp(-2.0, 2.0), project_u=t_proj, **kw,
        device="cpu"
    )(torch.tensor(bounds))
    close(U, U_j, 1e-9)


def test_batched_sls_argument_errors():
    tA, tB, tcost = _port(*_problem(8))
    with pytest.raises(ValueError, match="at least one projection"):
        make_batched_sls_admm(tA, tB, tcost, device="cpu")
    with pytest.raises(ValueError, match="rho_u"):
        make_batched_sls_admm(tA, tB, tcost, project_u=lambda y, p: y, device="cpu")
    with pytest.raises(ValueError, match="project_u"):
        make_batched_sls_admm(tA, tB, tcost, project_x=lambda y, p: y, rho_x=1.0, rho_u=1.0,
                              device="cpu")
