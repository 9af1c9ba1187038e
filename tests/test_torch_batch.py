"""Port vs JAX package: the batched front ends of `parallel/batch.py`,
and the certificates of the two fleets they serve on the card.

The `batched_*` calls of `tests/test_parallel.py` without the mesh, in
float64: the LQT-ADMM fleet with the DP x-update (24 instances, |u| <= 5,
50 iterations; also with Anderson, accel or adaptive rho), the multi-start iLQR
(32 instances), the boxDDP fleet (16) and the AL fleet (16), each against
the JAX function on the same inputs (the LQT fleet in each ADMM mode,
the iLQR fleet in each method): cost to 1e-10 relative, trajectories
to 1e-8, iteration counts and statuses equal (CONVERGED and
LINE_SEARCH_FAILED counting as one stop, as in
`tests/test_torch_al_ilqr.py`: a converged solve's last step is a
rounding-level tie).

The certificates (`utils/certify.py`) on small CPU fleets: the oracle's
gradient against torch autograd, `car_polish` against
`benchmarks/_oracles.py::boxddp_polish`, the boxDDP gates passing on
polished controls and failing on a bound broken by 1e-4 and on a polish
that stops early, and the AL gates failing on a fleet off the
reference's violation or cost.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from threadpoolctl import threadpool_limits

from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator as JDI
from ilqr_admm_tpu.ops.riccati import quad_cost_model as j_quad_model
from ilqr_admm_tpu.parallel import batch as jb
from ilqr_admm_tpu.problem import ADMMConfig as JADMM, ILQRConfig as JConfig
from ilqr_admm_tpu.projections import project_bound as j_project_bound
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost as j_viapoint_cost
from ilqr_admm_tpu_torch.models.car import CarFrontWheel, CarParkingCost
from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.ops.riccati import quad_cost_model
from ilqr_admm_tpu_torch.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu_torch.parallel import (
    batched_al_solve,
    batched_boxddp_solve,
    batched_ilqr_solve,
    batched_lqt_admm_dp,
)
from ilqr_admm_tpu_torch.problem import ADMMConfig, ILQRConfig, SolveStatus
from ilqr_admm_tpu_torch.projections import project_bound
from ilqr_admm_tpu_torch.solvers.al_ilqr import ALResult
from ilqr_admm_tpu_torch.utils import certify
from ilqr_admm_tpu_torch.utils.certify import (
    AL_ARM_REFERENCE,
    al_gate_failures,
    boxddp_gate_failures,
    car_polish,
    car_value_and_grad,
    certify_al_fleet,
    certify_boxddp_fleet,
)
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost

torch.set_num_threads(2)

COST_TOL = 1e-10
TRAJ_TOL = 1e-8
TIE_TRAJ_TOL = 1e-7
F64 = torch.float64
N = 50
STOPS = {int(SolveStatus.CONVERGED), int(SolveStatus.LINE_SEARCH_FAILED)}


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _problem():
    """`tests/test_parallel.py::_problem`: 1-D double integrator, N = 50,
    terminal (1, 0) at weight 1e4, u_std 1e-2, linear f; both packages."""
    jp = JDI(1, 2, dt=1.0 / N)
    A, B = jp.AB(N)
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    zs, Qs = np.stack([np.zeros(2), [1.0, 0.0]]), np.stack([np.zeros((2, 2)), np.eye(2) * 1e4])
    jc = j_viapoint_cost(jnp.asarray(zs), jnp.asarray(Qs), seq, 1e-2, 1)
    tc = viapoint_cost(torch.tensor(zs), torch.tensor(Qs), seq, 1e-2, 1)
    tp = DoubleIntegrator(1, 2, dt=1.0 / N, device="cpu", dtype=F64)
    tA, tB = tp.AB(N)
    jA, jB = jnp.asarray(jp.A), jnp.asarray(jp.B)
    jfns = (lambda x, u: jA @ x + jB @ u, lambda xs, us: (A, B),
            lambda xs, us: j_quad_model(jc.Q, jc.xd, jc.R, xs, us), jc)
    tfns = (lambda x, u: tp.A @ x + tp.B @ u, lambda xs, us: (tA, tB),
            lambda xs, us: quad_cost_model(tc.Q, tc.xd, tc.R, xs, us), tc)
    return (A, B, jc), (tA, tB, tc), jfns, tfns


@pytest.mark.parametrize("mode", [
    pytest.param(dict(anderson_m=0), id="0"),
    pytest.param(dict(anderson_m=3), id="3"),
    pytest.param(dict(accel=True), id="accel"),
    pytest.param(dict(adaptive_rho=True), id="adaptive_rho"),
])
def test_batched_lqt_admm_dp_matches_jax(mode):
    """`test_sharded_matches_unsharded`'s fleet: 24 x0 ~ N(0, 0.1^2), |u| <=
    5, rho_u 1e-2, 50 iterations at tol 1e-4; in each ADMM mode of the one
    fleet loop (plain, Anderson, accel with restart, adaptive rho, whose
    x-update re-runs each instance's backward pass at its own scale)."""
    (A, B, jc), (tA, tB, tc), _, _ = _problem()
    x0s = np.random.default_rng(0).normal(0, 0.1, size=(24, 2))
    x_j, u_j, it_j = jb.batched_lqt_admm_dp(
        A, B, jc, jnp.asarray(x0s), project_u=lambda u: j_project_bound(u, -5.0, 5.0),
        rho_u=1e-2, cfg=JADMM(max_iter=50, tol=1e-4, **mode))
    x_t, u_t, it_t = batched_lqt_admm_dp(
        tA, tB, tc, torch.tensor(x0s), project_u=lambda u: project_bound(u, -5.0, 5.0),
        rho_u=1e-2, cfg=ADMMConfig(max_iter=50, tol=1e-4, **mode), device="cpu")
    assert it_t.tolist() == np.asarray(it_j).tolist()
    assert _rel(x_t, x_j) < TRAJ_TOL and _rel(u_t, u_j) < TRAJ_TOL


def _fleet_inputs(n, seed, scale):
    x0s = np.random.default_rng(seed).normal(0, scale, size=(n, 2))
    return x0s, np.zeros((n, N, 1))


@pytest.mark.parametrize("method", ["dp", "batch", "sls"])
def test_batched_ilqr_solve_matches_jax(method):
    """`test_batched_ilqr_multistart_sharded`: 32 starts x0 ~ N(0, 0.2^2),
    10 iterations of 10 alphas; the lifted 'batch' and 'sls' steps run
    under vmap as the 'dp' one does."""
    _, _, jfns, tfns = _problem()
    x0s, u0s = _fleet_inputs(32, 1, 0.2)
    cfg = dict(max_iter=10, max_line_search_iter=10)
    want = jb.batched_ilqr_solve(*jfns, jnp.asarray(x0s), jnp.asarray(u0s), JConfig(**cfg),
                                 method=method)
    got = batched_ilqr_solve(*tfns, torch.tensor(x0s), torch.tensor(u0s), ILQRConfig(**cfg),
                             method=method, device="cpu")
    _assert_fleet(got, want)


def test_batched_boxddp_solve_matches_jax():
    """`test_boxddp_fleet_sharded`: 16 x0 ~ N(0, 0.1^2), |u| <= 5, 15
    iterations, the sequential backward."""
    _, _, jfns, tfns = _problem()
    x0s, u0s = _fleet_inputs(16, 0, 0.1)
    want = jb.batched_boxddp_solve(*jfns, jnp.asarray(x0s), jnp.asarray(u0s), -5.0, 5.0,
                                   cfg=JConfig(max_iter=15))
    got = batched_boxddp_solve(*tfns, torch.tensor(x0s), torch.tensor(u0s), -5.0, 5.0,
                               cfg=ILQRConfig(max_iter=15), device="cpu")
    _assert_fleet(got, want)
    assert float(got.u_nom.abs().max()) <= 5.0 + 1e-12


def _same_stops(got, want):
    """Statuses equal, CONVERGED and LINE_SEARCH_FAILED counting as one stop
    (a converged solve's last step changes the cost at the rounding
    level; accepting or rejecting it is the packages' rounding, see
    `tests/test_torch_al_ilqr.py`). Returns the trajectory tolerance:
    1e-8, or 1e-7 where a stop differs (that last step moves the iterate
    by up to ~sqrt(eps) on a flat optimum)."""
    got, want = got.tolist(), np.asarray(want).tolist()
    assert all(a == b or {a, b} <= STOPS for a, b in zip(got, want)), (got, want)
    return TRAJ_TOL if got == want else TIE_TRAJ_TOL


def _assert_fleet(got, want):
    tol = _same_stops(got.status, want.status)
    assert got.iteration.tolist() == np.asarray(want.iteration).tolist()
    assert _rel(got.cost, want.cost) < COST_TOL
    assert _rel(got.u_nom, want.u_nom) < tol and _rel(got.x_nom, want.x_nom) < tol


def test_batched_al_solve_matches_jax():
    """`test_al_fleet_sharded`: 16 x0 ~ N(0, 0.1^2), |u| <= 5 as AL
    inequalities, 30 iterations, 10 stages, tol_con 1e-8; all feasible."""
    _, _, jfns, tfns = _problem()
    x0s, u0s = _fleet_inputs(16, 1, 0.1)
    want = jb.batched_al_solve(*jfns, jnp.asarray(x0s), jnp.asarray(u0s),
                               ineq=lambda x, u: jnp.concatenate([u - 5.0, -u - 5.0]),
                               cfg=JConfig(max_iter=30), n_al=10, tol_con=1e-8)
    got = batched_al_solve(*tfns, torch.tensor(x0s), torch.tensor(u0s),
                           ineq=lambda x, u: torch.cat([u - 5.0, -u - 5.0]),
                           cfg=ILQRConfig(max_iter=30), n_al=10, tol_con=1e-8, device="cpu")
    tol = _same_stops(got.status, want.status)
    assert _rel(got.cost, want.cost) < COST_TOL
    assert _rel(got.u_nom, want.u_nom) < tol and _rel(got.x_nom, want.x_nom) < tol
    assert float(got.max_violation.max()) < 1e-6


CAR_N = 30
LO, HI = torch.tensor([-0.5, -2.0], dtype=F64), torch.tensor([0.5, 2.0], dtype=F64)


@pytest.fixture(scope="module")
def car_fleet():
    """A 4-instance boxDDP car fleet at N = 30 (bench_boxddp.py's problem,
    cut in horizon), 60 iterations in f64 on the CPU: short of a local
    optimum, which the polish then finds."""
    car, cost = CarFrontWheel(dt=15.0 / CAR_N), CarParkingCost(dtype=F64)
    rng = np.random.default_rng(0)
    u0 = torch.tensor(rng.normal(size=(CAR_N, 2)) * 0.1)
    x0s = torch.tensor(np.array([1.0, 1.0, 3 * np.pi / 2, 0.0]) + rng.normal(0, 0.05, (4, 4)))
    res = batched_boxddp_solve(car.step, car.get_AB, cost.get_Cs, cost, x0s,
                               u0.expand(4, CAR_N, 2), LO, HI,
                               cfg=ILQRConfig(max_iter=60, tol_fun=1e-8), device="cpu")
    return car, cost, x0s, res


def test_car_value_and_grad_is_autograd_through_the_rollout(car_fleet):
    car, cost, x0s, res = car_fleet
    u = res.u_nom[1].reshape(-1).clone().requires_grad_(True)
    J = cost(rollout_nonlinear(car.step, x0s[1], u.reshape(CAR_N, 2)), u.reshape(CAR_N, 2))
    (g,) = torch.autograd.grad(J, u)
    val, grad = car_value_and_grad(car, cost, x0s[1], res.u_nom[1].reshape(-1))
    assert abs(float(val) - float(J.detach())) <= 1e-13 * float(J.detach())
    assert float((grad - g).abs().max()) <= 1e-12 * float(g.abs().max())


def test_car_oracle_matches_the_jax_oracle(car_fleet, monkeypatch):
    """`certify.car_polish` against `benchmarks/_oracles.py::boxddp_polish`
    (JAX f64 grad, the same scipy call) on 2 instances, both cut at 30
    L-BFGS-B iterations (no restart), where their paths still agree:
    j_ours to 1e-12 and j_star to 1e-9 relative."""
    import scipy.optimize

    from benchmarks._oracles import boxddp_polish

    minimize = scipy.optimize.minimize

    def cut(*args, options, **kw):
        return minimize(*args, options=dict(options, maxiter=30), **kw)

    car, cost, x0s, res = car_fleet
    x0s, us = x0s[[1, 3]], res.u_nom[[1, 3]]  # two that are off a local optimum
    with threadpool_limits(1):
        got = car_polish(car, cost, x0s, us, LO, HI, maxiter=30, restarts=0)
        monkeypatch.setattr(scipy.optimize, "minimize", cut)
        want = boxddp_polish({"dt": car.dt, "lo": LO.numpy(), "hi": HI.numpy(),
                              "x0s": x0s.numpy(), "us": us.numpy()})
    np.testing.assert_allclose(got["j_ours"], want["j_ours"], rtol=1e-12)
    np.testing.assert_allclose(got["j_star"], want["j_star"], rtol=1e-9)
    assert got["iterations"] == [30, 30] and len(got["failures"]) == 2


def test_car_polish_in_worker_processes(car_fleet):
    """workers=2 polishes in two spawned processes: the same numbers."""
    car, cost, x0s, res = car_fleet
    with threadpool_limits(1):
        here = car_polish(car, cost, x0s[:2], res.u_nom[:2], LO, HI, maxiter=20, restarts=1)
    there = car_polish(car, cost, x0s[:2], res.u_nom[:2], LO, HI, maxiter=20, restarts=1,
                       workers=2)
    for key in ("j_ours", "j_star"):
        np.testing.assert_allclose(there[key], here[key], rtol=1e-12)
    assert there["iterations"] == here["iterations"] and there["failures"] == here["failures"]


@pytest.fixture(scope="module")
def polished(car_fleet):
    """The first two instances polished to a local optimum (with restarts)."""
    car, cost, x0s, res = car_fleet
    with threadpool_limits(1):
        orc = car_polish(car, cost, x0s[:2], res.u_nom[:2], LO, HI)
    assert orc["failures"] == []
    return res._replace(u_nom=orc["u_star"], cost=torch.tensor(orc["j_star"]))


def test_boxddp_gates_pass_and_catch_a_broken_bound(car_fleet, polished):
    car, cost, x0s, _ = car_fleet
    with threadpool_limits(1):
        cert = certify_boxddp_fleet(car, cost, x0s[:2], polished, LO, HI, n_oracle=2)
        assert boxddp_gate_failures(cert) == [], cert
        assert cert["max_violation"] <= 0.0
        u = polished.u_nom.clone()
        u[1, 7, 1] = 2.0 * (1.0 + 1e-4)  # a bound broken by 1e-4 of it
        broken = certify_boxddp_fleet(car, cost, x0s[:2], polished._replace(u_nom=u), LO, HI,
                                      n_oracle=1)
    fails = boxddp_gate_failures(broken)
    assert len(fails) == 1 and fails[0].startswith("max_violation"), fails


def test_boxddp_gates_catch_a_polish_that_stops_early(car_fleet, monkeypatch):
    """A polish cut at 2 iterations: instance 0 sits at a local optimum and
    converges in one; instance 1 is still at its limit after its 4
    restarts (10 iterations), and the gates fail on it."""
    car, cost, x0s, res = car_fleet
    monkeypatch.setattr(certify, "car_polish", functools.partial(certify.car_polish, maxiter=2))
    with threadpool_limits(1):
        cert = certify_boxddp_fleet(car, cost, x0s, res, LO, HI, n_oracle=2)
    assert cert["oracle_iterations"] == [1, 10]
    assert len(cert["oracle_failures"]) == 1
    assert cert["oracle_failures"][0].startswith("instance 1:")
    assert "LIMIT" in cert["oracle_failures"][0].upper()
    assert [f for f in boxddp_gate_failures(cert) if f.startswith("oracle failed")] == [
        "oracle failed on " + cert["oracle_failures"][0]]


def _al_result(viol, cost):
    n = len(viol)
    return ALResult(x_nom=torch.zeros((n, 3, 2)), u_nom=torch.zeros((n, 3, 1)),
                    cost=torch.tensor(cost), max_violation=torch.tensor(viol), lam_ineq=None,
                    lam_eq=None, status=torch.full((n,), 4))


def test_al_gates():
    """The AL fleet gates against a reference of median violation 2e-3 and
    mean cost 0.2 over the first 4 instances: a fleet at the reference
    passes; one whose median violation is 2.5x the reference's, whose
    mean cost is 2% off, or with a NaN cost fails."""
    ref = dict(n=4, median_violation=2e-3, mean_cost=0.2)
    ok = _al_result([1e-3, 2e-3, 3e-3, 1e-1, 2e-3, 2e-3], [0.2, 0.21, 0.19, 0.2, 5.0, 0.1])
    assert al_gate_failures(certify_al_fleet(ok, ref)) == []
    cases = {
        "median_violation": _al_result([5e-3] * 6, [0.2] * 6),
        "mean cost": _al_result([2e-3] * 6, [0.204] * 6),
        "non-finite": _al_result([2e-3] * 6, [0.2, float("nan"), 0.2, 0.2, 0.2, 0.2]),
    }
    for key, res in cases.items():
        fails = al_gate_failures(certify_al_fleet(res, ref))
        assert any(key in f for f in fails), (key, fails)
    # the committed reference is the JAX package's f32 run of the bench fleet
    assert AL_ARM_REFERENCE["n"] == 64 and 0.0 < AL_ARM_REFERENCE["median_violation"] < 5e-3
