"""Port vs JAX package: the constrained iLQR-ADMM fleet on the 3DoF arm.

`ilqr_admm_fleet` against `jax.vmap` of the JAX package's `ilqr_admm`
(the semantics of `tests/test_batched_ilqr_admm.py` and
`benchmarks/bench_arm_admm.py`), in float64 at N = 20 on 4 instances
made with numpy from a seed, in both line-search modes, with a bound
that no instance reaches (|u| <= 6) and one that some reach (|u| <= 2).
Costs, u_nom, statuses and outer iterations must agree to 1e-8 (the two
differ in the order of f64 sums, amplified by the stiff lifted solves).
Each fleet instance must equal the port's single-instance solve, bit for
bit where it left early, and the fleet must count the host reads of its
slowest instance, whatever its size. The fleet's certificates
(`utils/certify.py`) hold the port's f64 oracle against the JAX one.

The dp method and Anderson acceleration (`anderson_m = 3`, with either
method) are held to `jax.vmap(ilqr_admm)` on 4 simple cars (the MPC
tick's model and cost, N = 30, |u| <= 0.6) whose instances leave at
different outer steps: costs and u to 1e-8, statuses and outer
iterations equal. With every tolerance 0 no stop test can pass, and the
fleet reads nothing on the host, bit for bit what it computes when it
reads.

The fused line-search rollout (`ops/fused_rollout.py`, its plain version
on CPU tensors) runs the control-limited car fleet, 3 parkings from
x0 = (1, 1, 3pi/2, 0) + N(0, 0.05^2) at N = 40 in float32, against
`jax.vmap(ilqr_admm)` with the Pallas rollout in interpret mode, in both
line-search modes: statuses and outer iterations equal, costs and u to
1e-3 relative (two f32 solves whose lifted Cholesky solves sum in other
orders; ~1e-4 seen), and to 1e-5 of the same fleet with the default
vmapped rollout, ADMM iterations equal, one rollout call a line search.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.models.arm import PlanarArm as JArm
from ilqr_admm_tpu.models.car import CarFrontWheel as JCarFrontWheel
from ilqr_admm_tpu.models.car import CarParkingCost as JCarParkingCost
from ilqr_admm_tpu.models.car import CarSimple as JCarSimple
from ilqr_admm_tpu.ops.pallas_rollout import make_pallas_linesearch_rollout
from ilqr_admm_tpu.ops.rollout import rollout_nonlinear as j_rollout
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost as j_viapoint_cost
from ilqr_admm_tpu_torch.convert import arm_from_numpy, quadcost_from_numpy
from ilqr_admm_tpu_torch.models import car as tc
from ilqr_admm_tpu_torch.ops.fused_rollout import make_fused_linesearch_rollout
from ilqr_admm_tpu_torch.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu_torch.problem import SolveStatus
from ilqr_admm_tpu_torch.solvers import admm as tadmm
from ilqr_admm_tpu_torch.solvers import batched_ilqr_admm as tbia
from ilqr_admm_tpu_torch.solvers.batched_ilqr_admm import ilqr_admm_fleet
from ilqr_admm_tpu_torch.solvers.ilqr_admm import ilqr_admm
from ilqr_admm_tpu_torch.utils.certify import arm_gate_failures, arm_polish, certify_arm, gaps

torch.set_num_threads(2)
# the JAX package's solvers/__init__ rebinds the module name to the function
jia = importlib.import_module("ilqr_admm_tpu.solvers.ilqr_admm")

N, F, TOL = 20, 4, 1e-8
SOLVE = dict(rho_u=1e-2, max_iter=6, max_admm_iter=5, tol=1e-4)
ALPHAS = 10.0 ** np.linspace(0.0, -5.0, 50)[:8]
CASES = [(bound, mode) for bound in (6.0, 2.0) for mode in ("inner", "outer")]


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _jax_cost():
    """bench_arm_admm.py's cost at N: zero terminal velocity and ee height
    1.0, weight 1e4 each, u_std 1e-4."""
    d, n = 9, 3
    x_std = 1e4
    target = jnp.asarray([0.0] * 2 * n + [1.5, 1.0, 0.0])
    w = jnp.asarray([0.0] * n + [x_std] * n + [0.0, x_std, 0.0])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    return j_viapoint_cost(jnp.stack([jnp.zeros(d), target]),
                           jnp.stack([jnp.zeros((d, d)), jnp.diag(w)]), seq, 1e-4, 3)


@pytest.fixture(scope="module")
def problem():
    jarm = JArm((1.0, 1.0, 1.0), dt=1.0 / N)
    rng = np.random.default_rng(0)
    q0s = np.array([np.pi / 3, -np.pi / 2, -np.pi / 4]) + rng.normal(0.0, 0.2, (F, 3))
    u0 = np.ones((F, N, 3))
    x_nom0 = np.stack([np.asarray(j_rollout(jarm.step, jarm.initial_state(jnp.asarray(q)),
                                            jnp.asarray(u))) for q, u in zip(q0s, u0)])
    return jarm, _jax_cost(), x_nom0, u0


def _jax_fleet(problem, bound, line_search):
    jarm, quad, x_nom0, u0 = problem

    def solve_one(x0, u):
        res = jia.ilqr_admm(jarm.step, jarm.get_AB, quad, x0, u, quad_cost=quad,
                            project_u=lambda v: jnp.clip(v, -bound, bound),
                            alphas=jnp.asarray(ALPHAS), line_search=line_search, **SOLVE)
        return res.cost, res.u_nom, res.status, res.outer_iters

    return jax.vmap(solve_one)(jnp.asarray(x_nom0), jnp.asarray(u0))


def _port(problem):
    jarm, quad, x_nom0, u0 = problem
    tarm = arm_from_numpy(np.asarray(jarm.lengths), jarm.dt)
    tquad = quadcost_from_numpy(np.asarray(quad.Q), np.asarray(quad.xd), np.asarray(quad.R),
                                device="cpu", dtype=torch.float64)
    return tarm, tquad, torch.tensor(x_nom0), torch.tensor(u0)


def _kw(quad, bound, line_search, **extra):
    return dict(SOLVE, quad_cost=quad, project_u=lambda v: torch.clamp(v, -bound, bound),
                alphas=torch.tensor(ALPHAS), line_search=line_search, device="cpu", **extra)


def _fleet(problem, bound, line_search, rows=slice(None), stats=None, **extra):
    tarm, tquad, x_nom0, u0 = _port(problem)
    return ilqr_admm_fleet(tarm.step, tarm.get_AB, tquad, x_nom0[rows], u0[rows],
                           stats=stats, **_kw(tquad, bound, line_search, **extra))


@pytest.mark.parametrize("bound,line_search", CASES)
def test_fleet_matches_jax_vmap(problem, bound, line_search):
    cost_j, u_j, status_j, outer_j = _jax_fleet(problem, bound, line_search)
    got = _fleet(problem, bound, line_search)
    assert got.u_nom.shape == (F, N, 3) and got.cost.shape == (F,)
    assert got.cost_log.shape == (F, SOLVE["max_iter"])
    assert got.status.tolist() == np.asarray(status_j).tolist()
    assert got.outer_iters.tolist() == np.asarray(outer_j).tolist()
    assert _rel(got.cost, cost_j) < TOL and _rel(got.u_nom, u_j) < TOL
    if bound == 6.0:
        assert float(got.u_nom.abs().max()) < 0.98 * bound
    else:  # the tight bound binds on some instances, not all
        binding = (got.u_nom.abs().amax(dim=(1, 2)) > 0.98 * bound).tolist()
        assert any(binding) and not all(binding)


@pytest.mark.parametrize("line_search", ["inner", "outer"])
def test_each_instance_is_its_single_solve(problem, line_search):
    """The fleet of 4 against 4 single `ilqr_admm` solves of the same
    instances. At |u| <= 1.5 three instances converge after 3 outer steps
    and the fourth runs on to max_iter (asserted): every instance's result,
    the early leavers' included, is its single solve bit for bit, since a
    frozen carry is selected by torch.where and never recomputed."""
    tarm, tquad, x_nom0, u0 = _port(problem)
    kw = _kw(tquad, 1.5, line_search)
    fleet = _fleet(problem, 1.5, line_search)
    assert len(set(fleet.outer_iters.tolist())) > 1, fleet.outer_iters
    for i in range(F):
        single = ilqr_admm(tarm.step, tarm.get_AB, tquad, x_nom0[i], u0[i], **kw)
        assert fleet.outer_iters[i] == single.outer_iters and fleet.status[i] == single.status
        for name in ("x_nom", "u_nom", "cost", "z_u", "lmb_u", "cost_log"):
            assert torch.equal(getattr(fleet, name)[i], getattr(single, name)), (i, name)


def test_host_reads_follow_the_slowest_instance(problem):
    """One read an outer step and one an ADMM iteration, as many as the
    slowest instance alone would count, for a fleet of 2 or of 6."""
    tarm, tquad, x_nom0, u0 = _port(problem)
    kw = _kw(tquad, 1.5, "inner")
    alone = []
    for i in range(F):
        before = tadmm.host_sync_count
        ilqr_admm(tarm.step, tarm.get_AB, tquad, x_nom0[i], u0[i], **kw)
        alone.append(tadmm.host_sync_count - before)
    counts = []
    for rows in ([0, 3], [0, 3, 0, 3, 3, 0]):
        stats, before = {}, tadmm.host_sync_count
        res = _fleet(problem, 1.5, "inner", rows=rows, stats=stats)
        counts.append(tadmm.host_sync_count - before)
        assert counts[-1] == stats["outer_steps"] + stats["fleet_admm_iters"]
        assert stats["outer_steps"] == int(res.outer_iters.max())
        per_instance = (res.outer_iters + stats["admm_iters"]).tolist()
        assert per_instance == [alone[i] for i in rows]
    assert counts[0] == counts[1] == max(alone[0], alone[3])


def test_statuses_are_solve_statuses(problem):
    res = _fleet(problem, 6.0, "outer", max_iter=2)
    assert res.status.dtype == torch.int64 and res.outer_iters.dtype == torch.int64
    assert set(res.status.tolist()) <= {int(s) for s in SolveStatus}
    assert (res.outer_iters <= 2).all()
    # the cost log holds each instance's outer costs, +inf beyond
    for i in range(F):
        k = int(res.outer_iters[i])
        assert bool(torch.isfinite(res.cost_log[i, :k]).all()) and bool(
            torch.isinf(res.cost_log[i, k:]).all())


def test_no_device_means_the_card(problem):
    tarm, tquad, x_nom0, u0 = _port(problem)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ilqr_admm_fleet(tarm.step, tarm.get_AB, tquad, x_nom0, u0, quad_cost=tquad)


@pytest.mark.parametrize("option,error", [
    (dict(method="dp", line_search="outer"), ValueError),
    (dict(method="lifted"), ValueError),
    (dict(line_search="middle"), ValueError),
])
def test_unsupported_options_raise(problem, option, error):
    with pytest.raises(error, match="method must be|line_search"):
        _fleet(problem, 6.0, option.pop("line_search", "inner"), **option)


def test_rollout_helper_agrees_with_the_jax_rollout(problem):
    """The fleet's x_nom0 (made by the JAX rollout) is the port's rollout."""
    jarm, _, x_nom0, u0 = problem
    tarm = arm_from_numpy(np.asarray(jarm.lengths), jarm.dt)
    got = rollout_nonlinear(tarm.step, torch.tensor(x_nom0[1, 0]), torch.tensor(u0[1]))
    assert _rel(got, x_nom0[1]) < 1e-12


def test_arm_oracle_matches_the_jax_oracle(problem):
    """`certify.arm_polish` (torch f64 autograd, scipy L-BFGS-B) against
    `benchmarks/_oracles.py::arm_polish` (JAX f64 grad, the same scipy
    call), in this process, on 2 fleet instances at N = 20: j_ours to
    1e-10 and j_star to 1e-8 relative."""
    from benchmarks._oracles import arm_polish as jax_arm_polish

    jarm, quad, x_nom0, _ = problem
    res = _fleet(problem, 2.0, "outer", rows=[0, 3])
    q0s = x_nom0[[0, 3], 0, :3]
    us = res.u_nom.numpy()
    tarm, tquad, _, _ = _port(problem)
    got = arm_polish(tarm, tquad, torch.tensor(q0s), res.u_nom, -2.0, 2.0)
    want = jax_arm_polish({
        "lengths": np.asarray(jarm.lengths), "dt": jarm.dt,
        "zs": np.stack([np.zeros(9), np.asarray(quad.xd[-1])]),
        "Qs": np.stack([np.zeros((9, 9)), np.asarray(quad.Q[-1])]),
        "seq": np.eye(1, N, N - 1, dtype=np.int32)[0], "u_std": float(quad.R[0, 0, 0]),
        "u_lo": -2.0, "u_hi": 2.0, "q0s": q0s, "us": us,
    })
    assert np.abs(got["j_ours"] - want["j_ours"]).max() <= 1e-10 * np.abs(want["j_ours"]).max()
    assert np.abs(got["j_star"] - want["j_star"]).max() <= 1e-8 * np.abs(want["j_star"]).max()
    assert (got["j_star"] <= got["j_ours"]).all() and got["seconds"] > 0.0


def test_arm_certificate_and_gates(problem):
    """certify_arm reads the fleet as bench_arm_admm.py does, and
    arm_gate_failures applies the bench's gates of each mode."""
    tarm, tquad, x_nom0, _ = _port(problem)
    res = _fleet(problem, 2.0, "inner")
    cert = certify_arm(tarm, tquad, x_nom0[:, 0, :3], res, 2.0, n_oracle=2)
    u_max = res.u_nom.abs().amax(dim=(1, 2))
    assert cert["converged_frac"] == float((res.status == SolveStatus.CONVERGED).double().mean())
    assert cert["max_violation"] == pytest.approx(max(float(u_max.max()) - 2.0, 0.0))
    assert cert["bounds_active_frac"] == float((u_max > 1.96).double().mean())
    assert cert["max_outer_iters"] == int(res.outer_iters.max())
    assert cert["cost_gap_median"] >= 0.0 and cert["cost_gap_max"] >= cert["cost_gap_median"]
    passing = dict(cert, converged_frac=1.0, max_violation=0.0, cost_gap_median=1.5e-3,
                   cost_gap_max=5e-3)
    assert arm_gate_failures(passing, "outer") == []
    assert arm_gate_failures(passing, "inner") == ["cost_gap_median 0.0015 > 0.001"]
    failing = dict(passing, converged_frac=0.98, max_violation=0.02, cost_gap_max=0.05)
    assert len(arm_gate_failures(failing, "inner")) == 4
    assert gaps([1.0, 2.0, 3.0], [1.0, 1.0, 3.0]) == (0.0, 1.0)


@pytest.mark.parametrize("line_search", ["inner", "outer"])
@pytest.mark.parametrize("state_box", [False, True])
def test_get_cs_and_state_box_paths_are_single_solves(line_search, state_box):
    """The fleet's non-quadratic-cost path (get_Cs, vmapped) and its state
    block (project_x with rho_x), on 3 control-limited cars at N = 20 in
    float64: each instance is its single `ilqr_admm` solve to 1e-12 (the
    state block's batched GEMVs sum in another order than the single
    solve's: ~1e-14 in the outer mode, bit for bit elsewhere)."""
    n_car = 20
    car, park = tc.CarFrontWheel(dt=0.1), tc.CarParkingCost(dtype=torch.float64)
    u0 = torch.tensor(np.random.default_rng(7).normal(size=(3, n_car, 2)) * 0.3)
    x0 = torch.tensor([1.0, 1.0, 3 * np.pi / 2, 0.0], dtype=torch.float64)
    x_nom0 = torch.stack([rollout_nonlinear(car.step, x0, u) for u in u0])
    lo, hi = torch.tensor([-0.5, -2.0]).double(), torch.tensor([0.5, 2.0]).double()
    x_hi = torch.tensor([np.inf, np.inf, np.inf, 0.6]).double()

    def project_u(u):
        return torch.clamp(u.reshape(*u.shape[:-1], n_car, 2), lo, hi).reshape(u.shape)

    def project_x(x):
        return torch.clamp(x.reshape(*x.shape[:-1], n_car, 4), -x_hi, x_hi).reshape(x.shape)

    kw = dict(get_Cs=park.get_Cs, project_u=project_u, rho_u=torch.diag(torch.tensor([1e-2, 1e-3])).double(),
              max_iter=4, max_admm_iter=4, tol=1e-3, outer_tol=1e-6, osc_tol=1e-6,
              line_search=line_search, device="cpu")
    if state_box:
        kw.update(project_x=project_x, rho_x=torch.diag(torch.tensor([0.0, 0.0, 0.0, 1.0])).double())
    fleet = ilqr_admm_fleet(car.step, car.get_AB, park, x_nom0, u0, **kw)
    for i in range(3):
        single = ilqr_admm(car.step, car.get_AB, park, x_nom0[i], u0[i], **kw)
        assert fleet.outer_iters[i] == single.outer_iters and fleet.status[i] == single.status
        for name in ("x_nom", "u_nom", "cost", "z_x", "z_u", "lmb_x", "lmb_u"):
            assert _rel(getattr(fleet, name)[i], getattr(single, name)) < 1e-12, (i, name)


CAR_N, CAR_U = 30, 0.6
CAR_SOLVE = dict(rho_u=1.0, max_iter=10, max_admm_iter=10, tol=1e-3, outer_tol=1e-3, osc_tol=1e-6)
CAR_ALPHAS = 10.0 ** np.linspace(0.0, -3.0, 10)
FLEET_MODES = [("dp", 0), ("dp", 3), ("batch", 3)]


@pytest.fixture(scope="module")
def cars():
    """4 simple cars with `tests/test_mpc.py`'s via-point cost (target
    (1, 1), terminal weight 20), x0 = (0, 0, 0.5, 0) + N(0, 0.3), u0 =
    N(0, 0.2) from default_rng(0), the nominal by the JAX rollout."""
    jcar = JCarSimple(dt=0.1)
    target = jnp.asarray([1.0, 1.0, 0.0, 0.0])
    seq = np.zeros(CAR_N, dtype=np.int32)
    seq[-1] = 1
    quad = j_viapoint_cost(jnp.stack([target, target]),
                           jnp.stack([jnp.diag(jnp.asarray([1.0, 1.0, 0.0, 0.1])),
                                      jnp.diag(jnp.asarray([20.0, 20.0, 0.0, 1.0]))]), seq, 1e-2, 2)
    rng = np.random.default_rng(0)
    x0s = np.array([0.0, 0.0, 0.5, 0.0]) + rng.normal(0, 0.3, size=(F, 4))
    u0 = rng.normal(0, 0.2, size=(F, CAR_N, 2))
    x_nom0 = np.stack([np.asarray(j_rollout(jcar.step, jnp.asarray(a), jnp.asarray(u)))
                       for a, u in zip(x0s, u0)])
    tquad = quadcost_from_numpy(np.asarray(quad.Q), np.asarray(quad.xd), np.asarray(quad.R),
                                device="cpu", dtype=torch.float64)
    return jcar, quad, tc.CarSimple(dt=0.1), tquad, x_nom0, u0


def _car_kw(tquad, **extra):
    return dict(CAR_SOLVE, quad_cost=tquad, project_u=lambda v: torch.clamp(v, -CAR_U, CAR_U),
                alphas=torch.tensor(CAR_ALPHAS), device="cpu", **extra)


def _car_fleet(cars, stats=None, **extra):
    _, _, tcar, tquad, x_nom0, u0 = cars
    return ilqr_admm_fleet(tcar.step, tcar.get_AB, tquad, torch.tensor(x_nom0), torch.tensor(u0),
                           stats=stats, **_car_kw(tquad, **extra))


@pytest.mark.parametrize("method,anderson_m", FLEET_MODES)
def test_fleet_dp_and_anderson_match_jax_vmap(cars, method, anderson_m):
    jcar, quad, _, _, x_nom0, u0 = cars

    def solve_one(x0, u):
        res = jia.ilqr_admm(jcar.step, jcar.get_AB, quad, x0, u, quad_cost=quad,
                            project_u=lambda v: jnp.clip(v, -CAR_U, CAR_U),
                            alphas=jnp.asarray(CAR_ALPHAS), method=method,
                            anderson_m=anderson_m, **CAR_SOLVE)
        return res.cost, res.u_nom, res.status, res.outer_iters, res.lmb_u

    cost_j, u_j, status_j, outer_j, lmb_j = jax.vmap(solve_one)(jnp.asarray(x_nom0), jnp.asarray(u0))
    got = _car_fleet(cars, method=method, anderson_m=anderson_m)
    assert got.status.tolist() == np.asarray(status_j).tolist()
    assert got.outer_iters.tolist() == np.asarray(outer_j).tolist()
    assert len(set(got.outer_iters.tolist())) > 1  # instances leave at different steps
    assert _rel(got.cost, cost_j) < TOL and _rel(got.u_nom, u_j) < TOL
    assert _rel(got.lmb_u, lmb_j) < TOL


@pytest.mark.parametrize("method,anderson_m", FLEET_MODES)
def test_dp_and_anderson_instances_are_single_solves(cars, method, anderson_m):
    """Each instance of the fleet against its single `ilqr_admm` solve, to
    1e-12 (the vmapped Riccati passes and batched solves sum as the
    single ones do, up to the order of f64 sums), 1e-10 with Anderson:
    its least squares for the mixing weights magnifies those sums'
    rounding (~4e-12 seen)."""
    tol = 1e-10 if anderson_m else 1e-12
    _, _, tcar, tquad, x_nom0, u0 = cars
    fleet = _car_fleet(cars, method=method, anderson_m=anderson_m)
    for i in range(F):
        single = ilqr_admm(tcar.step, tcar.get_AB, tquad, torch.tensor(x_nom0[i]),
                           torch.tensor(u0[i]), **_car_kw(tquad, method=method,
                                                          anderson_m=anderson_m))
        assert fleet.outer_iters[i] == single.outer_iters and fleet.status[i] == single.status
        for name in ("x_nom", "u_nom", "cost", "z_u", "lmb_u"):
            assert _rel(getattr(fleet, name)[i], getattr(single, name)) < tol, (i, name)


@pytest.mark.parametrize("method", ["dp", "batch"])
def test_zero_tolerances_read_nothing(cars, method, monkeypatch):
    """tol = outer_tol = osc_tol = 0 (the MPC tick's): no host read, and
    the same result bit for bit as the loops that read their flags."""
    extra = dict(method=method, tol=0.0, outer_tol=0.0, osc_tol=0.0, max_iter=3, max_admm_iter=4)
    if method == "batch":
        extra["line_search"] = "outer"
    before = tadmm.host_sync_count
    quiet = _car_fleet(cars, **extra)
    assert tadmm.host_sync_count == before
    monkeypatch.setattr(tadmm, "can_stop", lambda cfg: True)
    monkeypatch.setattr(tbia, "outer_can_stop", lambda outer_tol, osc_tol: True)
    stats, before = {}, tadmm.host_sync_count
    read = _car_fleet(cars, stats=stats, **extra)
    assert tadmm.host_sync_count - before == 3 * (1 + 4)
    assert stats["outer_steps"] == 3 and stats["fleet_admm_iters"] == 12
    for name in ("x_nom", "u_nom", "cost", "z_u", "lmb_u", "status", "outer_iters"):
        assert torch.equal(getattr(quiet, name), getattr(read, name)), name
    assert (quiet.status == SolveStatus.MAX_ITER).all()


PARK_N, PARK_F, PARK_ALPHAS = 40, 3, 8
PARK_X0 = np.array([1.0, 1.0, 3 * np.pi / 2, 0.0])
PARK_LO, PARK_HI = np.array([-0.5, -2.0], np.float32), np.array([0.5, 2.0], np.float32)
PARK_RHO = np.diag([1e-2, 1e-3]).astype(np.float32)
PARK_SOLVE = dict(max_iter=5, max_admm_iter=5)
PARK_REL, PARK_PLAIN_REL = 1e-3, 1e-5


@pytest.fixture(scope="module")
def parkings():
    """(x_nom0, u0, alphas) in float32: the boxDDP fleet's scatter around
    the car's start (default_rng(0)), u0 ~ 0.1 N(0, 1), the nominal by the
    JAX rollout."""
    rng = np.random.default_rng(0)
    x0s = (PARK_X0 + rng.normal(0, 0.05, (PARK_F, 4))).astype(np.float32)
    u0 = (rng.normal(size=(PARK_F, PARK_N, 2)) * 0.1).astype(np.float32)
    jcar = JCarFrontWheel(dt=0.1)
    x_nom0 = np.stack([np.asarray(j_rollout(jcar.step, jnp.asarray(a), jnp.asarray(u)))
                       for a, u in zip(x0s, u0)])
    alphas = (10.0 ** np.linspace(0.0, -5.0, 50)[:PARK_ALPHAS]).astype(np.float32)
    return x_nom0, u0, alphas


def _park_fleet(parkings, line_search, rollout=None, stats=None):
    x_nom0, u0, alphas = parkings
    car, park = tc.CarFrontWheel(dt=0.1), tc.CarParkingCost()
    lo, hi = torch.tensor(PARK_LO), torch.tensor(PARK_HI)
    return ilqr_admm_fleet(
        car.step, car.get_AB, park, torch.tensor(x_nom0), torch.tensor(u0), get_Cs=park.get_Cs,
        project_u=lambda v: torch.clamp(v.reshape(-1, PARK_N, 2), lo, hi).reshape(v.shape),
        rho_u=torch.tensor(PARK_RHO), alphas=torch.tensor(alphas), line_search=line_search,
        linesearch_rollout=rollout, stats=stats, device="cpu", **PARK_SOLVE)


@pytest.mark.parametrize("line_search", ["inner", "outer"])
def test_fused_rollout_fleet_matches_jax_vmap(parkings, line_search):
    x_nom0, u0, alphas = parkings
    jcar, jpark = JCarFrontWheel(dt=0.1), JCarParkingCost()
    roll = make_pallas_linesearch_rollout(jcar.step_cols, PARK_N, 4, 2, PARK_ALPHAS,
                                          interpret=True)

    def solve_one(x, u):
        res = jia.ilqr_admm(
            jcar.step, jcar.get_AB, jpark, x, u, get_Cs=jpark.get_Cs,
            project_u=lambda v: jnp.clip(v.reshape(PARK_N, 2), PARK_LO, PARK_HI).reshape(-1),
            rho_u=jnp.asarray(PARK_RHO), alphas=jnp.asarray(alphas), line_search=line_search,
            linesearch_rollout=roll, **PARK_SOLVE)
        return res.cost, res.u_nom, res.status, res.outer_iters

    cost_j, u_j, status_j, outer_j = jax.vmap(solve_one)(jnp.asarray(x_nom0), jnp.asarray(u0))
    fused = make_fused_linesearch_rollout(tc.CarFrontWheel(dt=0.1), PARK_N, 4, 2, PARK_ALPHAS,
                                          device="cpu")
    got = _park_fleet(parkings, line_search, fused)
    assert got.u_nom.dtype == torch.float32 and got.u_nom.shape == (PARK_F, PARK_N, 2)
    assert got.status.tolist() == np.asarray(status_j).tolist()
    assert got.outer_iters.tolist() == np.asarray(outer_j).tolist()
    assert _rel(got.cost, cost_j) < PARK_REL and _rel(got.u_nom, u_j) < PARK_REL


@pytest.mark.parametrize("line_search", ["inner", "outer"])
def test_fused_rollout_fleet_is_the_default_fleet(parkings, line_search):
    """One call of the fleet's rollout a line search (each ADMM iteration
    in the inner mode, each outer step in the outer mode), and the solve
    of the default vmapped rollout."""
    calls = []
    fused = make_fused_linesearch_rollout(tc.CarFrontWheel(dt=0.1), PARK_N, 4, 2, PARK_ALPHAS,
                                          device="cpu")

    def counted(x0s, u_cands):
        assert x0s.shape == (PARK_F, 4) and u_cands.shape == (PARK_F, PARK_ALPHAS, PARK_N, 2)
        calls.append(1)
        return fused(x0s, u_cands)

    stats, stats_ref = {}, {}
    got = _park_fleet(parkings, line_search, counted, stats)
    ref = _park_fleet(parkings, line_search, stats=stats_ref)
    lines = stats["fleet_admm_iters"] if line_search == "inner" else stats["outer_steps"]
    assert len(calls) == lines > 0
    assert got.outer_iters.tolist() == ref.outer_iters.tolist()
    assert got.status.tolist() == ref.status.tolist()
    assert stats["admm_iters"].tolist() == stats_ref["admm_iters"].tolist()
    for name in ("x_nom", "u_nom", "cost", "z_u", "lmb_u"):
        assert _rel(getattr(got, name), getattr(ref, name)) < PARK_PLAIN_REL, name
