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
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.models.arm import PlanarArm as JArm
from ilqr_admm_tpu.ops.rollout import rollout_nonlinear as j_rollout
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost as j_viapoint_cost
from ilqr_admm_tpu_torch.convert import arm_from_numpy, quadcost_from_numpy
from ilqr_admm_tpu_torch.models import car as tc
from ilqr_admm_tpu_torch.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu_torch.problem import SolveStatus
from ilqr_admm_tpu_torch.solvers import admm as tadmm
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
    (dict(method="dp"), NotImplementedError),
    (dict(anderson_m=3), NotImplementedError),
    (dict(linesearch_rollout=lambda x0, u: None), NotImplementedError),
    (dict(method="lifted"), ValueError),
    (dict(line_search="middle"), ValueError),
])
def test_unsupported_options_raise(problem, option, error):
    with pytest.raises(error, match="ROADMAP|method must be|line_search"):
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
