"""Slice 5 as a whole on the CPU: constrained iLQR-ADMM on the control-
limited car, port vs JAX package.

The same problem (made with numpy from a seed) goes through
`ilqr_admm_tpu.solvers.ilqr_admm` and `ilqr_admm_tpu_torch.solvers.ilqr_admm`
in float64: the batch method in both line-search modes, the DP method
with the Cholesky and square-root backward passes, Anderson-accelerated
inner ADMM, and penalty continuation. Both must take the same outer
steps with the same statuses and cost logs, and end on the same
trajectories and ADMM state to 1e-8 relative (the two differ only in the
order of f64 sums and in library routines, ~1e-14, amplified by the
Cholesky solves of the lifted problem). The port's fused line-search
rollout on CPU tensors (its plain version) must give the default path's
solve in float32.
"""

import importlib
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.models.car import CarFrontWheel as JCar, CarParkingCost as JCost
from ilqr_admm_tpu.ops.rollout import rollout_nonlinear as j_rollout
from ilqr_admm_tpu.problem import SolveStatus as JStatus
from ilqr_admm_tpu_torch.convert import (
    admm_warm_from_numpy,
    car_from_numpy,
    car_parking_cost_from_numpy,
)
from ilqr_admm_tpu_torch.ops.fused_rollout import make_fused_linesearch_rollout
from ilqr_admm_tpu_torch.problem import SolveStatus
from ilqr_admm_tpu_torch.solvers import admm as tadmm
from ilqr_admm_tpu_torch.solvers import ilqr_admm as tia

torch.set_num_threads(2)
# the JAX package's solvers/__init__ rebinds the module name to the function
jia = importlib.import_module("ilqr_admm_tpu.solvers.ilqr_admm")

N, DT = 40, 0.1
LO, HI = np.array([-0.5, -2.0]), np.array([0.5, 2.0])
RHO_U = np.diag([1e-2, 1e-3])
TOL = 1e-8
WEIGHTS = dict(cu=(1e-2, 1e-4), cf=(0.1, 0.1, 1.0, 0.3), pf=(0.01, 0.01, 0.01, 1.0),
               cx=(1e-3, 1e-3), px=(0.1, 0.1))

CASES = {
    "batch, inner line search": dict(max_iter=6, max_admm_iter=4),
    "batch, outer line search": dict(max_iter=10, max_admm_iter=10, line_search="outer"),
    "dp, chol": dict(max_iter=5, max_admm_iter=4, method="dp"),
    "dp, sqrt": dict(max_iter=5, max_admm_iter=4, method="dp", riccati="sqrt"),
    "batch, Anderson inner ADMM": dict(max_iter=5, max_admm_iter=6, anderson_m=3),
}


def _rel(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    u0 = rng.normal(size=(N, 2)) * 0.3
    x0 = np.array([1.0, 1.0, 3.0 * np.pi / 2, 0.0])
    x_nom0 = np.asarray(j_rollout(JCar(dt=DT).step, jnp.asarray(x0), jnp.asarray(u0)))
    alphas = 10.0 ** np.linspace(0.0, -5.0, 50)[:12]
    return x_nom0, u0, alphas


def _jax_solve(problem, solve=jia.ilqr_admm, **kw):
    x_nom0, u0, alphas = problem
    car, cost = JCar(dt=DT), JCost(**WEIGHTS)
    lo, hi = jnp.asarray(LO), jnp.asarray(HI)

    def proj_u(u):
        return jnp.clip(u.reshape(N, 2), lo, hi).reshape(-1)

    return solve(car.step, car.get_AB, cost, jnp.asarray(x_nom0), jnp.asarray(u0),
                 get_Cs=cost.get_Cs, project_u=proj_u, rho_u=jnp.asarray(RHO_U),
                 alphas=jnp.asarray(alphas), tol=1e-3, outer_tol=1e-6, osc_tol=1e-6, **kw)


def _torch_solve(problem, solve=tia.ilqr_admm, dtype=torch.float64, **kw):
    x_nom0, u0, alphas = problem
    car = car_from_numpy(DT)
    cost = car_parking_cost_from_numpy(**WEIGHTS, device="cpu", dtype=dtype)
    lo, hi = torch.tensor(LO, dtype=dtype), torch.tensor(HI, dtype=dtype)

    def proj_u(u):
        return torch.clamp(u.reshape(N, 2), lo, hi).reshape(-1)

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype)

    return solve(car.step, car.get_AB, cost, t(x_nom0), t(u0), get_Cs=cost.get_Cs,
                 project_u=proj_u, rho_u=t(RHO_U), alphas=t(alphas), tol=1e-3,
                 outer_tol=1e-6, osc_tol=1e-6, device="cpu", **kw)


def _assert_same_solve(got, want):
    assert got.outer_iters == int(want.outer_iters)
    assert got.status == int(want.status)
    log_j = np.asarray(want.cost_log)
    log_t = got.cost_log.numpy()
    assert np.array_equal(np.isinf(log_t), np.isinf(log_j))
    finite = np.isfinite(log_j)
    assert _rel(log_t[finite], log_j[finite]) < TOL
    for name in ("x_nom", "u_nom", "cost", "z_u", "lmb_u", "z_x", "lmb_x"):
        assert _rel(getattr(got, name), getattr(want, name)) < TOL, name


@pytest.mark.parametrize("case", list(CASES))
def test_ilqr_admm_matches_jax(problem, case):
    kw = CASES[case]
    want = _jax_solve(problem, **kw)
    got = _torch_solve(problem, **kw)
    _assert_same_solve(got, want)
    u = got.u_nom.numpy()
    assert np.isfinite(u).all() and got.outer_iters >= 2


def test_continuation_matches_jax(problem):
    """Two penalty phases; the second starts from the first's nominal with
    the scaled duals rescaled by `_rescale_dual`."""
    phases = [dict(max_iter=3, rho_u=10.0 * RHO_U), dict(max_iter=4, rho_u=RHO_U)]
    want = _jax_solve(problem, solve=jia.ilqr_admm_continuation, phases=phases, max_admm_iter=4)
    t_phases = [dict(ph, rho_u=torch.tensor(ph["rho_u"])) for ph in phases]
    got = _torch_solve(problem, solve=tia.ilqr_admm_continuation, phases=t_phases,
                       max_admm_iter=4)
    _assert_same_solve(got, want)


def test_rescale_dual_matches_jax():
    rng = np.random.default_rng(5)
    lmb = rng.normal(size=6 * 2)
    P_old, P_new = np.diag([1.0, 3.0]), rng.normal(size=(6, 2, 2)) + 4.0 * np.eye(2)
    want = jia._rescale_dual(jnp.asarray(lmb), jnp.asarray(P_old), jnp.asarray(P_new), 2, 6)
    got = tia._rescale_dual(torch.tensor(lmb), torch.tensor(P_old), torch.tensor(P_new), 2, 6)
    assert _rel(got, want) < 1e-12
    assert tia._rescale_dual(torch.tensor(lmb), None, P_new, 2, 6).equal(torch.tensor(lmb))


def test_warm_start_from_a_jax_result(problem):
    """A JAX result's (z, lambda) warm-start the port through
    `admm_warm_from_numpy`, and both continue alike."""
    first = _jax_solve(problem, max_iter=2, max_admm_iter=4, line_search="outer")
    warm_np = tuple(np.asarray(a) for a in (first.z_x, first.z_u, first.lmb_x, first.lmb_u))
    nominal = (np.asarray(first.x_nom), np.asarray(first.u_nom), problem[2])
    want = _jax_solve(nominal, max_iter=3, max_admm_iter=4, line_search="outer",
                      warm=tuple(jnp.asarray(a) for a in warm_np))
    warm = admm_warm_from_numpy(*warm_np, device="cpu", dtype=torch.float64)
    assert all(w.dtype == torch.float64 for w in warm)
    got = _torch_solve(nominal, max_iter=3, max_admm_iter=4, line_search="outer", warm=warm)
    _assert_same_solve(got, want)


def test_fused_rollout_gives_the_default_solve(problem):
    """line_search='outer' with `linesearch_rollout=` the fused rollout
    (its plain version on CPU tensors) against the default vmapped
    rollout, in float32: one rollout an outer step either way, and
    the same solve."""
    car = car_from_numpy(DT)
    kw = dict(max_iter=8, max_admm_iter=10, line_search="outer", dtype=torch.float32)
    ref = _torch_solve(problem, **kw)
    roll = make_fused_linesearch_rollout(car, N, 4, 2, len(problem[2]), device="cpu")
    got = _torch_solve(problem, linesearch_rollout=roll, **kw)
    assert got.outer_iters == ref.outer_iters and got.status == ref.status
    # both are elementwise f32 in the same order; only torch's vectorized
    # and scalar CPU transcendentals may differ in the last bit
    for name in ("x_nom", "u_nom", "cost", "z_u", "lmb_u"):
        assert _rel(getattr(got, name), getattr(ref, name)) < 1e-5, name


def test_status_and_sync_count(problem):
    """One host read a ADMM iteration and one an outer step; status is a
    SolveStatus value the JAX package also uses."""
    before = tadmm.host_sync_count
    got = _torch_solve(problem, max_iter=3, max_admm_iter=2, line_search="outer")
    assert got.outer_iters == 3 and got.status == SolveStatus.MAX_ITER == JStatus.MAX_ITER
    # no early ADMM stop at 2 iterations here: 3 x (2 + 1)
    assert tadmm.host_sync_count - before == 9
    assert got.cost_log.shape == (3,) and bool(torch.isfinite(got.cost_log).all())


def test_argument_errors(problem):
    with pytest.raises(ValueError, match="line_search"):
        _torch_solve(problem, line_search="middle")
    with pytest.raises(ValueError, match="only supported with method='batch'"):
        _torch_solve(problem, method="dp", line_search="outer")
    with pytest.raises(ValueError, match="method must be"):
        _torch_solve(problem, method="lifted")
    with pytest.raises(ValueError, match="phases"):
        tia.ilqr_admm_continuation(None, None, None, torch.zeros(N, 4), torch.zeros(N, 2), [])


def test_no_device_means_the_card(problem):
    x_nom0, u0, _ = problem
    car = car_from_numpy(DT)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tia.ilqr_admm(car.step, car.get_AB, None, torch.tensor(x_nom0), torch.tensor(u0))


def test_nan_candidates_cost_inf():
    costs = torch.tensor([3.0, math.nan, 1.0, math.nan])
    fixed = tia.nan_to_inf(costs)
    assert torch.isinf(fixed[1]) and torch.isinf(fixed[3]) and int(torch.argmin(fixed)) == 2
