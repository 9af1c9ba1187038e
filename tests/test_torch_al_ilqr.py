"""Port vs JAX package: augmented-Lagrangian iLQR (`solvers/al_ilqr.py`).

Each problem of `tests/test_al_ilqr.py` through both packages in
float64: velocity bounds (in both curvature modes), the mid-horizon pin
and the moving belt (time-indexed equalities), the infeasible start, the
facade's problem, the nonconvex keep-out (Gauss-Newton) and the 3DoF
arm's constrained optimum (riccati='sqrt'). Cost to 1e-10 relative,
trajectories to 1e-8, violation, multipliers and the last status equal.
The fleet (`al_ilqr_fleet_solve`) matches `jax.vmap(al_ilqr_solve)` and
the port's single solves; the caller's u0 is left as it was.

Two allowances, both from f64 rounding and not from the algorithm:
- Status: an inner solve that has converged ends on a step whose cost
  change is at the rounding level (~1e-14 relative). Accepted, it is
  CONVERGED; rejected, LINE_SEARCH_FAILED; the two packages round it
  differently (stage by stage the iteration counts and costs agree). So
  those two count as one stop; RUNNING and MAX_ITER must match exactly.
  Where the two stops differ, one package took that last step and the
  other did not: on a flat optimum a step worth a rounding-level cost
  change moves the iterate by up to ~sqrt(eps), so the trajectories
  then agree to 1e-7.
- Multipliers: the last update lam + mu g carries mu up to 5^11, which
  scales the rounding of g by as much; they agree to 1e-4 of their
  largest entry.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.models.arm import PlanarArm as JArm
from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator as JDI
from ilqr_admm_tpu.ops.riccati import quad_cost_model as j_quad_model
from ilqr_admm_tpu.problem import ILQRConfig as JConfig
from ilqr_admm_tpu.solvers.al_ilqr import al_ilqr_solve as j_al
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost as j_viapoint_cost
from ilqr_admm_tpu_torch.models.arm import PlanarArm
from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.ops.riccati import quad_cost_model
from ilqr_admm_tpu_torch.problem import ILQRConfig, SolveStatus
from ilqr_admm_tpu_torch.solvers import admm
from ilqr_admm_tpu_torch.solvers.al_ilqr import al_ilqr_fleet_solve, al_ilqr_solve
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost

torch.set_num_threads(2)

COST_TOL = 1e-10
TRAJ_TOL = 1e-8
TIE_TRAJ_TOL = 1e-7
LAM_TOL = 1e-4
F64 = torch.float64
STOPS = {int(SolveStatus.CONVERGED), int(SolveStatus.LINE_SEARCH_FAILED)}


def _same_status(got, want):
    got, want = int(got), int(want)
    return got == want or {got, want} <= STOPS


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _cost_pair(N, d, m, target, weight, u_std):
    """viapoint_cost with the target at weight `weight` on the last step,
    both packages; with each its quadratic model."""
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    Qs = np.stack([np.zeros((d, d)), np.diag(np.broadcast_to(weight, d))])
    zs = np.stack([np.zeros(d), target])
    jc = j_viapoint_cost(jnp.asarray(zs), jnp.asarray(Qs), seq, u_std, m)
    tc = viapoint_cost(torch.tensor(zs), torch.tensor(Qs), seq, u_std, m)
    return ((jc, lambda xs, us: j_quad_model(jc.Q, jc.xd, jc.R, xs, us)),
            (tc, lambda xs, us: quad_cost_model(tc.Q, tc.xd, tc.R, xs, us)))


def _integrator(m, N, target):
    """`tests/test_al_ilqr.py::_lq_setup` (m = 1) and the keep-out task's
    2-D integrator: terminal target at weight 1e3, u_std 1e-2."""
    jp = JDI(m, 2, dt=1.0 / N)
    tp = DoubleIntegrator(m, 2, dt=1.0 / N, device="cpu", dtype=F64)
    (jc, jC), (tc, tC) = _cost_pair(N, jp.x_dim, m, np.asarray(target, np.float64), 1e3, 1e-2)
    jfns = (jp.step, lambda xs, us: jp.AB(xs.shape[0]), jC, jc)
    tfns = (tp.step, lambda xs, us: tp.AB(xs.shape[0]), tC, tc)
    return jfns, tfns, np.zeros(jp.x_dim), m


def _velocity_bounds():
    v = 1.2
    return (_integrator(1, 60, [1.0, 0.0]),
            dict(ineq=(lambda x, u: jnp.asarray([x[1] - v, -x[1] - v]),
                       lambda x, u: torch.stack([x[1] - v, -x[1] - v]))),
            dict(max_iter=40, tol_fun=1e-12), dict(n_al=12, mu0=1.0, mu_factor=5.0, tol_con=1e-8))


def _pin():
    target = np.asarray([0.3, 0.0])

    def t_eq(x, u, t):
        return torch.where(t == 25, x - torch.tensor(target), torch.zeros(2, dtype=x.dtype))

    return (_integrator(1, 50, [1.0, 0.0]),
            dict(eq=(lambda x, u, t: jnp.where(t == 25, x - jnp.asarray(target), jnp.zeros(2)),
                     t_eq)),
            dict(max_iter=40, tol_fun=1e-12), dict(n_al=12, mu0=1.0, mu_factor=5.0, tol_con=1e-9))


def _belt():
    def t_eq(x, u, t):
        return torch.where(t > 0, (x[1] - 0.6).reshape(1), torch.zeros(1, dtype=x.dtype))

    return (_integrator(1, 50, [1.0, 0.0]),
            dict(eq=(lambda x, u, t: jnp.where(t > 0, jnp.asarray([x[1] - 0.6]), jnp.zeros(1)),
                     t_eq)),
            dict(max_iter=40, tol_fun=1e-12), dict(n_al=12, mu0=1.0, mu_factor=5.0, tol_con=1e-9))


def _u_box(N, cfg, **al):
    return (_integrator(1, N, [1.0, 0.0]),
            dict(ineq=(lambda x, u: jnp.asarray([u[0] - 2.0, -u[0] - 2.0]),
                       lambda x, u: torch.stack([u[0] - 2.0, -u[0] - 2.0]))), cfg, al)


def _keepout():
    center, r = np.asarray([0.45, 0.52]), 0.2
    c_t = torch.tensor(center)
    return (_integrator(2, 60, [1.0, 1.0, 0.0, 0.0]),
            dict(ineq=(lambda x, u: jnp.asarray([r - jnp.linalg.norm(x[:2] - center)]),
                       lambda x, u: (r - torch.linalg.norm(x[:2] - c_t)).reshape(1))),
            dict(max_iter=40, tol_fun=1e-12), dict(n_al=12, mu0=10.0, mu_factor=5.0, tol_con=1e-8))


def _arm():
    """`test_arm_constrained_optimum_beats_admm_plateau`: the 3DoF arm, N =
    100, x_std 1e6, u_std 1e-4, |q_dot| <= 1.5, |u| <= 6, terminal ee-x in
    [0.5, 1], riccati='sqrt'."""
    N, n = 100, 3
    ja, ta = JArm((1.0, 1.0, 1.0), dt=1.0 / N), PlanarArm((1.0, 1.0, 1.0), dt=1.0 / N)
    target = np.asarray([0.0] * 6 + [1.5, 1.0, 0.0])
    w = np.asarray([0.0] * n + [1e6] * n + [0.0, 1e6, 0.0])
    (jc, jC), (tc, tC) = _cost_pair(N, 9, 3, target, w, 1e-4)
    q0 = np.asarray([np.pi / 3, -np.pi / 2, -np.pi / 4])

    def j_ineq(x, u, t):
        vel, xe, is_T = x[n:2 * n], x[2 * n], t == N - 1
        return jnp.concatenate([u - 6.0, -u - 6.0, vel - 1.5, -vel - 1.5,
                                jnp.atleast_1d(jnp.where(is_T, xe - 1.0, -1.0)),
                                jnp.atleast_1d(jnp.where(is_T, 0.5 - xe, -1.0))])

    def t_ineq(x, u, t):
        vel, xe, is_T = x[n:2 * n], x[2 * n], t == N - 1
        m1 = torch.full_like(xe, -1.0)
        return torch.cat([u - 6.0, -u - 6.0, vel - 1.5, -vel - 1.5,
                          torch.where(is_T, xe - 1.0, m1).reshape(1),
                          torch.where(is_T, 0.5 - xe, m1).reshape(1)])

    jfns = (ja.step, ja.get_AB, jC, jc)
    tfns = (ta.step, ta.get_AB, tC, tc)
    x0 = np.asarray(ja.initial_state(jnp.asarray(q0)))
    return ((jfns, tfns, x0, 3, np.ones((N, 3))), dict(ineq=(j_ineq, t_ineq)),
            dict(max_iter=40, tol_fun=1e-10), dict(n_al=12, tol_con=1e-7, riccati="sqrt"))


def _case(name):
    if name == "velocity_bounds":
        return _velocity_bounds()
    if name == "velocity_bounds_exact_hessian":
        prob, cons, cfg, al = _velocity_bounds()
        return prob, cons, cfg, dict(al, gauss_newton=False)
    if name == "midhorizon_pin":
        return _pin()
    if name == "moving_belt":
        return _belt()
    if name == "infeasible_init":
        return _u_box(40, dict(max_iter=40, tol_fun=1e-12), n_al=12, mu0=1.0, mu_factor=5.0,
                      tol_con=1e-8)
    if name == "facade_problem":
        return _u_box(40, dict(max_iter=40, tol_fun=1e-9), n_al=10, tol_con=1e-8)
    if name == "keepout_gauss_newton":
        return _keepout()
    return _arm()


def _u0(name, prob):
    if len(prob) == 5:
        return prob[4]
    N = {"velocity_bounds": 60, "velocity_bounds_exact_hessian": 60, "keepout_gauss_newton": 60,
         "midhorizon_pin": 50, "moving_belt": 50}.get(name, 40)
    return (10.0 if name == "infeasible_init" else 0.0) * np.ones((N, prob[3]))


def _solve_both(name):
    prob, cons, cfg, al = _case(name)
    jfns, tfns, x0 = prob[:3]
    u0 = _u0(name, prob)
    jc = {k: v[0] for k, v in cons.items()}
    tc = {k: v[1] for k, v in cons.items()}
    res_j = j_al(*jfns, jnp.asarray(x0), jnp.asarray(u0), cfg=JConfig(**cfg), **jc, **al)
    u0_t = torch.tensor(u0)
    res_t = al_ilqr_solve(*tfns, torch.tensor(x0), u0_t, cfg=ILQRConfig(**cfg), device="cpu",
                          **tc, **al)
    assert torch.equal(u0_t, torch.tensor(u0))  # the caller's u0 is not written
    return res_j, res_t


def _assert_same(res_t, res_j):
    assert _same_status(res_t.status, res_j.status)
    tol = TRAJ_TOL if int(res_t.status) == int(res_j.status) else TIE_TRAJ_TOL
    assert _rel(res_t.cost, res_j.cost) < COST_TOL
    assert _rel(res_t.u_nom, res_j.u_nom) < tol and _rel(res_t.x_nom, res_j.x_nom) < tol
    assert abs(float(res_t.max_violation) - float(res_j.max_violation)) < TRAJ_TOL
    for got, want in ((res_t.lam_ineq, res_j.lam_ineq), (res_t.lam_eq, res_j.lam_eq)):
        assert (got is None) == (want is None)
        if got is not None:
            assert _rel(got, want) < LAM_TOL


CASES = ["velocity_bounds", "velocity_bounds_exact_hessian", "midhorizon_pin", "moving_belt",
         "infeasible_init", "facade_problem", "keepout_gauss_newton", "arm_sqrt"]


@pytest.mark.parametrize("name", CASES)
def test_al_matches_jax(name):
    res_j, res_t = _solve_both(name)
    _assert_same(res_t, res_j)
    xs, us = res_t.x_nom, res_t.u_nom
    # the JAX tests' own gates, on the port
    if name.startswith("velocity_bounds"):
        assert float(res_t.max_violation) < 1e-6
        assert float(xs[:, 1].abs().max()) > 0.99 * 1.2  # the bound binds
    elif name == "midhorizon_pin":
        assert float((xs[25] - torch.tensor([0.3, 0.0], dtype=F64)).abs().max()) < 1e-6
        assert abs(float(xs[-1, 0]) - 1.0) < 0.05
    elif name == "moving_belt":
        assert float((xs[1:, 1] - 0.6).abs().max()) < 1e-6
    elif name in ("infeasible_init", "facade_problem"):
        assert float(res_t.max_violation) < 1e-6 and float(us.abs().max()) <= 2.0 + 1e-6
    elif name == "keepout_gauss_newton":
        assert float(res_t.max_violation) < 1e-7 and abs(float(xs[-1, 0]) - 1.0) < 0.05
        dmin = float(torch.linalg.norm(xs[:, :2] - torch.tensor([0.45, 0.52], dtype=F64),
                                       dim=-1).min())
        assert dmin < 0.2 + 0.02
    else:
        assert abs(float(res_t.cost) - 0.199817) < 5e-4
        assert float(us.abs().max()) <= 6.0 + 1e-5
        assert float(xs[:, 3:6].abs().max()) <= 1.5 + 1e-5
        assert 0.5 - 1e-5 <= float(xs[-1, 6]) <= 1.0 + 1e-5


def _fleet(name, F, seed):
    prob, cons, cfg, al = _case(name)
    jfns, tfns, x0 = prob[:3]
    N = _u0(name, prob).shape[0]
    m = prob[3]
    x0s = x0 + np.random.default_rng(seed).normal(0, 0.1, size=(F, x0.shape[0]))
    return jfns, tfns, x0s, np.zeros((F, N, m)), cons, cfg, al


@pytest.mark.parametrize("name,cfg,al", [
    # `test_jits_and_vmaps`: |u| <= 2, 10 iterations, 4 stages
    ("facade_problem", dict(max_iter=10), dict(n_al=4)),
    # a time-indexed equality under vmap
    ("midhorizon_pin", dict(max_iter=10, tol_fun=1e-12), dict(n_al=4, tol_con=1e-9)),
])
def test_fleet_matches_jax_vmap_and_single_solves(name, cfg, al):
    jfns, tfns, x0s, u0s, cons, _, _ = _fleet(name, 4, 0)
    jc = {k: v[0] for k, v in cons.items()}
    tc = {k: v[1] for k, v in cons.items()}

    def one(x0, u0):
        return j_al(*jfns, x0, u0, cfg=JConfig(**cfg), **jc, **al)

    res_j = jax.vmap(one)(jnp.asarray(x0s), jnp.asarray(u0s))
    stats = {}
    res_t = al_ilqr_fleet_solve(*tfns, torch.tensor(x0s), torch.tensor(u0s),
                                cfg=ILQRConfig(**cfg), device="cpu", stats=stats, **tc, **al)
    statuses = np.asarray(res_j.status).tolist()
    assert all(map(_same_status, res_t.status.tolist(), statuses))
    tol = TRAJ_TOL if res_t.status.tolist() == statuses else TIE_TRAJ_TOL
    assert _rel(res_t.cost, res_j.cost) < COST_TOL
    assert _rel(res_t.u_nom, res_j.u_nom) < tol and _rel(res_t.x_nom, res_j.x_nom) < tol
    assert _rel(res_t.max_violation, res_j.max_violation) < tol
    # each instance against the port's single solve
    for i in range(x0s.shape[0]):
        single = al_ilqr_solve(*tfns, torch.tensor(x0s[i]), torch.tensor(u0s[i]),
                               cfg=ILQRConfig(**cfg), device="cpu", **tc, **al)
        assert _same_status(res_t.status[i], single.status)
        assert abs(float(res_t.cost[i] - single.cost)) <= 1e-12 * abs(float(single.cost))
        tol = TRAJ_TOL if int(res_t.status[i]) == single.status else TIE_TRAJ_TOL
        assert _rel(res_t.u_nom[i], single.u_nom) < tol
    assert stats["host_reads"] <= al["n_al"] * cfg["max_iter"]


def test_fleet_host_reads_do_not_grow_with_the_fleet():
    """One read an inner iteration for the whole fleet: the count is that
    of the slowest instance's stages, at most n_al * max_iter, whatever F."""
    reads = []
    for F in (1, 6):
        _, tfns, x0s, u0s, cons, _, _ = _fleet("facade_problem", F, 1)
        tc = {k: v[1] for k, v in cons.items()}
        x0s[:] = x0s[0]  # every instance the same: the fleet runs as the first alone
        r0 = admm.host_sync_count
        al_ilqr_fleet_solve(*tfns, torch.tensor(x0s), torch.tensor(u0s),
                            cfg=ILQRConfig(max_iter=10), n_al=3, device="cpu", **tc)
        reads.append(admm.host_sync_count - r0)
    assert reads[0] == reads[1] <= 3 * 10


def test_needs_a_constraint_and_runs_on_the_card_unless_asked():
    _, tfns, x0, _ = _integrator(1, 10, [1.0, 0.0])
    with pytest.raises(ValueError, match="at least one"):
        al_ilqr_solve(*tfns, torch.tensor(x0), torch.zeros((10, 1), dtype=F64), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            al_ilqr_solve(*tfns, torch.tensor(x0), torch.zeros((10, 1), dtype=F64),
                          ineq=lambda x, u: u - 1.0)
