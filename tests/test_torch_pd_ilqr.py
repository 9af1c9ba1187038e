"""Port vs JAX package: primal-dual (multiple-shooting) iLQR
(`solvers/pd_ilqr.py`).

The problems of `tests/test_pd_ilqr.py` through both packages in
float64: one full-step iteration of the LQ double integrator from a
random infeasible state path (it must close every defect), a full solve
whose costates are compared, and the car (`CarSimple`, N = 60) from a
feasible rollout and from a straight-line state path with no controls.
Cost and merit to 1e-10 relative, trajectories and costates to 1e-8,
statuses and iteration counts equal. The port's LQ iterate also lands
on the lifted least-squares optimum, as in the JAX test.

One allowance, from f64 rounding: a converged solve ends on a step whose
merit change is at the rounding level. Accepted it is CONVERGED,
rejected LINE_SEARCH_FAILED, and the packages round it differently; the
two count as one stop (iterations and costs still agree). Where the two
stops differ one package took that last step and the other did not: on
a flat optimum it moves the iterate by up to ~sqrt(eps), and the
trajectories and costates (lambda = v + V dx) then agree to 1e-7.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.models.car import CarSimple as JCar
from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator as JDI
from ilqr_admm_tpu.ops.riccati import quad_cost_model as j_quad_model
from ilqr_admm_tpu.ops.rollout import rollout_nonlinear as j_rollout
from ilqr_admm_tpu.problem import ILQRConfig as JConfig
from ilqr_admm_tpu.solvers import pd_ilqr as jpd
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost as j_viapoint_cost
from ilqr_admm_tpu_torch.models.car import CarSimple
from ilqr_admm_tpu_torch.ops.riccati import quad_cost_model
from ilqr_admm_tpu_torch.problem import ILQRConfig, SolveStatus
from ilqr_admm_tpu_torch.solvers import pd_ilqr as tpd
from ilqr_admm_tpu_torch.solvers.lqt import lqt_solve_batch
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost

torch.set_num_threads(2)

COST_TOL = 1e-10
TRAJ_TOL = 1e-8
TIE_TRAJ_TOL = 1e-7
F64 = torch.float64


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _quad(N, d, m, zs, Qs, u_std):
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    jq = j_viapoint_cost(jnp.asarray(zs), jnp.asarray(Qs), seq, u_std, m)
    tq = viapoint_cost(torch.tensor(zs), torch.tensor(Qs), seq, u_std, m)

    def j_cost(xs, us):
        dx = xs - jq.xd
        return jnp.einsum("ti,tij,tj->", dx, jq.Q, dx) + jnp.einsum("ti,tij,tj->", us, jq.R, us)

    def t_cost(xs, us):
        dx = xs - tq.xd
        return (torch.einsum("ti,tij,tj->", dx, tq.Q, dx)
                + torch.einsum("ti,tij,tj->", us, tq.R, us))

    return ((lambda xs, us: j_quad_model(jq.Q, jq.xd, jq.R, xs, us), j_cost),
            (lambda xs, us: quad_cost_model(tq.Q, tq.xd, tq.R, xs, us), t_cost), tq)


def _lqt(N=30):
    """`tests/test_pd_ilqr.py::_lqt_setup`: 1-D double integrator, target
    (1, 0) at weight 1e3, 1e-2 on the way, u_std 1e-2, linear f."""
    plant = JDI(1, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    A, B = plant.AB(N)
    A0, B0 = np.asarray(A[0]), np.asarray(B[0])
    (jC, jc), (tC, tc), tq = _quad(N, d, m, np.stack([np.zeros(d), [1.0, 0.0]]),
                                   np.stack([np.eye(d) * 1e-2, np.eye(d) * 1e3]), 1e-2)
    Aj, Bj, At, Bt = jnp.asarray(A0), jnp.asarray(B0), torch.tensor(A0), torch.tensor(B0)
    jfns = (lambda x, u: Aj @ x + Bj @ u,
            lambda xs, us: (jnp.broadcast_to(Aj, (N, d, d)), jnp.broadcast_to(Bj, (N, d, m))),
            jC, jc)
    tfns = (lambda x, u: At @ x + Bt @ u,
            lambda xs, us: (At.expand(N, d, d), Bt.expand(N, d, m)), tC, tc)
    return jfns, tfns, tq, (At.expand(N, d, d), Bt.expand(N, d, m)), d, m, N


def _car(N=60):
    """`test_matches_single_shooting_on_car`'s problem (the example
    `pd_ilqr_infeasible_start.py`): CarSimple(dt=0.1), target (1.5, 1)."""
    target = np.asarray([1.5, 1.0, 0.0, 0.0])
    Qs = np.stack([np.diag([1.0, 1.0, 0.0, 0.1]) * 1e-2, np.diag([20.0, 20.0, 0.0, 1.0])])
    (jC, jc), (tC, tc), _ = _quad(N, 4, 2, np.stack([target, target]), Qs, 1e-2)
    jcar, tcar = JCar(dt=0.1), CarSimple(dt=0.1)
    return (jcar.step, jcar.get_AB, jC, jc), (tcar.step, tcar.get_AB, tC, tc), target


def _init_both(jfns, tfns, x_init, u_init):
    st_j = jpd.pd_ilqr_init(jfns[3], jfns[0], jnp.asarray(x_init), jnp.asarray(u_init))
    st_t = tpd.pd_ilqr_init(tfns[3], tfns[0], torch.tensor(x_init), torch.tensor(u_init),
                            device="cpu")
    return st_j, st_t


STOPS = {int(SolveStatus.CONVERGED), int(SolveStatus.LINE_SEARCH_FAILED)}


def _assert_same(st_t, st_j):
    assert st_t.status == int(st_j.status) or {st_t.status, int(st_j.status)} <= STOPS
    assert st_t.iteration == int(st_j.iteration)
    for name in ("cost", "merit", "defect"):
        assert _rel(getattr(st_t, name), getattr(st_j, name)) < COST_TOL, name
    tol = TRAJ_TOL if st_t.status == int(st_j.status) else TIE_TRAJ_TOL
    for name in ("x_nom", "u_nom", "lam"):
        assert _rel(getattr(st_t, name), getattr(st_j, name)) < tol, name


def test_lq_one_step_from_an_infeasible_path():
    """`test_lq_exactness_from_infeasible_init`: one alpha = 1 iteration
    from a random path pinned at x0 closes every defect and lands on the
    LQ optimum; the port's iterate equals JAX's."""
    jfns, tfns, tq, (A, B), d, m, N = _lqt()
    x0 = np.asarray([0.3, -0.2])
    rng = np.random.default_rng(0)
    x_init = rng.normal(size=(N, d))
    x_init[0] = x0
    u_init = rng.normal(size=(N, m)) * 0.5
    u_init[-1] = 0.0
    st_j, st_t = _init_both(jfns, tfns, x_init, u_init)
    assert float(st_t.defect) > 0.1  # really infeasible
    st_j, acc_j, _ = jpd.pd_ilqr_iterate(*jfns, st_j, jnp.asarray([1.0]))
    st_t, acc_t, _ = tpd.pd_ilqr_iterate(*tfns, st_t, torch.tensor([1.0], dtype=F64))
    assert bool(acc_t) and bool(acc_j)
    _assert_same(st_t, st_j)
    assert float(st_t.defect) < 1e-9  # all defects closed in one step
    xs_star, us_star = lqt_solve_batch(A, B, tq, torch.tensor(x0))
    c_star = float(tfns[3](xs_star, us_star))
    assert abs(float(st_t.cost) - c_star) < 1e-7 * max(1.0, abs(c_star))
    assert float((st_t.x_nom - xs_star).abs().max()) < 1e-7


def test_costates_match_jax():
    """`test_costates_match_x0_gradient`'s solve (N = 20, from x0 held as
    a constant path, 10 iterations): the costates lambda_t agree."""
    jfns, tfns, _, _, d, m, N = _lqt(N=20)
    x0 = np.asarray([0.25, -0.1])
    st_j, st_t = _init_both(jfns, tfns, np.broadcast_to(x0, (N, d)).copy(), np.zeros((N, m)))
    cfg = dict(max_iter=10, tol_fun=1e-12)
    st_j = jpd.pd_ilqr_solve(*jfns, st_j, JConfig(**cfg))
    st_t = tpd.pd_ilqr_solve(*tfns, st_t, ILQRConfig(**cfg))
    _assert_same(st_t, st_j)


@pytest.mark.parametrize("start", ["rollout", "straight_line"])
def test_car_matches_jax(start):
    """`test_matches_single_shooting_on_car`: from the rollout of u = 0 and
    from a straight-line state path with no controls, 80 iterations at
    tol_fun 1e-9; the defects close (< 1e-5)."""
    jfns, tfns, target = _car()
    N = 60
    x0 = np.asarray([0.0, 0.0, 0.3, 0.0])
    u0 = np.zeros((N, 2))
    if start == "rollout":
        x_init = np.asarray(j_rollout(jfns[0], jnp.asarray(x0), jnp.asarray(u0)))
    else:
        x_init = np.linspace(0.0, 1.0, N)[:, None] * (target - x0)[None] + x0[None]
        x_init[0] = x0
    st_j, st_t = _init_both(jfns, tfns, x_init, u0)
    cfg = dict(max_iter=80, tol_fun=1e-9)
    st_j = jpd.pd_ilqr_solve(*jfns, st_j, JConfig(**cfg))
    st_t = tpd.pd_ilqr_solve(*tfns, st_t, ILQRConfig(**cfg))
    _assert_same(st_t, st_j)
    assert float(st_t.defect) < 1e-5


@pytest.mark.parametrize("feasible", [True, False])
def test_status_of_a_rejected_step(feasible):
    """The status rule of `pd_ilqr_solve`: a rejected step ends the solve
    (LINE_SEARCH_FAILED) only on a feasible iterate; on an infeasible one
    it keeps running, here to MAX_ITER. A merit of -inf makes every step
    a reject; the iterate is the LQ rollout (feasible) or a random path."""
    jfns, tfns, _, _, d, m, N = _lqt()
    if feasible:
        x_init = np.zeros((N, d))
    else:
        x_init = np.random.default_rng(1).normal(size=(N, d))
        x_init[0] = 0.0
    st_j, st_t = _init_both(jfns, tfns, x_init, np.zeros((N, m)))
    st_j = st_j._replace(merit=jnp.asarray(-jnp.inf))
    st_t = st_t._replace(merit=torch.tensor(-np.inf, dtype=F64))
    cfg = dict(max_iter=3, tol_fun=1e-9)
    out_j = jpd.pd_ilqr_solve(*jfns, st_j, JConfig(**cfg))
    out_t = tpd.pd_ilqr_solve(*tfns, st_t, ILQRConfig(**cfg))
    want = SolveStatus.LINE_SEARCH_FAILED if feasible else SolveStatus.MAX_ITER
    assert out_t.status == int(out_j.status) == want
    assert out_t.iteration == int(out_j.iteration) == (1 if feasible else 3)
