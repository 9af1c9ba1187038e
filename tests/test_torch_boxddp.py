"""Port vs JAX package: boxDDP (`solvers/boxddp.py`).

Whole solves in float64 through both packages: the LQ double integrator
of `tests/test_boxddp.py` (N = 100, |u| <= 5, the reference's
control-bounds golden problem) with the sequential and the time-parallel
backward, and the control-limited car (N = 40, per-dim bounds, cost
model by autodiff) with full steps only, where about half the line
searches fail and the regularization schedule retries.
Cost, u, status and iteration count must agree (cost and u to 1e-8).
Beside them the JAX package's own oracles on the port:
the lifted ADMM solution of the golden problem, unconstrained iLQR
under inactive bounds, and the sequential KKT certificate.

As in `tests/test_torch_constrained_riccati.py`, JAX's parallel pass
runs its scans with one block (patched `ilqr_backward_parallel`): its
flat scan aborts XLA:CPU in a process that has imported torch.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.models.car import CarFrontWheel as JCar, CarParkingCost as JCost
from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator as JDI
from ilqr_admm_tpu.ops import parallel_riccati as jp
from ilqr_admm_tpu.ops.riccati import quad_cost_model as j_quad_model
from ilqr_admm_tpu.problem import ILQRConfig as JConfig
from ilqr_admm_tpu.solvers import boxddp as jbd
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost as j_viapoint_cost
from ilqr_admm_tpu_torch.convert import (
    car_from_numpy,
    car_parking_cost_from_numpy,
    quadcost_from_numpy,
)
from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.ops.constrained_riccati import box_kkt_residual
from ilqr_admm_tpu_torch.ops.riccati import quad_cost_model
from ilqr_admm_tpu_torch.problem import ADMMConfig, ILQRConfig, SolveStatus, line_search_alphas
from ilqr_admm_tpu_torch.projections import project_bound
from ilqr_admm_tpu_torch.solvers import boxddp as tbd
from ilqr_admm_tpu_torch.solvers.ilqr import ilqr_init, ilqr_solve
from ilqr_admm_tpu_torch.solvers.lqt_admm import lqt_admm_batch

torch.set_num_threads(2)

TOL = 1e-8
N_LQ = 100
N_CAR = 40
_FLAT = jp.ilqr_backward_parallel


def _one_block(A, B, Cts, cts, **kw):
    kw["block_size"] = A.shape[0]
    return _FLAT(A, B, Cts, cts, **kw)


@pytest.fixture(autouse=True)
def jax_one_block_scan(monkeypatch):
    monkeypatch.setattr(jp, "ilqr_backward_parallel", _one_block)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _lq():
    """`tests/test_boxddp.py::_lq_setup`: 1-D double integrator, N = 100,
    terminal position 1 at weight 1e3, u_std 1e-2; both packages."""
    jplant = JDI(1, 2, dt=1.0 / N_LQ)
    jplant.get_AB = lambda xs, us: jplant.AB(xs.shape[0])
    zs = jnp.stack([jnp.zeros(2), jnp.asarray([1.0, 0.0])])
    Qs = jnp.stack([jnp.zeros((2, 2)), jnp.eye(2) * 1e3])
    seq = np.zeros(N_LQ, dtype=np.int32)
    seq[-1] = 1
    jcost = j_viapoint_cost(zs, Qs, seq, 1e-2, 1)
    tplant = DoubleIntegrator(1, 2, dt=1.0 / N_LQ, device="cpu", dtype=torch.float64)
    tcost = quadcost_from_numpy(np.asarray(jcost.Q), np.asarray(jcost.xd), np.asarray(jcost.R),
                                device="cpu", dtype=torch.float64)
    jfns = (jplant.step, jplant.get_AB,
            lambda xs, us: j_quad_model(jcost.Q, jcost.xd, jcost.R, xs, us), jcost)
    tfns = (tplant.step, lambda xs, us: tplant.AB(xs.shape[0]),
            lambda xs, us: quad_cost_model(tcost.Q, tcost.xd, tcost.R, xs, us), tcost)
    return jfns, tfns, tplant, tcost


def _solve_both(jfns, tfns, x0, u0, lo, hi, cfg, **kw):
    j_lo, j_hi = (jnp.asarray(b) if isinstance(b, np.ndarray) else b for b in (lo, hi))
    t_lo, t_hi = (torch.tensor(b) if isinstance(b, np.ndarray) else b for b in (lo, hi))
    st_j = jbd.boxddp_solve(*jfns, jbd.boxddp_init(jfns[0], jfns[3], jnp.asarray(x0),
                                                    jnp.asarray(u0), j_lo, j_hi),
                            j_lo, j_hi, cfg=JConfig(**cfg), **kw)
    st_t = tbd.boxddp_solve(*tfns, tbd.boxddp_init(tfns[0], tfns[3], torch.tensor(x0),
                                                    torch.tensor(u0), t_lo, t_hi, device="cpu"),
                            t_lo, t_hi, cfg=ILQRConfig(**cfg), **kw)
    return st_j, st_t


def _assert_same(st_t, st_j):
    assert st_t.status == int(st_j.status) and st_t.iteration == int(st_j.iteration)
    assert _rel(st_t.cost, st_j.cost) < TOL and _rel(st_t.u_nom, st_j.u_nom) < TOL
    assert _rel(st_t.x_nom, st_j.x_nom) < TOL


@pytest.mark.parametrize("riccati", ["seq", "parallel"])
def test_boxddp_golden_lq_matches_jax(riccati):
    jfns, tfns, _, _ = _lq()
    st_j, st_t = _solve_both(jfns, tfns, np.zeros(2), np.zeros((N_LQ, 1)), -5.0, 5.0,
                             dict(max_iter=60, tol_fun=1e-10), riccati=riccati)
    _assert_same(st_t, st_j)
    assert st_t.status == SolveStatus.CONVERGED
    assert float(st_t.u_nom.abs().max()) <= 5.0 + 1e-9  # exact feasibility
    assert float(st_t.u_nom.abs().max()) > 4.99  # the bound is active


def test_boxddp_meets_the_admm_golden():
    """`tests/test_boxddp.py::test_control_bounds_match_admm_golden` on the
    port: boxDDP and the lifted ADMM (`lqt_admm_batch`, |u| <= 5, 300
    iterations) agree on the optimum to 2e-3, and the unconstrained cost
    is lower (reference golden: 1.250e1 constrained, 1.237e1 without)."""
    _, tfns, plant, cost = _lq()
    A, B = plant.AB(N_LQ)
    x0 = torch.zeros(2, dtype=torch.float64)
    xf, uf, _ = lqt_admm_batch(A, B, cost, x0, project_u=lambda u: project_bound(u, -5.0, 5.0),
                               rho_u=1e-2, cfg=ADMMConfig(max_iter=300, tol=1e-6))
    c_admm = float(cost(xf.reshape(N_LQ, -1), uf.reshape(N_LQ, 1)))
    cfg = ILQRConfig(max_iter=60, tol_fun=1e-10)
    for riccati in ("seq", "parallel"):
        st = tbd.boxddp_solve(*tfns, tbd.boxddp_init(tfns[0], cost, x0, torch.zeros((N_LQ, 1),
                              dtype=torch.float64), -5.0, 5.0, device="cpu"), -5.0, 5.0, cfg=cfg,
                              riccati=riccati)
        assert abs(float(st.cost) - c_admm) < 2e-3 * max(1.0, abs(c_admm)), (float(st.cost), c_admm)
    st_u = ilqr_solve(*tfns, ilqr_init(tfns[0], cost, x0, torch.zeros((N_LQ, 1), dtype=torch.float64),
                                       device="cpu"), cfg=ILQRConfig(max_iter=30))
    assert float(st_u.cost) < float(st.cost)


def test_inactive_bounds_match_unconstrained():
    _, tfns, _, cost = _lq()
    x0 = torch.zeros(2, dtype=torch.float64)
    u0 = torch.zeros((N_LQ, 1), dtype=torch.float64)
    st_u = ilqr_solve(*tfns, ilqr_init(tfns[0], cost, x0, u0, device="cpu"),
                      cfg=ILQRConfig(max_iter=30))
    st_b = tbd.boxddp_solve(*tfns, tbd.boxddp_init(tfns[0], cost, x0, u0, -1e6, 1e6, device="cpu"), -1e6, 1e6,
                            cfg=ILQRConfig(max_iter=30))
    assert abs(float(st_b.cost) - float(st_u.cost)) < 1e-6 * max(1.0, float(st_u.cost))


def _car():
    jcar, jcost = JCar(dt=15.0 / N_CAR), JCost()
    tcar = car_from_numpy(jcar.dt, jcar.dist)
    tcost = car_parking_cost_from_numpy(jcost.cu, jcost.cf, jcost.pf, jcost.cx, jcost.px,
                                        device="cpu", dtype=torch.float64)
    jfns = (jcar.step, jcar.get_AB, jcost.get_Cs, jcost)
    tfns = (tcar.step, tcar.get_AB, tcost.get_Cs, tcost)
    u0 = np.random.default_rng(0).normal(size=(N_CAR, 2)) * 0.1
    return jfns, tfns, np.array([1.0, 1.0, 3.0 * np.pi / 2, 0.0]), u0


@pytest.mark.parametrize("riccati", ["seq", "parallel"])
def test_boxddp_car_matches_jax(riccati, monkeypatch):
    """The nonlinear car with per-dim bounds, one alpha (the full step):
    rejected steps raise the Levenberg-Marquardt regularization (x4 from
    reg_min), accepted ones lower it (/2), and the path must be JAX's
    step for step over 30 iterations."""
    rejected = []
    iterate = tbd.boxddp_iterate

    def spy(*args, **kw):
        out = iterate(*args, **kw)
        rejected.append(not bool(out[1]))
        return out

    monkeypatch.setattr(tbd, "boxddp_iterate", spy)
    jfns, tfns, x0, u0 = _car()
    lo, hi = np.array([-0.5, -2.0]), np.array([0.5, 2.0])
    st_j, st_t = _solve_both(jfns, tfns, x0, u0, lo, hi,
                             dict(max_iter=30, tol_fun=1e-9, max_line_search_iter=1),
                             riccati=riccati, reg_factor=4.0, reg_down=2.0, mask_iters=1)
    _assert_same(st_t, st_j)
    assert 5 < sum(rejected) < 25
    assert float((st_t.u_nom.abs() / torch.tensor(hi)).max()) <= 1.0 + 1e-12


def test_boxddp_parallel_car_certifies():
    """The parallel-backward solution of the car satisfies the sequential
    backward's KKT conditions (`box_kkt_residual`, the JAX package's
    certificate), as the sequential solve's does. At N = 40 the two
    solves end in different local minima of the nonconvex car (0.1311
    and 0.1347), so their costs are not compared."""
    _, tfns, x0, u0 = _car()
    lo, hi = torch.tensor([-0.5, -2.0]).double(), torch.tensor([0.5, 2.0]).double()
    st0 = tbd.boxddp_init(tfns[0], tfns[3], torch.tensor(x0), torch.tensor(u0), lo, hi,
                          device="cpu")
    cfg = ILQRConfig(max_iter=300, tol_fun=1e-12)
    st_s = tbd.boxddp_solve(*tfns, st0, lo, hi, cfg=cfg)
    st_p = tbd.boxddp_solve(*tfns, st0, lo, hi, cfg=cfg, riccati="parallel")
    for st in (st_p, st_s):
        assert st.status == SolveStatus.CONVERGED
        A, B = tfns[1](st.x_nom, st.u_nom)
        cts, Cts = tfns[2](st.x_nom, st.u_nom)
        assert float(box_kkt_residual(A, B, Cts, cts, st.u_nom, lo, hi)) <= 1e-6


@pytest.mark.parametrize("carry", [False, True])
def test_boxddp_iterate_matches_jax(carry):
    """One parallel iteration from the car's start, with and without a
    carried active set (then the set comes back as a fourth element)."""
    jfns, tfns, x0, u0 = _car()
    lo, hi = np.array([-0.5, -2.0]), np.array([0.5, 2.0])
    st_j = jbd.boxddp_init(jfns[0], jfns[3], jnp.asarray(x0), jnp.asarray(u0), jnp.asarray(lo),
                           jnp.asarray(hi))
    st_t = tbd.boxddp_init(tfns[0], tfns[3], torch.tensor(x0), torch.tensor(u0), torch.tensor(lo),
                           torch.tensor(hi), device="cpu")
    rng = np.random.default_rng(1)
    set_lo = rng.random((N_CAR, 2)) < 0.1
    set_hi = (rng.random((N_CAR, 2)) < 0.1) & ~set_lo
    alphas = np.asarray(line_search_alphas(ILQRConfig(max_line_search_iter=8), torch.float64))
    kw = dict(riccati="parallel", mask_iters=2, reg=0.1)
    out_j = jbd.boxddp_iterate(*jfns, st_j, jnp.asarray(alphas), jnp.asarray(lo), jnp.asarray(hi),
                               clamp=(jnp.asarray(set_lo), jnp.asarray(set_hi)) if carry else None,
                               **kw)
    out_t = tbd.boxddp_iterate(*tfns, st_t, torch.tensor(alphas), torch.tensor(lo),
                               torch.tensor(hi),
                               clamp=(torch.tensor(set_lo), torch.tensor(set_hi)) if carry else None,
                               **kw)
    assert len(out_t) == len(out_j) == (4 if carry else 3)
    assert bool(out_t[1]) == bool(out_j[1])
    assert _rel(out_t[0].u_nom, out_j[0].u_nom) < TOL and _rel(out_t[0].cost, out_j[0].cost) < TOL
    for g, w in zip(out_t[2], out_j[2]):
        assert _rel(g, w) < TOL
    if carry:
        for g, w in zip(out_t[3], out_j[3]):
            assert g.tolist() == np.asarray(w).tolist()


def test_boxddp_init_clips_and_iterate_validates():
    _, tfns, _, cost = _lq()
    u0 = torch.linspace(-8.0, 8.0, N_LQ, dtype=torch.float64)[:, None]
    st = tbd.boxddp_init(tfns[0], cost, torch.zeros(2, dtype=torch.float64), u0, -5.0, 5.0,
                         device="cpu")
    assert float(st.u_nom.abs().max()) == 5.0 and st.status == SolveStatus.RUNNING
    assert st.iteration == 0 and float(st.prev_cost) == float("inf")
    with pytest.raises(ValueError, match="riccati"):
        tbd.boxddp_iterate(*tfns, st, torch.ones(1, dtype=torch.float64), -5.0, 5.0,
                           riccati="blocked")


def test_boxddp_init_runs_on_the_card_unless_asked():
    """Without a device the solve runs on the card, from CPU inputs too:
    without a card that raises, never a quiet CPU solve."""
    _, tfns, _, cost = _lq()
    x0, u0 = torch.zeros(2, dtype=torch.float64), torch.zeros((N_LQ, 1), dtype=torch.float64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbd.boxddp_init(tfns[0], cost, x0, u0, -5.0, 5.0)
    st = tbd.boxddp_init(tfns[0], cost, x0.numpy(), u0.numpy(), -5.0, 5.0, device="cpu")
    assert st.x_nom.device.type == "cpu" and st.u_nom.device.type == "cpu"
