"""The fleet DP solvers: `ilqr_fleet_solve` and `boxddp_fleet_solve`
(`solvers/ilqr.py`, `solvers/boxddp.py`, the loop in `solvers/fleet.py`)
against `jax.vmap` of the JAX package's single solvers and against the
port's own single solves, in float64.

The problems: the control-limited car of `tests/test_torch_boxddp.py`
(CarFrontWheel, N = 40, per-dimension bounds, the parking cost by
autodiff, full steps only so that about half the iterations are retried
at a higher regularization) for boxDDP with the sequential and the
time-parallel backward, and the same car without bounds for iLQR.
Against JAX: cost to 1e-10 relative, trajectories to 1e-8, statuses and
iteration counts equal. Against the port's single solves: the
time-parallel backward bit for bit; the sequential backward and iLQR to
1e-12 (vmap turns a stage's small matrix products into batched GEMMs,
which may round apart in f64).

Beside them: an instance that stops keeps its state while the rest run
on, a solve reads one flag an iteration whatever F, the stage solvers
(`boxqp`, `boxqp_enum`, `ilqr_backward_box(_parallel)`) run under vmap,
and the CUDA-graph option refuses the CPU.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.func import vmap

from ilqr_admm_tpu.models.car import CarFrontWheel as JCar, CarParkingCost as JCost
from ilqr_admm_tpu.ops import parallel_riccati as jp
from ilqr_admm_tpu.problem import ILQRConfig as JConfig
from ilqr_admm_tpu.solvers import boxddp as jbd
from ilqr_admm_tpu.solvers import ilqr as jil
from ilqr_admm_tpu_torch.convert import car_from_numpy, car_parking_cost_from_numpy
from ilqr_admm_tpu_torch.ops.boxqp import boxqp, boxqp_enum
from ilqr_admm_tpu_torch.ops.constrained_riccati import (
    ilqr_backward_box,
    ilqr_backward_box_parallel,
)
from ilqr_admm_tpu_torch.problem import ILQRConfig
from ilqr_admm_tpu_torch.solvers import admm
from ilqr_admm_tpu_torch.solvers import boxddp as tbd
from ilqr_admm_tpu_torch.solvers import ilqr as til

torch.set_num_threads(2)

COST_TOL = 1e-10
TRAJ_TOL = 1e-8
SINGLE_TOL = 1e-12
F64 = torch.float64
N = 40
_FLAT = jp.ilqr_backward_parallel


def _one_block(A, B, Cts, cts, **kw):
    kw["block_size"] = A.shape[0]
    return _FLAT(A, B, Cts, cts, **kw)


@pytest.fixture(autouse=True)
def jax_one_block_scan(monkeypatch):
    """JAX's parallel pass with one block: its flat scan aborts XLA:CPU in a
    process that has imported torch (`tests/test_torch_boxddp.py`)."""
    monkeypatch.setattr(jp, "ilqr_backward_parallel", _one_block)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _car():
    jcar, jcost = JCar(dt=15.0 / N), JCost()
    tcar = car_from_numpy(jcar.dt, jcar.dist)
    tcost = car_parking_cost_from_numpy(*(np.asarray(getattr(jcost, k))
                                          for k in ("cu", "cf", "pf", "cx", "px")),
                                        device="cpu", dtype=F64)
    return ((jcar.step, jcar.get_AB, jcost.get_Cs, jcost),
            (tcar.step, tcar.get_AB, tcost.get_Cs, tcost))


def _fleet(F, seed=0):
    rng = np.random.default_rng(seed)
    x0s = np.array([1.0, 1.0, 3 * np.pi / 2, 0.0]) + rng.normal(0, 0.05, (F, 4))
    u0s = np.broadcast_to(rng.normal(size=(N, 2)) * 0.1, (F, N, 2)).copy()
    return x0s, u0s


LO, HI = np.array([-0.5, -2.0]), np.array([0.5, 2.0])
# `tests/test_torch_boxddp.py::test_boxddp_car_matches_jax`'s schedule:
# full steps only, so about half the iterations are rejected and retried
BOX_CFG = dict(max_iter=30, tol_fun=1e-9, max_line_search_iter=1)
BOX_KW = dict(reg_factor=4.0, reg_down=2.0, qp_iters=8)


def _box_fleet(tfns, x0s, u0s, riccati, cfg=BOX_CFG, **kw):
    st = tbd.boxddp_fleet_init(tfns[0], tfns[3], torch.tensor(x0s), torch.tensor(u0s),
                               torch.tensor(LO), torch.tensor(HI), device="cpu")
    return tbd.boxddp_fleet_solve(*tfns, st, torch.tensor(LO), torch.tensor(HI),
                                  cfg=ILQRConfig(**cfg), riccati=riccati, **BOX_KW, **kw)


def _box_single(tfns, x0, u0, riccati, cfg=BOX_CFG):
    st = tbd.boxddp_init(tfns[0], tfns[3], torch.tensor(x0), torch.tensor(u0), torch.tensor(LO),
                         torch.tensor(HI), device="cpu")
    return tbd.boxddp_solve(*tfns, st, torch.tensor(LO), torch.tensor(HI),
                            cfg=ILQRConfig(**cfg), riccati=riccati, **BOX_KW)


@pytest.mark.parametrize("riccati", ["seq", "parallel"])
def test_boxddp_fleet_matches_jax_vmap(riccati):
    jfns, tfns = _car()
    x0s, u0s = _fleet(6)
    lo, hi = jnp.asarray(LO), jnp.asarray(HI)

    def one(x0, u0):
        st = jbd.boxddp_init(jfns[0], jfns[3], x0, u0, lo, hi)
        return jbd.boxddp_solve(*jfns, st, lo, hi, cfg=JConfig(**BOX_CFG), riccati=riccati,
                                **BOX_KW)

    want = jax.vmap(one)(jnp.asarray(x0s), jnp.asarray(u0s))
    got = _box_fleet(tfns, x0s, u0s, riccati)
    assert got.status.tolist() == np.asarray(want.status).tolist()
    assert got.iteration.tolist() == np.asarray(want.iteration).tolist()
    assert _rel(got.cost, want.cost) < COST_TOL
    assert _rel(got.u_nom, want.u_nom) < TRAJ_TOL and _rel(got.x_nom, want.x_nom) < TRAJ_TOL
    assert float(got.u_nom[..., 0].abs().max()) <= 0.5 and float(got.u_nom[..., 1].abs().max()) <= 2


@pytest.mark.parametrize("riccati", ["seq", "parallel"])
def test_boxddp_fleet_matches_single_solves(riccati):
    _, tfns = _car()
    x0s, u0s = _fleet(4, seed=1)
    fleet = _box_fleet(tfns, x0s, u0s, riccati)
    for i in range(4):
        one = _box_single(tfns, x0s[i], u0s[i], riccati)
        assert int(fleet.status[i]) == one.status and int(fleet.iteration[i]) == one.iteration
        if riccati == "parallel":
            assert torch.equal(fleet.u_nom[i], one.u_nom) and torch.equal(fleet.cost[i], one.cost)
        else:
            assert abs(float(fleet.cost[i] - one.cost)) <= SINGLE_TOL * float(one.cost)
            assert _rel(fleet.u_nom[i], one.u_nom) < SINGLE_TOL


def test_ilqr_fleet_matches_jax_vmap_and_single_solves():
    jfns, tfns = _car()
    x0s, u0s = _fleet(5, seed=2)
    cfg = dict(max_iter=20, tol_fun=1e-8, max_line_search_iter=20)

    def one(x0, u0):
        return jil.ilqr_solve(*jfns, jil.ilqr_init(jfns[0], jfns[3], x0, u0), JConfig(**cfg))

    want = jax.vmap(one)(jnp.asarray(x0s), jnp.asarray(u0s))
    st = til.ilqr_fleet_init(tfns[0], tfns[3], torch.tensor(x0s), torch.tensor(u0s),
                             device="cpu")
    got = til.ilqr_fleet_solve(*tfns, st, ILQRConfig(**cfg))
    assert got.status.tolist() == np.asarray(want.status).tolist()
    assert got.iteration.tolist() == np.asarray(want.iteration).tolist()
    assert _rel(got.cost, want.cost) < COST_TOL and _rel(got.u_nom, want.u_nom) < TRAJ_TOL
    for i in range(5):
        single = til.ilqr_solve(*tfns, til.ilqr_init(tfns[0], tfns[3], torch.tensor(x0s[i]),
                                                     torch.tensor(u0s[i]), device="cpu"),
                                ILQRConfig(**cfg))
        assert int(got.status[i]) == single.status and int(got.iteration[i]) == single.iteration
        assert abs(float(got.cost[i] - single.cost)) <= SINGLE_TOL * float(single.cost)
        assert _rel(got.u_nom[i], single.u_nom) < SINGLE_TOL


def test_a_stopped_instance_keeps_its_state():
    """Instance 0 starts parked (x0 = 0, u = 0, the cost's minimum): every
    step is rejected until the regularization runs out, and it stops
    first. Rerunning the fleet with the cap at its stop iteration gives
    its state bit for bit, so later iterations never touched it."""
    _, tfns = _car()
    x0s, u0s = _fleet(4, seed=3)
    x0s[0], u0s[0] = 0.0, 0.0
    full = _box_fleet(tfns, x0s, u0s, "parallel")
    k0 = int(full.iteration[0])
    assert k0 < int(full.iteration.max())  # it stopped while others ran on
    cut = _box_fleet(tfns, x0s, u0s, "parallel", cfg=dict(BOX_CFG, max_iter=k0))
    for name in ("x_nom", "u_nom", "cost", "prev_cost", "iteration", "status"):
        assert torch.equal(getattr(full, name)[0], getattr(cut, name)[0]), name


def test_host_reads_do_not_grow_with_the_fleet():
    """One read an iteration for the whole fleet, none after the cap's
    last iteration: F copies of one instance read as often as it alone."""
    _, tfns = _car()
    x0s, u0s = _fleet(1, seed=4)
    counts = []
    for F in (1, 5):
        stats = {}
        r0 = admm.host_sync_count
        out = _box_fleet(tfns, np.repeat(x0s, F, 0), np.repeat(u0s, F, 0), "parallel",
                         stats=stats)
        counts.append((admm.host_sync_count - r0, stats["host_reads"], stats["iterations"]))
        k = int(out.iteration.max())
        assert stats["iterations"] == k
        assert stats["host_reads"] == min(k, BOX_CFG["max_iter"] - 1)
    assert counts[0] == counts[1]
    assert counts[0][0] == counts[0][1]


def test_graph_needs_the_card():
    _, tfns = _car()
    x0s, u0s = _fleet(2)
    with pytest.raises(ValueError, match="CUDA graph"):
        _box_fleet(tfns, x0s, u0s, "seq", graph=True)
    st = tbd.boxddp_init(tfns[0], tfns[3], torch.tensor(x0s[0]), torch.tensor(u0s[0]),
                         torch.tensor(LO), torch.tensor(HI), device="cpu")
    with pytest.raises(ValueError, match="CUDA graph"):
        tbd.boxddp_solve(*tfns, st, torch.tensor(LO), torch.tensor(HI), graph=True)


def _random_qps(n, m, seed):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, m, m))
    H = torch.tensor(M @ M.transpose(0, 2, 1) + 0.5 * np.eye(m))
    g = torch.tensor(rng.normal(size=(n, m)) * 3.0)
    return H, g, torch.tensor(-np.abs(rng.normal(size=(n, m)))), torch.tensor(
        np.abs(rng.normal(size=(n, m))))


@pytest.mark.parametrize("solver", ["newton", "enum"])
def test_box_qps_run_under_vmap(solver):
    H, g, lb, ub = _random_qps(6, 2, 5)
    fn = boxqp if solver == "newton" else boxqp_enum
    u_v, free_v = vmap(fn)(H, g, lb, ub)
    for i in range(6):
        u, free = fn(H[i], g[i], lb[i], ub[i])
        assert torch.equal(free_v[i], free)
        assert float((u_v[i] - u).abs().max()) < 1e-12


@pytest.mark.parametrize("parallel", [False, True])
def test_box_backward_passes_run_under_vmap(parallel):
    _, tfns = _car()
    x0s, u0s = _fleet(3, seed=6)
    st = tbd.boxddp_fleet_init(tfns[0], tfns[3], torch.tensor(x0s), torch.tensor(u0s),
                               torch.tensor(LO), torch.tensor(HI), device="cpu")
    A, B = vmap(tfns[1])(st.x_nom, st.u_nom)
    cts, Cts = vmap(tfns[2])(st.x_nom, st.u_nom)
    lo, hi = torch.tensor(LO), torch.tensor(HI)

    def back(A_, B_, C_, c_, u_):
        if parallel:
            return ilqr_backward_box_parallel(A_, B_, C_, c_, u_, lo, hi, mask_iters=2)
        return ilqr_backward_box(A_, B_, C_, c_, u_, lo, hi)

    K_v, k_v = vmap(back)(A, B, Cts, cts, st.u_nom)
    for i in range(3):
        K, k = back(A[i], B[i], Cts[i], cts[i], st.u_nom[i])
        assert float((K_v[i] - K).abs().max()) < 1e-10 and float((k_v[i] - k).abs().max()) < 1e-10
