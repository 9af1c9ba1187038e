"""Port vs JAX package: the MPC fleets and the closed loop of `run_mpc`
(`solvers/mpc.py`, `solvers/boxddp.py`).

In float64, against `jax.vmap` of the JAX package on 4 controllers or
instances, to 1e-7 relative to max|u| (`tests/test_torch_mpc.py`'s TOL):

- the boxDDP fleet tick (`make_mpc_fleet_step_boxddp`, `torch.func.vmap`
  of the tick) with each backward over 5 ticks, and `boxddp_fleet_solve`
  with each backward: the time-parallel box backward under vmap, with
  the cost's Hessian shared by the fleet and each instance's own
  regularization;
- `run_mpc` with every fleet tick (DP, constrained dp and SQP on the car
  of `car_problem(30)`, boxDDP with each backward on `di_problem()`) and
  a vmapped plant over 10 ticks with per-controller noise. JAX's outputs
  are (F, n, .) and the port's (n, F, .).

Beside them: `run_mpc` over 0 ticks (JAX's empty logs), graph=True on
the CPU (refused), and the fleet ticks read nothing on the host.

JAX's parallel boxDDP backward runs its scans with one block (the fixture
imported from `tests/test_torch_mpc.py`): its flat scan aborts XLA:CPU in
a process that has imported torch.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from ilqr_admm_tpu.models.car import CarSimple as JCar
from ilqr_admm_tpu.problem import ILQRConfig as JConfig
from ilqr_admm_tpu.solvers import boxddp as jbd
from ilqr_admm_tpu.solvers import mpc as jm
from ilqr_admm_tpu_torch.models.car import CarSimple
from ilqr_admm_tpu_torch.problem import ILQRConfig
from ilqr_admm_tpu_torch.solvers import admm as tadmm
from ilqr_admm_tpu_torch.solvers import boxddp as tbd
from ilqr_admm_tpu_torch.solvers import mpc as tm
from test_torch_batch import _same_stops
from test_torch_mpc import (  # noqa: F401 (jax_one_block_scan is a fixture)
    TOL,
    X0,
    _err,
    _fleet_states,
    car_problem,
    constrained_steps,
    di_problem,
    jax_one_block_scan,
)

torch.set_num_threads(2)

F = 4
N_BOX = 50
U_BOX = 3.0
H_CAR = 30
TICKS = 10
FLEET_TICKS = ("dp", "constrained-dp", "constrained-sqp", "boxddp-seq", "boxddp-parallel")


def _box_kw(riccati):
    return dict(u_lower=-U_BOX, u_upper=U_BOX, n_iters=3, riccati=riccati)


def _box_x0s():
    return np.random.default_rng(0).normal(0, 0.3, size=(F, 2))


def _car_x0s():
    return X0 + np.random.default_rng(1).normal(0, 0.3, size=(F, 4))


def _box_states(t, x0s):
    states = [tm.mpc_init(t["f"], torch.tensor(a), torch.zeros((N_BOX, 1), dtype=torch.float64),
                          device="cpu") for a in x0s]
    return tm.MPCState(*(torch.stack(z) for z in zip(*states)))


def _jax_states(j, x0s, H, m, constrained=False):
    init = jm.mpc_constrained_init if constrained else jm.mpc_init
    return jax.vmap(lambda a: init(j["f"], a, jnp.zeros((H, m))))(jnp.asarray(x0s))


def fleet_case(tick):
    """A fleet tick of both packages, the plants, the starts and the
    initial states: (jstep, jf, js, tstep, tf, ts, x0s)."""
    if tick.startswith("boxddp"):
        j, t = di_problem(N_BOX)
        kw = _box_kw(tick.split("-")[1])
        jstep = jm.make_mpc_step_boxddp(j["f"], j["get_AB"], j["cost"], j["get_Cs"], **kw)
        tstep = tm.make_mpc_fleet_step_boxddp(t["f"], t["get_AB"], t["cost"], t["get_Cs"], **kw)
        x0s = _box_x0s()
        return jstep, j["f"], _jax_states(j, x0s, N_BOX, 1), tstep, t["f"], _box_states(t, x0s), x0s
    x0s = _car_x0s()
    if tick == "dp":
        j, t = car_problem(H_CAR)
        jstep = jm.make_mpc_step(j["f"], j["get_AB"], j["get_Cs"], j["quad"])
        tstep = tm.make_mpc_fleet_step(t["f"], t["get_AB"], t["get_Cs"], t["quad"])
        constrained = False
    else:
        kw = dict(method="dp") if tick == "constrained-dp" else dict(method="batch",
                                                                   line_search="outer")
        j, t, jstep, _ = constrained_steps(H_CAR, **kw)
        tstep = constrained_steps(H_CAR, fleet=True, **kw)[3]
        constrained = True
    return (jstep, j["f"], _jax_states(j, x0s, H_CAR, 2, constrained), tstep, t["f"],
            _fleet_states(t, x0s, H_CAR, constrained), x0s)


@pytest.mark.parametrize("riccati", ["seq", "parallel"])
def test_boxddp_fleet_tick_matches_jax(riccati):
    """`torch.func.vmap` of the boxDDP tick against `jax.vmap` of JAX's,
    4 controllers, 5 ticks, each on its own plant."""
    jstep, jf, js, tstep, tf, ts, x0s = fleet_case(f"boxddp-{riccati}")
    jstep, jf = jax.vmap(jstep), jax.vmap(jf)
    xj, xt = jnp.asarray(x0s), torch.tensor(x0s)
    for _ in range(5):
        uj, js = jstep(js, xj)
        ut, ts = tstep(ts, xt)
        assert ut.shape == (F, 1)
        assert _err(ut, uj) < TOL
        xj, xt = jf(xj, uj), vmap(tf)(xt, ut)
    assert _err(ts.u_nom, js.u_nom) < TOL and _err(ts.x_nom, js.x_nom) < TOL
    assert float(ts.u_nom.abs().max()) <= U_BOX


@pytest.mark.parametrize("riccati", ["seq", "parallel"])
def test_boxddp_fleet_solve_matches_jax(riccati):
    """`boxddp_fleet_solve` on 4 instances of `di_problem()` against
    `jax.vmap` of JAX's `boxddp_solve`: costs, controls and stops."""
    j, t = di_problem(N_BOX)
    x0s = _box_x0s()

    def jax_solve(x0):
        st = jbd.boxddp_init(j["f"], j["cost"], x0, jnp.zeros((N_BOX, 1)), -U_BOX, U_BOX)
        return jbd.boxddp_solve(j["f"], j["get_AB"], j["get_Cs"], j["cost"], st, -U_BOX, U_BOX,
                                cfg=JConfig(), riccati=riccati)

    want = jax.vmap(jax_solve)(jnp.asarray(x0s))
    st0 = tbd.boxddp_fleet_init(t["f"], t["cost"], torch.tensor(x0s),
                                torch.zeros((F, N_BOX, 1), dtype=torch.float64), -U_BOX, U_BOX,
                                device="cpu")
    got = tbd.boxddp_fleet_solve(t["f"], t["get_AB"], t["get_Cs"], t["cost"], st0, -U_BOX, U_BOX,
                                 cfg=ILQRConfig(), riccati=riccati)
    _same_stops(got.status, want.status)
    assert _err(got.cost, want.cost) < TOL
    assert _err(got.u_nom, want.u_nom) < TOL
    assert float(got.u_nom.abs().max()) <= U_BOX


@pytest.mark.parametrize("tick", FLEET_TICKS)
def test_run_mpc_fleet_matches_jax(tick):
    """`run_mpc` (the eager loop, the body the graph captures) with the
    fleet tick and a vmapped plant against `jax.vmap` of JAX's `run_mpc`:
    4 controllers, 10 ticks, noise N(0, 1e-3^2) of shape (n, F, d)."""
    jstep, jf, js, tstep, tf, ts, x0s = fleet_case(tick)
    d = x0s.shape[-1]
    ws = np.random.default_rng(2).normal(0, 1e-3, size=(TICKS, F, d))
    xs_j, us_j, st_j = jax.vmap(lambda st, x0, w: jm.run_mpc(jf, jstep, st, x0, TICKS, ws=w))(
        js, jnp.asarray(x0s), jnp.asarray(ws.transpose(1, 0, 2)))
    stats = {}
    xs_t, us_t, st_t = tm.run_mpc(vmap(tf), tstep, ts, torch.tensor(x0s), TICKS,
                                  ws=torch.tensor(ws), stats=stats)
    m = us_t.shape[-1]
    assert xs_t.shape == (TICKS, F, d) and us_t.shape == (TICKS, F, m)
    assert type(st_t) is type(ts) and stats == {"capture_seconds": 0.0}
    assert _err(us_t.transpose(0, 1), us_j) < TOL
    assert _err(xs_t.transpose(0, 1), xs_j) < TOL
    assert _err(st_t.u_nom, st_j.u_nom) < TOL


@pytest.mark.parametrize("fleet", [False, True])
def test_run_mpc_of_no_ticks(fleet):
    """n_steps = 0: JAX's empty logs, (0, [F,] d) and (0, [F,] m), and the
    state it was given."""
    j, t = car_problem(H_CAR)
    jstep = jm.make_mpc_step(j["f"], j["get_AB"], j["get_Cs"], j["quad"])
    x0s = _car_x0s()
    if fleet:
        js = _jax_states(j, x0s, H_CAR, 2)
        xs_j, us_j, _ = jax.vmap(lambda st, x0: jm.run_mpc(j["f"], jstep, st, x0, 0))(
            js, jnp.asarray(x0s))
        want = (0, *np.asarray(xs_j).shape[:1], *np.asarray(xs_j).shape[2:]), \
            (0, *np.asarray(us_j).shape[:1], *np.asarray(us_j).shape[2:])
        tstep = tm.make_mpc_fleet_step(t["f"], t["get_AB"], t["get_Cs"], t["quad"])
        ts, x0 = _fleet_states(t, x0s, H_CAR, False), torch.tensor(x0s)
    else:
        xs_j, us_j, _ = jm.run_mpc(j["f"], jstep, jm.mpc_init(j["f"], jnp.asarray(X0),
                                                                jnp.zeros((H_CAR, 2))),
                                   jnp.asarray(X0), 0)
        want = np.asarray(xs_j).shape, np.asarray(us_j).shape
        tstep = tm.make_mpc_step(t["f"], t["get_AB"], t["get_Cs"], t["quad"])
        ts = tm.mpc_init(t["f"], torch.tensor(X0), torch.zeros((H_CAR, 2), dtype=torch.float64),
                         device="cpu")
        x0 = torch.tensor(X0)
    assert want == (((0, F, 4), (0, F, 2)) if fleet else ((0, 4), (0, 2)))
    xs, us, st = tm.run_mpc(t["f"], tstep, ts, x0, 0)
    assert (tuple(xs.shape), tuple(us.shape)) == want
    assert xs.dtype == us.dtype == torch.float64
    assert all(a is b for a, b in zip(st, ts))


def test_run_mpc_graph_needs_the_card():
    """graph=True captures a CUDA graph: a state on the CPU is refused
    before any tick runs."""
    _, t = car_problem(H_CAR)
    step = tm.make_mpc_step(t["f"], t["get_AB"], t["get_Cs"], t["quad"])
    ts = tm.mpc_init(t["f"], torch.tensor(X0), torch.zeros((H_CAR, 2), dtype=torch.float64),
                     device="cpu")
    with pytest.raises(ValueError, match="CUDA graph"):
        tm.run_mpc(CarSimple(dt=0.1).step, step, ts, torch.tensor(X0), 3, graph=True)


_READS = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__")


@contextlib.contextmanager
def _host_reads(monkeypatch):
    """Count every call that takes a tensor's value to the host."""
    count = {"n": 0}
    for name in _READS:
        original = getattr(torch.Tensor, name)

        def counted(self, *a, _original=original, **kw):
            count["n"] += 1
            return _original(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    yield count
    for name in _READS:
        monkeypatch.undo()


@pytest.mark.parametrize("tick", FLEET_TICKS)
def test_fleet_tick_reads_nothing(tick, monkeypatch):
    """A fleet tick reads no stop flag (`admm.host_sync_count`) and no
    tensor value on the host, over two ticks of the closed loop."""
    _, _, _, tstep, tf, ts, x0s = fleet_case(tick)
    x = torch.tensor(x0s)
    before = tadmm.host_sync_count
    with _host_reads(monkeypatch) as reads:
        u, ts = tstep(ts, x)
        x = vmap(tf)(x, u)
        u, ts = tstep(ts, x)
    assert reads["n"] == 0
    assert tadmm.host_sync_count == before
    assert u.shape == (F, ts.u_nom.shape[-1])
