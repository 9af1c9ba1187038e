"""Port vs JAX package: receding-horizon MPC (`solvers/mpc.py`).

The ticks of `tests/test_mpc.py` go through both packages in float64 and
their applied controls must agree to 1e-7 relative to max|u|, tick for
tick: the DP tick (simple car, H = 40), the constrained tick in its dp
and SQP forms (H = 30, |u| <= 0.6, rho_u = 1, 2 outer x 5 ADMM
iterations) and the boxDDP tick with each backward (1-D double
integrator, N = 50, |u| <= 3), 10 ticks each, and `run_mpc` over 30
ticks with additive noise on a mismatched plant. The converters start
the port from a JAX state partway through a run. The fleet forms are
held to the port's own single ticks on 4 controllers. A tick reads
nothing on the host; with its reads forced back on it computes the same
bits and reads 12 times (2 outer steps x (1 + 5 ADMM iterations)).

JAX's parallel boxDDP backward runs its scans with one block (patched
`ilqr_backward_parallel`, as in `tests/test_torch_constrained_riccati.py`):
its flat scan aborts XLA:CPU in a process that has imported torch.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.models.car import CarSimple as JCar
from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator as JDI
from ilqr_admm_tpu.ops import parallel_riccati as jp
from ilqr_admm_tpu.ops.riccati import quad_cost_model as j_quad_model
from ilqr_admm_tpu.solvers import mpc as jm
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost as j_viapoint_cost
from ilqr_admm_tpu_torch.convert import (
    mpc_constrained_state_from_numpy,
    mpc_state_from_numpy,
    quadcost_from_numpy,
)
from ilqr_admm_tpu_torch.models.car import CarSimple
from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.ops.riccati import quad_cost_model
from ilqr_admm_tpu_torch.solvers import admm as tadmm
from ilqr_admm_tpu_torch.solvers import ilqr_admm as tia
from ilqr_admm_tpu_torch.solvers import mpc as tm

torch.set_num_threads(2)

TOL = 1e-7
U_MAX = 0.6
X0 = np.array([0.0, 0.0, 0.5, 0.0])
_FLAT = jp.ilqr_backward_parallel


def _one_block(A, B, Cts, cts, **kw):
    kw["block_size"] = A.shape[0]
    return _FLAT(A, B, Cts, cts, **kw)


@pytest.fixture(autouse=True)
def jax_one_block_scan(monkeypatch):
    monkeypatch.setattr(jp, "ilqr_backward_parallel", _one_block)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _err(got, want):
    """max |got - want| relative to max |want| (at least 1)."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def car_problem(H):
    """`tests/test_mpc.py`'s car: CarSimple(dt=0.1), via-point cost to
    (1, 1) with terminal weight 20, u_std 1e-2; both packages."""
    target = jnp.asarray([1.0, 1.0, 0.0, 0.0])
    Qs = jnp.stack([jnp.diag(jnp.asarray([1.0, 1.0, 0.0, 0.1])),
                    jnp.diag(jnp.asarray([20.0, 20.0, 0.0, 1.0]))])
    seq = np.zeros(H, dtype=np.int32)
    seq[-1] = 1
    jq = j_viapoint_cost(jnp.stack([target, target]), Qs, seq, 1e-2, 2)
    tq = quadcost_from_numpy(np.asarray(jq.Q), np.asarray(jq.xd), np.asarray(jq.R),
                             device="cpu", dtype=torch.float64)
    jcar, tcar = JCar(dt=0.1), CarSimple(dt=0.1)
    return (dict(f=jcar.step, get_AB=jcar.get_AB, quad=jq,
                 get_Cs=lambda xs, us: j_quad_model(jq.Q, jq.xd, jq.R, xs, us)),
            dict(f=tcar.step, get_AB=tcar.get_AB, quad=tq,
                 get_Cs=lambda xs, us: quad_cost_model(tq.Q, tq.xd, tq.R, xs, us)))


def constrained_steps(H, fleet=False, **kw):
    j, t = car_problem(H)
    common = dict(rho_u=1.0, n_outer_iters=2, n_admm_iters=5, **kw)
    jstep = jm.make_mpc_step_constrained(j["f"], j["get_AB"], j["quad"], get_Cs=j["get_Cs"],
                                         project_u=lambda u: jnp.clip(u, -U_MAX, U_MAX), **common)
    make = tm.make_mpc_fleet_step_constrained if fleet else tm.make_mpc_step_constrained
    tstep = make(t["f"], t["get_AB"], t["quad"], get_Cs=t["get_Cs"],
                 project_u=lambda u: torch.clamp(u, -U_MAX, U_MAX), **common)
    return j, t, jstep, tstep


def di_problem(N=50):
    """`tests/test_mpc.py`'s boxDDP plant: 1-D double integrator, N = 50,
    terminal position 1 at weight 1e3; both packages."""
    jplant = JDI(1, 2, dt=1.0 / N)
    zs = jnp.stack([jnp.zeros(2), jnp.asarray([1.0, 0.0])])
    Qs = jnp.stack([jnp.zeros((2, 2)), jnp.eye(2) * 1e3])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    jc = j_viapoint_cost(zs, Qs, seq, 1e-2, 1)
    A, B = jplant.AB(N)
    tplant = DoubleIntegrator(1, 2, dt=1.0 / N, device="cpu", dtype=torch.float64)
    tA, tB = tplant.AB(N)
    tc = quadcost_from_numpy(np.asarray(jc.Q), np.asarray(jc.xd), np.asarray(jc.R),
                             device="cpu", dtype=torch.float64)
    return (dict(f=lambda x, u: jplant.A @ x + jplant.B @ u, get_AB=lambda xs, us: (A, B), cost=jc,
                 get_Cs=lambda xs, us: j_quad_model(jc.Q, jc.xd, jc.R, xs, us)),
            dict(f=lambda x, u: tplant.A @ x + tplant.B @ u, get_AB=lambda xs, us: (tA, tB),
                 cost=tc, get_Cs=lambda xs, us: quad_cost_model(tc.Q, tc.xd, tc.R, xs, us)))


def _ticks(jstep, tstep, jf, tf, js, ts, x0, n):
    """n ticks of both packages on their own plants; the worst relative
    error of the applied u, and the final states."""
    xj, xt = jnp.asarray(x0), torch.tensor(x0)
    worst = 0.0
    for _ in range(n):
        uj, js = jstep(js, xj)
        ut, ts = tstep(ts, xt)
        worst = max(worst, _err(ut, uj))
        xj, xt = jf(xj, uj), tf(xt, ut)
    return worst, js, ts, xt


def test_dp_tick_matches_jax():
    j, t = car_problem(40)
    jstep = jm.make_mpc_step(j["f"], j["get_AB"], j["get_Cs"], j["quad"], n_ilqr_iters=2)
    tstep = tm.make_mpc_step(t["f"], t["get_AB"], t["get_Cs"], t["quad"], n_ilqr_iters=2)
    js = jm.mpc_init(j["f"], jnp.asarray(X0), jnp.zeros((40, 2)))
    ts = tm.mpc_init(t["f"], torch.tensor(X0), torch.zeros((40, 2), dtype=torch.float64),
                     device="cpu")
    assert _err(ts.x_nom, js.x_nom) < 1e-12
    worst, js, ts, _ = _ticks(jstep, tstep, j["f"], t["f"], js, ts, X0, 10)
    assert worst < TOL and _err(ts.u_nom, js.u_nom) < TOL


@pytest.mark.parametrize("kw", [dict(method="dp"), dict(method="batch", line_search="outer")],
                         ids=["dp", "sqp"])
def test_constrained_tick_matches_jax(kw):
    j, t, jstep, tstep = constrained_steps(30, **kw)
    js = jm.mpc_constrained_init(j["f"], jnp.asarray(X0), jnp.zeros((30, 2)))
    ts = tm.mpc_constrained_init(t["f"], torch.tensor(X0), torch.zeros((30, 2), dtype=torch.float64),
                                 device="cpu")
    worst, js, ts, _ = _ticks(jstep, tstep, j["f"], t["f"], js, ts, X0, 10)
    assert worst < TOL
    for name in ("u_nom", "z_u", "lmb_u"):
        assert _err(getattr(ts, name), getattr(js, name)) < TOL, name


@pytest.mark.parametrize("riccati", ["seq", "parallel"])
def test_boxddp_tick_matches_jax(riccati):
    j, t = di_problem()
    kw = dict(u_lower=-3.0, u_upper=3.0, n_iters=3, riccati=riccati)
    jstep = jm.make_mpc_step_boxddp(j["f"], j["get_AB"], j["cost"], j["get_Cs"], **kw)
    tstep = tm.make_mpc_step_boxddp(t["f"], t["get_AB"], t["cost"], t["get_Cs"], **kw)
    js = jm.mpc_init(j["f"], jnp.zeros(2), jnp.zeros((50, 1)))
    ts = tm.mpc_init(t["f"], torch.zeros(2, dtype=torch.float64),
                     torch.zeros((50, 1), dtype=torch.float64), device="cpu")
    worst, js, ts, _ = _ticks(jstep, tstep, j["f"], t["f"], js, ts, np.zeros(2), 10)
    assert worst < TOL and _err(ts.u_nom, js.u_nom) < TOL
    assert float(ts.u_nom.abs().max()) == 3.0  # the bound binds, exactly


def test_run_mpc_with_noise_on_a_mismatched_plant_matches_jax():
    """The DP tick (H = 40) over 30 ticks of a plant with dt = 0.105 and
    additive noise N(0, 1e-3) from default_rng(0)."""
    j, t = car_problem(40)
    jstep = jm.make_mpc_step(j["f"], j["get_AB"], j["get_Cs"], j["quad"], n_ilqr_iters=2)
    tstep = tm.make_mpc_step(t["f"], t["get_AB"], t["get_Cs"], t["quad"], n_ilqr_iters=2)
    ws = np.random.default_rng(0).normal(0, 1e-3, size=(30, 4))
    xs_j, us_j, st_j = jm.run_mpc(JCar(dt=0.105).step, jstep,
                                  jm.mpc_init(j["f"], jnp.asarray(X0), jnp.zeros((40, 2))),
                                  jnp.asarray(X0), 30, ws=jnp.asarray(ws))
    st0 = tm.mpc_init(t["f"], torch.tensor(X0), torch.zeros((40, 2), dtype=torch.float64),
                      device="cpu")
    xs_t, us_t, st_t = tm.run_mpc(CarSimple(dt=0.105).step, tstep, st0, torch.tensor(X0), 30,
                                  ws=torch.tensor(ws))
    assert xs_t.shape == (30, 4) and us_t.shape == (30, 2)
    assert _err(us_t, us_j) < TOL and _err(xs_t, xs_j) < TOL
    assert _err(st_t.u_nom, st_j.u_nom) < TOL


def test_ticks_start_from_a_jax_state():
    """Both packages continue a JAX run from its state after 5 ticks (the
    converters), 5 ticks more: the constrained dp tick and the DP tick."""
    j, t, jstep, tstep = constrained_steps(30)
    js = jm.mpc_constrained_init(j["f"], jnp.asarray(X0), jnp.zeros((30, 2)))
    x = jnp.asarray(X0)
    for _ in range(5):
        u, js = jstep(js, x)
        x = j["f"](x, u)
    ts = mpc_constrained_state_from_numpy(*(np.asarray(a) for a in js), device="cpu",
                                          dtype=torch.float64)
    assert isinstance(ts, tm.MPCConstrainedState) and ts.z_x.shape == (120,)
    worst, _, _, _ = _ticks(jstep, tstep, j["f"], t["f"], js, ts, np.asarray(x), 5)
    assert worst < TOL

    dstep_j = jm.make_mpc_step(j["f"], j["get_AB"], j["get_Cs"], j["quad"])
    dstep_t = tm.make_mpc_step(t["f"], t["get_AB"], t["get_Cs"], t["quad"])
    ds_j = jm.MPCState(x_nom=js.x_nom, u_nom=js.u_nom)
    ds = mpc_state_from_numpy(np.asarray(js.x_nom), np.asarray(js.u_nom), device="cpu",
                              dtype=torch.float64)
    worst, _, _, _ = _ticks(dstep_j, dstep_t, j["f"], t["f"], ds_j, ds, np.asarray(x), 5)
    assert worst < TOL


def _fleet_states(t, x0s, H, constrained):
    init = tm.mpc_constrained_init if constrained else tm.mpc_init
    states = [init(t["f"], torch.tensor(a), torch.zeros((H, 2), dtype=torch.float64), device="cpu")
              for a in x0s]
    return type(states[0])(*(torch.stack(z) for z in zip(*states)))


@pytest.mark.parametrize("tick", ["dp", "constrained-dp", "constrained-sqp"])
def test_fleet_tick_matches_single_ticks(tick):
    """The fleet of 4 controllers against 4 single ticks of the port, 3
    ticks, each on its own plant: to 1e-12."""
    H = 30
    x0s = X0 + np.random.default_rng(1).normal(0, 0.3, size=(4, 4))
    if tick == "dp":
        _, t = car_problem(H)
        args = (t["f"], t["get_AB"], t["get_Cs"], t["quad"])
        fleet, single = tm.make_mpc_fleet_step(*args), tm.make_mpc_step(*args)
    else:
        kw = dict(method="dp") if tick == "constrained-dp" else dict(method="batch",
                                                                   line_search="outer")
        _, t, _, single = constrained_steps(H, **kw)
        fleet = constrained_steps(H, fleet=True, **kw)[3]
    fs = _fleet_states(t, x0s, H, tick != "dp")
    singles = [type(fs)(*(f[i] for f in fs)) for i in range(4)]
    xf, xs = torch.tensor(x0s), [torch.tensor(a) for a in x0s]
    for _ in range(3):
        uf, fs = fleet(fs, xf)
        assert uf.shape == (4, 2)
        for i in range(4):
            ui, singles[i] = single(singles[i], xs[i])
            assert _err(uf[i], ui) < 1e-12, i
            xs[i] = t["f"](xs[i], ui)
        xf = torch.stack([t["f"](xf[i], uf[i]) for i in range(4)])
    for i in range(4):
        assert _err(fs.u_nom[i], singles[i].u_nom) < 1e-12


@pytest.mark.parametrize("fleet", [False, True])
@pytest.mark.parametrize("kw", [dict(method="dp"), dict(method="batch", line_search="outer")],
                         ids=["dp", "sqp"])
def test_constrained_tick_reads_nothing(kw, fleet, monkeypatch):
    """A constrained tick reads no stop flag on the host. Forced to read
    them (as a tolerance > 0 would), it reads 12 a tick (2 outer steps x
    (1 + 5 ADMM iterations)) and computes the same bits."""
    H = 30
    _, t, _, step = constrained_steps(H, fleet=fleet, **kw)
    if fleet:
        st = _fleet_states(t, X0 + np.random.default_rng(2).normal(0, 0.3, size=(3, 4)), H, True)
        x = st.x_nom[:, 0]
    else:
        st = tm.mpc_constrained_init(t["f"], torch.tensor(X0), torch.zeros((H, 2), dtype=torch.float64),
                                     device="cpu")
        x = torch.tensor(X0)
    before = tadmm.host_sync_count
    u_quiet, st_quiet = step(st, x)
    u_quiet, st_quiet = step(st_quiet, x)
    assert tadmm.host_sync_count == before
    forced = (tadmm, "can_stop", lambda cfg: True), (tia, "outer_can_stop", lambda a, b: True)
    for module, name, value in forced:
        monkeypatch.setattr(module, name, value)
    if fleet:
        from ilqr_admm_tpu_torch.solvers import batched_ilqr_admm as tbia

        monkeypatch.setattr(tbia, "outer_can_stop", lambda a, b: True)
    before = tadmm.host_sync_count
    u_read, st_read = step(st, x)
    u_read, st_read = step(st_read, x)
    assert tadmm.host_sync_count - before == 2 * 12
    assert torch.equal(u_quiet, u_read)
    for a, b in zip(st_quiet, st_read):
        assert torch.equal(a, b)


def test_entry_points_validate():
    _, t = car_problem(30)
    with pytest.raises(ValueError, match="n_outer_iters"):
        tm.make_mpc_step_constrained(t["f"], t["get_AB"], t["quad"], n_outer_iters=0)
    with pytest.raises(ValueError, match="n_outer_iters"):
        tm.make_mpc_fleet_step_constrained(t["f"], t["get_AB"], t["quad"], n_admm_iters=0)
    with pytest.raises(ValueError, match="n_iters"):
        tm.make_mpc_step_boxddp(t["f"], t["get_AB"], t["quad"], t["get_Cs"], -1.0, 1.0, n_iters=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.mpc_init(t["f"], torch.tensor(X0), torch.zeros((30, 2)))
    st = tm.mpc_constrained_init(t["f"], torch.tensor(X0), torch.zeros((30, 2), dtype=torch.float64),
                                 device="cpu")
    assert torch.equal(st.z_x, st.x_nom.reshape(-1)) and not st.lmb_u.any()
    v = torch.arange(12.0)
    assert tm._shift_flat(v, 4, 3).tolist() == list(range(3, 12)) + [9.0, 10.0, 11.0]
