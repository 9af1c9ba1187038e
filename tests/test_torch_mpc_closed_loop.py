"""The port's receding-horizon closed loops against `tests/test_mpc.py`'s
own gates, in float64 on the CPU: the DP tick tracks its target under
process noise, and a fleet of its ticks batches; the constrained dp and
SQP ticks hold |u| <= 0.6 at every tick, the bound binds, and the car
parks (the SQP tick within 0.05); the boxDDP tick, each backward, holds
|u| <= 3 exactly, reaches the target within 0.05 and, sequential, stays
there (no limit cycle) with the bound binding in the transient.
"""

import numpy as np
import pytest
import torch

from ilqr_admm_tpu_torch.models.car import CarSimple
from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.ops.riccati import quad_cost_model
from ilqr_admm_tpu_torch.solvers import mpc as tm
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost

torch.set_num_threads(2)

F64 = dict(dtype=torch.float64, device="cpu")
X0 = torch.tensor([0.0, 0.0, 0.5, 0.0], **F64)
TARGET = torch.tensor([1.0, 1.0], **F64)


def car_cost(H):
    target = torch.tensor([1.0, 1.0, 0.0, 0.0], **F64)
    Qs = torch.stack([torch.diag(torch.tensor([1.0, 1.0, 0.0, 0.1], **F64)),
                      torch.diag(torch.tensor([20.0, 20.0, 0.0, 1.0], **F64))])
    seq = np.zeros(H, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(torch.stack([target, target]), Qs, seq, 1e-2, 2)
    return quad, lambda xs, us: quad_cost_model(quad.Q, quad.xd, quad.R, xs, us)


def test_mpc_tracks_target_under_disturbance():
    H, car = 40, CarSimple(dt=0.1)
    quad, get_Cs = car_cost(H)
    step = tm.make_mpc_step(car.step, car.get_AB, get_Cs, quad, n_ilqr_iters=2)
    state = tm.mpc_init(car.step, X0, torch.zeros((H, 2), **F64), device="cpu")
    rng = np.random.default_rng(0)
    ws = torch.tensor(rng.normal(0, 1e-3, size=(60, 4)))
    xs, us, _ = tm.run_mpc(car.step, step, state, X0, 60, ws=ws)
    assert float(torch.linalg.norm(xs[-1, :2] - TARGET)) < 0.2, xs[-1]
    # a fleet of controllers: the vmapped tick
    x0s = torch.tensor(rng.normal(0, 0.1, size=(4, 4)))
    states = tm.MPCState(*(torch.stack(z) for z in zip(
        *[tm.mpc_init(car.step, a, torch.zeros((H, 2), **F64), device="cpu") for a in x0s])))
    us_b, states_b = tm.make_mpc_fleet_step(car.step, car.get_AB, get_Cs, quad)(states, x0s)
    assert us_b.shape == (4, 2) and states_b.u_nom.shape == (4, H, 2)


@pytest.mark.parametrize("kw,park", [(dict(method="dp"), 0.25),
                                     (dict(method="batch", line_search="outer"), 0.05)],
                         ids=["dp", "sqp"])
def test_constrained_mpc_respects_control_bounds(kw, park):
    H, car, u_max = 30, CarSimple(dt=0.1), 0.6
    quad, get_Cs = car_cost(H)
    step = tm.make_mpc_step_constrained(car.step, car.get_AB, quad, get_Cs=get_Cs,
                                        project_u=lambda u: torch.clamp(u, -u_max, u_max),
                                        rho_u=1.0, n_outer_iters=2, n_admm_iters=5, **kw)
    state = tm.mpc_constrained_init(car.step, X0, torch.zeros((H, 2), **F64), device="cpu")
    x, us, z_u_first = X0, [], None
    for t in range(50):
        u, state = step(state, x)
        if t == 0:
            z_u_first = state.z_u.clone()
        us.append(u)
        x = car.step(x, u)
    u_abs = float(torch.stack(us).abs().max())
    assert u_abs <= u_max + 1e-3 and u_abs > 0.9 * u_max  # held, and binding
    assert float(torch.linalg.norm(x[:2] - TARGET)) < park, x
    assert not torch.allclose(state.z_u, z_u_first)  # the duals are carried


def _di(N=50):
    plant = DoubleIntegrator(1, 2, dt=1.0 / N, **F64)
    zs = torch.stack([torch.zeros(2, **F64), torch.tensor([1.0, 0.0], **F64)])
    Qs = torch.stack([torch.zeros((2, 2), **F64), torch.eye(2, **F64) * 1e3])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, 1)
    A, B = plant.AB(N)
    return (lambda x, u: plant.A @ x + plant.B @ u, lambda xs, us: (A, B), cost,
            lambda xs, us: quad_cost_model(cost.Q, cost.xd, cost.R, xs, us))


@pytest.mark.parametrize("riccati,ticks", [("seq", 200), ("parallel", 150)])
def test_boxddp_mpc_tracks_and_respects_bounds(riccati, ticks):
    f, get_AB, cost, get_Cs = _di()
    step = tm.make_mpc_step_boxddp(f, get_AB, cost, get_Cs, u_lower=-3.0, u_upper=3.0, n_iters=3,
                                   riccati=riccati)
    x0 = torch.zeros(2, **F64)
    xs, us, _ = tm.run_mpc(f, step, tm.mpc_init(f, x0, torch.zeros((50, 1), **F64), device="cpu"),
                           x0, ticks)
    assert float(us.abs().max()) <= 3.0 + 1e-12  # exact feasibility every tick
    assert abs(float(xs[-1, 0]) - 1.0) < 0.05, float(xs[-1, 0])
    if riccati == "seq":
        assert float((xs[-20:, 0] - 1.0).abs().max()) < 0.08  # no limit cycle
        assert float(us.abs().max()) > 2.99  # the bound binds in the transient
