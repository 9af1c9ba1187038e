"""Port vs JAX package: the car plants and the car-parking cost of
`models/car.py`.

Inputs are made with numpy from a seed and fed to both packages in
float64. The steps, Jacobians (autodiff on both sides), costs and Taylor
blocks must agree to 1e-12 (only the order of f64 operations differs).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.models import car as jc
from ilqr_admm_tpu_torch.convert import car_from_numpy, car_parking_cost_from_numpy
from ilqr_admm_tpu_torch.models import car as tc

torch.set_num_threads(2)

TOL = 1e-12
N = 30


def _err(got, want):
    return float(np.abs(got.detach().numpy() - np.asarray(want)).max())


@pytest.fixture(scope="module")
def traj():
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(N, 4)) + np.array([1.0, 1.0, 4.7, 0.0])
    us = rng.normal(size=(N, 2)) * 0.3
    return xs, us


@pytest.mark.parametrize("dt,dist", [(0.03, None), (0.375, 1.5)])
def test_front_wheel_step_and_jacobians(traj, dt, dist):
    xs, us = traj
    jcar = jc.CarFrontWheel(dt=dt) if dist is None else jc.CarFrontWheel(dt=dt, dist=dist)
    tcar = car_from_numpy(dt, dist)
    assert tcar.dist == jcar.dist
    want = np.stack([np.asarray(jcar.step(jnp.asarray(x), jnp.asarray(u))) for x, u in zip(xs, us)])
    got = torch.stack([tcar.step(torch.tensor(x), torch.tensor(u)) for x, u in zip(xs, us)])
    assert _err(got, want) < TOL
    # step_cols: components on rows, candidates on columns
    cols = tcar.step_cols(torch.tensor(xs.T), torch.tensor(us.T))
    assert cols.shape == (4, N) and _err(cols.T, want) < TOL
    jA, jB = jcar.get_AB(jnp.asarray(xs), jnp.asarray(us))
    tA, tB = tcar.get_AB(torch.tensor(xs), torch.tensor(us))
    assert tA.shape == (N, 4, 4) and tB.shape == (N, 4, 2)
    assert _err(tA, jA) < TOL and _err(tB, jB) < TOL


def test_front_wheel_f32_jacobians_stay_f32(traj):
    xs, us = traj
    car = tc.CarFrontWheel(dt=0.03)
    A, B = car.get_AB(torch.tensor(xs, dtype=torch.float32), torch.tensor(us, dtype=torch.float32))
    assert A.dtype == B.dtype == torch.float32


def test_front_wheel_nan_outside_the_geometry():
    """sqrt of a negative and asin beyond 1 give NaN states, as in JAX."""
    car = tc.CarFrontWheel(dt=1.0)
    s = car.step(torch.tensor([0.0, 0.0, 0.0, 5.0]), torch.tensor([1.5, 0.0]))
    js = jc.CarFrontWheel(dt=1.0).step(jnp.asarray([0.0, 0.0, 0.0, 5.0]), jnp.asarray([1.5, 0.0]))
    assert np.array_equal(torch.isnan(s).numpy(), np.isnan(np.asarray(js)))
    assert bool(torch.isnan(s[:3]).all()) and float(s[3]) == 5.0


def test_car_simple(traj):
    xs, us = traj
    jcar, tcar = jc.CarSimple(dt=0.05), tc.CarSimple(dt=0.05)
    for x, u in zip(xs, us):
        assert _err(tcar.step(torch.tensor(x), torch.tensor(u)),
                    jcar.step(jnp.asarray(x), jnp.asarray(u))) < TOL
        assert _err(tcar.step_unwrapped(torch.tensor(x), torch.tensor(u)),
                    jcar.step_unwrapped(jnp.asarray(x), jnp.asarray(u))) < TOL
    for name in ("get_AB", "get_AB_autodiff"):
        jA, jB = getattr(jcar, name)(jnp.asarray(xs), jnp.asarray(us))
        tA, tB = getattr(tcar, name)(torch.tensor(xs), torch.tensor(us))
        assert _err(tA, jA) < TOL and _err(tB, jB) < TOL
    # the closed form is the autodiff Jacobian of the unwrapped step
    A1, B1 = tcar.get_AB(torch.tensor(xs), torch.tensor(us))
    A2, B2 = tcar.get_AB_autodiff(torch.tensor(xs), torch.tensor(us))
    assert float((A1 - A2).abs().max()) < TOL and float((B1 - B2).abs().max()) < TOL


@pytest.mark.parametrize("theta", [-0.3, 0.01, 6.25, 2 * np.pi + 0.4, -7.0])
def test_car_simple_wraps_heading(theta):
    """theta wraps into [0, 2 pi) across both ends, as jnp's floor-mod."""
    x = np.array([0.0, 0.0, theta, 1.0])
    u = np.array([0.7, 0.0])
    got = tc.CarSimple(dt=0.05).step(torch.tensor(x), torch.tensor(u))
    want = jc.CarSimple(dt=0.05).step(jnp.asarray(x), jnp.asarray(u))
    assert 0.0 <= float(got[2]) < 2 * np.pi
    assert _err(got, want) < TOL


def test_pseudo_huber():
    x = np.linspace(-3.0, 3.0, 13)
    assert _err(tc.pseudo_huber(torch.tensor(x), 0.1), jc.pseudo_huber(jnp.asarray(x), 0.1)) < TOL


WEIGHTS = {
    "defaults": dict(cu=(1e-2, 1e-4), cf=(0.1, 0.1, 1.0, 0.3), pf=(0.01, 0.01, 0.01, 1.0),
                     cx=(1e-3, 1e-3), px=(0.1, 0.1)),
    "other": dict(cu=(0.3, 0.02), cf=(1.0, 2.0, 0.5, 0.1), pf=(0.2, 0.1, 0.05, 0.5),
                  cx=(0.01, 0.02), px=(0.3, 0.2)),
}


@pytest.mark.parametrize("weights", list(WEIGHTS))
def test_parking_cost_and_taylor_blocks(traj, weights):
    xs, us = traj
    w = WEIGHTS[weights]
    jcost = jc.CarParkingCost(**w)
    tcost = car_parking_cost_from_numpy(**w, device="cpu", dtype=torch.float64)
    assert _err(tcost(torch.tensor(xs), torch.tensor(us)), jcost(jnp.asarray(xs), jnp.asarray(us))) < TOL
    jc_, jC = jcost.get_Cs(jnp.asarray(xs), jnp.asarray(us))
    tc_, tC = tcost.get_Cs(torch.tensor(xs), torch.tensor(us))
    assert tc_.shape == (N, 6) and tC.shape == (N, 6, 6)
    assert _err(tc_, jc_) < TOL and _err(tC, jC) < TOL
    assert torch.equal(tC, tC.transpose(-1, -2))


def test_parking_cost_batches_and_maps_nan_to_inf(traj):
    """Any leading axes; a NaN trajectory costs +inf (JAX: same)."""
    xs, us = traj
    rng = np.random.default_rng(2)
    xb = xs[None, None] + 0.1 * rng.normal(size=(2, 3, N, 4))
    ub = np.broadcast_to(us, (2, 3, N, 2)).copy()
    xb[1, 2, 5, 0] = np.nan
    jcost = jc.CarParkingCost()
    tcost = tc.CarParkingCost(dtype=torch.float64)
    want = np.asarray(jcost(jnp.asarray(xb), jnp.asarray(ub)))
    got = tcost(torch.tensor(xb), torch.tensor(ub))
    assert got.shape == (2, 3) and np.isinf(want[1, 2]) and bool(torch.isinf(got[1, 2]))
    fin = np.isfinite(want)
    assert float(np.abs(got.numpy()[fin] - want[fin]).max()) < TOL
    # one trajectory is a batch of none
    assert _err(tcost(torch.tensor(xs), torch.tensor(us)), jcost(jnp.asarray(xs), jnp.asarray(us))) < TOL


def test_parking_cost_buffers_move_as_a_module():
    cost = tc.CarParkingCost(dtype=torch.float64)
    assert {name for name, _ in cost.named_buffers()} == {"cu", "cf", "pf", "cx", "px"}
    assert all(b.dtype == torch.float32 for b in cost.to(torch.float32).buffers())
