"""Port vs JAX package: iLQR (`solvers/ilqr.py`) on the car.

The control-limited car's parking problem at N = 40 (made with numpy
from a seed) goes through `ilqr_solve` of both packages in float64, in
every method and Riccati mode: DP with the sequential Cholesky pass, the
square-root pass and the time-parallel passes (flat and blocked), the
batch method and the SLS method. Both must stop after the same number of
iterations with the same status, on the same trajectories to 1e-8
relative.

The JAX flat associative scan aborts XLA:CPU in a process that imported
torch (see `tests/test_torch_parallel_riccati.py`), so JAX's
riccati='parallel' solve runs in a subprocess without torch.
"""

import importlib
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.models.car import CarFrontWheel as JCar, CarParkingCost as JCost
from ilqr_admm_tpu.problem import ILQRConfig as JConfig
from ilqr_admm_tpu_torch.models.car import CarFrontWheel, CarParkingCost
from ilqr_admm_tpu_torch.problem import ILQRConfig, SolveStatus, line_search_alphas
from ilqr_admm_tpu_torch.solvers import ilqr as ti

torch.set_num_threads(2)
# the JAX package's solvers/__init__ rebinds some module names to functions
ji = importlib.import_module("ilqr_admm_tpu.solvers.ilqr")

REPO = Path(__file__).resolve().parents[1]
N, DT, TOL = 40, 0.05, 1e-8
X0 = [1.0, 1.0, 3.0 * np.pi / 2, 0.0]
CFG = dict(max_iter=8, max_line_search_iter=12)
MODES = {
    "dp, chol": ("dp", "chol"),
    "dp, sqrt": ("dp", "sqrt"),
    "dp, parallel_fast": ("dp", "parallel_fast"),
    "batch": ("batch", "chol"),
    "sls": ("sls", "chol"),
}


def _u0():
    return np.random.default_rng(0).normal(size=(N, 2)) * 0.1


def _jax(method, riccati):
    car, cost = JCar(dt=DT), JCost()
    s0 = ji.ilqr_init(car.step, cost, jnp.asarray(X0), jnp.asarray(_u0()))
    return ji.ilqr_solve(car.step, car.get_AB, cost.get_Cs, cost, s0, JConfig(**CFG),
                         method=method, riccati=riccati)


def _torch(method, riccati):
    car, cost = CarFrontWheel(dt=DT), CarParkingCost(dtype=torch.float64)
    s0 = ti.ilqr_init(car.step, cost, torch.tensor(X0, dtype=torch.float64),
                      torch.tensor(_u0()), device="cpu")
    return ti.ilqr_solve(car.step, car.get_AB, cost.get_Cs, cost, s0, ILQRConfig(**CFG),
                         method=method, riccati=riccati)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / max(1.0, np.abs(want).max()))


def _assert_same(got, iteration, status, x_nom, u_nom, cost):
    assert got.iteration == int(iteration)
    assert got.status == int(status)
    for g, w in ((got.x_nom, x_nom), (got.u_nom, u_nom), (got.cost, cost)):
        assert _rel(g, w) < TOL


@pytest.mark.parametrize("mode", list(MODES))
def test_ilqr_solve_matches_jax(mode):
    want = _jax(*MODES[mode])
    got = _torch(*MODES[mode])
    _assert_same(got, want.iteration, want.status, want.x_nom, want.u_nom, want.cost)
    assert got.iteration >= 5 and float(got.cost) < 1.5


_FLAT = textwrap.dedent(
    """
    import sys
    import numpy as np
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from ilqr_admm_tpu.models.car import CarFrontWheel, CarParkingCost
    from ilqr_admm_tpu.problem import ILQRConfig
    import importlib
    ji = importlib.import_module("ilqr_admm_tpu.solvers.ilqr")
    inp = np.load(sys.argv[1])
    car, cost = CarFrontWheel(dt=float(inp["dt"])), CarParkingCost()
    s0 = ji.ilqr_init(car.step, cost, jnp.asarray(inp["x0"]), jnp.asarray(inp["u0"]))
    out = ji.ilqr_solve(car.step, car.get_AB, cost.get_Cs, cost, s0,
                        ILQRConfig(max_iter=int(inp["max_iter"]),
                                   max_line_search_iter=int(inp["n_ls"])),
                        method="dp", riccati="parallel")
    np.savez(sys.argv[2], x_nom=out.x_nom, u_nom=out.u_nom, cost=out.cost,
             iteration=out.iteration, status=out.status)
    """
)


def test_ilqr_solve_flat_parallel_matches_jax(tmp_path):
    """riccati='parallel' (flat associative scan): JAX in a process
    without torch."""
    np.savez(tmp_path / "in.npz", x0=np.asarray(X0), u0=_u0(), dt=DT,
             max_iter=CFG["max_iter"], n_ls=CFG["max_line_search_iter"])
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _FLAT, str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = dict(np.load(tmp_path / "out.npz"))
    got = _torch("dp", "parallel")
    _assert_same(got, want["iteration"], want["status"], want["x_nom"], want["u_nom"], want["cost"])


def test_nan_candidate_never_wins():
    """A NaN-cost candidate is +inf before the argmin; the best finite
    candidate wins, and an all-NaN grid is not accepted."""
    N_, A = 5, 3
    xs = torch.zeros((A, N_, 4), dtype=torch.float64)
    us = torch.zeros((A, N_, 2), dtype=torch.float64)
    xs[0, 2, 0] = math.nan  # candidate 0's cost is NaN
    us[1] = 0.5
    us[2] = 0.1
    cost = CarParkingCost(dtype=torch.float64)
    state = ti.ILQRState(x_nom=xs[2] + 1.0, u_nom=us[2], cost=torch.tensor(1e9, dtype=torch.float64),
                         prev_cost=torch.tensor(math.inf, dtype=torch.float64), iteration=0,
                         status=int(SolveStatus.RUNNING))
    new, accept = ti._select_candidate(cost, xs, us, state)
    assert bool(accept) and torch.equal(new.u_nom, us[2]) and new.iteration == 1
    # the JAX package picks the same candidate
    jnew, jaccept = ji._select_candidate(JCost(), jnp.asarray(xs.numpy()), jnp.asarray(us.numpy()),
                                         ji.ILQRState(jnp.asarray(state.x_nom.numpy()),
                                                      jnp.asarray(us[2].numpy()), jnp.asarray(1e9),
                                                      jnp.asarray(np.inf), 0, 0))
    assert bool(jaccept) and np.array_equal(np.asarray(jnew.u_nom), us[2].numpy())
    xs[1:, 2, 0] = math.nan
    new, accept = ti._select_candidate(cost, xs, us, state)
    assert not bool(accept) and torch.equal(new.x_nom, state.x_nom)


def test_ilqr_errors_and_defaults():
    car, cost = CarFrontWheel(dt=DT), CarParkingCost(dtype=torch.float64)
    s0 = ti.ilqr_init(car.step, cost, torch.tensor(X0, dtype=torch.float64),
                      torch.tensor(_u0()), device="cpu")
    assert s0.iteration == 0 and s0.status == SolveStatus.RUNNING and bool(torch.isinf(s0.prev_cost))
    with pytest.raises(ValueError, match="riccati must be"):
        ti.ilqr_solve(car.step, car.get_AB, cost.get_Cs, cost, s0, riccati="qr")
    with pytest.raises(ValueError, match="method must be"):
        ti.ilqr_solve(car.step, car.get_AB, cost.get_Cs, cost, s0, method="lifted")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ti.ilqr_init(car.step, cost, torch.tensor(X0), torch.tensor(_u0()))
    # the step grid of the reference, 10^linspace(0, -5, 50)[:n]
    a = line_search_alphas(ILQRConfig(max_line_search_iter=7), torch.float64)
    assert a.shape == (7,) and float(a[0]) == 1.0
    assert float((a - torch.tensor(10.0 ** np.linspace(0, -5, 50)[:7])).abs().max()) < 1e-15
