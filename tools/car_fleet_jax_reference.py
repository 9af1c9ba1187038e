"""The JAX package's own bound violations on the `[car fleet]` starts of
`chip_smoke.py` (`phase_car_fleet`, `CAR_FLEET_JAX`).

Solves each of the fleet's 256 parkings alone with the JAX package's
`ilqr_admm` on the CPU in float32: `CarFrontWheel(dt=15/500)`, N = 500,
`CarParkingCost()`, |w| <= 0.5, |a| <= 2, rho_u = diag(1e-2, 1e-3), x0 =
(1, 1, 3pi/2, 0) + N(0, 0.05^2) as `benchmarks/bench_boxddp.py:66-70`
draws them (default_rng(0) after its u0; instance 0 at the start
itself), u0 = 0.1 N(0, 1) from default_rng(0) (outer) or default_rng(3)
(inner), in the outer line-search mode (60 outer steps, 30 ADMM
iterations, 20 alphas) or the inner one (8 ADMM iterations, 40 alphas),
and prints each instance's cost, status, outer steps and max bound
violation of u_nom, then one JSON line: the violations' max and median,
how many exceed the single car's gate (3e-4 outer, 1e-3 inner), and the
same by status. About 7 s an instance.

Needs jax (not the port); run from the repository root on a machine
that has it: python3 tools/car_fleet_jax_reference.py outer|inner [n_instances]
"""

import importlib
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ilqr_admm_tpu.models.car import CarFrontWheel, CarParkingCost  # noqa: E402
from ilqr_admm_tpu.ops.rollout import rollout_nonlinear  # noqa: E402

# the solvers package rebinds the module name to the function
ilqr_admm_module = importlib.import_module("ilqr_admm_tpu.solvers.ilqr_admm")

N, FLEET = 500, 256
X0 = np.array([1.0, 1.0, 3.0 * np.pi / 2, 0.0])
LO, HI = np.array([-0.5, -2.0]), np.array([0.5, 2.0])
MODES = {
    "outer": (0, 20, 3e-4, dict(max_iter=60, max_admm_iter=30, tol=1e-3, outer_tol=1e-5,
                               osc_tol=1e-5, line_search="outer")),
    "inner": (3, 40, 1e-3, dict(max_iter=60, max_admm_iter=8, tol=1e-3, outer_tol=1e-5,
                               osc_tol=1e-5, line_search="inner")),
}


def starts(n=FLEET):
    rng = np.random.default_rng(0)
    rng.normal(size=(N, 2))  # the bench's u0 draw
    x0s = X0 + rng.normal(0, 0.05, (n, 4))
    x0s[0] = X0
    return x0s


def main(mode, n_inst=FLEET):
    jax.config.update("jax_enable_x64", False)
    seed, n_alphas, gate, kw = MODES[mode]
    u0 = jnp.asarray((np.random.default_rng(seed).normal(size=(N, 2)) * 0.1).astype(np.float32))
    car, park = CarFrontWheel(dt=15.0 / N), CarParkingCost()
    lo, hi = jnp.asarray(LO, jnp.float32), jnp.asarray(HI, jnp.float32)
    alphas = (10.0 ** jnp.linspace(0.0, -5.0, 50, dtype=jnp.float32))[:n_alphas]

    @jax.jit
    def solve(x0):
        res = ilqr_admm_module.ilqr_admm(
            car.step, car.get_AB, park, rollout_nonlinear(car.step, x0, u0), u0,
            get_Cs=park.get_Cs, project_u=lambda u: jnp.clip(u.reshape(N, 2), lo, hi).reshape(-1),
            rho_u=jnp.diag(jnp.asarray([1e-2, 1e-3], jnp.float32)), alphas=alphas, **kw)
        return res.cost, res.u_nom, res.status, res.outer_iters

    viols, statuses = [], []
    t0 = time.perf_counter()
    for i, x0 in enumerate(starts(n_inst)):
        cost, u, status, outer = solve(jnp.asarray(x0, jnp.float32))
        u = np.asarray(u, np.float64)
        viols.append(float(np.clip(np.maximum(u - HI, LO - u), 0.0, None).max()))
        statuses.append(int(status))
        print(f"{i} cost {float(cost):.6f} status {int(status)} outer {int(outer)} violation "
              f"{viols[-1]:.3e} ({time.perf_counter() - t0:.0f} s)", flush=True)
    v, s = np.array(viols), np.array(statuses)
    print(json.dumps({
        "mode": mode, "instances": n_inst, "gate": gate, "max": float(v.max()),
        "median": float(np.median(v)), "over": int((v > gate).sum()), "instance_0": float(v[0]),
        "by_status": {str(k): {"n": int((s == k).sum()), "max": float(v[s == k].max()),
                               "over": int((v[s == k] > gate).sum())} for k in np.unique(s)},
    }))


if __name__ == "__main__":
    main(sys.argv[1], *(int(a) for a in sys.argv[2:3]))
