"""The JAX package's own numbers for the AL arm fleet gates of
`chip_smoke.py` (`phase_al_arm`, `utils/certify.py::AL_ARM_REFERENCE`).

Runs `benchmarks/bench_al_arm.py`'s fleet (the 3DoF arm, N = 100,
|q_dot| <= 1.5, |u| <= 6, the terminal ee-x window [0.5, 1], x_std 1e3,
u_std 1e-4, ILQRConfig(max_iter=8, max_line_search_iter=15), n_al = 7,
mu0 = 1e2, mu_factor = 8, tol_con = 1e-5, q0 = (pi/3, -pi/2, -pi/4) +
N(0, 0.05^2) from default_rng(0), u0 = 1) through
`jax.vmap(al_ilqr_solve)` on the CPU in float32, for the first 64
instances of the bench's 512, and prints the median max_violation, the
mean cost and the statuses as one JSON line.

Needs jax (not the port); run from the repository root on a machine
that has it: python3 tools/al_arm_jax_reference.py [n_instances]
"""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ilqr_admm_tpu.models.arm import PlanarArm  # noqa: E402
from ilqr_admm_tpu.ops.riccati import quad_cost_model  # noqa: E402
from ilqr_admm_tpu.problem import ILQRConfig  # noqa: E402
from ilqr_admm_tpu.solvers.al_ilqr import al_ilqr_solve  # noqa: E402
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost  # noqa: E402


def main(n_inst=64, bench_batch=512):
    jax.config.update("jax_enable_x64", False)
    N = 100
    arm = PlanarArm((1.0, 1.0, 1.0), dt=1.0 / N)
    d, m, n = arm.x_dim, arm.u_dim, arm.q_dim
    x_std, u_std = 1e3, 1e-4
    target = jnp.asarray([0.0] * n + [0.0] * n + [1.5, 1.0, 0.0], jnp.float32)
    w = jnp.asarray([0.0] * n + [x_std] * n + [0.0, x_std, 0.0], jnp.float32)
    zs = jnp.stack([jnp.zeros(d, jnp.float32), target])
    Qs = jnp.stack([jnp.zeros((d, d), jnp.float32), jnp.diag(w)])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(zs, Qs, seq, u_std, m)

    def get_Cs(xs, us):
        return quad_cost_model(quad.Q, quad.xd, quad.R, xs, us)

    def ineq(x, u, t):
        dq = x[n:2 * n]
        ee_x = x[2 * n]
        return jnp.concatenate([
            dq - 1.5, -dq - 1.5, u - 6.0, -u - 6.0,
            jnp.where(t == N - 1, jnp.asarray([ee_x - 1.0, 0.5 - ee_x]),
                      jnp.asarray([-1.0, -1.0])),
        ])

    rng = np.random.default_rng(0)
    q0s = jnp.asarray(np.array([np.pi / 3, -np.pi / 2, -np.pi / 4])
                      + rng.normal(0, 0.05, (bench_batch, n)), jnp.float32)[:n_inst]
    x0s = jax.vmap(arm.initial_state)(q0s)
    u0s = jnp.ones((n_inst, N, m), jnp.float32)

    def one(x0, u0):
        return al_ilqr_solve(arm.step, arm.get_AB, get_Cs, quad, x0, u0, ineq=ineq,
                             cfg=ILQRConfig(max_iter=8, max_line_search_iter=15), n_al=7,
                             mu0=1e2, mu_factor=8.0, tol_con=1e-5)

    res = jax.jit(jax.vmap(one))(x0s, u0s)
    viol = np.asarray(res.max_violation, np.float64)
    cost = np.asarray(res.cost, np.float64)
    print(json.dumps({
        "n_instances": n_inst,
        "dtype": "float32",
        "backend": jax.default_backend(),
        "median_violation": float(np.median(viol)),
        "max_violation": float(viol.max()),
        "mean_cost": float(cost.mean()),
        "finite": bool(np.isfinite(cost).all()),
        "max_abs_u": float(np.abs(np.asarray(res.u_nom)).max()),
        "statuses": {int(s): int(c) for s, c in zip(*np.unique(np.asarray(res.status),
                                                                return_counts=True))},
    }))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 64)
