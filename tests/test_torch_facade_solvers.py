"""Port vs JAX package: the facade's solver methods beyond
`tests/test_facade.py` (`tests/test_torch_facade.py` holds its tests).

`solve_boxddp` (both backward passes), `solve_barrier`, `solve_al` (the
facade tests of `tests/test_boxddp.py` and `tests/test_al_ilqr.py`),
`solve` with the batch and SLS methods, `isls_admm` and the closed-loop
Monte-Carlo simulator run through both facades in float64 with the same
seeded numpy inputs, at the tolerances of `test_torch_facade.py`.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu import iSLS as JiSLS
from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator as JDoubleIntegrator
from ilqr_admm_tpu.ops.riccati import quad_cost_model as j_quad_cost_model
from ilqr_admm_tpu.solvers.barrier_ilqr import make_barrier as j_make_barrier
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost as j_viapoint_cost
from ilqr_admm_tpu_torch import iSLS
from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.ops.riccati import quad_cost_model
from ilqr_admm_tpu_torch.solvers.barrier_ilqr import make_barrier
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost

from test_torch_facade import (  # noqa: F401 (x64 is a fixture)
    F64,
    _car_parking_pair,
    _set_nominal,
    _viapoint,
    close,
    cost_close,
    x64,
)

torch.set_num_threads(2)


def _lq_pair(N, m=1):
    """`tests/test_boxddp.py::_lq_setup` in both packages, with iSLS
    facades whose nominal is the zero-control rollout."""
    jp, tp = JDoubleIntegrator(m, 2, dt=1.0 / N), DoubleIntegrator(m, 2, dt=1.0 / N)
    jp.get_AB = lambda xs, us: jp.AB(xs.shape[0])
    tp.get_AB = lambda xs, us: tp.AB(xs.shape[0])
    d = jp.x_dim
    zs, Qs, seq = _viapoint(d, N, np.r_[np.ones(d // 2), np.zeros(d - d // 2)], 1e3)
    jq = j_viapoint_cost(jnp.asarray(zs), jnp.asarray(Qs), seq, 1e-2, m)
    tq = viapoint_cost(zs, Qs, seq, 1e-2, m, dtype=F64)
    j, t = JiSLS(d, m, N), iSLS(d, m, N, device="cpu")
    j.forward_model, t.forward_model = jp.step, tp.step
    j.cost_function, t.cost_function = jq, tq
    j.nominal_values = j.get_trajectory_batch(jnp.zeros(d), jnp.zeros((N, m)))
    t.nominal_values = t.get_trajectory_batch(np.zeros(d), np.zeros((N, m)))
    cost_close(t.cost, j.cost)
    get_Cs = (lambda xs, us: j_quad_cost_model(jq.Q, jq.xd, jq.R, xs, us),
              lambda xs, us: quad_cost_model(tq.Q, tq.xd, tq.R, xs, us))
    return j, t, jp, tp, get_Cs


@pytest.mark.parametrize("which", ["boxddp", "boxddp_parallel", "barrier", "al"])
def test_facade_constrained_dp_solvers(x64, which):
    N = 60 if which != "al" else 40
    j, t, jp, tp, (jCs, tCs) = _lq_pair(N)
    if which.startswith("boxddp"):
        riccati = "parallel" if which == "boxddp_parallel" else "seq"
        out = t.solve_boxddp(tp.get_AB, -5.0, 5.0, get_Cs=tCs, riccati=riccati)
        jout = j.solve_boxddp(jp.get_AB, -5.0, 5.0, get_Cs=jCs, riccati=riccati)
        assert float(out.u_nom.abs().max()) <= 5.0 + 1e-12
    elif which == "barrier":
        kw = dict(n_barrier=6, mu_factor=8.0)
        out = t.solve_barrier(tp.get_AB, make_barrier(
            ineq=lambda x, u: torch.cat([u + 5.0, 5.0 - u])), get_Cs=tCs, **kw)
        jout = j.solve_barrier(jp.get_AB, j_make_barrier(
            ineq=lambda x, u: jnp.concatenate([u + 5.0, 5.0 - u])), get_Cs=jCs, **kw)
        assert float(out.u_nom.abs().max()) <= 5.0
    else:
        kw = dict(n_al=10, tol_con=1e-8)
        out = t.solve_al(tp.get_AB, ineq=lambda x, u: torch.stack([u[0] - 2.0, -u[0] - 2.0]),
                         get_Cs=tCs, **kw)
        jout = j.solve_al(jp.get_AB, ineq=lambda x, u: jnp.asarray([u[0] - 2.0, -u[0] - 2.0]),
                          get_Cs=jCs, **kw)
        assert float(out.max_violation) < 1e-6
        close(out.max_violation, jout.max_violation, 1e-6)
    cost_close(float(out.cost), float(jout.cost))
    close(out.u_nom, jout.u_nom)
    assert t.cost_log[-1] == float(out.cost)
    cost_close(t.cost_log, j.cost_log)
    close(t.A, j.A)


@pytest.mark.parametrize("method", ["batch", "sls"])
def test_isls_solve_batch_and_sls_methods(x64, method):
    N = 40
    j, t, jc, tc, jcost, tcost = _car_parking_pair(N, 0.05)
    u0 = np.random.default_rng(1).normal(size=(N, 2)) * 0.1
    jx_nom, ju_nom = j.get_trajectory_batch(np.array([1.0, 1.0, 3 * np.pi / 2, 0.0]), u0)
    _set_nominal(j, t, jx_nom, ju_nom)
    t.solve(tc.get_AB, tcost.get_Cs, max_iter=4, method=method)
    j.solve(jc.get_AB, jcost.get_Cs, max_iter=4, method=method)
    cost_close(t.cost_log, j.cost_log)
    close(t.u_nom, j.u_nom)
    if method == "sls":
        close(t._K_sls, j._K_sls)
        x0s = np.asarray(jx_nom[0]) + np.random.default_rng(2).normal(0, 0.01, (3, 4))
        xs, us = t.get_trajectory_sls(x0s, t._K_sls, t._k_sls, noise_scale=1e-3,
                                      rng=np.random.default_rng(3))
        jxs, jus = j.get_trajectory_sls(x0s, j._K_sls, j._k_sls, noise_scale=1e-3,
                                        rng=np.random.default_rng(3))
        close(xs, jxs)
        close(us, jus)
    with pytest.raises(ValueError, match="unknown method"):
        t.solve(tc.get_AB, tcost.get_Cs, method="newton")


def test_isls_admm_and_closed_loop_rollouts(x64):
    """The robust iSLS-ADMM method (notebook-era spellings) and the
    closed-loop Monte-Carlo simulator around the nominal."""
    N = 30
    j, t, jc, tc, jcost, tcost = _car_parking_pair(N, 0.05)
    u0 = np.random.default_rng(4).normal(size=(N, 2)) * 0.1
    x0 = np.array([1.0, 1.0, 3 * np.pi / 2, 0.0])
    jx_nom, ju_nom = j.get_trajectory_batch(x0, u0)
    _set_nominal(j, t, jx_nom, ju_nom)
    kw = dict(max_admm_iter=5, k_max=4, max_line_search=10, threshold=1e-3)
    du, phi_u = t.isls_admm(2, tc.get_AB, get_Cs=tcost.get_Cs, **kw)
    jdu, jphi_u = j.isls_admm(2, jc.get_AB, get_Cs=jcost.get_Cs, **kw)
    close(du, jdu)
    close(phi_u, jphi_u)
    cost_close(t.cost_log, j.cost_log)
    rng = np.random.default_rng(5)
    x0s = x0 + rng.normal(0, 0.01, (4, 4))
    K_dp, k_dp = rng.normal(0, 0.1, (N, 2, 4)), rng.normal(0, 0.01, (N, 2))
    xs, us = t.get_trajectory_dp(x0s, K_dp, k_dp, noise_scale=1e-3, rng=np.random.default_rng(7))
    jxs, jus = j.get_trajectory_dp(x0s, K_dp, k_dp, noise_scale=1e-3,
                                   rng=np.random.default_rng(7))
    close(xs, jxs)
    close(us, jus)
