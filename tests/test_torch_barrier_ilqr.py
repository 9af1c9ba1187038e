"""Port vs JAX package: log-barrier iLQR (`solvers/barrier_ilqr.py`).

The problems of `tests/test_boxddp.py::TestBarrierILQR` through both
packages in float64: the per-stage SOC ball ||u_t|| <= 3 on a 2-input
double integrator, the elementwise box |u| <= 5 (also held to the port's
boxDDP, as the JAX test holds JAX's), and an infeasible start that must
fail cleanly. Cost to 1e-10 relative, trajectories to 1e-8, statuses and
iteration counts equal. Beside them the NaN trap: an infeasible
line-search candidate costs +inf, never a finite clamp.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator as JDI
from ilqr_admm_tpu.ops.riccati import quad_cost_model as j_quad_model
from ilqr_admm_tpu.problem import ILQRConfig as JConfig
from ilqr_admm_tpu.solvers import barrier_ilqr as jbar
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost as j_viapoint_cost
from ilqr_admm_tpu_torch.convert import quadcost_from_numpy
from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.ops.riccati import quad_cost_model
from ilqr_admm_tpu_torch.problem import ILQRConfig, SolveStatus, line_search_alphas
from ilqr_admm_tpu_torch.solvers import barrier_ilqr as tbar
from ilqr_admm_tpu_torch.solvers.boxddp import boxddp_init, boxddp_solve
from ilqr_admm_tpu_torch.solvers.ilqr import ILQRState, ilqr_iterate_dp, nan_to_inf

torch.set_num_threads(2)

COST_TOL = 1e-10
TRAJ_TOL = 1e-8
F64 = torch.float64


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _lq(m, N):
    """`tests/test_boxddp.py::_lq_setup(nb_deriv=2, m, N)` in both packages:
    terminal position 1 at weight 1e3, u_std 1e-2."""
    jplant = JDI(m, 2, dt=1.0 / N)
    jplant.get_AB = lambda xs, us: jplant.AB(xs.shape[0])
    d = jplant.x_dim
    zs = jnp.stack([jnp.zeros(d), jnp.ones(d).at[d // 2:].set(0.0)])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    jcost = j_viapoint_cost(zs, Qs, seq, 1e-2, m)
    tplant = DoubleIntegrator(m, 2, dt=1.0 / N, device="cpu", dtype=F64)
    tcost = quadcost_from_numpy(np.asarray(jcost.Q), np.asarray(jcost.xd), np.asarray(jcost.R),
                                device="cpu", dtype=F64)
    jfns = (jplant.step, jplant.get_AB,
            lambda xs, us: j_quad_model(jcost.Q, jcost.xd, jcost.R, xs, us), jcost)
    tfns = (tplant.step, lambda xs, us: tplant.AB(xs.shape[0]),
            lambda xs, us: quad_cost_model(tcost.Q, tcost.xd, tcost.R, xs, us), tcost)
    return jfns, tfns, d


def _box(lim):
    return (lambda x, u: jnp.concatenate([u + lim, lim - u]),
            lambda x, u: torch.cat([u + lim, lim - u]))


def _ball(s):
    return (lambda x, u: [(jnp.asarray(s, u.dtype), u)],
            lambda x, u: [(torch.as_tensor(s, dtype=u.dtype), u)])


def _solve_both(m, N, u0, kind, spec, cfg, **kw):
    jfns, tfns, d = _lq(m, N)
    jspec, tspec = spec
    st_j = jbar.barrier_ilqr_solve(*jfns, jnp.zeros(d), jnp.asarray(u0),
                                   jbar.make_barrier(**{kind: jspec}), cfg=JConfig(**cfg), **kw)
    st_t = tbar.barrier_ilqr_solve(*tfns, torch.zeros(d, dtype=F64), torch.tensor(u0),
                                   tbar.make_barrier(**{kind: tspec}), cfg=ILQRConfig(**cfg),
                                   device="cpu", **kw)
    return st_j, st_t, tfns


def _assert_same(st_t, st_j):
    assert st_t.status == int(st_j.status) and st_t.iteration == int(st_j.iteration)
    assert _rel(st_t.cost, st_j.cost) < COST_TOL
    assert _rel(st_t.u_nom, st_j.u_nom) < TRAJ_TOL and _rel(st_t.x_nom, st_j.x_nom) < TRAJ_TOL


def test_soc_ball_matches_jax():
    """The SOC test's problem: ||u_t|| <= 3, N = 60, mu 1 / 8^i, 7 stages."""
    st_j, st_t, _ = _solve_both(2, 60, np.zeros((60, 2)), "soc", _ball(3.0),
                                dict(max_iter=40, tol_fun=1e-10), mu0=1.0, mu_factor=8.0,
                                n_barrier=7)
    _assert_same(st_t, st_j)
    norms = torch.linalg.norm(st_t.u_nom, dim=-1)
    assert float(norms.max()) <= 3.0 + 1e-9  # strictly feasible
    assert float(norms.max()) > 0.95 * 3.0  # the cone is active


def test_elementwise_barrier_matches_jax_and_boxddp():
    """|u| <= 5, N = 80: the port's barrier equals JAX's, and lies within
    5e-3 of the port's boxDDP, the JAX test's own limit."""
    st_j, st_t, tfns = _solve_both(1, 80, np.zeros((80, 1)), "ineq", _box(5.0),
                                   dict(max_iter=40, tol_fun=1e-10), mu0=1.0, mu_factor=8.0,
                                   n_barrier=7)
    _assert_same(st_t, st_j)
    st_box = boxddp_solve(*tfns, boxddp_init(tfns[0], tfns[3], torch.zeros(2, dtype=F64),
                                             torch.zeros((80, 1), dtype=F64), -5.0, 5.0,
                                             device="cpu"),
                          -5.0, 5.0, cfg=ILQRConfig(max_iter=60, tol_fun=1e-10))
    assert float(st_t.u_nom.abs().max()) <= 5.0
    assert abs(float(st_t.cost) - float(st_box.cost)) < 5e-3 * max(1.0, abs(float(st_box.cost)))


def test_infeasible_start_fails_cleanly():
    """|u| <= 0.1 from u = 1: the barrier is NaN at the start, every
    candidate costs +inf, and both packages stop with the same status."""
    st_j, st_t, tfns = _solve_both(1, 20, np.ones((20, 1)), "ineq", _box(0.1),
                                   dict(max_iter=5), n_barrier=2)
    assert st_t.status == int(st_j.status) == SolveStatus.LINE_SEARCH_FAILED
    assert not (math.isfinite(float(tfns[3](st_t.x_nom, st_t.u_nom)))
                and float(st_t.u_nom.abs().max()) <= 0.1)


def test_nan_candidate_costs_inf():
    """The trap of a finite NaN clamp (the reference's 1e5): a barrier
    stage whose full step crosses the boundary. The crossing candidates
    cost NaN, which must become +inf, so a shorter feasible step wins."""
    _, tfns, d = _lq(1, 20)
    f, get_AB, get_Cs, cost = tfns
    barrier = tbar.make_barrier(ineq=_box(0.3)[1])
    x0 = torch.zeros(d, dtype=F64)
    us = torch.zeros((20, 1), dtype=F64)
    xs = torch.stack([x0] * 20)
    mu = torch.tensor(1e-3, dtype=F64)

    def aug_cost(xs_, us_):
        return cost(xs_, us_) + mu * torch.vmap(barrier)(xs_, us_).sum()

    alphas = line_search_alphas(ILQRConfig(), F64, "cpu")
    c = aug_cost(xs, us)
    st = ILQRState(xs, us, c, torch.full_like(c, math.inf), 0, int(SolveStatus.RUNNING))
    new, accept, (K, k) = ilqr_iterate_dp(f, get_AB, tbar._augment_Cs(get_Cs, barrier, mu),
                                          aug_cost, st, alphas)
    # the full Newton step leaves the box: its barrier, and cost, is NaN
    assert float((alphas[0] * k).abs().max()) > 0.3
    assert bool(torch.isnan(aug_cost(xs, us + alphas[0] * k)))
    assert float(nan_to_inf(aug_cost(xs, us + alphas[0] * k))) == math.inf
    assert bool(accept) and math.isfinite(float(new.cost)) and float(new.cost) < float(c)
    assert float(new.u_nom.abs().max()) < 0.3


@pytest.mark.parametrize("kw", [dict(), dict(ineq=None, soc=None)])
def test_make_barrier_needs_a_cone(kw):
    with pytest.raises(ValueError, match="at least one"):
        tbar.make_barrier(**kw)
