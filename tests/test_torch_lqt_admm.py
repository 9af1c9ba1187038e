"""Port vs JAX package: the constrained LQT-ADMM solvers of
`solvers/lqt_admm.py` and the robust SLS-ADMM of `solvers/sls_admm.py`.

A 1-D double integrator reaching for x = 1 under a control box and a
velocity box (made with numpy) goes through both packages in float64:
the batch x-update by Cholesky and by QR, with fixed, accelerated and
adaptive penalties; the DP x-update in operator form and as sweeps, with
fixed and adaptive penalties; and `sls_admm` with a box on the
feedforward column, fixed and adaptive. Results, iteration counts and
statuses must agree to 1e-9 (only the order of f64 operations differs).
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.problem import ADMMConfig as JConfig, QuadCost as JQuadCost
from ilqr_admm_tpu_torch.problem import ADMMConfig, QuadCost, SolveStatus
from ilqr_admm_tpu_torch.solvers import lqt_admm as tl
from ilqr_admm_tpu_torch.solvers import sls_admm as ts

torch.set_num_threads(2)
# the JAX package's solvers/__init__ rebinds the module names to functions
jl = importlib.import_module("ilqr_admm_tpu.solvers.lqt_admm")
js = importlib.import_module("ilqr_admm_tpu.solvers.sls_admm")

TOL = 1e-9
N, DT = 20, 0.1
U_MAX, V_MAX = 2.0, 0.8


@pytest.fixture(scope="module")
def problem():
    A = np.tile(np.array([[1.0, DT], [0.0, 1.0]]), (N, 1, 1))
    B = np.tile(np.array([[0.5 * DT**2], [DT]]), (N, 1, 1))
    Q = np.tile(np.diag([1e-3, 1e-3]), (N, 1, 1))
    Q[-1] = np.diag([1e2, 1e1])
    xd = np.zeros((N, 2))
    xd[-1, 0] = 1.0
    R = np.tile(np.eye(1) * 1e-2, (N, 1, 1))
    x0 = np.array([0.0, 0.0])
    return A, B, Q, xd, R, x0


def _box(lib, lo, hi, dim, which):
    """Projection of a flattened (N*dim,) vector clipping component `which`."""
    clip = jnp.clip if lib is jnp else torch.clamp

    def project(v):
        parts = [clip(v.reshape(N, dim)[:, i], lo, hi) if i == which else v.reshape(N, dim)[:, i]
                 for i in range(dim)]
        return (jnp.stack if lib is jnp else torch.stack)(parts, -1).reshape(-1)

    return project


def _args(lib, problem):
    A, B, Q, xd, R, x0 = problem
    if lib is jnp:
        arr = jnp.asarray
        cost = JQuadCost(Q=arr(Q), xd=arr(xd), R=arr(R))
    else:
        arr = torch.tensor
        cost = QuadCost(arr(Q), arr(xd), arr(R))
    return arr(A), arr(B), cost, arr(x0)


LQT_CASES = {
    "batch, chol": ("batch", dict(), dict(max_iter=300, tol=1e-7)),
    "batch, QR": ("batch", dict(use_qr=True), dict(max_iter=300, tol=1e-7)),
    "batch, accel": ("batch", dict(), dict(max_iter=300, tol=1e-7, accel=True)),
    "batch, adaptive rho": ("batch", dict(), dict(max_iter=300, tol=1e-7, adaptive_rho=True)),
    "dp, operator form": ("dp", dict(), dict(max_iter=300, tol=1e-7)),
    "dp, sweeps": ("dp", dict(operator_form=False), dict(max_iter=40, tol=1e-7)),
    "dp, adaptive rho": ("dp", dict(), dict(max_iter=60, tol=1e-7, adaptive_rho=True,
                                            rho_freq=2)),
}


def _lqt(lib, problem, case):
    method, extra, cfg = LQT_CASES[case]
    A, B, cost, x0 = _args(lib, problem)
    kw = dict(project_x=_box(lib, -V_MAX, V_MAX, 2, 1), rho_x=np.diag([0.0, 3.0]),
              project_u=_box(lib, -U_MAX, U_MAX, 1, 0), rho_u=0.5, **extra)
    if lib is torch:
        kw["rho_x"] = torch.tensor(kw["rho_x"])
        solve = tl.lqt_admm_batch if method == "batch" else tl.lqt_admm_dp
        return solve(A, B, cost, x0, cfg=ADMMConfig(**cfg), **kw)
    solve = jl.lqt_admm_batch if method == "batch" else jl.lqt_admm_dp
    return solve(A, B, cost, x0, cfg=JConfig(**cfg), **kw)


def _close(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max()) <= TOL * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("case", list(LQT_CASES))
def test_lqt_admm_matches_jax(problem, case):
    want = _lqt(jnp, problem, case)
    got = _lqt(torch, problem, case)
    j_info, t_info = want[-1], got[-1]
    assert t_info.iters == int(j_info.iters) and t_info.status == int(j_info.status)
    assert _close(got[0], want[0]) and _close(got[1], want[1])
    if LQT_CASES[case][0] == "dp":
        K_t, k_t = got[2]
        K_j, k_j = want[2]
        assert _close(K_t, K_j) and _close(k_t, k_j)
    assert _close(t_info.logs, j_info.logs)
    # the velocity box binds and holds up to the ADMM residual
    v = got[0].numpy().reshape(N, 2)[:, 1]
    assert v.max() > 0.9 * V_MAX and np.abs(v).max() < V_MAX + 1e-2
    assert np.abs(got[1].numpy()).max() < U_MAX + 1e-2


def test_lqt_admm_converges(problem):
    info = _lqt(torch, problem, "batch, chol")[-1]
    assert info.status == SolveStatus.CONVERGED


SLS_CASES = {
    "fixed rho": dict(max_iter=200, tol=1e-6),
    "adaptive rho": dict(max_iter=200, tol=1e-6, adaptive_rho=True),
}


def _feedforward_box(lib, bound):
    """Clip the feedforward column of the (rows, p + 1) matrix [du | phi]."""
    if lib is jnp:
        return lambda Y: Y.at[:, 0].set(jnp.clip(Y[:, 0], -bound, bound))
    return lambda Y: torch.cat([torch.clamp(Y[:, :1], -bound, bound), Y[:, 1:]], dim=1)


@pytest.mark.parametrize("case", list(SLS_CASES))
@pytest.mark.parametrize("feasible", [False, True])
def test_sls_admm_matches_jax(problem, case, feasible):
    out = {}
    for lib in (jnp, torch):
        A, B, cost, _ = _args(lib, problem)
        cfg = (JConfig if lib is jnp else ADMMConfig)(**SLS_CASES[case])
        solve = js.sls_admm if lib is jnp else ts.sls_admm
        out[lib] = solve(A, B, cost, project_u=_feedforward_box(lib, 1.5), rho_u=1.0,
                         robust_dim=1, cfg=cfg, feasible_iterate=feasible)
    (du_j, phi_j, info_j), (du_t, phi_t, info_t) = out[jnp], out[torch]
    assert info_t.iters == int(info_j.iters) and info_t.status == int(info_j.status)
    assert du_t.shape == (N,) and phi_t.shape == (N, 2 * N)
    assert _close(du_t, du_j) and _close(phi_t, phi_j)
    if feasible:
        assert float(du_t.abs().max()) <= 1.5


def test_sls_admm_needs_both_block_parts(problem):
    A, B, cost, _ = _args(torch, problem)
    with pytest.raises(ValueError, match="rho_u=None"):
        ts.sls_admm(A, B, cost, project_u=_feedforward_box(torch, 1.5))
