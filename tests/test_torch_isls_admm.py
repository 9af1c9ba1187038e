"""Port vs JAX package: robust iSLS-ADMM on the 3DoF arm, and
`sls_admm(joint_alpha=...)` on the double integrator.

`isls_admm` runs the robust arm of `tests/test_isls_robust.py` (x_std
1e3, u_std 1e-4, ee target [1.5, 2.0], var_q0 0.1, |u| <= 6, rho_u 1) at
N = 25 in float64 through both packages in its three modes: no
projection, a per-row SOC `project_u` at Psi^-1(0.82), and the turnkey
`joint_alpha`. du, phi_u, x_nom and cost must agree to 1e-8 relative,
status and outer iterations exactly (the two differ in the order of f64
sums, amplified by the lifted solves and the nested projection loops).
`sls_admm(joint_alpha=...)` runs the setup of
`tests/test_sls_robust.py::test_joint_calibrated_one_call` at N = 30.
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.stats import norm

from ilqr_admm_tpu.models.arm import PlanarArm as JArm
from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator as JDI
from ilqr_admm_tpu.ops.rollout import rollout_nonlinear as j_rollout
from ilqr_admm_tpu.problem import ADMMConfig as JConfig
from ilqr_admm_tpu.projections import project_set_convex as j_psc, project_soc_unit as j_soc
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost as j_viapoint_cost
from ilqr_admm_tpu_torch.chance import make_state_box_chance_projection
from ilqr_admm_tpu_torch.convert import arm_from_numpy, dynamics_from_numpy, quadcost_from_numpy
from ilqr_admm_tpu_torch.problem import ADMMConfig, SolveStatus
from ilqr_admm_tpu_torch.projections import project_set_convex, project_soc_unit
from ilqr_admm_tpu_torch.solvers.isls_admm import isls_admm
from ilqr_admm_tpu_torch.solvers.sls_admm import sls_admm

torch.set_num_threads(2)
# the JAX package's solvers/__init__ rebinds the module names to the functions
j_isls = importlib.import_module("ilqr_admm_tpu.solvers.isls_admm").isls_admm
j_sls = importlib.import_module("ilqr_admm_tpu.solvers.sls_admm").sls_admm
j_chance = importlib.import_module("ilqr_admm_tpu.chance")

N, VAR_Q0, UPPER_U, TOL = 25, 0.1, 6.0, 1e-8
ALPHAS = 10.0 ** np.linspace(0.0, -5.0, 50)[:10]
SOLVE = dict(robust_dim=3, k_max=6, max_admm_iter=10, outer_tol=1e-4)
JOINT = dict(joint_alpha=0.958, u_bounds=(-UPPER_U, UPPER_U), x0_var=VAR_Q0)


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def arm_problem():
    """tests/test_isls_robust.py::_setup at N."""
    jarm = JArm((1.0, 1.0, 1.0), dt=1.0 / N)
    d, m, n = 9, 3, 3
    x_std = 1e3
    target = jnp.asarray([0.0] * 2 * n + [1.5, 2.0, 0.0])
    w = jnp.asarray([0.0] * n + [x_std] * n + [x_std, x_std, 0.0])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    quad = j_viapoint_cost(jnp.stack([jnp.zeros(d), target]),
                           jnp.stack([jnp.zeros((d, d)), jnp.diag(w)]), seq, 1e-4, m)
    x0 = jarm.initial_state(jnp.asarray([np.pi / 3, -np.pi / 2, -np.pi / 4]))
    u0 = np.zeros((N, m))
    x_nom0 = np.asarray(j_rollout(jarm.step, x0, jnp.asarray(u0)))
    tarm = arm_from_numpy(np.asarray(jarm.lengths), jarm.dt)
    tquad = quadcost_from_numpy(np.asarray(quad.Q), np.asarray(quad.xd), np.asarray(quad.R),
                                device="cpu", dtype=torch.float64)
    return (jarm, quad), (tarm, tquad), x_nom0, u0


def _soc_rows(psi_inv):
    """The per-row SOC data of tests/test_isls_robust.py::_soc_chance_proj."""
    n = 3
    mu = np.zeros(n + 1)
    mu[0] = 1.0
    Adiag = np.diag(np.sqrt(np.append(0.0, np.full(n, VAR_Q0))))
    A_hi = np.concatenate([Adiag, (-mu / psi_inv)[None]], 0)
    A_lo = np.concatenate([Adiag, (mu / psi_inv)[None]], 0)
    b = np.append(np.zeros(n + 1), UPPER_U / psi_inv)
    return [A_hi, A_lo], [b, b]


def _jax_proj(psi_inv):
    As, bs = _soc_rows(psi_inv)
    As, bs = [jnp.asarray(a) for a in As], [jnp.asarray(b) for b in bs]

    def proj_u(y, u_nom):
        y_abs = y.at[:, 0].add(u_nom.reshape(-1))
        out = j_psc(y_abs, As, bs, [j_soc] * 2, rho=1e1, max_iter=100, threshold=1e-4)
        return out.at[:, 0].add(-u_nom.reshape(-1))

    return proj_u


def _torch_proj(psi_inv):
    As, bs = _soc_rows(psi_inv)
    As, bs = [torch.tensor(a) for a in As], [torch.tensor(b) for b in bs]

    def proj_u(y, u_nom):
        shift = torch.zeros_like(y)
        shift[:, 0] = u_nom.reshape(-1)
        out = project_set_convex(y + shift, As, bs, [project_soc_unit] * 2, rho=1e1,
                                 max_iter=100, threshold=1e-4)
        return out - shift

    return proj_u


MODES = ["no projection", "per-row SOC", "joint_alpha", "joint_alpha, Anderson"]


def _mode_kwargs(mode, proj):
    if mode == "no projection":
        return {}
    if mode == "per-row SOC":
        return dict(project_u=proj(float(norm.ppf(0.82))), rho_u=1.0)
    extra = dict(anderson_m=4) if "Anderson" in mode else {}
    return dict(JOINT, rho_u=1.0, **extra)


def _solve(arm_problem, mode, side, **over):
    (jarm, jquad), (tarm, tquad), x_nom0, u0 = arm_problem
    kw = dict(SOLVE, **over)
    if side == "jax":
        return j_isls(jarm.step, jarm.get_AB, jquad, jnp.asarray(x_nom0), jnp.asarray(u0),
                      quad_cost=jquad, alphas=jnp.asarray(ALPHAS), **kw,
                      **_mode_kwargs(mode, _jax_proj))
    return isls_admm(tarm.step, tarm.get_AB, tquad, torch.tensor(x_nom0), torch.tensor(u0),
                     quad_cost=tquad, alphas=torch.tensor(ALPHAS), device="cpu", **kw,
                     **_mode_kwargs(mode, _torch_proj))


@pytest.mark.parametrize("mode", MODES)
def test_isls_admm_matches_jax(arm_problem, mode):
    want = _solve(arm_problem, mode, "jax")
    got = _solve(arm_problem, mode, "torch")
    assert got.outer_iters == int(want.outer_iters) and got.status == int(want.status)
    assert got.du.shape == (N * 3,) and got.phi_u.shape == (N * 3, 3)
    for name in ("du", "phi_u", "x_nom", "u_nom", "cost"):
        assert _rel(getattr(got, name), getattr(want, name)) < TOL, name
    log_j, log_t = np.asarray(want.cost_log), got.cost_log.numpy()
    assert np.array_equal(np.isinf(log_t), np.isinf(log_j))
    assert _rel(log_t[np.isfinite(log_j)], log_j[np.isfinite(log_j)]) < TOL
    if mode == "joint_alpha":
        # the returned controller is the projected z-iterate: its rows
        # certify the chi ball, min z-score >= chi_3^{-1}(0.958)
        psi = j_chance.calibrate(joint_alpha=0.958, robust_dim=3).psi_inv
        u_abs = got.u_nom.reshape(-1) + got.du
        spread = np.sqrt(VAR_Q0) * torch.linalg.vector_norm(got.phi_u, dim=-1)
        z = torch.minimum(UPPER_U - u_abs, u_abs + UPPER_U) / torch.clamp(spread, min=1e-12)
        assert float(z.min()) >= psi - 5e-2


def test_isls_admm_anderson_smoke(arm_problem):
    """tests/test_isls_robust.py::test_isls_admm_anderson_smoke on the port:
    anderson_m stays finite and near the plain run."""
    kw = dict(k_max=4, max_admm_iter=6, outer_tol=1e-6)
    plain = _solve(arm_problem, "joint_alpha", "torch", **kw)
    acc = _solve(arm_problem, "joint_alpha, Anderson", "torch", **kw)
    assert bool(torch.isfinite(acc.du).all()) and bool(torch.isfinite(acc.phi_u).all())
    assert float((acc.x_nom - plain.x_nom).abs().max()) < 5e-2


def test_feasible_iterate_off_returns_the_x_update(arm_problem):
    """feasible_iterate=False returns the last x-update's [du | phi_u], as
    the JAX package does."""
    got = _solve(arm_problem, "joint_alpha", "torch", k_max=2, feasible_iterate=False)
    want = _solve(arm_problem, "joint_alpha", "jax", k_max=2, feasible_iterate=False)
    for name in ("du", "phi_u"):
        assert _rel(getattr(got, name), getattr(want, name)) < TOL, name


def test_isls_argument_errors(arm_problem):
    (_, _), (tarm, tquad), x_nom0, u0 = arm_problem
    args = (tarm.step, tarm.get_AB, tquad, torch.tensor(x_nom0), torch.tensor(u0), 3)
    with pytest.raises(ValueError, match="either joint_alpha or project_u"):
        isls_admm(*args, quad_cost=tquad, project_u=_torch_proj(1.0), rho_u=1.0, device="cpu",
                  **JOINT)
    with pytest.raises(ValueError, match="requires u_bounds"):
        isls_admm(*args, quad_cost=tquad, joint_alpha=0.9, x0_var=VAR_Q0, rho_u=1.0, device="cpu")
    with pytest.raises(ValueError, match="rho_u"):
        isls_admm(*args, quad_cost=tquad, project_u=_torch_proj(1.0), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            isls_admm(*args, quad_cost=tquad)
    assert SolveStatus.MAX_ITER == 3


# sls_admm(joint_alpha=...): tests/test_sls_robust.py::test_joint_calibrated_one_call at N_SLS
N_SLS, X_FINAL, VAR_X0 = 30, 0.5, 0.02


@pytest.fixture(scope="module")
def di_problem():
    plant = JDI(1, 2, dt=1.0 / N_SLS)
    d = plant.x_dim
    seq = np.zeros(N_SLS, dtype=np.int32)
    seq[-1] = 1
    cost = j_viapoint_cost(jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 1.0])]),
                           jnp.zeros((2, d, d)), seq, 1e-4, plant.u_dim)
    A, B = plant.AB(N_SLS)
    tA, tB = dynamics_from_numpy(np.asarray(A), np.asarray(B), device="cpu", dtype=torch.float64)
    tcost = quadcost_from_numpy(np.asarray(cost.Q), np.asarray(cost.xd), np.asarray(cost.R),
                                device="cpu", dtype=torch.float64)
    return (A, B, cost), (tA, tB, tcost)


@pytest.mark.parametrize("with_state_pin", [True, False])
def test_sls_admm_joint_alpha_matches_jax(di_problem, with_state_pin):
    (A, B, cost), (tA, tB, tcost) = di_problem
    d = 2
    pins = {(N_SLS - 1, 0): (X_FINAL, X_FINAL), (N_SLS - 1, 1): (0.0, 0.0)}
    rho_x = np.zeros((N_SLS, d, d))
    rho_x[-1] = np.eye(d) * 1e3
    kw = dict(joint_alpha=0.95, u_bounds=(-3.0, 3.0), x0_var=VAR_X0, rho_u=1e-3, robust_dim=1)
    j_kw, t_kw = dict(kw), dict(kw)
    if with_state_pin:
        j_kw.update(project_x=j_chance.make_state_box_chance_projection(
            VAR_X0, 1, N_SLS, d, pins, joint_alpha=0.95)[0], rho_x=jnp.asarray(rho_x))
        t_kw.update(project_x=make_state_box_chance_projection(
            VAR_X0, 1, N_SLS, d, pins, joint_alpha=0.95, device="cpu")[0],
            rho_x=torch.tensor(rho_x))
    du_j, phi_j, info_j = j_sls(A, B, cost, cfg=JConfig(max_iter=100, tol=1e-5, stall_tol=1e-6),
                                **j_kw)
    du_t, phi_t, info_t = sls_admm(tA, tB, tcost,
                                   cfg=ADMMConfig(max_iter=100, tol=1e-5, stall_tol=1e-6), **t_kw)
    assert info_t.iters == int(info_j.iters) and info_t.status == int(info_j.status)
    assert _rel(du_t, du_j) < TOL and _rel(phi_t, phi_j) < TOL
    if not with_state_pin:
        # the z-side controller (feasible_iterate's default) keeps every
        # row's SOC: z-score >= chi_1^{-1}(0.95), up to the projection's
        # tolerance
        psi = j_chance.calibrate(joint_alpha=0.95, robust_dim=1).psi_inv
        spread = np.sqrt(VAR_X0) * phi_t[:, 0].abs()
        z = torch.minimum(3.0 - du_t, du_t + 3.0) / torch.clamp(spread, min=1e-12)
        assert float(z.min()) >= psi - 5e-2


def test_sls_admm_joint_alpha_errors(di_problem):
    _, (tA, tB, tcost) = di_problem
    with pytest.raises(ValueError, match="either joint_alpha or project_u"):
        sls_admm(tA, tB, tcost, project_u=lambda y: y, rho_u=1.0, joint_alpha=0.9,
                 u_bounds=(-1.0, 1.0), x0_var=0.1)
    with pytest.raises(ValueError, match="requires u_bounds"):
        sls_admm(tA, tB, tcost, joint_alpha=0.9, rho_u=1.0)
