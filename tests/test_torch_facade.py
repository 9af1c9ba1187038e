"""Port vs JAX package: the reference-style facade `SLS` / `iSLS`
(`tests/test_facade.py`).

Each test of `tests/test_facade.py` runs the same notebook workflow with
the same seeded numpy inputs through both facades in float64, the port's
on the CPU (`device="cpu"`, `use_x64()` scoped by the `x64` fixture).
Solves agree to 1e-10 relative in cost and 1e-8 in trajectories and
gains; every cost log has the same length and values. Beyond the JAX
file: noisy Monte-Carlo rollouts (the same numpy draws), the device rule
(no card, no `device`: an error) and the float32 default.
`tests/test_torch_facade_solvers.py` holds the facade's other solvers.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu import SLS as JSLS, iSLS as JiSLS
from ilqr_admm_tpu import get_double_integrator_AB as j_double_integrator_AB
from ilqr_admm_tpu.models import car as jcar
from ilqr_admm_tpu.projections import project_bound as j_project_bound
from ilqr_admm_tpu_torch import SLS, iSLS
from ilqr_admm_tpu_torch.convert import (
    car_from_numpy,
    car_parking_cost_from_numpy,
    facade_from_numpy,
    nominal_from_numpy,
)
from ilqr_admm_tpu_torch.models import car as tcar
from ilqr_admm_tpu_torch.projections import project_bound
from ilqr_admm_tpu_torch.utils.precision import use_x64

torch.set_num_threads(2)

F64 = torch.float64
COST_RTOL = 1e-10
TRAJ_TOL = 1e-8


@pytest.fixture
def x64():
    """The port's working dtype float64 (`use_x64`) for one test, then back."""
    prev = torch.get_default_dtype()
    use_x64()
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


def _n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, tol=TRAJ_TOL):
    got, want = _n(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1.0))


def cost_close(got, want, rtol=COST_RTOL):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def _viapoint(d, N, target, weight):
    zs = np.stack([np.zeros(d), np.asarray(target, dtype=float)])
    Qs = np.stack([np.zeros((d, d)), np.eye(d) * weight])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    return zs, Qs, seq


def _sls_pair(d, m, N, dt, target, weight, u_std=1e-2, nb_dim=1):
    """The JAX facade and the port's, with the same dynamics and cost."""
    A, B = j_double_integrator_AB(nb_dim, nb_deriv=2, dt=dt)
    zs, Qs, seq = _viapoint(d, N, target, weight)
    j = JSLS(d, m, N)
    j.AB = [A, B]
    j.set_quadratic_cost(zs, Qs, seq, u_std)
    t = facade_from_numpy(SLS, d, m, N, A=np.asarray(A), B=np.asarray(B),
                          viapoint=(zs, Qs, seq, u_std), device="cpu", dtype=F64)
    return j, t, (zs, Qs, seq)


def test_sls_notebook_workflow(x64):
    """The double-integrator control-bounds notebook, end to end."""
    N, d, u_dim = 100, 2, 1
    j, t, (zs, _, seq) = _sls_pair(d, u_dim, N, 1.0 / N, [1.0, 0.0], 1e6)
    x0 = np.zeros(d)

    x_opt, u_opt = t.solve(x0, method="batch")
    jx_opt, ju_opt = j.solve(x0, method="batch")
    close(x_opt, jx_opt)
    close(u_opt, ju_opt)
    assert abs(float(x_opt[-1, 0]) - 1.0) < 1e-3

    K, k = t.solve(method="dp")
    jK, jk = j.solve(method="dp")
    close(K, jK)
    close(k, jk)
    xs_dp, us_dp = t.get_trajectory_dp(x0, K, k)
    close(xs_dp, j.get_trajectory_dp(x0, jK, jk)[0])
    np.testing.assert_allclose(_n(xs_dp), _n(x_opt), atol=1e-6)

    close(t.Sw, j.Sw)
    close(t.Su, j.Su)
    x_lift = _n(t.Sw)[:, :d] @ x0 + _n(t.Su) @ _n(u_opt).reshape(-1)
    np.testing.assert_allclose(x_lift.reshape(N, d), _n(x_opt), atol=1e-8)

    proj, j_proj = (lambda u: project_bound(u, -5.0, 5.0)), (lambda u: j_project_bound(u, -5.0, 5.0))
    kw = dict(max_iter=100, rho_u=1e-2, tol=1e-4, log=True)
    x_c, u_c, log = t.ADMM_LQT_Batch(x0, project_u=proj, **kw)
    jx_c, ju_c, jlog = j.ADMM_LQT_Batch(x0, project_u=j_proj, **kw)
    close(x_c, jx_c)
    close(u_c, ju_c)
    assert log.shape == jlog.shape and log.shape[1] == 2
    close(log, jlog)
    assert float(u_c.max()) <= 5.0 + 1e-2
    c_con, c_unc = float(t.compute_cost(x_c, u_c)), float(t.compute_cost(x_opt, u_opt))
    cost_close(c_con, j.compute_cost(jx_c, ju_c))
    cost_close(c_unc, j.compute_cost(jx_opt, ju_opt))
    assert c_con >= c_unc and abs(c_con - 12.50) < 0.15

    x_aa, u_aa, log_aa = t.ADMM_LQT_Batch(x0, project_u=proj, anderson_m=5, **kw)
    _, ju_aa, jlog_aa = j.ADMM_LQT_Batch(x0, project_u=j_proj, anderson_m=5, **kw)
    close(u_aa, ju_aa)
    assert log_aa.shape == jlog_aa.shape and log_aa.shape[0] < log.shape[0]
    np.testing.assert_allclose(_n(u_aa), _n(u_c), atol=1e-3)

    kw = dict(max_iter=500, rho_u=1e-1, tol=1e-4)
    x_c2, u_c2, K2, k2 = t.ADMM_LQT_DP(x0, project_u=proj, **kw)
    jx_c2, ju_c2, jK2, jk2 = j.ADMM_LQT_DP(x0, project_u=j_proj, **kw)
    for got, want in ((x_c2, jx_c2), (u_c2, ju_c2), (K2, jK2), (k2, jk2)):
        close(got, want)
    x0s = np.zeros((64, d))
    x0s[:, 0] = np.random.default_rng(0).normal(0, 0.1, 64)
    xs_mc, us_mc = t.get_trajectory_dp(x0s, K2, k2)
    assert xs_mc.shape == (64, N, d)
    close(xs_mc, j.get_trajectory_dp(x0s, jK2, jk2)[0])
    # noisy rollouts: the same numpy draws in both packages
    noisy = t.get_trajectory_dp(x0s, K2, k2, noise_scale=1e-3, rng=np.random.default_rng(4))
    j_noisy = j.get_trajectory_dp(x0s, jK2, jk2, noise_scale=1e-3, rng=np.random.default_rng(4))
    close(noisy[0], j_noisy[0])
    close(noisy[1], j_noisy[1])

    PHI_U, du = t.solve(method="sls")
    jPHI_U, jdu = j.solve(method="sls")
    close(PHI_U, jPHI_U)
    close(du, jdu)
    K_sls, k_sls = t.controller(PHI_U, du)
    jK_sls, jk_sls = j.controller(jPHI_U, jdu)
    close(K_sls, jK_sls)
    close(k_sls, jk_sls)
    xs_sls, us_sls = t.get_trajectory_sls(x0s, K_sls, k_sls)
    jxs_sls, jus_sls = j.get_trajectory_sls(x0s, jK_sls, jk_sls)
    assert xs_sls.shape == (64, N, d)
    close(xs_sls, jxs_sls)
    close(us_sls, jus_sls)
    xs_ol, us_ol = t.get_trajectory_batch(x0s[:3], u_opt, noise_scale=1e-3,
                                          rng=np.random.default_rng(6))
    jxs_ol, jus_ol = j.get_trajectory_batch(x0s[:3], ju_opt, noise_scale=1e-3,
                                            rng=np.random.default_rng(6))
    close(xs_ol, jxs_ol)
    close(us_ol, jus_ol)

    t.initialize_replanning_procedure(K_sls)
    j.initialize_replanning_procedure(jK_sls)
    zs2 = zs.copy()
    zs2[1, 0] = 0.7
    xd_new = zs2[seq].reshape(-1)
    k_new = t.replan_feedforward(k_sls, xd_new)
    assert k_new.shape == k_sls.shape
    close(k_new, j.replan_feedforward(jk_sls, jnp.asarray(xd_new)))


def _car_parking_pair(N, dt):
    """The Tutorial car in both packages: (JAX facade, port facade, JAX car,
    port car, JAX cost, port cost)."""
    jc, jcost = jcar.CarFrontWheel(dt=dt), jcar.CarParkingCost()
    tc = car_from_numpy(dt)
    tcost = car_parking_cost_from_numpy(jcost.cu, jcost.cf, jcost.pf, jcost.cx, jcost.px,
                                        device="cpu", dtype=F64)
    j, t = JiSLS(x_dim=4, u_dim=2, N=N), iSLS(x_dim=4, u_dim=2, N=N, device="cpu")
    j.forward_model, t.forward_model = jc.step, tc.step
    j.cost_function, t.cost_function = jcost, tcost
    return j, t, jc, tc, jcost, tcost


def _set_nominal(j, t, x_nom, u_nom):
    j.reset()
    t.reset()
    j.nominal_values = x_nom, u_nom
    t.nominal_values = nominal_from_numpy(_n(x_nom), _n(u_nom), device="cpu", dtype=F64)
    cost_close(t.cost, j.cost)


def test_isls_tutorial_workflow(x64):
    """The Tutorial car workflow through both iSLS facades."""
    N = 200
    j, t, jc, tc, jcost, tcost = _car_parking_pair(N, 0.03)
    u0 = np.random.default_rng(5).normal(size=(N, 2)) * 0.1
    x0 = np.array([1.0, 1.0, 3 * np.pi / 2, 0.0])

    x_nom, u_nom = t.get_trajectory_batch(x0, u0)
    jx_nom, ju_nom = j.get_trajectory_batch(x0, u0)
    close(x_nom, jx_nom)
    _set_nominal(j, t, jx_nom, ju_nom)
    assert isinstance(t.cost, float) and len(t.cost_log) == 1

    kw = dict(max_iter=25, max_line_search_iter=25, method="dp", verbose=False)
    t.solve(tc.get_AB, tcost.get_Cs, **kw)
    j.solve(jc.get_AB, jcost.get_Cs, **kw)
    cost_close(t.cost_log, j.cost_log)
    close(t.x_nom, j.x_nom)
    close(t.K, j.K)
    assert t.cost < t.cost_log[0] and len(t.cost_log) > 1

    _set_nominal(j, t, jx_nom, ju_nom)
    t.solve_ilqr(tc.get_AB, get_Cs=tcost.get_Cs, max_ilqr_iter=5, dp=True)
    j.solve_ilqr(jc.get_AB, get_Cs=jcost.get_Cs, max_ilqr_iter=5, dp=True)
    cost_close(t.cost_log, j.cost_log)
    assert len(t.cost_log) >= 2

    _set_nominal(j, t, jx_nom, ju_nom)
    lo, hi = torch.tensor([-0.5, -2.0], dtype=F64), torch.tensor([0.5, 2.0], dtype=F64)

    def project_u(u):
        return torch.clamp(u.reshape(N, 2), lo, hi).reshape(-1)

    def j_project_u(u):
        u_ = u.reshape(N, 2)
        u_ = u_.at[:, 0].set(jnp.clip(u_[:, 0], -0.5, 0.5))
        u_ = u_.at[:, 1].set(jnp.clip(u_[:, 1], -2.0, 2.0))
        return u_.reshape(-1)

    kw = dict(max_iter=20, max_admm_iter=5, max_line_search_iter=25, rho_u=np.diag([1e-1, 1e-2]),
              tol=1e-3, log=True)
    log = t.ilqr_admm(get_AB=tc.get_AB, get_Cs=tcost.get_Cs, project_u=project_u, **kw)
    jlog = j.ilqr_admm(get_AB=jc.get_AB, get_Cs=jcost.get_Cs, project_u=j_project_u, **kw)
    cost_close(log, jlog)
    close(t.u_nom, j.u_nom)
    us = _n(t.u_nom)
    assert np.abs(us[:, 0]).max() <= 0.5 + 5e-2
    assert np.abs(us[:, 1]).max() <= 2.0 + 5e-2


def test_isls_quadratic_cost_and_aliases(x64):
    """set_cost_variables and the quadratic-cost iLQR path (Car notebooks)."""
    N = 80
    jc, tc = jcar.CarSimple(dt=15.0 / 500), tcar.CarSimple(dt=15.0 / 500)
    zs, Qs, seq = _viapoint(4, N, [-1.0, -1.0, np.pi / 4, 0.0], 1e2)
    j, t = JiSLS(4, 2, N), iSLS(4, 2, N, device="cpu")
    j.forward_model, t.forward_model = jc.step, tc.step
    j.set_cost_variables(zs, Qs, seq, 1e-2)
    t.set_cost_variables(zs, Qs, seq, 1e-2)

    x0 = np.array([0.0, -2.0, np.pi / 2, 0.0])
    x_nom, u_nom = t.rollout_batch(x0[None], np.zeros((1, N, 2)))
    jx_nom, ju_nom = j.rollout_batch(x0[None], np.zeros((1, N, 2)))
    close(x_nom, jx_nom)
    t.reset()
    j.reset()
    t.nominal_values = x_nom[0], u_nom[0]
    j.nominal_values = jx_nom[0], ju_nom[0]
    cost_close(t.cost, j.cost)

    c0 = t.cost
    t.solve(tc.get_AB, method="dp", max_iter=30, max_line_search_iter=30)
    j.solve(jc.get_AB, method="dp", max_iter=30, max_line_search_iter=30)
    cost_close(t.cost_log, j.cost_log)
    close(t.x_nom, j.x_nom)
    assert t.cost < c0
    assert np.linalg.norm(_n(t.x_nom[-1])[:2] - np.array([-1.0, -1.0])) < 0.3


def test_facade_solve_dp_ff(x64):
    """The cached-blocks feedforward re-sweep."""
    N = 50
    j, t, _ = _sls_pair(2, 1, N, 1.0 / N, [1.0, 0.0], 1e4)
    K, k, Quu, Quu_inv, Qux = t.solve_dp(return_Qs=True)
    jout = j.solve_dp(return_Qs=True)
    for got, want in zip((K, k, Quu, Quu_inv, Qux), jout):
        close(got, want)
    k2 = t.solve_dp_ff(K, Quu, Qux, Quu_inv)
    close(k2, j.solve_dp_ff(*(jout[i] for i in (0, 2, 4, 3))))
    np.testing.assert_allclose(_n(k2), _n(k), atol=1e-10)


def test_facade_solve_dp_time_parallel(x64):
    """solve_dp(time_parallel=...) matches the sequential scan. The JAX
    package's flat scan aborts XLA:CPU in a process that imported torch,
    so the port's flat scan is held to JAX's sequential gains (as the JAX
    test holds JAX's own), and the blocked scans to each other."""
    N = 50
    j, t, _ = _sls_pair(2, 1, N, 1.0 / N, [1.0, 0.0], 1e4)
    K_s, k_s = t.solve_dp()
    jK_s, jk_s = j.solve_dp()
    close(K_s, jK_s)
    close(k_s, jk_s)
    K_f, k_f = t.solve_dp(time_parallel="flat")
    close(K_f, jK_s)
    close(k_f, jk_s)
    K_b, k_b = t.solve_dp(time_parallel=16)
    jK_b, jk_b = j.solve_dp(time_parallel=16)
    close(K_b, jK_b)
    close(k_b, jk_b)
    np.testing.assert_allclose(_n(K_b), _n(K_s), atol=1e-8)
    np.testing.assert_allclose(_n(k_b), _n(k_s), atol=1e-8)


def test_isls_solve_stores_final_linearization(x64):
    """After a solve the facade holds the linearization at the solution, so
    Su, Sw and controller() work."""
    N = 40
    j, t, jc, tc, jcost, tcost = _car_parking_pair(N, 0.05)
    u0 = np.random.default_rng(0).normal(size=(N, 2)) * 0.1
    x0 = np.array([1.0, 1.0, 3 * np.pi / 2, 0.0])
    jx_nom, ju_nom = j.get_trajectory_batch(x0, u0)
    _set_nominal(j, t, jx_nom, ju_nom)
    assert t.A is None
    t.solve(tc.get_AB, tcost.get_Cs, max_iter=3, method="dp")
    j.solve(jc.get_AB, jcost.get_Cs, max_iter=3, method="dp")
    assert t.A is not None and t.A.shape == (N, 4, 4)
    close(t.A, j.A)
    A_now, _ = tc.get_AB(t.x_nom, t.u_nom)
    np.testing.assert_allclose(_n(t.A), _n(A_now), atol=1e-12)
    assert t.Su.shape == (N * 4, N * 2)
    close(t.Su, j.Su)


def test_compute_cost_shape_dispatch(x64):
    """Stacked or lifted, batched or not, N = 1 included (where N*dim == dim)."""
    rng = np.random.default_rng(0)
    for N in (5, 1):
        j, t, _ = _sls_pair(2, 1, N, 0.1, [1.0, 0.0], 10.0)
        xs, us = rng.normal(size=(N, 2)), rng.normal(size=(N, 1))
        c_ref = float(t.compute_cost(xs, us))
        cost_close(c_ref, j.compute_cost(xs, us))
        cost_close(float(t.compute_cost(xs.reshape(-1), us.reshape(-1))), c_ref)
        xb, ub = np.stack([xs, 2 * xs]), np.stack([us, 2 * us])
        cb = _n(t.compute_cost(xb, ub))
        assert cb.shape == (2,)
        cost_close(cb, j.compute_cost(xb, ub))
        cost_close(_n(t.compute_cost(xb.reshape(2, -1), ub.reshape(2, -1))), cb)
    t = SLS(2, 1, 5, device="cpu")
    with pytest.raises(ValueError, match="stacked"):
        t.compute_cost(np.zeros((3, 7)))


def test_u_optimal_x_optimal_against_lifted_definition(x64):
    N, d = 40, 2
    j, t, _ = _sls_pair(d, 1, N, 1.0 / N, [1.0, 0.0], 1e6)
    x0 = np.array([0.3, -0.2])
    x_b, u_b = t.solve(x0, method="batch")
    PHI_U, du = t.solve(method="sls")
    jPHI_U, jdu = j.solve(method="sls")
    u_sls = t.u_optimal(x0, PHI_U, du)
    assert u_sls.shape == (N - 1, 1)
    close(u_sls, j.u_optimal(jnp.asarray(x0), jPHI_U, jdu))
    np.testing.assert_allclose(_n(u_sls), _n(u_b)[:-1], atol=1e-6)
    PHI_X = t.Sw + t.Su @ PHI_U
    dx = t.Su @ du
    x_sls = t.x_optimal(x0, PHI_X, dx)
    close(x_sls, j.x_optimal(jnp.asarray(x0), j.Sw + j.Su @ jPHI_U, j.Su @ jdu))
    np.testing.assert_allclose(_n(x_sls), _n(x_b), atol=1e-6)
    np.testing.assert_array_equal(_n(t.u_optimal(np.zeros(d), PHI_U, du)),
                                  _n(du).reshape(N, 1)[:-1])


# -- beyond tests/test_facade.py: the device and dtype rules ------------------


def test_facade_needs_a_card_without_device(monkeypatch):
    """Without `device` the facade is for the card: with no card it
    raises instead of building on the CPU. The default dtype is float32
    here, outside the `x64` fixture."""
    assert torch.get_default_dtype() == torch.float32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (SLS, iSLS):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(2, 1, 5)
        assert cls(2, 1, 5, device="cpu").device == torch.device("cpu")


def test_float32_facade_uses_the_default_dtype():
    """Outside `use_x64` the facade works in float32, picks the QR x-update
    for a stiff cost and warns past float32's range, as the JAX facade
    does without x64."""
    N = 20
    A, B = j_double_integrator_AB(1, nb_deriv=2, dt=1.0 / N)
    t = SLS(2, 1, N, device="cpu")
    t.AB = [np.asarray(A), np.asarray(B)]
    zs, Qs, seq = _viapoint(2, N, [1.0, 0.0], 1e6)
    t.set_quadratic_cost(zs, Qs, seq, 1e-2)
    assert t.A.dtype == torch.float32 and t._auto_use_qr()
    x, u = t.solve(np.zeros(2), method="batch")
    assert x.dtype == torch.float32 and abs(float(x[-1, 0]) - 1.0) < 1e-2
    with pytest.warns(UserWarning, match="exceeds float32"):
        t.set_quadratic_cost(zs, Qs, seq, 1e-4)
