"""Port vs JAX package: IFT-differentiable ADMM (`tests/test_implicit.py`).

`lqt_admm_implicit` and `fixed_point` get the same seeded problem in
float64 through both packages. The port's gradients (a
`torch.autograd.Function` whose backward runs the transposed Neumann
iteration) agree with `jax.grad` of the JAX package's `custom_vjp` to
1e-8 relative; the forward and backward loops stop on the same float32
test, so they take the same iterations. Each JAX test has its case here,
the two the JAX file marks slow included (N = 40 keeps them to seconds).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator as JDoubleIntegrator
from ilqr_admm_tpu.projections import project_bound as j_project_bound
from ilqr_admm_tpu.solvers.implicit import fixed_point as j_fixed_point
from ilqr_admm_tpu.solvers.implicit import lqt_admm_implicit as j_lqt_admm_implicit
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost as j_viapoint_cost
from ilqr_admm_tpu_torch.convert import dynamics_from_numpy, implicit_theta_from_numpy
from ilqr_admm_tpu_torch.projections import project_bound
from ilqr_admm_tpu_torch.solvers.implicit import fixed_point, lqt_admm_implicit

torch.set_num_threads(2)

F64 = torch.float64
GRAD_RTOL = 1e-8


def _problem(N=40):
    """The JAX test's problem, and the port's copy of it."""
    di = JDoubleIntegrator(1, 2, dt=1.0 / N)
    d, m = di.x_dim, di.u_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    quad = j_viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = di.AB(N)
    tA, tB = dynamics_from_numpy(np.asarray(A), np.asarray(B), device="cpu", dtype=F64)
    theta = dict(Q=np.asarray(quad.Q), R=np.asarray(quad.R), xd=np.asarray(quad.xd),
                 x0=np.zeros(d))
    return dict(A=A, B=B, quad=quad, tA=tA, tB=tB, theta=theta, N=N, d=d, m=m)


def _j_proj(v, p):
    return j_project_bound(v, -p, p)


def _t_proj(v, p):
    return project_bound(v, -p, p)


def _scalar(v):
    return torch.tensor(v, dtype=F64, requires_grad=True)


def _t_theta(p, target=None, bound=None):
    """The port's theta; target (a tensor) replaces xd[-1, 0], bound is pu."""
    theta = implicit_theta_from_numpy(p["theta"], device="cpu", dtype=F64)
    if target is not None:
        theta["xd"] = torch.cat([theta["xd"][:-1], torch.stack(
            [target, theta["xd"][-1, 1]])[None]])
    if bound is not None:
        theta["pu"] = bound
    return theta


def _rel_close(got, want, rtol=GRAD_RTOL):
    got, want = float(got), float(want)
    assert abs(got - want) <= rtol * max(abs(want), 1e-300), (got, want)


def test_implicit_grad_matches_finite_difference():
    p = _problem()
    kw = dict(rho_u=1e-1, n_iters=300, bwd_iters=150)

    def j_loss(xd_target, bound):
        theta = dict(Q=p["quad"].Q, R=p["quad"].R, xd=p["quad"].xd.at[-1, 0].set(xd_target),
                     x0=jnp.zeros(p["d"]), pu=bound)
        xs, us = j_lqt_admm_implicit(p["A"], p["B"], theta, project_u=_j_proj, **kw)
        return jnp.sum((xs[-1, 0] - 0.8) ** 2) + 1e-3 * jnp.sum(us**2)

    def t_loss(xd_target, bound):
        xs, us = lqt_admm_implicit(p["tA"], p["tB"], _t_theta(p, xd_target, bound),
                                   project_u=_t_proj, **kw)
        return torch.sum((xs[-1, 0] - 0.8) ** 2) + 1e-3 * torch.sum(us**2)

    target, bound = _scalar(1.0), _scalar(4.0)
    loss = t_loss(target, bound)
    g_xd, g_b = torch.autograd.grad(loss, (target, bound))
    jg_xd, jg_b = jax.grad(j_loss, argnums=(0, 1))(1.0, 4.0)
    _rel_close(loss.detach(), j_loss(1.0, 4.0), 1e-12)
    _rel_close(g_xd, jg_xd)
    _rel_close(g_b, jg_b)

    eps = 1e-6
    with torch.no_grad():
        fd_xd = (t_loss(_scalar(1.0 + eps), bound) - t_loss(_scalar(1.0 - eps), bound)) / (2 * eps)
        fd_b = (t_loss(target, _scalar(4.0 + eps)) - t_loss(target, _scalar(4.0 - eps))) / (2 * eps)
    np.testing.assert_allclose(float(g_xd), float(fd_xd), rtol=1e-3)
    np.testing.assert_allclose(float(g_b), float(fd_b), rtol=1e-3)


def test_implicit_grad_wrt_bound_active_constraint():
    """d(loss)/d(bound) is nonzero with the bound active, zero when slack."""
    p = _problem()
    kw = dict(rho_u=1e-1, n_iters=150, bwd_iters=80)
    xd_j = p["quad"].xd
    xd_t = torch.tensor(np.asarray(xd_j), dtype=F64)

    def j_loss(bound):
        theta = dict(Q=p["quad"].Q, R=p["quad"].R, xd=xd_j, x0=jnp.zeros(p["d"]), pu=bound)
        xs, _ = j_lqt_admm_implicit(p["A"], p["B"], theta, project_u=_j_proj, **kw)
        return jnp.sum((xs - xd_j) ** 2)

    def t_grad(b):
        bound = _scalar(b)
        xs, _ = lqt_admm_implicit(p["tA"], p["tB"], _t_theta(p, bound=bound),
                                  project_u=_t_proj, **kw)
        return torch.autograd.grad(torch.sum((xs - xd_t) ** 2), bound)[0]

    g_active, g_slack = t_grad(2.0), t_grad(50.0)  # unconstrained max|u| ~ 5.9
    _rel_close(g_active, jax.grad(j_loss)(2.0))
    assert float(jax.grad(j_loss)(50.0)) == 0.0 == float(g_slack)
    assert abs(float(g_active)) > 1e-6


def test_inverse_lqt_gradient_descent_recovers_target():
    """Recover the via-point target from an observed constrained
    trajectory by gradient descent through the solver: the port's
    descent follows JAX's step for step."""
    p = _problem()
    kw = dict(rho_u=1e-1, n_iters=120, bwd_iters=60)
    true_target = 0.7

    def j_solve(target):
        theta = dict(Q=p["quad"].Q, R=p["quad"].R, xd=p["quad"].xd.at[-1, 0].set(target),
                     x0=jnp.zeros(p["d"]), pu=3.0)
        return j_lqt_admm_implicit(p["A"], p["B"], theta, project_u=_j_proj, **kw)

    def t_solve(target):
        return lqt_admm_implicit(p["tA"], p["tB"], _t_theta(p, target, torch.tensor(3.0, dtype=F64)),
                                 project_u=_t_proj, **kw)

    xs_obs_j, _ = j_solve(true_target)
    xs_obs_t, _ = t_solve(torch.tensor(true_target, dtype=F64))
    g = jax.jit(jax.grad(lambda t: jnp.sum((j_solve(t)[0] - xs_obs_j) ** 2)))
    target_j = target_t = 0.2
    for _ in range(60):
        target_j = target_j - 0.005 * float(g(target_j))
        tt = _scalar(target_t)
        (gt,) = torch.autograd.grad(torch.sum((t_solve(tt)[0] - xs_obs_t) ** 2), tt)
        target_t = target_t - 0.005 * float(gt)
        assert abs(target_t - target_j) <= 1e-8 * abs(target_j)
    assert abs(target_t - true_target) < 1e-3, target_t


# -- beyond tests/test_implicit.py ------------------------------------------


def test_fixed_point_matches_custom_vjp():
    """fixed_point on a small contraction with a tree of parameters, one
    of them a constant: the fixed point, the gradient of every tensor
    leaf, and a zero gradient for the warm start."""
    rng = np.random.default_rng(0)
    M = rng.normal(size=(3, 3))
    M = 0.5 * M / np.linalg.norm(M, 2)
    c, s = rng.normal(size=3), 0.7

    def j_step(w, th):
        (v,) = w
        return (jnp.tanh(th["M"] @ v + th["c"]) * th["s"],)

    def t_step(w, th):
        (v,) = w
        return (torch.tanh(th["M"] @ v + th["c"]) * th["s"],)

    def j_loss(Mc):
        (v,) = j_fixed_point(j_step, dict(M=Mc[0], c=Mc[1], s=s), (jnp.zeros(3),), 200, 200, 1e-12)
        return jnp.sum(v**2) + v[0]

    tM = torch.tensor(M, requires_grad=True)
    tc = torch.tensor(c, requires_grad=True)
    w0 = torch.zeros(3, dtype=F64, requires_grad=True)
    (v,) = fixed_point(t_step, dict(M=tM, c=tc, s=s), (w0,), 200, 200, 1e-12)
    gM, gc, gw0 = torch.autograd.grad(torch.sum(v**2) + v[0], (tM, tc, w0))
    jM, jc = jax.grad(j_loss)((jnp.asarray(M), jnp.asarray(c)))
    (jv,) = j_fixed_point(j_step, dict(M=jnp.asarray(M), c=jnp.asarray(c), s=s), (jnp.zeros(3),),
                          200, 200, 1e-12)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(gM.numpy(), np.asarray(jM), rtol=GRAD_RTOL, atol=1e-14)
    np.testing.assert_allclose(gc.numpy(), np.asarray(jc), rtol=GRAD_RTOL, atol=1e-14)
    assert torch.all(gw0 == 0)


def test_lqt_admm_implicit_needs_a_constraint_block():
    p = _problem(N=5)
    theta = _t_theta(p)
    with pytest.raises(ValueError, match="at least one"):
        lqt_admm_implicit(p["tA"], p["tB"], theta)
    with pytest.raises(ValueError, match="rho_u"):
        lqt_admm_implicit(p["tA"], p["tB"], theta, project_u=_t_proj)
