"""Port vs JAX package: the plain fleet `solvers/batched.py::make_batched_lqt_admm`.

The same problems, made from a seed with numpy, go through the JAX fleet
and its port in float64 on the CPU. Both compute the same operations in
the same order; they differ only in the round-off of the two libraries'
inverses of the lifted normal matrix (condition ~1e6 at the 1e3 via-point
weight). The tolerance is 1e-10 relative to the largest entry unless
noted.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu.projections import project_bound
from ilqr_admm_tpu.solvers.batched import make_batched_lqt_admm as jax_fleet
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.convert import array_from_numpy, dynamics_from_numpy, quadcost_from_numpy
from ilqr_admm_tpu_torch.solvers.batched import _chol_solve_small, make_batched_lqt_admm

torch.set_num_threads(2)

F64 = torch.float64


def _problem(N, target=(1.0, 0.0), weight=1e3, r=1e-2):
    """The fleet problem of tests/test_batched_admm.py, in f64."""
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray(target)])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * weight])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, r, m)
    A, B = plant.AB(N)
    return A, B, cost


def _port(A, B, cost):
    tA, tB = dynamics_from_numpy(np.asarray(A), np.asarray(B), device="cpu", dtype=F64)
    tcost = quadcost_from_numpy(
        np.asarray(cost.Q), np.asarray(cost.xd), np.asarray(cost.R), device="cpu", dtype=F64
    )
    return tA, tB, tcost


def _x0s(seed, batch, scale=0.2):
    return np.random.default_rng(seed).normal(0.0, scale, size=(batch, 2))


def _agree(port_out, jax_out, tol):
    for got, want in zip(port_out, jax_out):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=tol * max(1.0, np.abs(want).max()))


def _pin(N, backend):
    """The terminal pin of tests/test_batched_admm.py:56-60, x_N = (0.5, 0)."""
    if backend == "jax":
        def proj(x):
            x_ = x.reshape(-1, N, 2)
            return x_.at[:, -1, 0].set(0.5).at[:, -1, 1].set(0.0).reshape(x.shape)
    else:
        def proj(x):
            x_ = x.reshape(-1, N, 2).clone()
            x_[:, -1, 0] = 0.5
            x_[:, -1, 1] = 0.0
            return x_.reshape(x.shape)
    return proj


def _vbox(N, v_max, backend):
    """Velocity box |v| <= v_max on flattened (batch, N*2) states."""
    lo = np.tile([-np.inf, -v_max], N)
    hi = np.tile([np.inf, v_max], N)
    if backend == "jax":
        return lambda x: jnp.clip(x, lo, hi)
    lo_t, hi_t = torch.tensor(lo), torch.tensor(hi)
    return lambda x: torch.minimum(torch.maximum(x, lo_t), hi_t)


def test_fixed_count_u_only():
    N = 60
    A, B, cost = _problem(N)
    x0s = _x0s(0, 8, 0.15)
    kw = dict(rho_u=1e-2, n_iters=60)
    want = jax_fleet(A, B, cost, project_u=lambda u: project_bound(u, -5.0, 5.0), **kw)(
        jnp.asarray(x0s)
    )
    solver = make_batched_lqt_admm(*_port(A, B, cost), project_u=lambda u: u.clamp(-5.0, 5.0),
                                   **kw, device="cpu")
    got = solver(torch.tensor(x0s))
    _agree(got, want, 1e-10)
    assert got[1].dtype == F64 and tuple(got[0].shape) == (8, 2 * N)


def test_fixed_count_both_blocks_terminal_pin():
    """Both blocks, a callable project_x (the terminal pin) and an (N, d, d)
    rho_x that is zero except at the last step."""
    N = 50
    A, B, cost = _problem(N, target=(1.0, 1.0), weight=0.0, r=1e-4)
    rho_x = np.zeros((N, 2, 2))
    rho_x[-1] = np.eye(2) * 1e1
    x0s = _x0s(1, 4)
    want = jax_fleet(A, B, cost, project_x=_pin(N, "jax"),
                     project_u=lambda u: project_bound(u, -3.0, 3.0),
                     rho_x=jnp.asarray(rho_x), rho_u=1e-3, n_iters=300)(jnp.asarray(x0s))
    got = make_batched_lqt_admm(
        *_port(A, B, cost), project_x=_pin(N, "torch"), project_u=lambda u: u.clamp(-3.0, 3.0),
        rho_x=array_from_numpy(rho_x,
        device="cpu", dtype=F64), rho_u=1e-3, n_iters=300, device="cpu",
    )(torch.tensor(x0s))
    _agree(got, want, 1e-10)
    xs = got[0].numpy().reshape(4, N, 2)
    assert np.abs(xs[:, -1, 0] - 0.5).max() < 2e-2


@pytest.mark.parametrize("tol", [1e-8, 1e-3])
def test_tol_freeze_matches_jax(tol):
    """tol > 0: the per-instance freeze, on a velocity-boxed fleet whose
    instances converge at different iterations."""
    N = 40
    A, B, cost = _problem(N)
    x0s = _x0s(3, 16, 0.3)
    kw = dict(rho_x=10.0, rho_u=0.1, n_iters=400, tol=tol)
    want = jax_fleet(A, B, cost, project_x=_vbox(N, 1.3, "jax"),
                     project_u=lambda u: project_bound(u, -5.0, 5.0), **kw)(jnp.asarray(x0s))
    got = make_batched_lqt_admm(*_port(A, B, cost), project_x=_vbox(N, 1.3, "torch"),
                                project_u=lambda u: u.clamp(-5.0, 5.0), **kw,
                                device="cpu")(torch.tensor(x0s))
    _agree(got, want, 1e-10)


@pytest.mark.parametrize("blocks", ["u", "xu"])
def test_anderson_matches_jax(blocks):
    """anderson_m = 5 against the JAX fleet at the 1e-8 of
    tests/test_batched_admm.py:194, relative to the largest entry (control
    box; terminal pin and box)."""
    N = 60 if blocks == "u" else 40
    A, B, cost = _problem(N)
    x0s = _x0s(5, 8, 0.3)
    kw = dict(rho_u=1e-2, n_iters=400, tol=1e-7, anderson_m=5)
    jax_kw, port_kw = {}, {}
    if blocks == "xu":
        rho_x = np.zeros((N, 2, 2))
        rho_x[-1] = np.eye(2) * 1e1
        jax_kw = dict(project_x=_pin(N, "jax"), rho_x=jnp.asarray(rho_x))
        port_kw = dict(project_x=_pin(N, "torch"), rho_x=torch.tensor(rho_x))
    want = jax_fleet(A, B, cost, project_u=lambda u: project_bound(u, -5.0, 5.0), **jax_kw,
                     **kw)(jnp.asarray(x0s))
    got = make_batched_lqt_admm(*_port(A, B, cost), project_u=lambda u: u.clamp(-5.0, 5.0),
                                **port_kw, **kw, device="cpu")(torch.tensor(x0s))
    _agree(got, want, 1e-8)
    assert float(got[1].abs().max()) <= 5.0 + 1e-7


def test_alpha_over_relaxation_diverges_alike_on_a_state_box():
    """At alpha = 1.6 the JAX fleet's relaxed step (its dual update takes
    the unrelaxed x_hat) diverges on a velocity box; the port follows the
    same iterates, to 1e-9 relative, as they grow."""
    N = 30
    A, B, cost = _problem(N)
    x0s = _x0s(6, 4, 0.1)
    kw = dict(rho_x=10.0, rho_u=0.1, n_iters=120, alpha=1.6)
    _, u_j = jax_fleet(A, B, cost, project_x=_vbox(N, 1.3, "jax"),
                       project_u=lambda u: project_bound(u, -5.0, 5.0), **kw)(jnp.asarray(x0s))
    _, u_t = make_batched_lqt_admm(*_port(A, B, cost), project_x=_vbox(N, 1.3, "torch"),
                                   project_u=lambda u: u.clamp(-5.0, 5.0), **kw,
                                   device="cpu")(torch.tensor(x0s))
    u_j = np.asarray(u_j)
    assert np.abs(u_j).max() > 1e2  # diverging
    np.testing.assert_allclose(u_t.numpy(), u_j, rtol=0, atol=1e-9 * np.abs(u_j).max())


@pytest.mark.parametrize("n", [1, 3, 5])
def test_chol_solve_small_matches_linalg_solve(n):
    rng = np.random.default_rng(n)
    G = rng.normal(size=(7, n, n))
    M = torch.tensor(G @ np.swapaxes(G, 1, 2) + n * np.eye(n))
    b = torch.tensor(rng.normal(size=(7, n)))
    got = _chol_solve_small(M, b)
    want = torch.linalg.solve(M, b)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_argument_errors():
    A, B, cost = _port(*_problem(16))
    proj = lambda u: u.clamp(-1.0, 1.0)  # noqa: E731
    with pytest.raises(ValueError, match="anderson"):
        make_batched_lqt_admm(A, B, cost, project_u=proj, rho_u=1e-2, anderson_m=5, device="cpu")
    with pytest.raises(ValueError, match="rho_u"):
        make_batched_lqt_admm(A, B, cost, project_u=proj, device="cpu")
    with pytest.raises(ValueError, match="rho_x"):
        make_batched_lqt_admm(A, B, cost, project_x=proj, project_u=proj, rho_u=1e-2, device="cpu")
    with pytest.raises(ValueError, match="project_u"):
        make_batched_lqt_admm(A, B, cost, project_x=proj, rho_x=1.0, rho_u=1e-2, device="cpu")
