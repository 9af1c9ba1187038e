"""Port vs JAX package: the small box QPs of `ops/boxqp.py`.

Random strictly convex QPs with m = 1-4 (and 5 for the linear-solve
branch), made with numpy from a seed, go through both packages in
float64: the projected-Newton `boxqp` and the exact enumeration
`boxqp_enum` must give the same u to 1e-9 and the same free masks. The
f32 check of `boxqp_enum` on ill-scaled H is the JAX package's own
(`tests/test_boxddp.py::test_enum_f32_ill_scaled`), on the port.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.ops import boxqp as jb
from ilqr_admm_tpu_torch.ops import boxqp as tb

torch.set_num_threads(2)

TOL = 1e-9
TRIALS = 6


def _qp(rng, m, scale=1.0):
    M = rng.normal(size=(m, m))
    H = (M @ M.T + 0.5 * np.eye(m)) * scale
    g = rng.normal(size=m) * 3.0 * scale
    lb, ub = -np.abs(rng.normal(size=m)), np.abs(rng.normal(size=m))
    return H, g, lb, ub


def _both(name, args, **kw):
    j_fn = jax.jit(getattr(jb, name), static_argnames=tuple(kw))
    uj, fj = j_fn(*map(jnp.asarray, args), **kw)
    ut, ft = getattr(tb, name)(*map(torch.tensor, args), **kw)
    return (ut, ft), (np.asarray(uj), np.asarray(fj))


@pytest.mark.parametrize("name", ["boxqp", "boxqp_enum"])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_box_qp_matches_jax(name, m):
    rng = np.random.default_rng(10 * m + (name == "boxqp_enum"))
    active = 0
    for _ in range(TRIALS):
        args = _qp(rng, m)
        (ut, ft), (uj, fj) = _both(name, args)
        assert ut.shape == (m,) and ft.dtype == torch.bool
        assert np.abs(ut.numpy() - uj).max() < TOL
        assert ft.tolist() == fj.tolist()
        lb, ub = args[2], args[3]
        assert (ut.numpy() >= lb - 1e-12).all() and (ut.numpy() <= ub + 1e-12).all()
        active += int((~ft).sum())
    assert active > 0  # some bound binds in the draws


def test_newton_and_enum_agree_and_newton_takes_options():
    """boxqp with a warm start and its iteration count, against JAX, and
    against the exact enumeration at convergence."""
    rng = np.random.default_rng(3)
    for m in (2, 3):
        H, g, lb, ub = _qp(rng, m)
        u0 = rng.normal(size=m)
        uj, fj = jb.boxqp(*map(jnp.asarray, (H, g, lb, ub)), u0=jnp.asarray(u0), n_iters=3)
        ut, ft = tb.boxqp(*map(torch.tensor, (H, g, lb, ub)), u0=torch.tensor(u0), n_iters=3)
        assert np.abs(ut.numpy() - np.asarray(uj)).max() < TOL and ft.tolist() == np.asarray(fj).tolist()
        u_n, _ = tb.boxqp(*map(torch.tensor, (H, g, lb, ub)), n_iters=40)
        u_e, _ = tb.boxqp_enum(*map(torch.tensor, (H, g, lb, ub)))
        assert torch.allclose(u_n, u_e, atol=1e-8)


def test_enum_fallback_is_the_best_clipped_candidate():
    """A negative eps makes every KKT test fail: both packages then return
    the clipped candidate of least objective, not the all-free case."""
    rng = np.random.default_rng(5)
    for m in (1, 2, 3):
        H, g, lb, ub = _qp(rng, m)
        (ut, ft), (uj, fj) = _both("boxqp_enum", (H, g, lb, ub), eps=-1.0)
        assert np.abs(ut.numpy() - uj).max() < TOL and ft.tolist() == fj.tolist()
        u_best, _ = tb.boxqp_enum(*map(torch.tensor, (H, g, lb, ub)))
        obj = lambda u: 0.5 * u @ H @ u + g @ u  # noqa: E731
        assert obj(ut.numpy()) <= obj(u_best.numpy()) + 1e-9  # the exact optimum is a candidate


@pytest.mark.parametrize("m", [2, 5])
def test_masked_solve_matches_jax(m):
    """Vector and matrix right-hand sides, the adjugate branch (m <= 4)
    and the linear-solve branch (m = 5)."""
    rng = np.random.default_rng(m)
    H = _qp(rng, m)[0]
    free = rng.random(m) < 0.6
    for rhs in (rng.normal(size=m), rng.normal(size=(m, 3))):
        want = jb._masked_solve(jnp.asarray(H), jnp.asarray(free), jnp.asarray(rhs))
        got = tb._masked_solve(torch.tensor(H), torch.tensor(free), torch.tensor(rhs))
        assert got.shape == want.shape
        assert np.abs(got.numpy() - np.asarray(want)).max() < TOL
        assert (got.numpy().reshape(m, -1)[~free] == 0).all()


def test_unconstrained_interior():
    H = torch.eye(3, dtype=torch.float64) * 2.0
    g = torch.tensor([0.1, -0.2, 0.05], dtype=torch.float64)
    for fn in (tb.boxqp, tb.boxqp_enum):
        u, free = fn(H, g, -10.0, 10.0)
        assert torch.allclose(u, -g / 2.0, atol=1e-12) and bool(free.all())


def test_enum_f32_ill_scaled():
    """boxqp_enum in f32 at Quu magnitudes 1 to 1e6: feasible, and within
    f32 roundoff of the f64 optimum in objective (the scale-relative KKT
    tolerance; the JAX package's test and gate)."""
    rng = np.random.default_rng(0)
    for scale in (1.0, 1e2, 1e4, 1e6):
        for m in (1, 2, 3):
            for _ in range(5):
                Q = rng.normal(size=(m, m))
                H64 = (Q @ Q.T + np.eye(m) * 0.1) * scale
                g64 = rng.normal(size=m) * 2.0 * scale
                lb = -np.abs(rng.normal(size=m)) - 0.05
                ub = np.abs(rng.normal(size=m)) + 0.05
                u32, _ = tb.boxqp_enum(*(torch.tensor(a, dtype=torch.float32)
                                         for a in (H64, g64, lb, ub)))
                u64, _ = tb.boxqp_enum(*map(torch.tensor, (H64, g64, lb, ub)))
                u32 = u32.double().numpy()
                obj = lambda u: 0.5 * u @ H64 @ u + g64 @ u  # noqa: E731
                assert (u32 >= lb - 1e-6).all() and (u32 <= ub + 1e-6).all()
                ref = obj(u64.numpy())
                assert obj(u32) <= ref + 1e-4 * (abs(ref) + scale), (scale, m)
