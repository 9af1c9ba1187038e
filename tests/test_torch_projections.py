"""Port vs JAX package: the projections of the robust SLS fleet.

`project_soc_unit`, `project_soc_unit_batch`, `prox_l1`,
`project_weighted_l1` and `project_set_convex` get the same seeded numpy
inputs in float64 through both packages. The closed forms agree to
1e-12 (the two packages differ at most in the order of a few sums);
the consensus ADMM of `project_set_convex` iterates a contraction, so
its rounding differences stay at that level too.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.stats import norm

from ilqr_admm_tpu.projections import primitives as jp
from ilqr_admm_tpu.projections import project_set_convex as j_project_set_convex
from ilqr_admm_tpu_torch.projections import primitives as tp
from ilqr_admm_tpu_torch.projections.sets import project_set_convex

torch.set_num_threads(2)

F64 = torch.float64
TOL = 1e-12


def close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1.0))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _soc_points(seed=0):
    """Points in every branch: inside the cone, below its polar, between."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(60, 3))
    n = np.linalg.norm(z, axis=-1)
    t = np.concatenate([n[:20] * 1.5, -n[20:40] * 1.5, n[40:] * rng.uniform(-0.9, 0.9, 20)])
    return np.concatenate([z, t[:, None]], axis=-1)


def test_project_soc_unit_matches_jax():
    zt = _soc_points()
    close(tp.project_soc_unit(_t(zt)), jp.project_soc_unit(jnp.asarray(zt)))


def test_project_soc_unit_batch_matches_jax():
    zt = _soc_points(1).reshape(6, 10, 4)
    z_t, t_t = tp.project_soc_unit_batch(_t(zt[..., :-1]), _t(zt[..., -1]))
    z_j, t_j = jp.project_soc_unit_batch(jnp.asarray(zt[..., :-1]), jnp.asarray(zt[..., -1]))
    close(z_t, z_j)
    close(t_t, t_j)


def test_prox_l1_matches_jax():
    v = np.random.default_rng(2).normal(size=(5, 7))
    close(tp.prox_l1(_t(v), 0.3), jp.prox_l1(jnp.asarray(v), 0.3))


@pytest.mark.parametrize("dim", [2, 5])
def test_project_weighted_l1_matches_jax(dim):
    rng = np.random.default_rng(dim)
    x = rng.normal(size=(40, dim)) * 3.0
    w = rng.uniform(0.2, 2.0, dim)
    r = rng.uniform(0.5, 3.0, 40)  # about half the points lie inside
    got = tp.project_weighted_l1(_t(x), _t(w), _t(r))
    close(got, jp.project_weighted_l1(jnp.asarray(x), w, jnp.asarray(r)))
    radius = (got.abs() * _t(w)).sum(-1)
    assert bool((radius <= _t(r) + 1e-12).all())


@pytest.mark.parametrize(
    "weights",
    [[1.0, 0.0], np.array([1.0, -0.5]), torch.tensor([0.0, 1.0], dtype=F64)],
    ids=["list", "ndarray", "tensor"],
)
def test_project_weighted_l1_rejects_nonpositive_weights(weights):
    """Tensor weights are validated too (the JAX function skips its
    check for jax.Array weights)."""
    with pytest.raises(ValueError, match="strictly positive"):
        tp.project_weighted_l1(torch.ones(3, 2, dtype=F64), weights, 1.0)


def _chance_sets(bound=3.0):
    """The two SOCs of the chance-constrained control bounds
    (benchmarks/bench_sls_fleet.py:58-69)."""
    psi_inv = float(norm.ppf(0.95))
    mu = np.array([1.0, 0.0])
    Au = np.diag(np.sqrt([0.0, 0.01]))
    A_hi = np.concatenate([Au, (-mu / psi_inv)[None]], 0)
    A_lo = np.concatenate([Au, (mu / psi_inv)[None]], 0)
    b = np.array([0.0, 0.0, bound / psi_inv])
    return [A_hi, A_lo], [b, b]


def _rows(seed, n=12):
    return np.random.default_rng(seed).normal(size=(n, 2)) * np.array([4.0, 10.0])


@pytest.mark.parametrize(
    "kw",
    [
        dict(rho=10.0, max_iter=30, threshold=0.0, stall_tol=0.0),
        dict(rho=10.0, max_iter=200),  # default threshold 1e-4 and stall exit 1e-5
        dict(rho=10.0, max_iter=200, threshold=0.0),  # the stall exit alone
    ],
    ids=["fixed-30", "threshold-and-stall", "stall-only"],
)
def test_project_set_convex_matches_jax(kw):
    As, bs = _chance_sets()
    y = _rows(3)
    got = project_set_convex(_t(y), [_t(A) for A in As], [_t(b) for b in bs],
                             [tp.project_soc_unit] * 2, **kw)
    want = j_project_set_convex(jnp.asarray(y), [jnp.asarray(A) for A in As],
                                [jnp.asarray(b) for b in bs], [jp.project_soc_unit] * 2, **kw)
    close(got, want, 1e-10)
    single = project_set_convex(_t(y[0]), [_t(A) for A in As], [_t(b) for b in bs],
                                [tp.project_soc_unit] * 2, **kw)
    assert single.shape == (2,)


def test_project_set_convex_stall_exit_fires():
    """The stall rule stops the loop early: a larger max_iter changes nothing."""
    As, bs = _chance_sets()
    args = (_t(_rows(4)), [_t(A) for A in As], [_t(b) for b in bs], [tp.project_soc_unit] * 2)
    a = project_set_convex(*args, rho=10.0, max_iter=400, threshold=0.0, stall_tol=1e-2)
    b = project_set_convex(*args, rho=10.0, max_iter=4000, threshold=0.0, stall_tol=1e-2)
    c = project_set_convex(*args, rho=10.0, max_iter=400, threshold=0.0, stall_tol=0.0)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_project_set_convex_batch_dims_matches_vmap():
    """batch_dims=1 stops each instance on its own residuals, as
    jax.vmap of the JAX function does (bench_sls_fleet.py:72 leaves the
    stall exit on); the per-instance bound enters b_i."""
    bounds = np.array([2.0, 3.0, 4.5, 8.0])
    psi_inv = float(norm.ppf(0.95))
    As, _ = _chance_sets()
    y = np.stack([_rows(10 + i) for i in range(4)])  # (4, 12, 2)
    b = np.zeros((4, 1, 3))
    b[:, 0, 2] = bounds / psi_inv

    def one(yi, bi):
        return j_project_set_convex(yi, [jnp.asarray(A) for A in As], [bi, bi],
                                    [jp.project_soc_unit] * 2, rho=10.0, max_iter=30,
                                    threshold=0.0)

    want = jax.vmap(one)(jnp.asarray(y), jnp.asarray(b[:, 0]))
    got = project_set_convex(_t(y), [_t(A) for A in As], [_t(b), _t(b)],
                             [tp.project_soc_unit] * 2, rho=10.0, max_iter=30, threshold=0.0,
                             batch_dims=1)
    close(got, want, 1e-10)


def test_project_set_convex_argument_errors():
    As, bs = _chance_sets()
    x = torch.zeros(3, 2, dtype=F64)
    with pytest.raises(ValueError, match="at least one"):
        project_set_convex(x)
    with pytest.raises(ValueError, match="equal lengths"):
        project_set_convex(x, [_t(As[0])], [_t(bs[0]), _t(bs[1])], [tp.project_soc_unit])
    with pytest.raises(ValueError, match="batch_dims"):
        project_set_convex(x, [_t(As[0])], [_t(bs[0])], [tp.project_soc_unit], batch_dims=2)
