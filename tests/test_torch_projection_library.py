"""Port vs JAX package: the projection library (`tests/test_projections.py`).

Each test of `tests/test_projections.py` runs here with the same seeded
numpy inputs through both packages in float64; the outputs agree to
1e-12, the `exact` certificates of `project_outside_rotated_boxes` are
equal, and the iterative projections (`project_soc`,
`project_set_convex`, `project_set_convex_dykstra`) stop at the same
iteration. The JAX loops report no count, so a JAX count is the least
max_iter whose output equals the full run's. The port's outputs are also
held to the JAX test's own properties. Beyond the JAX file: `batch_dims`
against `jax.vmap`, the primitives the JAX tests leave out, and
gradients through the masked branches.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu_torch.projections import primitives as tprim
from ilqr_admm_tpu_torch.projections import sets as tsets

# the packages' `projections` attribute is the registry dict (star import)
J = importlib.import_module("ilqr_admm_tpu.projections")
T = importlib.import_module("ilqr_admm_tpu_torch.projections")

torch.set_num_threads(2)

F64 = torch.float64
TOL = 1e-12


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1.0))


def _both(j_proj, t_proj, x):
    """(port, JAX) outputs of one projection on the same numpy input."""
    return t_proj(_t(x)), j_proj(jnp.asarray(x))


def _check_props(j_proj, t_proj, member, rng, dim, n=256, nonexpansive=True):
    """The JAX test's `_check_props` on the port, with each output held to JAX's."""
    x = rng.normal(size=(n, dim)) * 3.0
    y = rng.normal(size=(n, dim)) * 3.0
    px, px_j = _both(j_proj, t_proj, x)
    py, py_j = _both(j_proj, t_proj, y)
    close(px, px_j)
    close(py, py_j)
    px, py = px.numpy(), py.numpy()
    assert member(px).all(), "membership violated"
    ppx, ppx_j = _both(j_proj, t_proj, px)
    close(ppx, ppx_j)
    np.testing.assert_allclose(ppx.numpy(), px, atol=1e-6)
    if nonexpansive:
        d_in = np.linalg.norm(x - y, axis=-1)
        d_out = np.linalg.norm(px - py, axis=-1)
        assert (d_out <= d_in + 1e-7).all(), "non-expansiveness violated"


def _jax_iters(run, max_iter):
    """The iteration a JAX loop stopped at: the least k <= max_iter whose
    output run(k) equals run(max_iter) bit for bit (bisection)."""
    full = np.asarray(run(max_iter))
    lo, hi = 0, max_iter
    while lo < hi:
        mid = (lo + hi) // 2
        if np.array_equal(np.asarray(run(mid)), full):
            hi = mid
        else:
            lo = mid + 1
    return lo


def test_bound(rng):
    _check_props(lambda x: J.project_bound(x, -1.0, 2.0), lambda x: T.project_bound(x, -1.0, 2.0),
                 lambda z: (z >= -1 - 1e-9) & (z <= 2 + 1e-9), rng, 5)


def test_linear(rng):
    a = rng.normal(size=4)

    def member(z):
        v = z @ a
        return (v >= -0.5 - 1e-7) & (v <= 0.7 + 1e-7)

    _check_props(lambda x: J.project_linear(x, jnp.asarray(a), -0.5, 0.7),
                 lambda x: T.project_linear(x, _t(a), -0.5, 0.7), member, rng, 4)


def test_affine(rng):
    a = rng.normal(size=3)

    def member(z):
        v = z @ a + 0.3
        return (v >= -1 - 1e-7) & (v <= 1 + 1e-7)

    _check_props(lambda x: J.project_affine(x, jnp.asarray(a), 0.3, -1.0, 1.0),
                 lambda x: T.project_affine(x, _t(a), 0.3, -1.0, 1.0), member, rng, 3)


def test_quadratic_shell(rng):
    l, u = 0.5, 2.0

    def member(z):
        v = 0.5 * np.sum(z**2, -1)
        return (v >= l - 1e-7) & (v <= u + 1e-7)

    # the annulus is not convex (inner exclusion): no non-expansiveness
    _check_props(lambda x: J.project_quadratic(x, l, u), lambda x: T.project_quadratic(x, l, u),
                 member, rng, 3, nonexpansive=False)


def test_soc_unit(rng):
    def member(zt):
        return np.linalg.norm(zt[..., :-1], axis=-1) <= zt[..., -1] + 1e-7

    _check_props(J.project_soc_unit, T.project_soc_unit, member, rng, 5)


def test_soc_unit_against_reference_cases():
    for point, want in (([0.3, 0.0, 1.0], [0.3, 0.0, 1.0]),  # inside: untouched
                        ([0.3, 0.0, -1.0], [0.0, 0.0, 0.0]),  # polar cone: zero
                        ([2.0, 0.0, 0.0], [1.0, 0.0, 1.0])):  # boundary scaling
        got, got_j = _both(J.project_soc_unit, T.project_soc_unit, np.asarray(point))
        close(got, got_j)
        np.testing.assert_allclose(got.numpy(), want)


def test_unit_ball(rng):
    _check_props(J.project_unit_ball, T.project_unit_ball,
                 lambda z: np.linalg.norm(z, axis=-1) <= 1 + 1e-9, rng, 4)


def test_square_shell(rng):
    l, u = 0.5, 2.0

    def member(z):
        v = np.max(np.abs(z), -1)
        return (v >= l - 1e-7) & (v <= u + 1e-9)

    _check_props(lambda x: J.project_square(x, l, u), lambda x: T.project_square(x, l, u),
                 member, rng, 3, nonexpansive=False)


def test_block_lower_triangular():
    out = T.project_block_lower_triangular(torch.ones((6, 9), dtype=F64), 3, 2, 3)
    close(out, J.project_block_lower_triangular(jnp.ones((6, 9)), 3, 2, 3))
    out = out.numpy()
    for i in range(3):
        np.testing.assert_allclose(out[i * 2, i * 3 : (i + 1) * 3], 0.0)
    assert out.sum() == 6 * 9 - 9


def test_project_soc_affine_preimage(rng):
    A = np.diag([1.0, 1.0, 0.5])
    b = np.array([0.1, -0.2, 0.05])
    z0 = rng.normal(size=(32, 3)) * 2
    stats = {}
    z = T.project_soc(_t(z0), _t(A), _t(b), rho=1.0, max_iter=300, tol=1e-8, stats=stats)

    def run(k):
        return J.project_soc(jnp.asarray(z0), jnp.asarray(A), jnp.asarray(b), rho=1.0,
                             max_iter=k, tol=1e-8)

    close(z, run(300))
    assert int(stats["iters"]) == _jax_iters(run, 300)
    v = z.numpy() @ A.T + b
    assert (np.linalg.norm(v[:, :-1], axis=-1) <= v[:, -1] + 1e-4).all()


def test_project_set_convex_intersection(rng):
    dim = 3
    As, bs = [np.eye(dim)] * 2, [np.zeros(dim)] * 2
    x0 = rng.normal(size=(64, dim)) * 2
    kw = dict(rho=1.0, threshold=1e-8, stall_tol=1e-12)
    stats = {}
    out = T.project_set_convex(
        _t(x0), [_t(A) for A in As], [_t(b) for b in bs],
        [lambda y: T.project_bound(y, -1.0, 0.8), lambda y: T.project_bound(y, -0.5, 2.0)],
        max_iter=400, stats=stats, **kw)

    def run(k):
        return J.project_set_convex(
            jnp.asarray(x0), [jnp.asarray(A) for A in As], [jnp.asarray(b) for b in bs],
            [lambda y: J.project_bound(y, -1.0, 0.8), lambda y: J.project_bound(y, -0.5, 2.0)],
            max_iter=k, **kw)

    close(out, run(400))
    assert int(stats["iters"]) == _jax_iters(run, 400)
    np.testing.assert_allclose(out.numpy(), np.clip(x0, -0.5, 0.8), atol=1e-3)


def test_dykstra_intersection(rng):
    x0 = rng.normal(size=(64, 2)) * 2
    stats = {}
    out = T.project_set_convex_dykstra(
        _t(x0), [lambda y: T.project_bound(y, 0.2, 10.0), T.project_unit_ball], max_iter=500,
        tol=1e-12, stats=stats)

    def run(k):
        return J.project_set_convex_dykstra(
            jnp.asarray(x0), [lambda y: J.project_bound(y, 0.2, 10.0), J.project_unit_ball],
            max_iter=k, tol=1e-12)

    close(out, run(500))
    assert int(stats["iters"]) == _jax_iters(run, 500)
    out = out.numpy()
    assert (out >= 0.2 - 1e-5).all()
    assert (np.linalg.norm(out, axis=-1) <= 1 + 1e-5).all()
    inside = (x0 >= 0.2).all(-1) & (np.linalg.norm(x0, axis=-1) <= 1)
    np.testing.assert_allclose(out[inside], x0[inside], atol=1e-6)


class TestOutsideRotatedBoxes:
    """The exact intersection-of-box-exteriors projection (car obstacles)."""

    def _obstacles(self):
        # two disjoint rotated boxes: centres (0,0) and (4,0), rotations 30
        # and -20 degrees, half-extents (1, 0.5); A = S^-1 R^T, b = -A c
        def box(cx, cy, th, hx, hy):
            R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
            A = np.diag([1.0 / hx, 1.0 / hy]) @ R.T
            return A, -A @ np.array([cx, cy])

        A1, b1 = box(0.0, 0.0, np.deg2rad(30), 1.0, 0.5)
        A2, b2 = box(4.0, 0.0, np.deg2rad(-20), 1.0, 0.5)
        return np.stack([A1, A2]), np.stack([b1, b2])

    def _both(self, pts, **kw):
        As, bs = self._obstacles()
        out, exact = T.project_outside_rotated_boxes(_t(pts), _t(As), _t(bs), **kw)
        out_j, exact_j = J.project_outside_rotated_boxes(
            jnp.asarray(pts), jnp.asarray(As), jnp.asarray(bs), **kw)
        close(out, out_j)
        np.testing.assert_array_equal(exact.numpy(), np.asarray(exact_j))
        return out.numpy(), exact.numpy()

    def test_feasible_points_fixed(self):
        pts = np.array([[2.0, 2.0], [-3.0, 0.0], [2.0, 0.0]])
        out, exact = self._both(pts)
        np.testing.assert_allclose(out, pts)
        assert exact.all()

    def test_infeasible_matches_bruteforce(self):
        As, bs = self._obstacles()

        def feasible(p):  # outside every box
            return np.all(np.max(np.abs(As @ p + bs), axis=-1) >= 1.0 - 1e-9)

        rng = np.random.default_rng(3)
        pts = []
        while len(pts) < 12:
            p = rng.uniform([-2, -2], [6, 2])
            if not feasible(p):
                pts.append(p)
        pts = np.stack(pts)
        out, exact = self._both(pts)
        assert all(feasible(q) for q in out)
        ts = np.linspace(-1, 1, 4001)
        cands = []
        for A, b in zip(As, bs):
            Ainv = np.linalg.inv(A)
            for fixed in (-1.0, 1.0):
                for face in (np.stack([np.full_like(ts, fixed), ts]),
                             np.stack([ts, np.full_like(ts, fixed)])):
                    cands.append((Ainv @ face.T[..., None])[..., 0] - Ainv @ b)
        cands = np.concatenate(cands)
        cands = cands[[feasible(c) for c in cands]]
        for p, q, ex in zip(pts, out, exact):
            assert ex
            best = np.min(np.linalg.norm(cands - p, axis=-1))
            assert np.linalg.norm(q - p) <= best + 2e-3

    def test_beats_consensus_admm(self):
        As, bs = self._obstacles()
        pts = np.random.default_rng(5).uniform([-2, -2], [6, 2], size=(64, 2))
        out, _ = self._both(pts)
        stats = {}
        approx = T.project_set_convex(
            _t(pts), As=list(_t(As)), bs=list(_t(bs)),
            projections=[lambda y: T.project_square(y, 1.0, np.inf)] * 2, max_iter=30,
            stats=stats)

        def run(k):
            return J.project_set_convex(
                jnp.asarray(pts), As=list(jnp.asarray(As)), bs=list(jnp.asarray(bs)),
                projections=[lambda y: J.project_square(y, 1.0, jnp.inf)] * 2, max_iter=k)

        close(approx, run(30))
        assert int(stats["iters"]) == _jax_iters(run, 30)
        approx = approx.numpy()

        def depth(q):  # worst violation depth across boxes
            y = np.einsum("sij,...j->...si", As, q) + bs
            return np.max(np.maximum(1.0 - np.max(np.abs(y), axis=-1), 0.0), axis=-1)

        assert depth(out).max() < 1e-5
        d_exact = np.linalg.norm(out - pts, axis=-1)
        d_admm = np.linalg.norm(approx - pts, axis=-1)
        feasible = depth(approx) <= 1e-9
        assert np.all(np.where(feasible, d_exact <= d_admm + 1e-6, True))


def test_project_quadratic_zero_vector_inner_shell():
    z = T.project_quadratic(torch.zeros(3, dtype=F64), 0.5, 2.0)
    close(z, J.project_quadratic(jnp.zeros(3), 0.5, 2.0))
    assert abs(0.5 * float(torch.sum(z * z)) - 0.5) < 1e-10
    x = np.array([[0.0, 0.0], [3.0, 4.0]])
    zb, zb_j = _both(lambda v: J.project_quadratic(v, 0.5, 20.0),
                     lambda v: T.project_quadratic(v, 0.5, 20.0), x)
    close(zb, zb_j)
    assert abs(0.5 * float(torch.sum(zb[0] ** 2)) - 0.5) < 1e-10
    np.testing.assert_allclose(zb[1].numpy(), [3.0, 4.0], atol=1e-12)


def test_project_set_convex_empty_raises():
    with pytest.raises(ValueError, match="at least one"):
        T.project_set_convex(torch.zeros(3, dtype=F64))
    with pytest.raises(ValueError, match="at least one"):
        T.project_set_convex_dykstra(torch.zeros(3, dtype=F64), projections=())


def test_project_weighted_l1_properties():
    from scipy.optimize import LinearConstraint, minimize

    rng = np.random.default_rng(0)
    n, r = 4, 1.3
    w = rng.uniform(0.2, 2.0, n)
    xs = rng.normal(0, 2.0, (64, n))
    out = T.project_weighted_l1(_t(xs), _t(w), r)
    close(out, J.project_weighted_l1(jnp.asarray(xs), jnp.asarray(w), r))
    out = out.numpy()
    assert np.max(np.sum(w * np.abs(out), axis=-1)) <= r + 1e-9
    np.testing.assert_allclose(T.project_weighted_l1(_t(out), _t(w), r).numpy(), out, atol=1e-9)
    inside = np.sum(w * np.abs(xs), -1) <= r
    np.testing.assert_array_equal(out[inside], xs[inside])
    signs = np.array(np.meshgrid(*([[-1, 1]] * n))).reshape(n, -1).T
    for x in xs[:8]:
        res = minimize(lambda v: np.sum((v - x) ** 2), x, jac=lambda v: 2 * (v - x),
                       method="SLSQP", constraints=[LinearConstraint(signs * w, -np.inf, r)])
        np.testing.assert_allclose(T.project_weighted_l1(_t(x), _t(w), r).numpy(), res.x,
                                   atol=1e-6)


def test_project_weighted_l1_matches_soc_intersection():
    from scipy.stats import norm

    psi = float(norm.ppf(0.95))
    c, r = psi * 0.1, 2.0
    mu = np.array([1.0, 0.0])
    Au = np.diag([0.0, 0.1])
    A_hi = np.concatenate([Au, (-mu / psi)[None]], 0)
    A_lo = np.concatenate([Au, (mu / psi)[None]], 0)
    b = np.array([0.0, 0.0, r / psi])
    for x in np.random.default_rng(1).normal(0, 3.0, (16, 2)):
        exact = T.project_weighted_l1(_t(x), _t([1.0, c]), r)
        close(exact, J.project_weighted_l1(jnp.asarray(x), jnp.asarray([1.0, c]), r))
        iterative = T.project_set_convex(_t(x), [_t(A_hi), _t(A_lo)], [_t(b), _t(b)],
                                         [T.project_soc_unit] * 2, rho=3.0, max_iter=400,
                                         threshold=0.0)
        close(iterative, J.project_set_convex(
            jnp.asarray(x), [jnp.asarray(A_hi), jnp.asarray(A_lo)], [jnp.asarray(b)] * 2,
            [J.project_soc_unit] * 2, rho=3.0, max_iter=400, threshold=0.0))
        np.testing.assert_allclose(exact.numpy(), iterative.numpy(), atol=2e-4)


def test_project_weighted_l1_rejects_nonpositive_weights():
    with pytest.raises(ValueError):
        T.project_weighted_l1(_t([1.0, 2.0]), [1.0, 0.0], 1.0)
    with pytest.raises(ValueError):
        J.project_weighted_l1(jnp.asarray([1.0, 2.0]), [1.0, 0.0], 1.0)


# -- beyond tests/test_projections.py ---------------------------------------


def test_other_primitives_match_jax():
    """project_multilinear, project_quadratic_b, project_square_c,
    prox_l1_box, the _batch aliases and the registry."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(40, 3)) * 2
    A = rng.normal(size=(2, 3))
    b = rng.normal(size=3)
    c = rng.normal(size=3)
    lo, hi = -np.array([0.5, 1.0]), np.array([0.8, 0.3])
    close(T.project_multilinear(_t(x), _t(A), _t(lo), _t(hi)),
          J.project_multilinear(jnp.asarray(x), jnp.asarray(A), jnp.asarray(lo), jnp.asarray(hi)))
    close(T.project_multilinear(_t(x[0]), _t(A), _t(lo), _t(hi)),
          J.project_multilinear(jnp.asarray(x[0]), jnp.asarray(A), jnp.asarray(lo),
                                jnp.asarray(hi)))
    close(T.project_quadratic_b(_t(x), _t(b), 0.3, 2.0),
          J.project_quadratic_b(jnp.asarray(x), jnp.asarray(b), 0.3, 2.0))
    close(T.project_square_c(_t(x), _t(c), 0.7, 1.5),
          J.project_square_c(jnp.asarray(x), jnp.asarray(c), 0.7, 1.5))
    close(T.prox_l1_box(_t(x), 0.4, -1.0, 1.5), J.prox_l1_box(jnp.asarray(x), 0.4, -1.0, 1.5))
    # ties in the inf-norm push go to the first coordinate, as jnp.argmax picks
    tie = np.array([[0.1, -0.1, 0.05], [0.0, 0.0, 0.0]])
    close(T.project_square(_t(tie), 0.5, 2.0), J.project_square(jnp.asarray(tie), 0.5, 2.0))
    assert T.project_linear_batch is T.project_linear
    assert T.project_quadratic_batch is T.project_quadratic
    assert T.project_square_batch is T.project_square
    assert sorted(tprim.projections) == sorted(J.projections)


def test_gradients_through_masked_branches():
    """torch.where differentiates both branches, like jnp.where: the
    guarded denominators keep the gradient finite and equal to jax.grad's.
    At the zero vector jax.grad of jnp.linalg.norm is NaN, while torch's
    vector_norm has the subgradient 0 there: the port's gradient is finite
    on that row too, and held to JAX's on the others."""
    rng = np.random.default_rng(8)
    x = np.concatenate([rng.normal(size=(8, 3)) * 2, np.zeros((1, 3))])
    w = rng.normal(size=x.shape)
    cases = [
        (lambda v: J.project_quadratic(v, 0.5, 2.0), lambda v: T.project_quadratic(v, 0.5, 2.0)),
        (lambda v: J.project_square(v, 0.5, 2.0), lambda v: T.project_square(v, 0.5, 2.0)),
        (J.project_unit_ball, T.project_unit_ball),
        (J.project_soc_unit, T.project_soc_unit),
        (lambda v: J.project_linear(v, jnp.ones(3), -0.5, 0.5),
         lambda v: T.project_linear(v, torch.ones(3, dtype=F64), -0.5, 0.5)),
    ]
    for j_proj, t_proj in cases:
        g_j = np.asarray(jax.grad(lambda v: jnp.sum(j_proj(v) * w))(jnp.asarray(x)))
        xt = _t(x).requires_grad_()
        (g_t,) = torch.autograd.grad(torch.sum(t_proj(xt) * _t(w)), xt)
        assert torch.isfinite(g_t).all()
        close(g_t[:-1], g_j[:-1])
        if np.isfinite(g_j[-1]).all():
            close(g_t[-1], g_j[-1])


@pytest.mark.parametrize("which", ["soc", "dykstra"])
def test_batch_dims_matches_vmap(which):
    """batch_dims=1: each instance stops on its own, as under jax.vmap of
    the JAX function, and takes the iterations it takes alone."""
    rng = np.random.default_rng(9)
    z0 = rng.normal(size=(4, 6, 3)) * 2
    z0[1] *= 0.05  # an instance that stops early
    if which == "soc":
        A, b = np.diag([1.0, 1.0, 0.5]), np.array([0.1, -0.2, 0.05])
        kw = dict(rho=1.0, max_iter=300, tol=1e-8)

        def t_run(z, **more):
            return T.project_soc(z, _t(A), _t(b), **kw, **more)

        def j_run(z):
            return J.project_soc(z, jnp.asarray(A), jnp.asarray(b), **kw)
    else:
        kw = dict(max_iter=500, tol=1e-12)

        def t_run(z, **more):
            return T.project_set_convex_dykstra(
                z, [lambda y: T.project_bound(y, 0.2, 10.0), T.project_unit_ball], **kw, **more)

        def j_run(z):
            return J.project_set_convex_dykstra(
                z, [lambda y: J.project_bound(y, 0.2, 10.0), J.project_unit_ball], **kw)

    stats = {}
    got = t_run(_t(z0), batch_dims=1, stats=stats)
    close(got, jax.vmap(j_run)(jnp.asarray(z0)))
    for i in range(z0.shape[0]):
        alone = {}
        close(t_run(_t(z0[i]), stats=alone), j_run(jnp.asarray(z0[i])))
        assert int(stats["iters"][i]) == int(alone["iters"])
    assert len(set(stats["iters"].tolist())) > 1
    # batch_dims=0: one stop test over all of z0, as the JAX function called directly
    close(t_run(_t(z0)), j_run(jnp.asarray(z0)))


def test_loops_count_their_host_reads():
    before = tsets.host_sync_count
    stats = {}
    T.project_set_convex_dykstra(torch.ones((3, 2), dtype=F64) * 2,
                                 [lambda y: T.project_bound(y, 0.2, 10.0), T.project_unit_ball],
                                 max_iter=50, tol=1e-12, stats=stats)
    # one read before each iteration and the one that ends the loop
    assert tsets.host_sync_count - before == int(stats["iters"]) + 1
    before = tsets.host_sync_count
    T.project_outside_rotated_boxes(torch.zeros((5, 2), dtype=F64),
                                    torch.eye(2, dtype=F64)[None], torch.zeros((1, 2), dtype=F64))
    assert tsets.host_sync_count == before
