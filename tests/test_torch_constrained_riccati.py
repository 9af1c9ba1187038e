"""Port vs JAX package: the constrained Riccati passes of
`ops/constrained_riccati.py`.

Random LQ stage models (cross terms, active bounds), made with numpy from
a seed, go through both packages in float64: the sequential boxDDP pass
in each qp_method, the time-parallel active-set pass with and without a
warm-started set and with the set returned, the KKT residual and the
clipped rollout. Gains, sets and residuals must agree to 1e-9.

XLA:CPU aborts with heap corruption while compiling the JAX package's
flat associative scans in a process that has imported torch (see
`tests/test_torch_parallel_riccati.py`). So here the JAX parallel pass
runs its Riccati scans with one block (`block_size = N`: the same
suffixes, folded sequentially) through a patched
`ilqr_admm_tpu.ops.parallel_riccati.ilqr_backward_parallel`; the port
runs its flat scan, which `tests/test_torch_parallel_riccati.py` holds
to JAX's to 1e-9.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.models.car import CarSimple as JCarSimple
from ilqr_admm_tpu.ops import constrained_riccati as jc
from ilqr_admm_tpu.ops import parallel_riccati as jp
from ilqr_admm_tpu_torch.models.car import CarSimple
from ilqr_admm_tpu_torch.ops import constrained_riccati as tc

torch.set_num_threads(2)

TOL = 1e-9
_FLAT = jp.ilqr_backward_parallel


def _one_block(A, B, Cts, cts, **kw):
    kw["block_size"] = A.shape[0]
    return _FLAT(A, B, Cts, cts, **kw)


@pytest.fixture(autouse=True)
def jax_one_block_scan(monkeypatch):
    monkeypatch.setattr(jp, "ilqr_backward_parallel", _one_block)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _problem(seed, N=24, d=3, m=2, u_scale=0.1):
    """The cross-term LQ problems of `tests/test_boxddp.py` (cold start)."""
    r = np.random.default_rng(seed)
    A = np.eye(d) + r.normal(size=(N, d, d)) * 0.08
    B = r.normal(size=(N, d, m)) * 0.6
    Cts = np.zeros((N, d + m, d + m))
    for t in range(N):
        Qx = r.normal(size=(d, d)) * 0.2
        Cts[t, :d, :d] = Qx @ Qx.T + np.eye(d) * 0.3
        Cts[t, d:, d:] = np.eye(m) * 0.05
        Cux = r.normal(size=(m, d)) * 0.05
        Cts[t, d:, :d] = Cux
        Cts[t, :d, d:] = Cux.T
    cts = r.normal(size=(N, d + m)) * 2.0
    u_nom = r.normal(size=(N, m)) * u_scale
    return A, B, Cts, cts, u_nom


def _j(args):
    return tuple(jnp.asarray(a) for a in args)


def _t(args):
    return tuple(torch.tensor(a) for a in args)


@pytest.mark.parametrize("qp_method", ["auto", "enum", "newton"])
@pytest.mark.parametrize("reg", [0.0, 0.05])
def test_backward_box_matches_jax(qp_method, reg):
    args = _problem(0)
    Kj, kj = jc.ilqr_backward_box(*_j(args), -0.25, 0.25, reg=reg, qp_method=qp_method,
                                  qp_iters=20)
    Kt, kt = tc.ilqr_backward_box(*_t(args), -0.25, 0.25, reg=reg, qp_method=qp_method,
                                  qp_iters=20)
    assert Kt.shape == (24, 2, 3) and kt.shape == (24, 2)
    assert _rel(Kt, Kj) < TOL and _rel(kt, kj) < TOL
    assert float(Kt[-1].abs().max()) == 0.0 and float(kt[-1].abs().max()) == 0.0
    # the bounds bind: some stage's feedforward sits on its increment bound
    dlo, dhi = -0.25 - args[4], 0.25 - args[4]
    kt_np = kt.numpy()[:-1]
    assert np.isclose(kt_np, dlo[:-1], atol=1e-12).any() or np.isclose(kt_np, dhi[:-1]).any()


def test_backward_box_rejects_an_unknown_qp_method():
    with pytest.raises(ValueError, match="qp_method"):
        tc.ilqr_backward_box(*_t(_problem(0, N=4)), -1.0, 1.0, qp_method="lbfgs")


@pytest.mark.parametrize("seed", [0, 8, 17])
@pytest.mark.parametrize("mask_iters", [1, 3, 20])
def test_backward_box_parallel_matches_jax(seed, mask_iters):
    """Cold start, the set returned: gains and the post-exchange set."""
    args = _problem(seed)
    Kj, kj, (lo_j, hi_j) = jc.ilqr_backward_box_parallel(
        *_j(args), -0.25, 0.25, mask_iters=mask_iters, return_clamp=True)
    Kt, kt, (lo_t, hi_t) = tc.ilqr_backward_box_parallel(
        *_t(args), -0.25, 0.25, mask_iters=mask_iters, return_clamp=True)
    assert _rel(Kt, Kj) < TOL and _rel(kt, kj) < TOL
    assert lo_t.tolist() == np.asarray(lo_j).tolist() and hi_t.tolist() == np.asarray(hi_j).tolist()
    assert bool((lo_t | hi_t).any())


@pytest.mark.parametrize("return_clamp", [False, True])
def test_backward_box_parallel_warm_set_matches_jax(return_clamp):
    """A warm-started set (clamp0) with a regularizer, from `tests/
    test_boxddp.py`'s fixed-point problem; nonzero offsets on clamped
    dims strictly inside the box."""
    r = np.random.default_rng(4)
    N, d, m = 12, 3, 2
    A = np.eye(d) + 0.05 * r.normal(size=(N, d, d))
    B = 0.3 * r.normal(size=(N, d, m))
    M = r.normal(size=(N, d + m, d + m))
    Cts = M @ M.transpose(0, 2, 1) + 0.5 * np.eye(d + m)
    cts = r.normal(size=(N, d + m))
    u_nom = 0.3 * r.normal(size=(N, m))
    clamp_lo = r.random((N, m)) < 0.25
    clamp_hi = (r.random((N, m)) < 0.25) & ~clamp_lo
    clamp_lo[-1] = clamp_hi[-1] = False
    args = (A, B, Cts, cts, u_nom)
    lo, hi = np.array([-0.4, -0.4]), np.array([0.4, 0.4])
    kw = dict(reg=0.01, mask_iters=2, return_clamp=return_clamp)
    want = jc.ilqr_backward_box_parallel(*_j(args), jnp.asarray(lo), jnp.asarray(hi),
                                         clamp0=(jnp.asarray(clamp_lo), jnp.asarray(clamp_hi)),
                                         **kw)
    got = tc.ilqr_backward_box_parallel(*_t(args), torch.tensor(lo), torch.tensor(hi),
                                        clamp0=(torch.tensor(clamp_lo), torch.tensor(clamp_hi)),
                                        **kw)
    assert len(got) == len(want) == (3 if return_clamp else 2)
    assert _rel(got[0], want[0]) < TOL and _rel(got[1], want[1]) < TOL
    if return_clamp:
        for g, w in zip(got[2], want[2]):
            assert g.tolist() == np.asarray(w).tolist()


@pytest.mark.parametrize("seed", [0, 8, 17, 26])
def test_backward_box_parallel_cold_start_reaches_sequential(seed):
    """The JAX package's exactness claim on the port: cold-started, the
    exchange reaches the sequential box-QP pass's gains (to 1e-8)."""
    args = _t(_problem(seed))
    K_s, k_s = tc.ilqr_backward_box(*args, -0.25, 0.25, qp_method="enum")
    K_p, k_p = tc.ilqr_backward_box_parallel(*args, -0.25, 0.25, mask_iters=20)
    assert torch.allclose(K_p, K_s, atol=1e-8) and torch.allclose(k_p, k_s, atol=1e-8)


def test_backward_box_parallel_overactuated_matches_jax():
    """m = 5 (past the adjugate inverses) and loose bounds, where the
    parallel pass equals the sequential one."""
    r = np.random.default_rng(6)
    N, d, m = 10, 3, 5
    A = np.eye(d) + 0.05 * r.normal(size=(N, d, d))
    B = 0.3 * r.normal(size=(N, d, m))
    M = r.normal(size=(N, d + m, d + m))
    Cts = M @ M.transpose(0, 2, 1) + 0.5 * np.eye(d + m)
    cts = r.normal(size=(N, d + m))
    u_nom = 0.2 * r.normal(size=(N, m))
    args = (A, B, Cts, cts, u_nom)
    Kj, kj = jc.ilqr_backward_box_parallel(*_j(args), -0.3, 0.3, mask_iters=6)
    Kt, kt = tc.ilqr_backward_box_parallel(*_t(args), -0.3, 0.3, mask_iters=6)
    assert _rel(Kt, Kj) < TOL and _rel(kt, kj) < TOL
    K_s, k_s = tc.ilqr_backward_box(*_t(args), -1e3, 1e3, qp_method="newton")
    K_w, k_w = tc.ilqr_backward_box_parallel(*_t(args), -1e3, 1e3)
    assert torch.allclose(K_w, K_s, atol=1e-7) and torch.allclose(k_w, k_s, atol=1e-7)


def test_backward_box_parallel_refuses_a_mesh():
    """A `DeviceMesh` shards each pass over its 'time' axis
    (`tests/test_torch_time_sharded.py`); anything else is refused."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        tc.ilqr_backward_box_parallel(*_t(_problem(0, N=4)), -1.0, 1.0, mesh=object())


@pytest.mark.parametrize("u_scale", [0.1, 0.4])
def test_box_kkt_residual_matches_jax(u_scale):
    """A nominal inside the box and one with controls at the bounds."""
    A, B, Cts, cts, u_nom = _problem(2, u_scale=u_scale)
    u_nom = np.clip(u_nom, -0.25, 0.25)
    args = (A, B, Cts, cts, u_nom)
    for reg in (0.0, 0.1):
        want = float(jc.box_kkt_residual(*_j(args), -0.25, 0.25, reg=reg))
        got = tc.box_kkt_residual(*_t(args), -0.25, 0.25, reg=reg)
        assert got.ndim == 0 and abs(float(got) - want) <= TOL * max(1.0, want)


def test_rollout_closed_loop_clipped_matches_jax():
    """The simple car under clipped feedback with per-dim bounds."""
    r = np.random.default_rng(9)
    N = 30
    jcar, tcar = JCarSimple(dt=0.1), CarSimple(dt=0.1)
    x0 = np.array([0.0, 0.0, 0.5, 0.2])
    K = 0.5 * r.normal(size=(N, 2, 4))
    k = 0.5 * r.normal(size=(N, 2))
    x_nom = r.normal(size=(N, 4)) * 0.2
    u_nom = r.normal(size=(N, 2)) * 0.3
    lo, hi = np.array([-0.6, -0.3]), np.array([0.6, 0.3])
    xs_j, us_j = jc.rollout_closed_loop_clipped(jcar.step, *_j((x0, K, k, x_nom, u_nom, lo, hi)))
    xs_t, us_t = tc.rollout_closed_loop_clipped(tcar.step, *_t((x0, K, k, x_nom, u_nom, lo, hi)))
    assert _rel(xs_t, xs_j) < TOL and _rel(us_t, us_j) < TOL
    assert bool((us_t.abs() <= torch.tensor(hi)).all())
    assert bool((us_t.abs() == torch.tensor(hi)).any())  # the clip acts
