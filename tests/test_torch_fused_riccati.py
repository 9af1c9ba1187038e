"""Port vs JAX package: `ops/fused_riccati.py`, the counterpart of
`ops/pallas_riccati.py`, on CPU tensors (the plain versions of the
kernels).

Inputs are made with numpy from a seed and rounded to f32 once. The
Pallas kernels run in interpret mode at one small case only (N = 20,
nb = 4, d = 2: the JAX suite marks its own interpret cases slow); the
other cases hold the port to JAX's XLA blocked scan
`lqt_backward_parallel(block_size=L, fast_inverse=True)` in f32, to the
tolerances of `tests/test_pallas_riccati.py:46-52`.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from ilqr_admm_tpu.ops import parallel_riccati as jp
from ilqr_admm_tpu.ops.pallas_riccati import lqt_backward_parallel_pallas
from ilqr_admm_tpu_torch.ops import fused_riccati as tf
from ilqr_admm_tpu_torch.ops.parallel_riccati import value_elements

torch.set_num_threads(2)


def _problem(seed, N, d=4, m=2, regularized=False):
    """`tests/test_pallas_riccati.py`'s problem family, as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    A = np.tile(np.eye(d), (N, 1, 1)) + 0.01 * rng.normal(size=(N, d, d))
    B = 0.1 * rng.normal(size=(N, d, m))
    Q = np.stack([np.diag(q) for q in rng.uniform(0.1, 10.0, size=(N, d))])
    xd = rng.normal(size=(N, d))
    R = np.tile(np.eye(m) * 0.1, (N, 1, 1))
    reg = {}
    if regularized:
        reg = dict(Qr=np.tile(np.eye(d) * 0.4, (N, 1, 1)), xr=rng.normal(size=(N, d)),
                   Rr=np.tile(np.eye(m) * 0.2, (N, 1, 1)), ur=rng.normal(size=(N, m)))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return [f32(a) for a in (A, B, Q, xd, R)], {k: f32(v) for k, v in reg.items()}


def _port(data, reg, nb):
    return tf.lqt_backward_parallel_fused(
        *map(torch.tensor, data), **{k: torch.tensor(v) for k, v in reg.items()}, nb=nb,
        device="cpu",
    )


def _assert_gains_close(got, want):
    """The f32 tolerances of tests/test_pallas_riccati.py:46-52."""
    K_ref = np.asarray(want.K)
    assert np.abs(got.K.numpy() - K_ref).max() / np.abs(K_ref).max() < 5e-5
    np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got.Quu.numpy(), np.asarray(want.Quu), atol=1e-4, rtol=1e-4)


def test_matches_interpret_pallas():
    data, _ = _problem(0, N=20, d=2)
    want = lqt_backward_parallel_pallas(*map(jnp.asarray, data), nb=4, interpret=True)
    got = _port(data, {}, nb=4)
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
    _assert_gains_close(got, want)
    np.testing.assert_allclose(got.Quu_inv.numpy(), np.asarray(want.Quu_inv), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.Qux.numpy(), np.asarray(want.Qux), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize(
    "N,nb,d,regularized",
    [(64, 8, 4, False), (50, 8, 4, False), (40, 16, 4, False), (48, 8, 3, True), (30, 4, 1, False),
     (100, 128, 4, False)],
)
def test_matches_xla_blocked_scan(N, nb, d, regularized):
    """Non-divisible N (identity padding), nb > L, regularizers, d = 1, and
    N < nb (L = 1, most lanes pure padding)."""
    data, reg = _problem(N + d, N, d=d, m=min(d, 2), regularized=regularized)
    L = -(-N // nb)
    want = jp.lqt_backward_parallel(*map(jnp.asarray, data),
                                    **{k: jnp.asarray(v) for k, v in reg.items()},
                                    block_size=L, fast_inverse=True)
    _assert_gains_close(_port(data, reg, nb), want)


def _elements(N, d, nb, seed=3):
    data, _ = _problem(seed, N, d=d)
    elems, _, _ = value_elements(*map(torch.tensor, data), fast_inverse=True)
    return elems, tf.pack_elements(elems, N, d, nb)


def test_wrappers_match_jax_blocked_suffix_scan():
    """The three wrappers, chained, give (eta, J) of the JAX blocked scan."""
    N, d, nb = 45, 4, 4
    elems, slabs = _elements(N, d, nb)
    L = -(-N // nb)
    comb = lambda a, b: jp._combine(a, b, fast_inverse=True)  # noqa: E731
    want = jp._blocked_suffix_scan(
        comb, lambda p: jp._identity_elems(p, d, jnp.float32),
        tuple(jnp.asarray(x.numpy()) for x in elems), N, L)
    r = tf.riccati_scan(*slabs)
    assert all(x.shape == y.shape for x, y in zip(r, slabs))
    S_eta, S_J = tf.riccati_level2(*r)
    assert S_eta.shape == (d, nb) and S_J.shape == (d * d, nb)
    eta, J = tf.riccati_join(*r, S_eta, S_J)
    got_eta = tf._unpack(eta, N, d).numpy()
    got_J = tf._unpack(J, N, d * d).reshape(N, d, d).numpy()
    for got, w in ((got_eta, want[3]), (got_J, want[4])):
        w = np.asarray(w)
        assert np.abs(got - w).max() / max(1.0, np.abs(w).max()) < 1e-5


@pytest.mark.parametrize("N,nb,d,regularized", chip_smoke.RICCATI_CASES)
def test_chunked_scan_reference_matches_sequential_f64(N, nb, d, regularized):
    """The kernel's order (32 chunks a lane, a Hillis-Steele suffix over
    their totals, the walk) is the sequential suffix in another order of
    combines: in f64 the two agree to rounding, at chip_smoke's shapes
    (L = 79, a non-divisible N with the regularizers, d = 1-4, L = 1)."""
    data, reg, _ = chip_smoke.riccati_problem("cpu", N, d, regularized)
    f64 = lambda x: x.to(torch.float64)  # noqa: E731
    elems, _, _ = value_elements(*map(f64, data), **{k: f64(v) for k, v in reg.items()},
                                 fast_inverse=True)
    slabs = tf.pack_elements(elems, N, d, nb)
    want = tf.riccati_scan_reference(*slabs)
    got = tf.riccati_scan_reference(*slabs, chunks=tf.SCAN_CHUNKS)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-12 * max(1.0, float(w.abs().max()))


def test_chunked_scan_in_the_pass_matches_jax_blocked_scan(monkeypatch):
    """`lqt_backward_parallel_fused` on the CPU with the scan's plain
    version in the kernel's chunked order: (eta, J) of the three wrappers
    within test_wrappers_match_jax_blocked_suffix_scan's 1e-5 of the JAX
    blocked scan (L = 12 in 32 chunks: most are empty), and the gains
    within the tolerances of the XLA blocked scan."""
    sequential = tf.riccati_scan_reference
    monkeypatch.setattr(tf, "riccati_scan_reference",
                        lambda *slabs: sequential(*slabs, chunks=tf.SCAN_CHUNKS))
    N, d, nb = 45, 4, 4
    elems, slabs = _elements(N, d, nb)
    L = -(-N // nb)
    comb = lambda a, b: jp._combine(a, b, fast_inverse=True)  # noqa: E731
    want = jp._blocked_suffix_scan(
        comb, lambda p: jp._identity_elems(p, d, jnp.float32),
        tuple(jnp.asarray(x.numpy()) for x in elems), N, L)
    r = tf.riccati_scan(*slabs)
    eta, J = tf.riccati_join(*r, *tf.riccati_level2(*r))
    got_eta = tf._unpack(eta, N, d).numpy()
    got_J = tf._unpack(J, N, d * d).reshape(N, d, d).numpy()
    for got, w in ((got_eta, want[3]), (got_J, want[4])):
        w = np.asarray(w)
        assert np.abs(got - w).max() / max(1.0, np.abs(w).max()) < 1e-5
    data, reg = _problem(7, 150, d=3, regularized=True)
    gains = _port(data, reg, nb=4)
    _assert_gains_close(gains, jp.lqt_backward_parallel(
        *map(jnp.asarray, data), **{k: jnp.asarray(v) for k, v in reg.items()},
        block_size=-(-150 // 4), fast_inverse=True))


def test_pack_unpack_round_trip_and_identity_padding():
    N, d, nb = 10, 2, 4  # L = 3, two identity pads
    elems, slabs = _elements(N, d, nb)
    for x, slab, rows in zip(elems, slabs, tf.comp_rows(d)):
        assert slab.shape == (3, rows, nb) and slab.is_contiguous()
        assert torch.equal(tf._unpack(slab, N, rows), x.reshape(N, rows))
    A_pad = tf._unpack(slabs[0], nb * 3, d * d)[N:]
    assert torch.equal(A_pad, torch.eye(d).reshape(1, -1).expand(2, -1))
    assert float(tf._unpack(slabs[4], nb * 3, d * d)[N:].abs().max()) == 0.0


def test_rejects_large_state_and_bad_nb():
    data, _ = _problem(4, N=16, d=5)
    with pytest.raises(ValueError, match="d <= 4"):
        _port(data, {}, nb=4)
    data, _ = _problem(4, N=16, d=2)
    for nb in (0, True, 2.0):
        with pytest.raises(ValueError, match="nb must be a positive int"):
            _port(data, {}, nb=nb)


def test_wrappers_check_their_inputs():
    _, slabs = _elements(12, 2, 4)
    with pytest.raises(TypeError, match="float32"):
        tf.riccati_scan(*(x.double() for x in slabs))
    with pytest.raises(ValueError, match="expected"):
        tf.riccati_scan(*slabs[:4], slabs[4][:, :3])
    with pytest.raises(ValueError, match="contiguous"):
        tf.riccati_level2(*slabs[:4], slabs[4].transpose(0, 2).contiguous().transpose(0, 2))
    S_eta, S_J = tf.riccati_level2(*slabs)
    with pytest.raises(ValueError, match="S_J"):
        tf.riccati_join(*slabs, S_eta, S_J[:, :2])
    five = torch.zeros((3, 25, 4))
    with pytest.raises(ValueError, match="d <= 4"):
        tf.riccati_scan(five, *slabs[1:])


def test_cpu_tensors_do_not_launch_the_kernels():
    before = (tf.scan_launch_count, tf.level2_launch_count, tf.join_launch_count)
    data, _ = _problem(5, N=24, d=3)
    got = _port(data, {}, nb=4)
    assert (tf.scan_launch_count, tf.level2_launch_count, tf.join_launch_count) == before
    assert all(bool(torch.isfinite(g).all()) for g in got)
