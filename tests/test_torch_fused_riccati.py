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
    """The two wrappers, chained, give (eta, J) of the JAX blocked scan,
    time-major."""
    N, d, nb = 45, 4, 4
    elems, slabs = _elements(N, d, nb)
    L = -(-N // nb)
    comb = lambda a, b: jp._combine(a, b, fast_inverse=True)  # noqa: E731
    want = jp._blocked_suffix_scan(
        comb, lambda p: jp._identity_elems(p, d, jnp.float32),
        tuple(jnp.asarray(x.numpy()) for x in elems), N, L)
    r = tf.riccati_scan(*slabs)
    assert all(x.shape == y.shape for x, y in zip(r, slabs))
    eta, J = tf.riccati_join(*r, N)
    assert eta.shape == (N, d) and J.shape == (N, d, d)
    for got, w in ((eta.numpy(), want[3]), (J.numpy(), want[4])):
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
    """`lqt_backward_parallel_fused` on the CPU with the plain versions in
    the kernels' orders (the scan's chunks, the join's level 2 for
    `JOIN_GROUP` lanes a block): (eta, J) of the two wrappers within
    test_wrappers_match_jax_blocked_suffix_scan's 1e-5 of the JAX blocked
    scan (L = 12 in 32 chunks: most are empty; nb = 4 lanes in a block of
    16: most hold the identity), and the gains within the tolerances of
    the XLA blocked scan."""
    sequential = tf.riccati_scan_reference
    jax_order = tf.riccati_join_reference
    monkeypatch.setattr(tf, "riccati_scan_reference",
                        lambda *slabs: sequential(*slabs, chunks=tf.SCAN_CHUNKS))
    monkeypatch.setattr(tf, "riccati_join_reference",
                        lambda *slabs: jax_order(*slabs, order=tf.JOIN_GROUP))
    N, d, nb = 45, 4, 4
    elems, slabs = _elements(N, d, nb)
    L = -(-N // nb)
    comb = lambda a, b: jp._combine(a, b, fast_inverse=True)  # noqa: E731
    want = jp._blocked_suffix_scan(
        comb, lambda p: jp._identity_elems(p, d, jnp.float32),
        tuple(jnp.asarray(x.numpy()) for x in elems), N, L)
    r = tf.riccati_scan(*slabs)
    eta, J = tf.riccati_join(*r, N)
    for got, w in ((eta.numpy(), want[3]), (J.numpy(), want[4])):
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
        tf.riccati_join(*slabs[:4], slabs[4].transpose(0, 2).contiguous().transpose(0, 2), 12)
    with pytest.raises(ValueError, match="expected"):
        tf.riccati_join(*slabs[:4], slabs[4][:, :, :3], 12)
    with pytest.raises(TypeError, match="float32"):
        tf.riccati_join(*(x.double() for x in slabs), 12)
    five = torch.zeros((3, 25, 4))
    with pytest.raises(ValueError, match="d <= 4"):
        tf.riccati_scan(five, *slabs[1:])
    with pytest.raises(ValueError, match="d <= 4"):
        tf.riccati_join(five, *slabs[1:], 12)


@pytest.mark.parametrize("N", [8, 13, 0, -1, True, 12.0, None])
def test_join_checks_the_horizon(N):
    """L = 3 steps of nb = 4 lanes hold horizons 9 .. 12 only."""
    _, slabs = _elements(12, 2, 4)
    with pytest.raises(ValueError, match="N must be an int in"):
        tf.riccati_join(*slabs, N)


def test_cpu_tensors_do_not_launch_the_kernels():
    before = (tf.scan_launch_count, tf.join_launch_count)
    data, _ = _problem(5, N=24, d=3)
    got = _port(data, {}, nb=4)
    assert (tf.scan_launch_count, tf.join_launch_count) == before
    assert all(bool(torch.isfinite(g).all()) for g in got)
    # level 2 runs inside the join: it has no wrapper or counter of its own
    assert not hasattr(tf, "riccati_level2") and not hasattr(tf, "level2_launch_count")


@pytest.mark.parametrize("N,nb,d,regularized", chip_smoke.RICCATI_CASES)
def test_join_reference_kernel_order_matches_jax_order_f64(N, nb, d, regularized):
    """The joined kernel's order of level-2 combines (`order=JOIN_GROUP`:
    a block's later lanes in `JOIN_GROUP` chunks and a tree, its own lanes
    in a Hillis-Steele suffix) is the JAX package's associative scan in
    another order: in f64 the two agree to rounding, at chip_smoke's shapes
    (nb < 16, nb = 16 a single block, nb = 1,024 with 63 totals a
    chunk)."""
    data, reg, _ = chip_smoke.riccati_problem("cpu", N, d, regularized)
    f64 = lambda x: x.to(torch.float64)  # noqa: E731
    elems, _, _ = value_elements(*map(f64, data), **{k: f64(v) for k, v in reg.items()},
                                 fast_inverse=True)
    r = tf.riccati_scan_reference(*tf.pack_elements(elems, N, d, nb))
    want = tf.riccati_join_reference(*r, N)
    got = tf.riccati_join_reference(*r, N, order=tf.JOIN_GROUP)
    assert got[0].shape == (N, d) and got[1].shape == (N, d, d)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert float((g - w).abs().max()) <= 1e-12 * max(1.0, float(w.abs().max()))


def test_time_major_join_equals_unpacked_slab_join():
    """The join's time-major rows are the old slab path's (level 2, the
    slab join, `_unpack`) bit for bit, the padding rows t >= N absent."""
    N, d, nb = 45, 4, 4  # L = 12, three identity pads
    _, slabs = _elements(N, d, nb)
    r = tf.riccati_scan(*slabs)
    eta, J = tf.riccati_join(*r, N)
    eta_s, J_s = tf._join_slabs(*r, *tf.riccati_level2_reference(*r))
    assert eta.shape == (N, d) and J.shape == (N, d, d)
    assert torch.equal(eta, tf._unpack(eta_s, N, d))
    assert torch.equal(J, tf._unpack(J_s, N, d * d).reshape(N, d, d))
    assert tf._unpack(J_s, nb * 12, d * d).shape[0] - J.shape[0] == 3
    got = tf.riccati_join_reference(*r, N, order=8)
    eta_s, J_s = tf._join_slabs(*r, *tf._level2_grouped(*r, 8))
    assert torch.equal(got[0], tf._unpack(eta_s, N, d))
    assert torch.equal(got[1], tf._unpack(J_s, N, d * d).reshape(N, d, d))


def _kernel_level2(r, d, G):
    """The join kernel's prologue written as its loops, one block and one
    combine group at a time: (S_eta (d, nb), S_J (d*d, nb))."""
    nb = r[0].shape[2]
    tot = tf._lanes(tuple(x[0] for x in r), d)
    ident = tuple(x[0] for x in tf._identity_elems((1,), d, r[0].dtype))
    lane = lambda b: tuple(x[b] for x in tot) if b < nb else ident  # noqa: E731
    comb = lambda a, b: tf._combine(a, b, fast_inverse=True)  # noqa: E731
    S = []
    for lane0 in range(0, nb, G):
        chunk = -(-max(nb - lane0 - G, 0) // G)
        x = [ident] * G
        for q in range(G):
            for k in range(chunk - 1, -1, -1):
                x[q] = comb(lane(lane0 + G + q * chunk + k), x[q])
        t = [lane(lane0 + q) for q in range(G)]
        o = 1
        while o < G:
            x = [comb(x[q], x[q + o]) if q % (2 * o) == 0 and q + o < G else x[q]
                 for q in range(G)]
            t = [comb(t[q], t[q + o]) if q + o < G else t[q] for q in range(G)]
            o *= 2
        S += [comb(t[q + 1] if q + 1 < G else ident, x[0]) for q in range(G)]
    S = S[:nb]
    return (torch.stack([s[3] for s in S]).T,
            torch.stack([s[4].reshape(-1) for s in S]).T)


@pytest.mark.parametrize("nb,G", [(40, 8), (13, 4), (3, 8), (64, 32)])
def test_grouped_level2_replays_the_kernels_loops(nb, G):
    """`_level2_grouped` batches the kernel's prologue over blocks and
    combine groups (the shorter chunks padded with identities); in f32 it
    equals the prologue's loops run one block and one group at a time bit
    for bit: a combine with the identity is exact."""
    N, d = 5 * nb - 2, 3
    _, slabs = _elements(N, d, nb)
    r = tf.riccati_scan(*slabs)
    with tf.full_f32_matmul():
        want = _kernel_level2(r, d, G)
        got = tf._level2_grouped(*r, G)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("L,nb,n_sms,steps", [
    (79, 128, 132, 5), (10, 1024, 132, 5), (126, 8, 132, 1), (1, 128, 132, 1),
    (625, 16, 132, 5), (313, 32, 132, 5), (10_000, 8192, 132, 16)])
def test_join_tile_covers_the_sms_once(L, nb, n_sms, steps):
    """Steps a join block takes: the fewest that fill the SMs with one
    wave of blocks, at most JOIN_MAX_STEPS."""
    assert tf.join_tile(L, nb, n_sms) == steps
