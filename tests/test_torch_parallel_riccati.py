"""Port vs JAX package: the time-parallel Riccati of `ops/parallel_riccati.py`
and the port's `ops/scan.py::associative_scan`.

Inputs are made with numpy from a seed and fed to both packages in
float64; results must agree to 1e-9 relative (the flat scan applies the
combine in the same tree, the blocked one in the same loops; only the
order of f64 sums differs).

XLA:CPU aborts with heap corruption while compiling the flat LQT scan
programs of the JAX package: in about half the runs of a process that
has imported torch, and in every run of one that compiles two of them
(the blocked and sequential programs do not; the JAX suite's conftest
records the same crash inside a single-device associative scan). So the
port's flat scans are held to JAX's one-block scan (block_size = N: the
same suffixes, folded sequentially), and JAX's own `lax.associative_scan`
and `rollout_closed_loop_parallel` run in one subprocess without torch.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.ops import parallel_riccati as jp
from ilqr_admm_tpu.ops import riccati as jr
from ilqr_admm_tpu_torch.ops import parallel_riccati as tp
from ilqr_admm_tpu_torch.ops import riccati as tr
from ilqr_admm_tpu_torch.ops.scan import associative_scan

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-9
SCAN_LENGTHS = (1, 2, 7, 8, 13)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _lqt(seed, N=33, d=4, m=2):
    rng = np.random.default_rng(seed)
    A = np.tile(np.eye(d), (N, 1, 1)) + 0.01 * rng.normal(size=(N, d, d))
    B = 0.1 * rng.normal(size=(N, d, m))
    Q = np.stack([np.diag(q) for q in rng.uniform(0.1, 10.0, size=(N, d))])
    xd = rng.normal(size=(N, d))
    R = np.tile(np.eye(m) * 0.1, (N, 1, 1))
    reg = dict(Qr=np.tile(np.eye(d) * 0.4, (N, 1, 1)), xr=rng.normal(size=(N, d)),
               Rr=np.tile(np.eye(m) * 0.2, (N, 1, 1)), ur=rng.normal(size=(N, m)))
    return (A, B, Q, xd, R), reg


def _ilqr(seed, N=29, d=4, m=2):
    rng = np.random.default_rng(seed)
    A = np.tile(np.eye(d), (N, 1, 1)) + 0.02 * rng.normal(size=(N, d, d))
    B = 0.1 * rng.normal(size=(N, d, m))
    G = rng.normal(size=(N, d + m, d + m))
    Cts = np.einsum("tij,tkj->tik", G, G) + np.eye(d + m)  # SPD with cross terms
    cts = rng.normal(size=(N, d + m))
    drift = 0.05 * rng.normal(size=(N, d))
    return A, B, Cts, cts, drift


def _scan_inputs(n):
    return np.random.default_rng(100 + n).normal(size=(n, 2, 2))


_FLAT_REFS = textwrap.dedent(
    """
    import sys
    import numpy as np
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from jax import lax
    from ilqr_admm_tpu.ops import parallel_riccati as jp
    assert "torch" not in sys.modules
    inp = dict(np.load(sys.argv[1]))
    out = {}
    for key in [k for k in inp if k.startswith("scan_")]:
        for rev in (0, 1):
            out[f"{key}_rev{rev}"] = np.asarray(lax.associative_scan(
                lambda a, b: a @ b, jnp.asarray(inp[key]), reverse=bool(rev)))
    xs, us = jp.rollout_closed_loop_parallel(
        *(jnp.asarray(inp[k]) for k in ("A", "B", "K", "k", "x0")))
    out["roll_xs"], out["roll_us"] = np.asarray(xs), np.asarray(us)
    np.savez(sys.argv[2], **out)
    """
)


def _rollout_inputs():
    (A, B, _, _, _), _ = _lqt(0)
    rng = np.random.default_rng(2)
    return dict(A=A, B=B, K=0.3 * rng.normal(size=(33, 2, 4)), k=rng.normal(size=(33, 2)),
                x0=rng.normal(size=4))


@pytest.fixture(scope="module")
def flat_refs(tmp_path_factory):
    """JAX's `lax.associative_scan` and `rollout_closed_loop_parallel`
    results, computed in a process without torch."""
    d = tmp_path_factory.mktemp("flat_refs")
    inp = dict(_rollout_inputs(), **{f"scan_{n}": _scan_inputs(n) for n in SCAN_LENGTHS})
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _FLAT_REFS, str(d / "in.npz"), str(d / "out.npz")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("n", SCAN_LENGTHS)
@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_matches_lax(flat_refs, n, reverse):
    """2 x 2 products do not commute, so operand order and tree show."""
    got = associative_scan(lambda a, b: a @ b, torch.tensor(_scan_inputs(n)), reverse=reverse)
    want = flat_refs[f"scan_{n}_rev{int(reverse)}"]
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() < 1e-12


def test_associative_scan_takes_tuples():
    x = torch.tensor(_scan_inputs(9))
    v = torch.tensor(np.random.default_rng(3).normal(size=(9, 2)))
    Ms, vs = associative_scan(
        lambda a, b: (b[0] @ a[0], (b[0] @ a[1][..., None])[..., 0] + b[1]), (x, v))
    M, w = x[0], v[0]
    for t in range(1, 9):
        M, w = x[t] @ M, x[t] @ w + v[t]
    assert torch.allclose(Ms[-1], M, atol=1e-12) and torch.allclose(vs[-1], w, atol=1e-12)
    with pytest.raises(ValueError, match="leading length"):
        associative_scan(lambda a, b: a, (x, v[:5]))


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_inv_small_matches_jax(d):
    rng = np.random.default_rng(d)
    M = rng.normal(size=(7, d, d)) + 3.0 * np.eye(d)
    got = tp.inv_small(torch.tensor(M)).numpy()
    assert _rel(got, jp.inv_small(jnp.asarray(M))) < 1e-12
    assert np.abs(got @ M - np.eye(d)).max() < 1e-12


def test_inv_small_rejects_above_4():
    with pytest.raises(ValueError, match="<= 4"):
        tp.inv_small(torch.eye(5)[None])


def _random_elems(seed, n, d):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(2, n, d, d))
    return (rng.normal(size=(n, d, d)), rng.normal(size=(n, d)),
            np.einsum("tij,tkj->tik", G[0], G[0]) * 0.1, rng.normal(size=(n, d)),
            np.einsum("tij,tkj->tik", G[1], G[1]))


@pytest.mark.parametrize("fast_inverse", [False, True])
def test_combine_matches_jax_and_has_identity(fast_inverse):
    e1, e2 = _random_elems(4, 6, 3), _random_elems(5, 6, 3)
    want = jp._combine(tuple(map(jnp.asarray, e1)), tuple(map(jnp.asarray, e2)),
                       fast_inverse=fast_inverse)
    t1, t2 = tuple(map(torch.tensor, e1)), tuple(map(torch.tensor, e2))
    got = tp._combine(t1, t2, fast_inverse=fast_inverse)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < 1e-12
    ident = tp._identity_elems((6,), 3, torch.float64)
    for left in (tp._combine(ident, t1, fast_inverse), tp._combine(t1, ident, fast_inverse)):
        for g, w in zip(left, t1):
            assert torch.allclose(g, w, rtol=0, atol=1e-12)


@pytest.mark.parametrize("regularized", [False, True])
@pytest.mark.parametrize("fast_inverse", [False, True])
def test_flat_lqt_backward_parallel_matches_jax(fast_inverse, regularized):
    """The flat scan against JAX's one-block scan (the same suffixes, summed
    sequentially) and the sequential pass."""
    data, reg = _lqt(0)
    kw = reg if regularized else {}
    N = data[0].shape[0]
    want = jp.lqt_backward_parallel(*map(jnp.asarray, data),
                                    **{k: jnp.asarray(v) for k, v in kw.items()},
                                    block_size=N, fast_inverse=fast_inverse)
    seq = jr.lqt_backward(*map(jnp.asarray, data), **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tp.lqt_backward_parallel(*map(torch.tensor, data),
                                   **{k: torch.tensor(v) for k, v in kw.items()},
                                   fast_inverse=fast_inverse)
    for name, g, w, w_seq in zip(got._fields, got, want, seq):
        assert _rel(g.numpy(), w) < TOL, name
        assert _rel(g.numpy(), w_seq) < TOL, name


def test_rollout_closed_loop_parallel_matches_jax(flat_refs):
    inp = {k: torch.tensor(v) for k, v in _rollout_inputs().items()}
    xs, us = tp.rollout_closed_loop_parallel(*(inp[k] for k in ("A", "B", "K", "k", "x0")))
    assert _rel(xs.numpy(), flat_refs["roll_xs"]) < TOL
    assert _rel(us.numpy(), flat_refs["roll_us"]) < TOL
    # and it is the sequential closed loop on the same gains
    x = inp["x0"]
    for t in range(inp["A"].shape[0]):
        assert torch.allclose(xs[t], x, atol=1e-10)
        x = inp["A"][t] @ x + inp["B"][t] @ (inp["K"][t] @ x + inp["k"][t])


@pytest.mark.parametrize("block_size", [4, 8, 33, 40])
@pytest.mark.parametrize("fast_inverse", [False, True])
def test_blocked_lqt_backward_parallel_matches_jax(block_size, fast_inverse):
    """Blocks that divide N or not, one block, and a block longer than N."""
    data, reg = _lqt(6)
    kw = {} if block_size % 8 else reg  # regularizers on half the cases
    want = jp.lqt_backward_parallel(*map(jnp.asarray, data),
                                    **{k: jnp.asarray(v) for k, v in kw.items()},
                                    block_size=block_size, fast_inverse=fast_inverse)
    got = tp.lqt_backward_parallel(*map(torch.tensor, data),
                                   **{k: torch.tensor(v) for k, v in kw.items()},
                                   block_size=block_size, fast_inverse=fast_inverse)
    for name, g, w in zip(got._fields, got, want):
        assert _rel(g.numpy(), w) < TOL, name
    seq = tr.lqt_backward(*map(torch.tensor, data), **{k: torch.tensor(v) for k, v in kw.items()})
    assert _rel(got.K.numpy(), seq.K.numpy()) < 1e-8


@pytest.mark.parametrize(
    "kwargs,match",
    [(dict(block_size=0), "positive int"), (dict(block_size=True), "positive int"),
     (dict(block_size=2.5), "positive int"), (dict(fast_inverse=True), "d=5")],
)
def test_lqt_backward_parallel_validation(kwargs, match):
    data, _ = _lqt(7, N=8, d=5)
    with pytest.raises(ValueError, match=match):
        tp.lqt_backward_parallel(*map(torch.tensor, data), **kwargs)


@pytest.mark.parametrize("fast_inverse", [False, True])
def test_value_elements_and_gains_with_drift_match_jax(fast_inverse):
    A, B, Cts, cts, drift = _ilqr(8)
    d = A.shape[-1]
    X, U = Cts[:, :d, :d], Cts[:, d:, d:] + 0.0
    eta, s = cts[:, :d], cts[:, d:]
    j_el, j_U, j_s = jp.value_elements_general(*map(jnp.asarray, (A, B, X, eta, U, s)),
                                               fast_inverse=fast_inverse, drift=jnp.asarray(drift))
    t_el, t_U, t_s = tp.value_elements_general(*map(torch.tensor, (A, B, X, eta, U, s)),
                                               fast_inverse=fast_inverse, drift=torch.tensor(drift))
    for g, w in zip(t_el, j_el):
        assert _rel(g.numpy(), w) < 1e-12
    # gains from the same scanned value functions, both branches
    rng = np.random.default_rng(9)
    G = rng.normal(size=(A.shape[0], d, d))
    J = np.einsum("tij,tkj->tik", G, G)
    scanned_np = (None, None, None, rng.normal(size=(A.shape[0], d)), J)
    want = jp.gains_from_scanned(*map(jnp.asarray, (A, B, U, s)),
                                 tuple(None if x is None else jnp.asarray(x) for x in scanned_np),
                                 fast_inverse=fast_inverse, drift=jnp.asarray(drift))
    got = tp.gains_from_scanned(*map(torch.tensor, (A, B, U, s)),
                                tuple(None if x is None else torch.tensor(x) for x in scanned_np),
                                fast_inverse=fast_inverse, drift=torch.tensor(drift))
    for name, g, w in zip(got._fields, got, want):
        assert _rel(g.numpy(), w) < 1e-10, name


@pytest.mark.parametrize("fast_inverse", [False, True])
def test_flat_ilqr_backward_parallel_matches_jax(fast_inverse):
    """Cross terms, drift and the value functions, against JAX's one-block scan."""
    A, B, Cts, cts, drift = _ilqr(1)
    want = jp.ilqr_backward_parallel(*map(jnp.asarray, (A, B, Cts, cts)), block_size=A.shape[0],
                                     fast_inverse=fast_inverse, return_value=True,
                                     drift=jnp.asarray(drift))
    got = tp.ilqr_backward_parallel(*map(torch.tensor, (A, B, Cts, cts)),
                                    fast_inverse=fast_inverse, return_value=True,
                                    drift=torch.tensor(drift))
    for name, g, w in zip(("K", "k", "J", "eta"), got, want):
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w) < TOL, name


@pytest.mark.parametrize("block_size", [5, 29])
def test_blocked_ilqr_backward_parallel_matches_jax_and_sequential(block_size):
    """Cross terms, no drift: also the sequential `ilqr_backward`."""
    A, B, Cts, cts, _ = _ilqr(10)
    want = jp.ilqr_backward_parallel(*map(jnp.asarray, (A, B, Cts, cts)), block_size=block_size)
    got = tp.ilqr_backward_parallel(*map(torch.tensor, (A, B, Cts, cts)), block_size=block_size)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < TOL
    K_seq, k_seq = jr.ilqr_backward(*map(jnp.asarray, (A, B, Cts, cts)))
    assert _rel(got[0].numpy(), K_seq) < 1e-8 and _rel(got[1].numpy(), k_seq) < 1e-8
    with pytest.raises(ValueError, match="d <= 4|dim <= 4"):
        tp.ilqr_backward_parallel(*map(torch.tensor, _ilqr(11, N=6, d=5)[:4]), fast_inverse=True)
