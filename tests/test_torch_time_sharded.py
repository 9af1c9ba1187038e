"""Port vs JAX package: the Riccati recursion with its horizon sharded
over a ('time',) mesh (`parallel/time_sharded.py`).

The counterpart of `tests/test_time_sharded.py`, with its inputs (numpy
from `default_rng(3)` in each case). A world of 4 gloo ranks
(`tests/torch_world.py`, importing only the port) runs the LQT pass, the
regularized pass with the adjugate combine, the general iLQR pass with
cross terms, drift and its value function, the box-constrained
active-set backward with `mesh=`, and the sharded suffix scan itself.
Every rank's result is held, in float64, to the unsharded port (1e-12
relative: the same combines in another tree), to the sequential pass and
to the JAX package's time-sharded pass on its 8-device mesh (1e-8).

The JAX package's sharded scans run in one subprocess without torch: its
flat associative scans abort XLA:CPU in a process that imported torch
(see `tests/test_torch_parallel_riccati.py`), and its collective
programs in a long-lived worker (`tests/test_time_sharded.py`).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_world
from ilqr_admm_tpu_torch.ops.constrained_riccati import ilqr_backward_box_parallel
from ilqr_admm_tpu_torch.ops.parallel_riccati import (
    _suffix_scan,
    ilqr_backward_parallel,
    lqt_backward_parallel,
)
from ilqr_admm_tpu_torch.ops.riccati import lqt_backward
from ilqr_admm_tpu_torch.parallel import lqt_backward_time_sharded
from ilqr_admm_tpu_torch.parallel.time_sharded import ilqr_backward_time_sharded

torch.set_num_threads(2)

NPROC = 4
SHARD_TOL = 1e-12
TOL = 1e-8
GAINS = ("K", "k", "Quu", "Quu_inv", "Qux")


def _random_lqt(rng, N=64, d=3, m=2):
    A = np.tile(np.eye(d), (N, 1, 1)) + 0.02 * rng.normal(size=(N, d, d))
    B = 0.15 * rng.normal(size=(N, d, m))
    Q = np.stack([np.diag(q) for q in rng.uniform(0.1, 5.0, size=(N, d))])
    xd = rng.normal(size=(N, d))
    R = np.tile(np.eye(m) * 0.3, (N, 1, 1))
    return A, B, Q, xd, R


def _random_ilqr(rng, N=64, d=3, m=2):
    A = np.tile(np.eye(d), (N, 1, 1)) + 0.02 * rng.normal(size=(N, d, d))
    B = 0.15 * rng.normal(size=(N, d, m))
    M = rng.normal(size=(N, d + m, d + m))
    Cts = M @ M.transpose(0, 2, 1) + 0.5 * np.eye(d + m)
    return A, B, Cts, rng.normal(size=(N, d + m))


def _inputs():
    out = dict(zip((f"lqt_{k}" for k in "A B Q xd R".split()),
                   _random_lqt(np.random.default_rng(3))))
    rng = np.random.default_rng(3)
    A, B, Q, xd, R = _random_lqt(rng, N=40, d=2, m=1)
    reg = dict(Qr=np.tile(np.eye(2) * 0.3, (40, 1, 1)), xr=rng.normal(size=(40, 2)),
               Rr=np.tile(np.eye(1) * 0.1, (40, 1, 1)), ur=rng.normal(size=(40, 1)))
    out.update({f"reg_{k}": v for k, v in dict(A=A, B=B, Q=Q, xd=xd, R=R, **reg).items()})
    rng = np.random.default_rng(3)
    ilqr = _random_ilqr(rng)
    out.update(zip(("ilqr_A", "ilqr_B", "ilqr_Cts", "ilqr_cts"), ilqr))
    out["ilqr_drift"] = 0.1 * rng.normal(size=(64, 3))
    rng = np.random.default_rng(3)
    out.update(zip(("box_A", "box_B", "box_Cts", "box_cts"), _random_ilqr(rng)))
    out.update(box_u_nom=0.3 * rng.normal(size=(64, 2)), box_lo=np.array([-0.4, -0.4]),
               box_hi=np.array([0.4, 0.4]))
    return out


_JAX_REFS = textwrap.dedent(
    """
    import sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_enable_compilation_cache", False)
    import jax.numpy as jnp
    from ilqr_admm_tpu.ops.constrained_riccati import ilqr_backward_box_parallel
    from ilqr_admm_tpu.parallel.mesh import make_mesh
    from ilqr_admm_tpu.parallel.time_sharded import (
        ilqr_backward_time_sharded, lqt_backward_time_sharded)
    assert "torch" not in sys.modules and len(jax.devices()) == 8
    inp = {k: jnp.asarray(v) for k, v in np.load(sys.argv[1]).items()}
    mesh = make_mesh(axis_names=("time",))
    out = {}
    g = lqt_backward_time_sharded(*(inp["lqt_" + k] for k in "A B Q xd R".split()), mesh=mesh)
    out.update({"lqt_" + k: v for k, v in g._asdict().items()})
    g = lqt_backward_time_sharded(
        *(inp["reg_" + k] for k in "A B Q xd R Qr xr Rr ur".split()), mesh=mesh,
        fast_inverse=True)
    out.update({"reg_" + k: v for k, v in g._asdict().items()})
    il = [inp["ilqr_" + k] for k in "A B Cts cts drift".split()]
    out["ilqr_K"], out["ilqr_k"] = ilqr_backward_time_sharded(*il, mesh=mesh)
    out["ilqr_Kv"], out["ilqr_kv"], out["ilqr_J"], out["ilqr_eta"] = \\
        ilqr_backward_time_sharded(*il, mesh=mesh, return_value=True)
    bx = [inp["box_" + k] for k in "A B Cts cts u_nom lo hi".split()]
    out["box_K"], out["box_k"] = ilqr_backward_box_parallel(*bx, mesh=mesh)
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
    """
)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the port's world, the JAX package's time-sharded results on its
    8-device mesh): the JAX side in a process without torch, run while
    the world runs."""
    d = tmp_path_factory.mktemp("jax_refs")
    np.savez(d / "in.npz", **_inputs())
    env = dict(os.environ, PYTHONPATH=str(torch_world.REPO), JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    proc = subprocess.Popen([sys.executable, "-c", _JAX_REFS, str(d / "in.npz"),
                             str(d / "out.npz")], cwd=torch_world.REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        world = torch_world.run_world("time", NPROC, _inputs(), tmp_path_factory.mktemp("world"))
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    return world, dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def world(results):
    return results[0]


@pytest.fixture(scope="module")
def refs(results):
    return results[1]


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _port(prefix, keys):
    inp = _inputs()
    return [torch.tensor(inp[f"{prefix}_{k}"]) for k in keys]


def test_lqt_matches_unsharded_sequential_and_jax(world, refs):
    """N = 64 over 4 ranks, 16 stages each."""
    data = _port("lqt", "A B Q xd R".split())
    unsharded, seq = lqt_backward_parallel(*data), lqt_backward(*data)
    for out in torch_world.case(world, "lqt"):
        for k in GAINS:
            assert _rel(out[k], getattr(unsharded, k)) < SHARD_TOL, k
            assert _rel(out[k], getattr(seq, k)) < TOL, k
            assert _rel(out[k], refs[f"lqt_{k}"]) < TOL, k


def test_regularizers_with_fast_inverse(world, refs):
    """N = 40, d = 2, m = 1 with the ADMM regularizers (Qr, xr, Rr, ur) and
    the adjugate combine."""
    data = _port("reg", "A B Q xd R Qr xr Rr ur".split())
    unsharded, seq = lqt_backward_parallel(*data, fast_inverse=True), lqt_backward(*data)
    for out in torch_world.case(world, "lqt_reg_fast"):
        for k in GAINS:
            assert _rel(out[k], getattr(unsharded, k)) < SHARD_TOL, k
            assert _rel(out[k], refs[f"reg_{k}"]) < TOL, k
        assert _rel(out["K"], seq.K) < TOL and _rel(out["k"], seq.k) < TOL


def test_indivisible_horizon_raises(world):
    for out in torch_world.case(world, "indivisible"):
        assert out["error"] == "ValueError: horizon 30 must be divisible by mesh axis size 4"
    A, B = (torch.zeros((8, 5, 5)), torch.zeros((8, 5, 1)))
    with pytest.raises(ValueError, match="fast_inverse"):
        lqt_backward_time_sharded(A, B, A, A[..., 0], B[:, :1], mesh=None, fast_inverse=True)


def test_suffix_scan_and_the_next_chunks_first_element(world):
    """The gathered scan equals the unsharded one, and rank i's exclusive
    suffix S_i is the next chunk's first joined element, scan[(i + 1) L]:
    the value function the gains at the chunk's last stage need, so no
    second exchange is made (identity on the last rank)."""
    data = _port("lqt", "A B Q xd R".split())
    elems, _, _ = torch_world.lqt_elements(*data)
    want = _suffix_scan(elems, 64, 3, torch.float64, "cpu", None, False)
    for out in torch_world.case(world, "scan"):
        for got, ref in zip(out["scan"], want):
            assert _rel(got, ref) < SHARD_TOL
        i, L = out["rank"], out["L"]
        for got, ref in zip(out["S"], want):
            if i < NPROC - 1:
                assert _rel(got[0], ref[(i + 1) * L]) < SHARD_TOL
        if i == NPROC - 1:
            assert torch.equal(out["S"][0][0], torch.eye(3, dtype=torch.float64))
            assert all(not s.any() for s in out["S"][1:])


def test_ilqr_with_drift_and_value(world, refs):
    """`test_ilqr_time_sharded_matches_parallel`: N = 64, d = 3, m = 2,
    cross terms and an affine drift; return_value adds (J, eta)."""
    A, B, Cts, cts, drift = _port("ilqr", "A B Cts cts drift".split())
    K, k, J, eta = ilqr_backward_parallel(A, B, Cts, cts, drift=drift, return_value=True)
    for out in torch_world.case(world, "ilqr"):
        for key, ref in (("K", K), ("k", k), ("Kv", K), ("kv", k), ("J", J), ("eta", eta)):
            assert _rel(out[key], ref) < SHARD_TOL, key
            assert _rel(out[key], refs[f"ilqr_{key}"]) < TOL, key


def test_box_backward_with_a_mesh(world, refs):
    """`test_box_backward_time_sharded_matches_unsharded`: the active-set
    boxDDP backward with each pass's scan over the mesh equals the call
    without a mesh, and the JAX package's with its mesh."""
    data = _port("box", "A B Cts cts u_nom lo hi".split())
    K, k = ilqr_backward_box_parallel(*data)
    assert float(k.abs().max()) > 0.0
    for out in torch_world.case(world, "box"):
        assert _rel(out["K"], K) < SHARD_TOL and _rel(out["k"], k) < SHARD_TOL
        assert _rel(out["K"], refs["box_K"]) < TOL and _rel(out["k"], refs["box_k"]) < TOL


def test_ilqr_time_sharded_checks_fast_inverse():
    A, B = torch.zeros((8, 5, 5)), torch.zeros((8, 5, 1))
    with pytest.raises(ValueError, match="state dim <= 4"):
        ilqr_backward_time_sharded(A, B, torch.zeros((8, 6, 6)), torch.zeros((8, 6)), mesh=None,
                                   fast_inverse=True)
