"""Port vs JAX package: the planar arm of `models/arm.py`.

Random joint angles, states and controls made with numpy from a seed go
through both packages in float64: forward kinematics, the frame
Jacobian, the step, the initial state and both linearizations must agree
to 1e-12 (only the order of f64 operations differs). The port's URDF
copy, and the arm under `torch.func.vmap`, are checked too.
"""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.func import vmap

from ilqr_admm_tpu.models import arm as ja
from ilqr_admm_tpu_torch.convert import arm_from_numpy
from ilqr_admm_tpu_torch.models import arm as ta

torch.set_num_threads(2)

TOL = 1e-12
N = 25
REPO = Path(__file__).resolve().parents[1]
LENGTHS = [(1.0, 1.0, 1.0), (0.7, 1.3, 0.9, 0.5)]


def _err(got, want):
    return float(np.abs(got.detach().numpy() - np.asarray(want)).max())


def _pair(lengths, dt=1.0 / N):
    jarm = ja.PlanarArm(lengths, dt=dt)
    return jarm, arm_from_numpy(np.asarray(jarm.lengths), jarm.dt)


def _traj(n, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(N, 3 * n + 3 - n))
    us = rng.normal(size=(N, n))
    return xs, us


@pytest.mark.parametrize("lengths", LENGTHS)
def test_kinematics_match_jax(lengths):
    jarm, tarm = _pair(lengths)
    n = len(lengths)
    qs = np.random.default_rng(1).uniform(-np.pi, np.pi, size=(N, n))
    for name in ("fk", "fk_links", "jacobian", "initial_state"):
        want = np.stack([np.asarray(getattr(jarm, name)(jnp.asarray(q))) for q in qs])
        got = torch.stack([getattr(tarm, name)(torch.tensor(q)) for q in qs])
        assert got.shape == want.shape, name
        assert _err(got, want) < TOL, name
        # the batched call of the port, without vmap, gives the same rows
        assert _err(getattr(tarm, name)(torch.tensor(qs)), want) < TOL, name


@pytest.mark.parametrize("lengths", LENGTHS)
def test_step_and_linearizations_match_jax(lengths):
    jarm, tarm = _pair(lengths)
    n = len(lengths)
    xs, us = _traj(n)
    want = np.stack([np.asarray(jarm.step(jnp.asarray(x), jnp.asarray(u))) for x, u in zip(xs, us)])
    got = torch.stack([tarm(torch.tensor(x), torch.tensor(u)) for x, u in zip(xs, us)])
    assert _err(got, want) < TOL
    jA, jB = jarm.get_AB(jnp.asarray(xs), jnp.asarray(us))
    jAd, jBd = jarm.get_AB_autodiff(jnp.asarray(xs), jnp.asarray(us))
    tA, tB = tarm.get_AB(torch.tensor(xs), torch.tensor(us))
    tAd, tBd = tarm.get_AB_autodiff(torch.tensor(xs), torch.tensor(us))
    d = 2 * n + 3
    assert tA.shape == (N, d, d) and tB.shape == (N, d, n)
    for got_m, want_m in ((tA, jA), (tB, jB), (tAd, jAd), (tBd, jBd)):
        assert _err(got_m, want_m) < TOL
    # the hand-assembled linearization is the step's exact Jacobian
    assert float((tA - tAd).abs().max()) < TOL and float((tB - tBd).abs().max()) < TOL


def test_f32_linearizations_stay_f32():
    tarm = ta.PlanarArm(dt=0.01)
    xs, us = _traj(3)
    f32 = torch.float32
    for get in (tarm.get_AB, tarm.get_AB_autodiff):
        A, B = get(torch.tensor(xs, dtype=f32), torch.tensor(us, dtype=f32))
        assert A.dtype == B.dtype == f32
    assert tarm.step(torch.zeros(9, dtype=f32), torch.zeros(3, dtype=f32)).dtype == f32


def test_urdf_copy_loads_and_equals_the_jax_asset():
    ours = Path(ta.PLANAR_3DOF_URDF)
    theirs = REPO / "ilqr_admm_tpu" / "assets" / "planar_3dof.urdf"
    assert ours.read_bytes() == theirs.read_bytes()
    arm = ta.load_planar_arm_urdf(dt=0.02)
    assert arm.link_lengths == (1.0, 1.0, 1.0) and arm.dt == 0.02 and arm.x_dim == 9
    jarm = ja.load_planar_arm_urdf(str(theirs), dt=0.02)
    assert np.array_equal(np.asarray(jarm.lengths), arm.lengths.numpy())


def test_urdf_without_links_raises(tmp_path):
    path = tmp_path / "empty.urdf"
    path.write_text('<robot name="x"><joint name="j" type="fixed"><origin xyz="0 0 0"/></joint></robot>')
    with pytest.raises(ValueError, match="no link lengths"):
        ta.load_planar_arm_urdf(str(path))


def test_vmap_over_a_batch_equals_a_loop():
    """step, fk and jacobian under torch.func.vmap (as the fleet maps them
    over instances and candidates), and get_AB vmapped over trajectories,
    equal the unbatched calls bit for bit."""
    tarm = ta.PlanarArm(dt=0.01)
    rng = np.random.default_rng(2)
    xs, us = torch.tensor(rng.normal(size=(7, 9))), torch.tensor(rng.normal(size=(7, 3)))
    loop = torch.stack([tarm.step(x, u) for x, u in zip(xs, us)])
    assert torch.equal(vmap(tarm.step)(xs, us), loop)
    assert torch.equal(vmap(tarm.fk)(xs[:, :3]), torch.stack([tarm.fk(q) for q in xs[:, :3]]))
    assert torch.equal(vmap(tarm.jacobian)(xs[:, :3]),
                       torch.stack([tarm.jacobian(q) for q in xs[:, :3]]))
    X = torch.tensor(rng.normal(size=(4, N, 9)))
    U = torch.tensor(rng.normal(size=(4, N, 3)))
    A, B = vmap(tarm.get_AB)(X, U)
    for i in range(4):
        Ai, Bi = tarm.get_AB(X[i], U[i])
        assert torch.equal(A[i], Ai) and torch.equal(B[i], Bi)
