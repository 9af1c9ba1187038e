"""Port vs JAX package: the host-side helpers `viz.py` and `native.py`.

`ilqr_admm_tpu_torch/viz.py` against `ilqr_admm_tpu/viz.py` on the Agg
backend, in the cases of `tests/test_viz.py`: the same artists at the
same display coordinates and colours, the same GIF frames, pixel for
pixel. `ilqr_admm_tpu_torch/native.py` against `ilqr_admm_tpu/native.py`
(the same `native/kinematics.cpp`, built by each into its own place) on
the same float64 inputs, and against the port's `PlanarArm`.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

mpl = pytest.importorskip("matplotlib")
mpl.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
from PIL import Image  # noqa: E402

from ilqr_admm_tpu import native as j_native  # noqa: E402
from ilqr_admm_tpu import viz as j_viz  # noqa: E402
from ilqr_admm_tpu_torch import native, viz  # noqa: E402
from ilqr_admm_tpu_torch.models.arm import PlanarArm  # noqa: E402

LENGTHS = (1.0, 0.7, 1.3)


def _car_traj(n=12):
    t = np.linspace(0, 1, n)
    xs = np.stack([t, t**2, 0.5 * t, t], axis=-1)
    us = np.stack([0.3 * np.sin(6 * t), np.cos(6 * t)], axis=-1)
    return xs, us


def _axes():
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.set_xlim(-1, 4)
    ax.set_ylim(-2, 3)
    return fig, ax


def _patch_record(patches, ax):
    """Each patch's display vertices and colours, after adding it to ax
    (None: the patches are on an axis already)."""
    for p in patches if ax is not None else ():
        ax.add_patch(p)
    return [(np.asarray(p.get_verts()), p.get_facecolor(), p.get_edgecolor()) for p in patches]


def _same_records(got, want):
    assert len(got) == len(want)
    for (v1, f1, e1), (v2, f2, e2) in zip(got, want):
        assert v1.shape == v2.shape and np.array_equal(v1, v2)
        assert f1 == f2 and e1 == e2


def test_plot_car_draws_the_jax_car():
    """4 wheels, body, window, 2 headlights, 2 origin-cross bars, the
    front wheels steered; numpy and tensor inputs alike."""
    xs, us = _car_traj()
    records = []
    for draw, state, control in ((j_viz.plot_car, xs[3], us[3]), (viz.plot_car, xs[3], us[3]),
                                 (viz.plot_car, torch.tensor(xs[3]), torch.tensor(us[3]))):
        fig, ax = _axes()
        records.append(_patch_record(draw(state, control, ax=ax), ax))
        plt.close(fig)
    assert len(records[0]) == 10
    _same_records(records[1], records[0])
    _same_records(records[2], records[0])


def _lines(ax):
    return [(line.get_xydata(), line.get_color(), line.get_marker()) for line in ax.get_lines()]


def test_plot_arm_and_convergence_draw_the_jax_lines():
    q = np.array([0.3, -0.2, 0.1])
    drawn = []
    for module, angles in ((j_viz, q), (viz, q), (viz, torch.tensor(q))):
        fig, ax = _axes()
        module.plotArm(ax, LENGTHS, angles, robot_base=True)
        module.plot_convergence([3.0, 2.0, 1.5, 1.49], ax=ax)
        drawn.append((_lines(ax), _patch_record(ax.patches, None),
                      ax.get_xlabel(), ax.get_title()))
        plt.close(fig)
    for got in drawn[1:]:
        for (xy1, c1, m1), (xy2, c2, m2) in zip(got[0], drawn[0][0]):
            assert np.array_equal(xy1, xy2) and c1 == c2 and m1 == m2
        _same_records(got[1], drawn[0][1])
        assert got[2:] == drawn[0][2:] == ("# of iterations", "Convergence")


def _frames(path):
    with Image.open(path) as im:
        out = []
        for i in range(getattr(im, "n_frames", 1)):
            im.seek(i)
            out.append(np.asarray(im.convert("RGB")))
        return out


def _same_gif(got, want):
    a, b = _frames(got), _frames(want)
    assert len(a) == len(b)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    return len(a)


def test_animate_car_writes_the_jax_gif(tmp_path):
    xs, us = _car_traj()
    j_viz.animate_car(xs, us, str(tmp_path / "jax.gif"), stride=3, fps=5)
    viz.animate_car(torch.tensor(xs), torch.tensor(us), str(tmp_path / "port.gif"), stride=3,
                    fps=5)
    assert _same_gif(tmp_path / "port.gif", tmp_path / "jax.gif") == 4  # 12 frames / stride 3


def test_animate_arm_writes_the_jax_gif(tmp_path):
    qs = np.linspace(0.0, 0.5, 6)[:, None] * np.array([1.0, -0.5, 0.25])
    for module, name in ((j_viz, "jax.gif"), (viz, "port.gif")):
        module.animate_arm(qs, (1.0, 1.0, 1.0), str(tmp_path / name), fps=5, target=(1.5, 1.0))
    assert _same_gif(tmp_path / "port.gif", tmp_path / "jax.gif") == 6


def test_animate_trajectory_custom_frames(tmp_path):
    seen = {}
    for module in (j_viz, viz):
        seen[module] = []

        def draw(ax, t, log=seen[module]):
            log.append(t)
            ax.plot([0, t], [0, 1])

        module.animate_trajectory(draw, 9, str(tmp_path / f"{module.__name__}.gif"), stride=4,
                                  fps=3)
    assert sorted(set(seen[viz])) == sorted(set(seen[j_viz])) == [0, 4, 8]
    _same_gif(tmp_path / "ilqr_admm_tpu_torch.viz.gif", tmp_path / "ilqr_admm_tpu.viz.gif")


def test_viz_imports_no_matplotlib():
    """The card machine has no matplotlib: importing the module must not
    need it."""
    code = ("import sys; sys.modules['matplotlib'] = None; "
            "import ilqr_admm_tpu_torch.viz as v; print(v.plt is None)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(Path(__file__).resolve().parents[1]))
    assert out.returncode == 0 and out.stdout.strip() == "True", out.stderr


@pytest.fixture(scope="module")
def libs():
    return native.load(), j_native.load()


def test_native_kinematics_match_jax_native(libs):
    qs = np.random.default_rng(0).normal(size=(32, 3))
    arm = PlanarArm(LENGTHS)
    for fn, name in ((native.planar_fk, "planar_fk"), (native.planar_jacobian, "planar_jacobian")):
        want = getattr(j_native, name)(list(LENGTHS), qs)
        np.testing.assert_array_equal(fn(LENGTHS, qs), want)
        np.testing.assert_array_equal(fn(LENGTHS, torch.tensor(qs[0])), want[0])
    np.testing.assert_allclose(native.planar_fk(LENGTHS, qs),
                               arm.fk(torch.tensor(qs)).numpy(), atol=1e-12)
    np.testing.assert_allclose(native.planar_jacobian(LENGTHS, qs),
                               arm.jacobian(torch.tensor(qs)).numpy(), atol=1e-12)


def test_native_riccati_matches_jax_native(libs):
    rng = np.random.default_rng(0)
    N, d, m = 25, 3, 2
    A = rng.normal(size=(N, d, d)) * 0.3 + np.eye(d)
    B = rng.normal(size=(N, d, m)) * 0.4
    Qh = rng.normal(size=(N, d, d)) * 0.3
    Q = Qh @ Qh.transpose(0, 2, 1) + 0.1 * np.eye(d)
    xd = rng.normal(size=(N, d))
    Rh = rng.normal(size=(N, m, m)) * 0.3
    R = Rh @ Rh.transpose(0, 2, 1) + 0.5 * np.eye(m)
    K, k = native.lqt_backward_ref(A, B, Q, xd, R)
    K_j, k_j = j_native.lqt_backward_ref(A, B, Q, xd, R)
    np.testing.assert_array_equal(K, K_j)
    np.testing.assert_array_equal(k, k_j)
    with pytest.raises(ValueError, match="xd has shape"):
        native.lqt_backward_ref(A, B, Q, xd[:, :2], R)
