"""Host-side visualization (counterpart of `ilqr_admm_tpu/viz.py`), with
matplotlib.

The reference's plotting helpers (`isls/plot_utils.py`,
`isls/utils.py:10-65`): the planar-robot renderer, the robot base, the
2-D car with steerable wheels, rounded rectangles, GIF animations and
the convergence plot. Out of the solver's path: matplotlib is imported
by the first function that draws, never when this module is imported,
so the port runs where matplotlib is absent. Arrays come in as numpy
arrays, sequences, or tensors, which are moved to the host.
"""

from __future__ import annotations

import numpy as np


# matplotlib's modules, imported by the first function that draws
plt = mpatches = Line2D = Affine2D = None


def _require_mpl():
    global plt, mpatches, Line2D, Affine2D
    if plt is not None:
        return
    try:
        import matplotlib.patches as patches_
        import matplotlib.pyplot as pyplot_
        from matplotlib.lines import Line2D as line2d_
        from matplotlib.transforms import Affine2D as affine2d_
    except ImportError as exc:
        raise ImportError("matplotlib is required for visualization") from exc
    plt, mpatches, Line2D, Affine2D = pyplot_, patches_, line2d_, affine2d_


def _host(x, dtype=None) -> np.ndarray:
    """x as a numpy array on the host (a tensor is detached and copied)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def plot_robot(xs, color="k", xlim=None, ax=None, ylim=None, robot_base=False, **kwargs):
    """Draw a planar kinematic chain through joint positions xs (n, 2).

    Mirrors the reference `plot_robot` (`utils.py:10-32`).
    """
    _require_mpl()
    xs = _host(xs)
    if ax is None:
        ax = plt.gca()
    line = ax.plot(
        xs[:, 0], xs[:, 1], marker="o", color=color, lw=10, mec="k", mfc="w",
        solid_capstyle="round", **kwargs,
    )
    if robot_base:
        plot_robot_base(xs[0], ax, ec="k", fc="k", sz=0.1, alpha=0.8, zorder=1)
    ax.set_aspect("equal")
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    return line


def plot_robot_base(p, ax, ec="k", fc="blue", sz=1.2, alpha=1.0, **kwargs):
    """Draw a robot mounting base at point p (reference `utils.py:34-65`)."""
    _require_mpl()
    p = _host(p)
    nseg = 30
    sz = sz * 1.2
    th = np.linspace(0, np.pi, nseg - 2)
    xs = np.concatenate([[sz * 1.5], sz * 1.5 * np.cos(th), [-sz * 1.5]])
    ys = np.concatenate([[-sz * 1.2], sz * 1.5 * np.sin(th), [-sz * 1.2]])
    poly = np.stack([xs + p[0], ys + p[1]], axis=-1)
    ax.add_patch(mpatches.Polygon(poly, ec=ec, fc=fc, alpha=alpha, lw=3, **kwargs))
    # hatching lines under the base
    n_line, mult = 4, 1.2
    x_top = np.linspace(-sz * mult, sz * mult, n_line) + p[0] + 0.04
    x_bot = np.linspace(-sz * mult, sz * mult, n_line) + p[0] - 0.5 * sz
    for i in range(n_line):
        ax.add_line(
            Line2D(
                [x_top[i], x_bot[i]],
                [p[1] - sz * mult + 0.05, p[1] - sz * mult - sz],
                color=ec, alpha=alpha, lw=2,
            )
        )


def rounded_rectangle(center, width, height, angle=0.0, radius=0.1, **kwargs):
    """A rotated rounded-rectangle patch (reference `plot_utils` helper)."""
    _require_mpl()
    center = _host(center)
    rect = mpatches.FancyBboxPatch(
        (center[0] - width / 2, center[1] - height / 2), width, height,
        boxstyle=mpatches.BoxStyle("Round", pad=0, rounding_size=radius), **kwargs,
    )
    rect.set_transform(
        Affine2D().rotate_deg_around(center[0], center[1], np.degrees(angle))
        + plt.gca().transData
    )
    return rect


def plot_car(x, u, width=0.9, length=2.1, bodycolor=(0.7, 0.7, 0.7), wheelcolor="k",
             ax=None):
    """Car as patches for state x=[px, py, theta, v], control u=[steer, .].

    Reference-fidelity rendering (`plot_utils.py:199-235` semantics):
    rounded-rectangle body, 4 rounded wheels (front pair steered by
    u[0]), white windshield polygon, two yellow headlights at the front
    bumper, and a black origin cross at (px, py). As in the reference,
    `width`/`length` are HALF-dimensions (the body is 2*length long) and
    (px, py) is the REAR AXLE: rear wheels at the origin of the car
    frame, front axle at x = +2.0, forward along +x before rotation.

    Returns a list of patches (add them to an axis; re-create per frame
    for animation). Pass `ax` to bind the patch transforms to a specific
    axis (required when animating on a non-current axis).
    """
    _require_mpl()
    if ax is None:
        ax = plt.gca()
    x = _host(x)
    px, py, th = float(x[0]), float(x[1]), float(x[2])
    u = _host(u)
    steer = float(u[0]) if u.size else 0.0

    pose = Affine2D().rotate(th).translate(px, py) + ax.transData

    def rbox(cx, cy, half_l, half_w, radius, angle=0.0, **kw):
        """Rounded box centered at (cx, cy) in the car frame."""
        p = mpatches.FancyBboxPatch(
            (-half_l + radius, -half_w + radius),
            2 * (half_l - radius), 2 * (half_w - radius),
            boxstyle=mpatches.BoxStyle("Round", pad=radius), **kw,
        )
        p.set_transform(Affine2D().rotate(angle).translate(cx, cy) + pose)
        return p

    patches = []
    # 4 wheels: 0.8 x 0.3, rounding 0.06; rear axle at x=0, front at 2.0,
    # lateral offset ±1.1*width (reference wheel = [.15 .4 .06 1.1w -1.1 .9])
    for wx, ang in ((0.0, 0.0), (2.0, steer)):
        for wy in (-1.1 * width, 1.1 * width):
            patches.append(
                rbox(wx, wy, 0.4, 0.15, 0.06, angle=ang, fc=wheelcolor, ec="k")
            )
    # body: center one wheelbase-half ahead of the rear axle, rounding 0.3
    patches.append(
        rbox(1.1, 0.0, length, width, 0.3, fc=bodycolor, ec="k", lw=1.5)
    )
    # windshield (reference hard-coded polygon, rotated to the +x frame)
    win = mpatches.Polygon(
        np.array([[2.0, 0.8], [2.0, -0.8], [1.4, -0.7], [1.4, 0.7]]),
        color="w",
    )
    win.set_transform(pose)
    patches.append(win)
    # headlights: 0.5 x 0.2 rounded, flush with the front bumper, yellow
    for hy in (-width / 2, width / 2):
        patches.append(
            rbox(1.1 + length - 0.1, hy, 0.1, 0.25, 0.1,
                 fc=(1.0, 1.0, 0.0), ec="none")
        )
    # origin cross at the rear axle (reference "make origin")
    ol, ow = 0.1, 0.01
    for pts in (
        np.array([[-ol, ow], [ol, ow], [ol, -ow], [-ol, -ow]]),
        np.array([[ow, -ol], [ow, ol], [-ow, ol], [-ow, -ol]]),
    ):
        cross = mpatches.Polygon(pts, color="k")
        cross.set_transform(pose)
        patches.append(cross)
    return patches


def plotArm(ax, lengths, q, base=(0.0, 0.0), color="b", **kwargs):
    """Draw an n-link arm from joint angles (reference `plot_utils.py:143-154`)."""
    _require_mpl()
    lengths = _host(lengths)
    c = np.cumsum(_host(q))
    pts = [_host(base, dtype=float)]
    for li, ci in zip(lengths, c):
        pts.append(pts[-1] + li * np.array([np.cos(ci), np.sin(ci)]))
    pts = np.stack(pts)
    return plot_robot(pts, color=color, ax=ax, **kwargs)


def twist(obj, x, y, theta=0.0):
    """Apply a rigid-body transform to a patch (reference `plot_utils.py:189`)."""
    _require_mpl()
    obj.set_transform(
        Affine2D().rotate(theta).translate(x, y) + plt.gca().transData
    )
    return obj


def plot_planar_axis(ax, p):
    """Draw a small planar coordinate frame at pose p = [x, y, theta]."""
    _require_mpl()
    x, y, th = (float(v) for v in _host(p)[:3])
    L = 0.3
    ax.annotate("", xy=(x + L * np.cos(th), y + L * np.sin(th)), xytext=(x, y),
                arrowprops=dict(arrowstyle="->", color="r"))
    ax.annotate("", xy=(x - L * np.sin(th), y + L * np.cos(th)), xytext=(x, y),
                arrowprops=dict(arrowstyle="->", color="g"))


def plotArmLink(ax, angle, length, start, sz=0.1, facecol="gray", edgecol="k",
                alpha=1.0, zorder=1):
    """Rounded-capsule rendering of one arm link (reference `plot_utils.py:82`)."""
    _require_mpl()
    start = _host(start, dtype=float)
    end = start + length * np.array([np.cos(angle), np.sin(angle)])
    body = mpatches.FancyBboxPatch(
        (0, -sz / 2), length, sz,
        boxstyle=mpatches.BoxStyle("Round", pad=0, rounding_size=sz / 2),
        fc=facecol, ec=edgecol, alpha=alpha, zorder=zorder,
    )
    body.set_transform(Affine2D().rotate(angle).translate(*start) + ax.transData)
    ax.add_patch(body)
    return end


def plotArmBasis(ax, p, sz=0.1, facecol="gray", edgecol="k", alpha=1.0, zorder=1):
    """Arm mounting basis (reference `plot_utils.py:124`)."""
    plot_robot_base(_host(p, dtype=float), ax, ec=edgecol, fc=facecol,
                    sz=sz, alpha=alpha, zorder=zorder)


def animate_trajectory(draw_frame, n_frames, path, fps=25, figsize=(6, 6),
                       dpi=80, stride=1):
    """Render an animation to a GIF (or any Pillow-writable) file.

    Equivalent of the reference's notebook animations (DDP-replicate
    notebook cell 22, helpers `plot_utils.py:199-235`), with
    `matplotlib.animation.FuncAnimation` + the Pillow writer standing in
    for the reference's imagemagick/ffmpeg backend (not in this image).

    draw_frame(ax, t): redraw frame t on a cleared axis.
    stride: render every stride-th frame (long horizons -> small GIFs).
    Returns the written path.
    """
    _require_mpl()
    from matplotlib.animation import FuncAnimation, PillowWriter

    frames = list(range(0, n_frames, stride))
    fig, ax = plt.subplots(figsize=figsize)

    def update(t):
        ax.clear()
        draw_frame(ax, t)

    anim = FuncAnimation(fig, update, frames=frames)
    anim.save(path, writer=PillowWriter(fps=fps), dpi=dpi)
    plt.close(fig)
    return path


def animate_car(xs, us, path, xlim=(-4, 4), ylim=(-4, 4), fps=25, stride=1,
                trail=True, **car_kwargs):
    """Animate a car trajectory to a GIF.

    xs: (N, >=3) states [px, py, theta, ...]; us: (N, >=1) controls
    [steer, ...] (front wheels turn with the steering command, as in the
    reference's control-limited DDP car animation).
    """
    _require_mpl()
    xs = _host(xs)
    us = _host(us)

    def draw(ax, t):
        if trail:
            ax.plot(xs[: t + 1, 0], xs[: t + 1, 1], "-", color="tab:blue",
                    lw=1.5, alpha=0.7)
        for p in plot_car(xs[t], us[min(t, len(us) - 1)], ax=ax, **car_kwargs):
            ax.add_patch(p)
        ax.set_xlim(*xlim)
        ax.set_ylim(*ylim)
        ax.set_aspect("equal")
        ax.set_title(f"t = {t}")

    return animate_trajectory(draw, len(xs), path, fps=fps, stride=stride)


def animate_arm(qs, lengths, path, xlim=(-3.2, 3.2), ylim=(-3.2, 3.2),
                fps=25, stride=1, target=None, **arm_kwargs):
    """Animate a planar-arm joint trajectory to a GIF.

    qs: (N, n_joints) joint angles; lengths: link lengths; target:
    optional (2,) end-effector goal to mark.
    """
    _require_mpl()
    qs = _host(qs)

    def draw(ax, t):
        plotArm(ax, lengths, qs[t], **arm_kwargs)
        if target is not None:
            ax.plot([target[0]], [target[1]], "*", color="tab:red", ms=14)
        ax.set_xlim(*xlim)
        ax.set_ylim(*ylim)
        ax.set_aspect("equal")
        ax.set_title(f"t = {t}")

    return animate_trajectory(draw, len(qs), path, fps=fps, stride=stride)


def plot_convergence(cost_log, ax=None, **kwargs):
    """Cost-vs-iteration convergence plot (every reference notebook)."""
    _require_mpl()
    if ax is None:
        ax = plt.gca()
    ax.plot(_host(cost_log), marker=".", **kwargs)
    ax.set_xlabel("# of iterations")
    ax.set_ylabel("Cost")
    ax.set_title("Convergence")
    return ax
