"""Differentiable ADMM: implicit-function-theorem gradients through the
fixed point (counterpart of `ilqr_admm_tpu/solvers/implicit.py`).

The constrained solution u*(theta) of an ADMM solve is a fixed point
w* = T(w*, theta) of the ADMM iteration map T (x-update, projections,
dual update). Instead of backpropagating through every unrolled
iteration, `fixed_point` applies the IFT,

    dw*/dtheta = (I - dT/dw)^-1 dT/dtheta  at  w = w*,

and evaluates the vector-Jacobian product by the Neumann series
v <- w_bar + (dT/dw)^T v (convergent where T is a contraction near the
fixed point, as for convex problems). Projections contribute their
generalized Jacobians (0/1 masks for boxes, etc.) through autograd.

This gives gradients of cost weights, targets, initial states and
constraint parameters through the constrained solution: inverse optimal
control, differentiable safety layers.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import vjp
from torch.utils import _pytree as pytree

from ilqr_admm_tpu_torch.ops.lifted import build_Su, sw_x0
from ilqr_admm_tpu_torch.solvers.admm import validate_constraint_blocks
from ilqr_admm_tpu_torch.solvers.lqt import block_diag_stacked, broadcast_rho
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


def _delta(a, b) -> torch.Tensor:
    """||a - b|| over the tuples' leaves, cast to float32 (the stop test
    of both loops compares it in float32, as the JAX package does)."""
    return torch.sqrt(sum(torch.sum((x - y) ** 2) for x, y in zip(a, b))).float()


def _iterate(update, v0, n_max: int, tol: float):
    """v <- update(v) while fewer than n_max steps ran and the last step
    moved v by at least tol: one host read of the flag a step."""
    v, tol32 = v0, None
    for _ in range(n_max):
        v_new = update(v)
        moved = _delta(v_new, v)
        v = v_new
        if tol32 is None:  # tol rounded to float32, as JAX compares it
            tol32 = torch.tensor(tol, dtype=torch.float32, device=moved.device)
        if not bool(moved >= tol32):
            break
    return v


class _FixedPoint(torch.autograd.Function):
    """Inputs: (step, theta's tree spec, theta's constant leaves, where its
    tensor leaves go, len(w0), max_iter, bwd_iters, tol, *w0, *tensor leaves)."""

    @staticmethod
    def forward(ctx, step, spec, consts, slots, n_w, max_iter, bwd_iters, tol, *args):
        w0, leaves = args[:n_w], args[n_w:]

        def theta_of(tensors):
            full = list(consts)
            for i, t in zip(slots, tensors):
                full[i] = t
            return pytree.tree_unflatten(full, spec)

        w_star = _iterate(lambda w: tuple(step(w, theta_of(leaves))), tuple(w0), max_iter, tol)
        # an output may not be one of the inputs (max_iter = 0, or a step
        # that returns an argument unchanged)
        w_star = tuple(w.clone() if any(w is a for a in args) else w for w in w_star)
        ctx.theta_of, ctx.step = theta_of, step
        ctx.bwd_iters, ctx.tol, ctx.n_w = bwd_iters, tol, n_w
        ctx.save_for_backward(*w_star, *leaves)
        return w_star

    @staticmethod
    def backward(ctx, *w_bar):
        saved = ctx.saved_tensors
        w_star, leaves = saved[:ctx.n_w], saved[ctx.n_w:]
        step, theta_of = ctx.step, ctx.theta_of
        _, vjp_w = vjp(lambda *w: tuple(step(w, theta_of(leaves))), *w_star)

        def neumann(v):
            return tuple(a + b for a, b in zip(w_bar, vjp_w(v)))

        v = _iterate(neumann, tuple(w_bar), ctx.bwd_iters, ctx.tol)
        _, vjp_theta = vjp(lambda *ls: tuple(step(w_star, theta_of(ls))), *leaves)
        theta_bar = vjp_theta(v)
        w0_bar = tuple(torch.zeros_like(w) for w in w_star)
        return (None,) * 8 + w0_bar + tuple(theta_bar)


def fixed_point(step: Callable, theta, w0, max_iter: int = 100, bwd_iters: int = 50,
                tol: float = 0.0):
    """Differentiable fixed point w* of w = step(w, theta).

    step(w, theta) -> w' maps a tuple of tensors to a tuple of the same
    shapes (one ADMM iteration, a contraction near the solution); theta
    is the differentiable parameter tree (a dict of tensors; leaves that
    are not tensors are constants); w0 the warm start (a tuple of
    tensors, not differentiated: its gradient is zero). The forward pass
    iterates without autograd until the change of an iterate drops below
    tol (or max_iter); the backward pass runs the transposed Neumann
    iteration at w* with the same stopping rule (bwd_iters cap), then
    one vector-Jacobian product into theta. Each loop reads one flag on
    the host an iteration.

    The IFT gradient is the derivative of the exact fixed point, so an
    unconverged forward solve yields gradients that disagree with finite
    differences of the truncated computation: prefer tol-based stopping
    with a generous max_iter.
    """
    flat, spec = pytree.tree_flatten(theta)
    slots = [i for i, leaf in enumerate(flat) if isinstance(leaf, torch.Tensor)]
    consts = [None if i in slots else leaf for i, leaf in enumerate(flat)]
    w0 = tuple(w0)
    return _FixedPoint.apply(step, spec, consts, slots, len(w0), max_iter, bwd_iters, tol,
                             *w0, *(flat[i] for i in slots))


@full_f32_matmul()
def lqt_admm_implicit(
    A,
    B,
    theta: dict,
    project_x: Optional[Callable] = None,
    project_u: Optional[Callable] = None,
    rho_x=None,
    rho_u=None,
    n_iters: int = 1000,
    bwd_iters: int = 300,
    tol: float = 1e-8,
    alpha: float = 1.0,
):
    """Differentiable constrained LQT-ADMM (batch x-update).

    theta is a dict of differentiable parameters: Q (N,d,d), R (N,m,m),
    xd (N,d), x0 (d,), and optionally px / pu, parameters forwarded to
    the projections. project_x(v, px) / project_u(v, pu) take the
    parameter slot (None when theta has no such key). A, B and the rho
    penalties are not differentiated (static problem structure). Runs on
    the device of A.

    Returns (xs (N,d), us (N,m)), differentiable with respect to every
    tensor of theta through the IFT fixed-point VJP, e.g.
    `torch.autograd.grad(loss(*lqt_admm_implicit(A, B, theta, ...)), target)`.
    """
    validate_constraint_blocks(project_x, rho_x, project_u, rho_u)
    N, d = A.shape[0], A.shape[-1]
    m = B.shape[-1]
    dtype, device = A.dtype, A.device

    Su = build_Su(A, B)
    Qr = broadcast_rho(rho_x, d, N, dtype, device)
    Rr = broadcast_rho(rho_u, m, N, dtype, device)
    has_x = project_x is not None
    has_u = project_u is not None
    if not (has_x or has_u):
        raise ValueError("at least one of project_x / project_u is required")
    Qr_l = block_diag_stacked(Qr) if (Qr is not None and has_x) else None
    Rr_l = block_diag_stacked(Rr) if (Rr is not None and has_u) else None

    def prepare(th):
        """The pieces of the x-update that depend on theta alone: the
        Cholesky factor of the normal matrix, the free response and the
        tracking term. They are made once (with autograd) and are the
        fixed point's parameters, so each ADMM iteration is a few products
        and one triangular solve; the IFT gradient reaches theta through
        them by the chain rule."""
        SuTQ = Su.T @ block_diag_stacked(th["Q"])
        free = sw_x0(A, th["x0"]).reshape(-1)
        l_side = SuTQ @ Su + block_diag_stacked(th["R"])
        if Qr_l is not None:
            l_side = l_side + Su.T @ (Qr_l @ Su)
        if Rr_l is not None:
            l_side = l_side + Rr_l
        prep = dict(L=torch.linalg.cholesky(l_side), free=free,
                    r_track=SuTQ @ (th["xd"].reshape(-1) - free))
        for key in ("px", "pu"):
            if key in th:
                prep[key] = th[key]
        return prep

    def x_update(pr, reg_x, reg_u):
        r_side = pr["r_track"]
        if Qr_l is not None:
            r_side = r_side + Su.T @ (Qr_l @ (reg_x - pr["free"]))
        if Rr_l is not None:
            r_side = r_side + Rr_l @ reg_u
        u_hat = torch.cholesky_solve(r_side[:, None], pr["L"])[:, 0]
        return pr["free"] + Su @ u_hat, u_hat

    def step(w, pr):
        z_x, z_u, l_x, l_u = w
        x_x, x_u = x_update(pr, z_x - l_x, z_u - l_u)
        if has_x:
            zr = alpha * x_x + (1.0 - alpha) * z_x
            z_x = project_x(zr + l_x, pr.get("px"))
            l_x = l_x + x_x - z_x
        if has_u:
            zr = alpha * x_u + (1.0 - alpha) * z_u
            z_u = project_u(zr + l_u, pr.get("pu"))
            l_u = l_u + x_u - z_u
        return (z_x, z_u, l_x, l_u)

    w0 = tuple(torch.zeros((n,), dtype=dtype, device=device) for n in (N * d, N * m, N * d, N * m))
    prep = prepare(theta)
    z_x, z_u, l_x, l_u = fixed_point(step, prep, w0, n_iters, bwd_iters, tol)
    # the final x-update at the fixed point (the differentiable path to the
    # solution; the consensus variables are the constrained iterates)
    x_x, x_u = x_update(prep, z_x - l_x, z_u - l_u)
    return x_x.reshape(N, d), x_u.reshape(N, m)
