"""boxDDP: control-limited DDP with the box-QP backward pass (counterpart
of `ilqr_admm_tpu/solvers/boxddp.py`).

The bounds live inside the Riccati recursion (`ops/constrained_riccati.py`),
iterates are feasible at every step (clipped rollouts) and there are no
penalty parameters. The JAX package runs the solve as one
`lax.while_loop`; here it is a Python loop over iterations that stops on
the same statuses, with one host read of its stop flags an iteration
(`admm.read_flags`). `boxddp_iterate` itself reads nothing.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.func import vmap

from ilqr_admm_tpu_torch.ops.constrained_riccati import (
    ilqr_backward_box,
    ilqr_backward_box_parallel,
    rollout_closed_loop_clipped,
)
from ilqr_admm_tpu_torch.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu_torch.problem import ILQRConfig, SolveStatus, line_search_alphas
from ilqr_admm_tpu_torch.solvers.admm import read_flags
from ilqr_admm_tpu_torch.solvers.ilqr import ILQRState, _select_candidate
from ilqr_admm_tpu_torch.utils.device import resolve_device
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


def boxddp_init(f: Callable, cost_fn: Callable, x0, u0, u_lower, u_upper, *,
                device=None) -> ILQRState:
    """Clip the initial controls into the box, roll out, evaluate the cost.
    device: where the solve runs (default the CUDA card)."""
    device = resolve_device(device)
    x0, u0 = torch.as_tensor(x0, device=device), torch.as_tensor(u0, device=device)
    lo = torch.as_tensor(u_lower, dtype=u0.dtype, device=device)
    hi = torch.as_tensor(u_upper, dtype=u0.dtype, device=device)
    u0 = torch.clamp(u0, lo, hi)
    xs = rollout_nonlinear(f, x0, u0)
    c = cost_fn(xs, u0)
    return ILQRState(x_nom=xs, u_nom=u0, cost=c, prev_cost=torch.full_like(c, math.inf),
                     iteration=0, status=int(SolveStatus.RUNNING))


@full_f32_matmul()
def boxddp_iterate(f, get_AB, get_Cs, cost_fn, state: ILQRState, alphas, u_lower, u_upper,
                   reg=0.0, qp_iters: int = 12, qp_method: str = "auto", riccati: str = "seq",
                   mask_iters: int = 3, clamp=None):
    """One boxDDP iteration: box-QP backward pass and clipped line search.

    riccati='parallel' takes the time-parallel active-set backward
    (`ilqr_backward_box_parallel`). Pass clamp=(clamp_lo, clamp_hi) to
    warm-start its active set; the result then gains a fourth element,
    the post-exchange set to carry. Returns (new_state, accept, (K, k)[,
    clamp]).
    """
    if riccati not in ("seq", "parallel"):
        raise ValueError(f"riccati must be 'seq' or 'parallel', got {riccati!r}")
    A, B = get_AB(state.x_nom, state.u_nom)
    cts, Cts = get_Cs(state.x_nom, state.u_nom)
    clamp_new = None
    if riccati == "parallel":
        if clamp is None:
            K, k = ilqr_backward_box_parallel(A, B, Cts, cts, state.u_nom, u_lower, u_upper,
                                              reg=reg, mask_iters=mask_iters)
        else:
            K, k, clamp_new = ilqr_backward_box_parallel(
                A, B, Cts, cts, state.u_nom, u_lower, u_upper, reg=reg, mask_iters=mask_iters,
                clamp0=clamp, return_clamp=True)
    else:
        K, k = ilqr_backward_box(A, B, Cts, cts, state.u_nom, u_lower, u_upper, reg=reg,
                                 qp_iters=qp_iters, qp_method=qp_method)

    def rollout_alpha(alpha):
        return rollout_closed_loop_clipped(f, state.x_nom[0], K, alpha * k, state.x_nom,
                                           state.u_nom, u_lower, u_upper)

    xs_cand, us_cand = vmap(rollout_alpha)(alphas)
    new_state, accept = _select_candidate(cost_fn, xs_cand, us_cand, state)
    if clamp_new is not None:
        return new_state, accept, (K, k), clamp_new
    return new_state, accept, (K, k)


@full_f32_matmul()
def boxddp_solve(f, get_AB, get_Cs, cost_fn, state0: ILQRState, u_lower, u_upper,
                 cfg: ILQRConfig = ILQRConfig(), reg: float = 0.0, qp_iters: int = 12,
                 qp_method: str = "auto", reg_min: float = 1e-6, reg_max: float = 1e8,
                 reg_factor: float = 10.0, reg_down: float | None = None,
                 riccati: str = "seq", mask_iters: int = 1) -> ILQRState:
    """Full boxDDP solve on the device of state0 (`boxddp_init`'s).

    Every accepted iterate satisfies the bounds exactly (clipped
    rollouts). A failed line search raises a Levenberg-Marquardt
    regularization on Quu (times reg_factor from max(reg, reg_min), and
    down by reg_down on acceptance) and retries; LINE_SEARCH_FAILED only
    once it exceeds reg_max. Retries count toward cfg.max_iter. CONVERGED
    on an accepted cost change below cfg.tol_fun.

    riccati='parallel': the time-parallel backward, with the active set
    carried across iterations from an all-free start (mask_iters
    exchange passes each).
    """
    dtype, device = state0.x_nom.dtype, state0.x_nom.device
    alphas = line_search_alphas(cfg, dtype, device)
    reg_down = reg_factor if reg_down is None else reg_down
    N, m = state0.u_nom.shape
    clamp = (torch.zeros((N, m), dtype=torch.bool, device=device),
             torch.zeros((N, m), dtype=torch.bool, device=device))
    lam = torch.zeros((), dtype=dtype, device=device)
    state = state0
    while state.iteration < cfg.max_iter and state.status == SolveStatus.RUNNING:
        if riccati == "parallel":
            new_state, accept, _, clamp = boxddp_iterate(
                f, get_AB, get_Cs, cost_fn, state, alphas, u_lower, u_upper, reg=reg + lam,
                riccati="parallel", mask_iters=mask_iters, clamp=clamp)
        else:
            new_state, accept, _ = boxddp_iterate(
                f, get_AB, get_Cs, cost_fn, state, alphas, u_lower, u_upper, reg=reg + lam,
                qp_iters=qp_iters, qp_method=qp_method, riccati=riccati)
        # the schedule: up on a reject (retry), down on an accept
        lam_up = torch.clamp(lam * reg_factor, min=reg_min)
        lam_dn = torch.where(lam <= reg_min * 1.01, torch.zeros_like(lam), lam / reg_down)
        lam = torch.where(accept, lam_dn, lam_up)
        dcost = torch.abs(new_state.cost - new_state.prev_cost)
        accepted, exhausted, converged = read_flags(accept, lam > reg_max, dcost < cfg.tol_fun)
        if not accepted:
            status = SolveStatus.LINE_SEARCH_FAILED if exhausted else SolveStatus.RUNNING
        else:
            status = SolveStatus.CONVERGED if converged else SolveStatus.RUNNING
        state = new_state._replace(status=int(status))
    if state.status == SolveStatus.RUNNING:
        state = state._replace(status=int(SolveStatus.MAX_ITER))
    return state
