"""boxDDP: control-limited DDP with the box-QP backward pass (counterpart
of `ilqr_admm_tpu/solvers/boxddp.py`).

The bounds live inside the Riccati recursion (`ops/constrained_riccati.py`),
iterates are feasible at every step (clipped rollouts) and there are no
penalty parameters. The JAX package runs the solve as one
`lax.while_loop`; here it is a Python loop over iterations that stops on
the same statuses, with one host read of its status an iteration
(`solvers/fleet.py::run_single`). `boxddp_iterate` itself reads nothing.
`boxddp_fleet_solve` runs a fleet of instances through the same
iteration, vmapped (`run_fleet`).
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
from ilqr_admm_tpu_torch.solvers.fleet import run_fleet, run_single
from ilqr_admm_tpu_torch.solvers.ilqr import (
    ILQRState,
    _select_candidate,
    ilqr_fleet_init,
    ilqr_status,
)
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
                 riccati: str = "seq", mask_iters: int = 1, *, graph: bool = False) -> ILQRState:
    """Full boxDDP solve on the device of state0 (`boxddp_init`'s).

    Every accepted iterate satisfies the bounds exactly (clipped
    rollouts). A failed line search raises a Levenberg-Marquardt
    regularization on Quu (times reg_factor from max(reg, reg_min), and
    down by reg_down on acceptance) and retries; LINE_SEARCH_FAILED only
    once it exceeds reg_max. Retries count toward cfg.max_iter. CONVERGED
    on an accepted cost change below cfg.tol_fun.

    riccati='parallel': the time-parallel backward, with the active set
    carried across iterations from an all-free start (mask_iters
    exchange passes each). graph=True (CUDA) replays one iteration as a
    CUDA graph (`fleet.run_single`).
    """
    body, carry = _boxddp_body(f, get_AB, get_Cs, cost_fn, state0, u_lower, u_upper, cfg, reg,
                               qp_iters, qp_method, reg_min, reg_max, reg_factor, reg_down,
                               riccati, mask_iters)
    (xs, us, c, pc, *_), iteration, status = run_single(body, carry, state0.iteration,
                                                        state0.status, cfg.max_iter, graph=graph)
    return ILQRState(x_nom=xs, u_nom=us, cost=c, prev_cost=pc, iteration=iteration,
                     status=status)


def _boxddp_body(f, get_AB, get_Cs, cost_fn, state0, u_lower, u_upper, cfg, reg, qp_iters,
                 qp_method, reg_min, reg_max, reg_factor, reg_down, riccati, mask_iters):
    """One boxDDP iteration as a function of the carry (x_nom, u_nom, cost,
    prev_cost, lam, clamp_lo, clamp_hi) -> (new carry, status), and the
    initial carry of state0 (lam 0, the all-free active set; state0 may
    carry a leading fleet axis). Shared by the single and the fleet loop."""
    if riccati not in ("seq", "parallel"):
        raise ValueError(f"riccati must be 'seq' or 'parallel', got {riccati!r}")
    dtype, device = state0.x_nom.dtype, state0.x_nom.device
    alphas = line_search_alphas(cfg, dtype, device)
    schedule = _RegSchedule(reg_min, reg_max, reg_factor, reg_down, cfg.tol_fun)
    u_lower, u_upper = (b if isinstance(b, (int, float)) else
                        torch.as_tensor(b, dtype=dtype, device=device) for b in (u_lower, u_upper))

    def body(x_nom, u_nom, cost, prev_cost, lam, clamp_lo, clamp_hi):
        st = ILQRState(x_nom, u_nom, cost, prev_cost, 0, int(SolveStatus.RUNNING))
        if riccati == "parallel":
            # the active set is carried and warm-started across iterations
            new, accept, _, (clamp_lo, clamp_hi) = boxddp_iterate(
                f, get_AB, get_Cs, cost_fn, st, alphas, u_lower, u_upper, reg=reg + lam,
                riccati="parallel", mask_iters=mask_iters, clamp=(clamp_lo, clamp_hi))
        else:
            new, accept, _ = boxddp_iterate(
                f, get_AB, get_Cs, cost_fn, st, alphas, u_lower, u_upper, reg=reg + lam,
                qp_iters=qp_iters, qp_method=qp_method, riccati=riccati)
        lam, status = schedule(lam, accept, new.cost, new.prev_cost)
        return (new.x_nom, new.u_nom, new.cost, new.prev_cost, lam, clamp_lo, clamp_hi), status

    lead = state0.cost.shape
    no = torch.zeros(state0.u_nom.shape, dtype=torch.bool, device=device)
    carry = (state0.x_nom, state0.u_nom, state0.cost, state0.prev_cost,
             torch.zeros(lead, dtype=dtype, device=device), no, no)
    return body, carry


class _RegSchedule:
    """The Levenberg-Marquardt schedule of boxDDP and an iteration's
    status, on the device (elementwise over a fleet): lam up by reg_factor
    from reg_min on a rejected step, down by reg_down (to 0 from reg_min)
    on an accepted one; a rejected step is LINE_SEARCH_FAILED once lam
    exceeds reg_max, else a retry (RUNNING); an accepted one CONVERGED
    when the cost moved by less than tol_fun."""

    def __init__(self, reg_min, reg_max, reg_factor, reg_down, tol_fun):
        self.reg_min, self.reg_max, self.reg_factor = reg_min, reg_max, reg_factor
        self.reg_down = reg_factor if reg_down is None else reg_down
        self.tol_fun = tol_fun

    def __call__(self, lam, accept, cost, prev_cost):
        lam_up = torch.clamp(lam * self.reg_factor, min=self.reg_min)
        lam_dn = torch.where(lam <= self.reg_min * 1.01, torch.zeros_like(lam), lam / self.reg_down)
        lam = torch.where(accept, lam_dn, lam_up)
        retry = torch.where(lam > self.reg_max, int(SolveStatus.LINE_SEARCH_FAILED),
                            int(SolveStatus.RUNNING))
        return lam, torch.where(accept, ilqr_status(accept, cost, prev_cost, self.tol_fun), retry)


def boxddp_fleet_init(f: Callable, cost_fn: Callable, x0s, u0s, u_lower, u_upper, *,
                      device=None) -> ILQRState:
    """`boxddp_init` of each instance: x0s (F, d), u0s (F, N, m) clipped
    into the box, rolled out and costed; a fleet state (leading F axis on
    every field). device: default the CUDA card."""
    device = resolve_device(device)
    u0s = torch.as_tensor(u0s, device=device)
    lo = torch.as_tensor(u_lower, dtype=u0s.dtype, device=device)
    hi = torch.as_tensor(u_upper, dtype=u0s.dtype, device=device)
    return ilqr_fleet_init(f, cost_fn, x0s, torch.clamp(u0s, lo, hi), device=device)


@full_f32_matmul()
def boxddp_fleet_solve(f, get_AB, get_Cs, cost_fn, state0: ILQRState, u_lower, u_upper,
                       cfg: ILQRConfig = ILQRConfig(), reg: float = 0.0, qp_iters: int = 12,
                       qp_method: str = "auto", reg_min: float = 1e-6, reg_max: float = 1e8,
                       reg_factor: float = 10.0, reg_down: float | None = None,
                       riccati: str = "seq", mask_iters: int = 1, *, stats: dict | None = None,
                       graph: bool = False) -> ILQRState:
    """`boxddp_solve` of each instance of a fleet, the counterpart of
    `jax.vmap(boxddp_solve)`.

    state0: a fleet state (`boxddp_fleet_init`). Each iteration is
    `boxddp_iterate` under `torch.func.vmap`, every instance with its own
    regularization lam and, with riccati='parallel', its own carried
    active set; an instance that stops keeps its state, status, iteration
    count and lam, and the loop reads one flag an iteration for the whole
    fleet (`fleet.run_fleet`, which also takes graph= and stats=). The
    bounds are numbers or (m,) tensors shared by the fleet.
    """
    body, carry = _boxddp_body(f, get_AB, get_Cs, cost_fn, state0, u_lower, u_upper, cfg, reg,
                               qp_iters, qp_method, reg_min, reg_max, reg_factor, reg_down,
                               riccati, mask_iters)
    step = vmap(body)
    (xs, us, c, pc, *_), status, iters = run_fleet(step, carry, state0.status, state0.iteration,
                                                   cfg.max_iter, graph=graph, stats=stats)
    return ILQRState(x_nom=xs, u_nom=us, cost=c, prev_cost=pc, iteration=iters, status=status)
