"""iLQR with DP (Riccati), batch (lifted least squares) or SLS inner
solves (counterpart of `ilqr_admm_tpu/solvers/ilqr.py`).

The whole line-search grid is rolled out at once through
`torch.func.vmap` and the candidate is picked by an on-device argmin. The
outer loop is a Python loop that stops on the same statuses as the JAX
package's `lax.while_loop`, with one device-to-host read of the status an
iteration (`fleet.run_single`). `ilqr_fleet_solve` runs a fleet of
instances through the same iteration, vmapped (`fleet.run_fleet`), in
each of the three methods.

User functions are single-instance: f(x, u) -> x_next;
cost_fn(xs, us) -> scalar; get_AB(xs, us) -> (A (N,d,d), B (N,d,m));
get_Cs(xs, us) -> (cts (N,d+m), Cts (N,d+m,d+m)).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch.func import vmap

from ilqr_admm_tpu_torch.ops.lifted import build_Su, build_Sw
from ilqr_admm_tpu_torch.ops.parallel_riccati import ilqr_backward_parallel
from ilqr_admm_tpu_torch.ops.riccati import ilqr_backward
from ilqr_admm_tpu_torch.ops.rollout import (
    rollout_closed_loop,
    rollout_nonlinear,
    rollout_sls_delta,
)
from ilqr_admm_tpu_torch.ops.sls_synthesis import sls_synthesize
from ilqr_admm_tpu_torch.ops.sqrt_riccati import ilqr_backward_sqrt
from ilqr_admm_tpu_torch.problem import ILQRConfig, SolveStatus, line_search_alphas
from ilqr_admm_tpu_torch.solvers.fleet import bind, run_fleet, run_single
from ilqr_admm_tpu_torch.solvers.lqt import block_diag_stacked
from ilqr_admm_tpu_torch.utils.device import resolve_device
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul

# NaN line-search candidates must never win: their cost becomes +inf (the
# reference's 1e5 clamp lets a NaN candidate win once true costs exceed it)
_NAN_COST = math.inf

RICCATI_MODES = ("chol", "sqrt", "parallel", "parallel_fast")


class ILQRState(NamedTuple):
    x_nom: torch.Tensor  # (N, d)
    u_nom: torch.Tensor  # (N, m)
    cost: torch.Tensor  # scalar
    prev_cost: torch.Tensor
    iteration: int  # a fleet's: (F,) int64
    status: int  # SolveStatus; a fleet's: (F,) int64


def ilqr_init(f: Callable, cost_fn: Callable, x0, u0, *, device=None) -> ILQRState:
    """Roll out an initial guess and evaluate its cost. device: where the
    solve runs (default the CUDA card)."""
    device = resolve_device(device)
    x0, u0 = torch.as_tensor(x0, device=device), torch.as_tensor(u0, device=device)
    xs = rollout_nonlinear(f, x0, u0)
    c = cost_fn(xs, u0)
    return ILQRState(x_nom=xs, u_nom=u0, cost=c, prev_cost=torch.full_like(c, math.inf),
                     iteration=0, status=int(SolveStatus.RUNNING))


def nan_to_inf(costs: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(costs), torch.full_like(costs, _NAN_COST), costs)


def take(xs: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """xs[ind] for a 0-dim index tensor, without reading it on the host."""
    return torch.index_select(xs, 0, ind.reshape(1))[0]


def _select_candidate(cost_fn, xs_cand, us_cand, state: ILQRState):
    """Evaluate all line-search candidates, pick the best, accept if better."""
    costs = nan_to_inf(vmap(cost_fn)(xs_cand, us_cand))
    ind = torch.argmin(costs)
    best = take(costs, ind)
    accept = best < state.cost
    return ILQRState(
        x_nom=torch.where(accept, take(xs_cand, ind), state.x_nom),
        u_nom=torch.where(accept, take(us_cand, ind), state.u_nom),
        cost=torch.where(accept, best, state.cost),
        prev_cost=state.cost,
        iteration=state.iteration + 1,
        status=state.status,
    ), accept


@full_f32_matmul()
def ilqr_iterate_dp(f, get_AB, get_Cs, cost_fn, state: ILQRState, alphas, riccati: str = "chol"):
    """One DP iLQR iteration: Riccati backward pass and a vmapped
    closed-loop line search. riccati: 'chol' (sequential), 'sqrt' (array
    form), 'parallel' (flat associative scan) or 'parallel_fast' (blocked
    scan of 128 with the closed-form combine inverses when d <= 4).
    Returns (new_state, accept, (K, k))."""
    A, B = get_AB(state.x_nom, state.u_nom)
    cts, Cts = get_Cs(state.x_nom, state.u_nom)
    if riccati == "sqrt":
        K, k = ilqr_backward_sqrt(A, B, Cts, cts)
    elif riccati == "parallel_fast":
        K, k = ilqr_backward_parallel(A, B, Cts, cts, block_size=128,
                                      fast_inverse=A.shape[-1] <= 4)
    elif riccati == "parallel":
        K, k = ilqr_backward_parallel(A, B, Cts, cts)
    else:
        K, k = ilqr_backward(A, B, Cts, cts)

    def rollout_alpha(alpha):
        return rollout_closed_loop(f, state.x_nom[0], K, alpha * k, state.x_nom, state.u_nom)

    xs_cand, us_cand = vmap(rollout_alpha)(alphas)
    new_state, accept = _select_candidate(cost_fn, xs_cand, us_cand, state)
    return new_state, accept, (K, k)


def _lifted_model(A, B, cts, Cts, d):
    """Su, l_side = Su^T (Cxx/2) Su + Cuu/2, r_side = -Su^T cx/2 - cu/2 and
    Su^T (Cxx/2) of the lifted batch problem."""
    Su = build_Su(A, B)
    SuTQ = Su.T @ (0.5 * block_diag_stacked(Cts[:, :d, :d]))
    l_side = SuTQ @ Su + 0.5 * block_diag_stacked(Cts[:, d:, d:])
    r_side = Su.T @ (-0.5 * cts[:, :d].reshape(-1)) - 0.5 * cts[:, d:].reshape(-1)
    return Su, SuTQ, l_side, r_side


@full_f32_matmul()
def ilqr_iterate_batch(f, get_AB, get_Cs, cost_fn, state: ILQRState, alphas):
    """One batch iLQR iteration: lifted least squares and an open-loop line
    search. Returns (new_state, accept, delta_u)."""
    N, d = state.x_nom.shape
    m = state.u_nom.shape[-1]
    A, B = get_AB(state.x_nom, state.u_nom)
    cts, Cts = get_Cs(state.x_nom, state.u_nom)
    _, _, l_side, r_side = _lifted_model(A, B, cts, Cts, d)
    delta_u = torch.linalg.solve(l_side, r_side).reshape(N, m)

    def rollout_alpha(alpha):
        us = state.u_nom + alpha * delta_u
        return rollout_nonlinear(f, state.x_nom[0], us), us

    xs_cand, us_cand = vmap(rollout_alpha)(alphas)
    new_state, accept = _select_candidate(cost_fn, xs_cand, us_cand, state)
    return new_state, accept, delta_u


@full_f32_matmul()
def ilqr_iterate_sls(f, get_AB, get_Cs, cost_fn, state: ILQRState, alphas):
    """One SLS iLQR iteration: response-map synthesis on the linearized
    problem, the lifted history-feedback gains K = Phi_u Phi_x^{-1},
    k = (I - K Su) du (delta coordinates around the nominal), and a line
    search over the feedforward with full history feedback.
    Returns (new_state, accept, (K_lifted (Nm, Nd), k_lifted (Nm,)))."""
    N, d = state.x_nom.shape
    m = state.u_nom.shape[-1]
    A, B = get_AB(state.x_nom, state.u_nom)
    cts, Cts = get_Cs(state.x_nom, state.u_nom)
    Su, SuTQ, l_side, r_ff = _lifted_model(A, B, cts, Cts, d)
    Sw = build_Sw(A)
    PHI_U, du = sls_synthesize(l_side, r_ff, -SuTQ @ Sw, m, d)

    PHI_X = Sw + Su @ PHI_U
    K = torch.linalg.solve(PHI_X.T, PHI_U.T).T
    k = (torch.eye(N * m, dtype=du.dtype, device=du.device) - K @ Su) @ du

    def rollout_alpha(alpha):
        return rollout_sls_delta(f, state.x_nom[0], K, alpha * k, state.x_nom, state.u_nom)

    xs_cand, us_cand = vmap(rollout_alpha)(alphas)
    new_state, accept = _select_candidate(cost_fn, xs_cand, us_cand, state)
    return new_state, accept, (K, k)


def _iterate_fn(method: str, riccati: str):
    if riccati not in RICCATI_MODES:
        raise ValueError(
            "riccati must be 'chol', 'sqrt', 'parallel' or "
            f"'parallel_fast', got {riccati!r}"
        )
    if method == "dp":
        def iterate(*args):
            return ilqr_iterate_dp(*args, riccati=riccati)
        return iterate
    if method == "sls":
        return ilqr_iterate_sls
    if method == "batch":
        return ilqr_iterate_batch
    raise ValueError(f"method must be 'dp', 'sls' or 'batch', got {method!r}")


def _ilqr_body(f, get_AB, get_Cs, cost_fn, cfg: ILQRConfig, alphas, iterate):
    """One iteration as a function of the carry (x_nom, u_nom, cost,
    prev_cost) and optional trailing arguments for get_Cs and cost_fn:
    -> (new carry, status). Shared by the single and the fleet loop."""
    def body(x_nom, u_nom, cost, prev_cost, *extra):
        st = ILQRState(x_nom, u_nom, cost, prev_cost, 0, int(SolveStatus.RUNNING))
        new, accept, _ = iterate(f, get_AB, bind(get_Cs, extra), bind(cost_fn, extra), st, alphas)
        status = ilqr_status(accept, new.cost, new.prev_cost, cfg.tol_fun)
        return (new.x_nom, new.u_nom, new.cost, new.prev_cost), status

    return body


def ilqr_solve(
    f: Callable,
    get_AB: Callable,
    get_Cs: Callable,
    cost_fn: Callable,
    state0: ILQRState,
    cfg: ILQRConfig = ILQRConfig(),
    method: str = "dp",
    riccati: str = "chol",
) -> ILQRState:
    """Full iLQR solve on the device of state0 (see `ilqr_init`).

    Stops on cost change < tol_fun (CONVERGED), a line search that finds
    no better candidate (LINE_SEARCH_FAILED) or the iteration cap
    (MAX_ITER).
    """
    iterate = _iterate_fn(method, riccati)
    alphas = line_search_alphas(cfg, state0.x_nom.dtype, state0.x_nom.device)
    body = _ilqr_body(f, get_AB, get_Cs, cost_fn, cfg, alphas, iterate)
    carry = (state0.x_nom, state0.u_nom, state0.cost, state0.prev_cost)
    (xs, us, c, pc), iteration, status = run_single(body, carry, state0.iteration,
                                                    state0.status, cfg.max_iter)
    return ILQRState(x_nom=xs, u_nom=us, cost=c, prev_cost=pc, iteration=iteration,
                     status=status)


def ilqr_status(accept, cost, prev_cost, tol_fun):
    """An iteration's status on the device: LINE_SEARCH_FAILED on a
    rejected step, CONVERGED when the cost moved by less than tol_fun,
    else RUNNING (elementwise over a fleet)."""
    dcost = torch.abs(cost - prev_cost)
    return torch.where(~accept, int(SolveStatus.LINE_SEARCH_FAILED),
                       torch.where(dcost < tol_fun, int(SolveStatus.CONVERGED),
                                   int(SolveStatus.RUNNING)))


def ilqr_fleet_init(f: Callable, cost_fn: Callable, x0s, u0s, *, device=None) -> ILQRState:
    """`ilqr_init` of each instance: x0s (F, d), u0s (F, N, m). The fleet
    state has a leading F axis on every field, iteration and status
    included ((F,) int64). device: default the CUDA card."""
    device = resolve_device(device)
    x0s, u0s = torch.as_tensor(x0s, device=device), torch.as_tensor(u0s, device=device)
    xs = vmap(rollout_nonlinear, in_dims=(None, 0, 0))(f, x0s, u0s)
    c = vmap(cost_fn)(xs, u0s)
    return fleet_state(xs, u0s, c)


def fleet_state(xs, us, cost) -> ILQRState:
    """A fresh fleet state: iteration 0, RUNNING, prev_cost +inf."""
    F = cost.shape[0]
    return ILQRState(x_nom=xs, u_nom=us, cost=cost, prev_cost=torch.full_like(cost, math.inf),
                     iteration=torch.zeros((F,), dtype=torch.int64, device=cost.device),
                     status=torch.full((F,), int(SolveStatus.RUNNING), dtype=torch.int64,
                                       device=cost.device))


def ilqr_fleet_solve(
    f: Callable,
    get_AB: Callable,
    get_Cs: Callable,
    cost_fn: Callable,
    state0: ILQRState,
    cfg: ILQRConfig = ILQRConfig(),
    method: str = "dp",
    riccati: str = "chol",
    *,
    args: tuple = (),
    stats: dict | None = None,
) -> ILQRState:
    """`ilqr_solve` of each instance of a fleet, the counterpart of
    `jax.vmap(ilqr_solve)`.

    state0: a fleet state (`ilqr_fleet_init`, `fleet_state`). Each
    iteration is the method's iterate function (`ilqr_iterate_dp`,
    `ilqr_iterate_batch` or `ilqr_iterate_sls`) under `torch.func.vmap`; an instance
    that stops keeps its state, status and iteration count, and the loop
    reads one flag an iteration for the whole fleet (`fleet.run_fleet`;
    stats= receives its counts). method and riccati as in `ilqr_solve`. The user functions are
    single-instance and must work under vmap. args: tensors with a
    leading fleet axis; get_Cs and cost_fn receive the instance's rows as
    trailing arguments (per-instance multipliers, for example).
    The lifted 'batch' and 'sls' steps run as a fleet too: their block
    diagonals (`lqt.block_diag_stacked`) take no indexed write, so the
    same iterate functions run under vmap.
    """
    alphas = line_search_alphas(cfg, state0.x_nom.dtype, state0.x_nom.device)
    body = vmap(_ilqr_body(f, get_AB, get_Cs, cost_fn, cfg, alphas, _iterate_fn(method, riccati)))

    def step(*carry):
        return body(*carry, *args)

    carry = (state0.x_nom, state0.u_nom, state0.cost, state0.prev_cost)
    (xs, us, c, pc), status, iters = run_fleet(step, carry, state0.status, state0.iteration,
                                               cfg.max_iter, stats=stats)
    return ILQRState(x_nom=xs, u_nom=us, cost=c, prev_cost=pc, iteration=iters, status=status)
