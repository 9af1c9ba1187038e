"""iLQR with DP (Riccati), batch (lifted least squares) or SLS inner
solves (counterpart of `ilqr_admm_tpu/solvers/ilqr.py`).

The whole line-search grid is rolled out at once through
`torch.func.vmap` and the candidate is picked by an on-device argmin. The
outer loop is a Python loop that stops on the same statuses as the JAX
package's `lax.while_loop`, with one device-to-host read of the stop
flags an iteration (`admm.read_flags`).

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
from ilqr_admm_tpu_torch.solvers.admm import read_flags
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
    iteration: int
    status: int  # SolveStatus


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
    if riccati not in RICCATI_MODES:
        raise ValueError(
            "riccati must be 'chol', 'sqrt', 'parallel' or "
            f"'parallel_fast', got {riccati!r}"
        )
    if method == "dp":
        def iterate(*args):
            return ilqr_iterate_dp(*args, riccati=riccati)
    elif method == "sls":
        iterate = ilqr_iterate_sls
    elif method == "batch":
        iterate = ilqr_iterate_batch
    else:
        raise ValueError(f"method must be 'dp', 'sls' or 'batch', got {method!r}")
    alphas = line_search_alphas(cfg, state0.x_nom.dtype, state0.x_nom.device)

    state = state0
    while state.iteration < cfg.max_iter and state.status == SolveStatus.RUNNING:
        new_state, accept, _ = iterate(f, get_AB, get_Cs, cost_fn, state, alphas)
        dcost = torch.abs(new_state.cost - new_state.prev_cost)
        failed, converged = read_flags(~accept, dcost < cfg.tol_fun)
        if failed:
            status = SolveStatus.LINE_SEARCH_FAILED
        else:
            status = SolveStatus.CONVERGED if converged else SolveStatus.RUNNING
        state = new_state._replace(status=int(status))
    if state.status == SolveStatus.RUNNING:
        state = state._replace(status=int(SolveStatus.MAX_ITER))
    return state
