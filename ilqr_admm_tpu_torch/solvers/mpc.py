"""Receding-horizon MPC over the iLQR solvers (counterpart of
`ilqr_admm_tpu/solvers/mpc.py`).

At every control tick: shift the warm-started nominal one step (repeat
the tail), run a fixed small number of solver iterations from the
measured state, return the first control and the new warm start. The
ticks are the JAX package's: `make_mpc_step` (DP iLQR),
`make_mpc_step_constrained` (bounded iLQR-ADMM with the duals carried,
method 'dp' or the SQP tick 'batch' + line_search='outer') and
`make_mpc_step_boxddp` (bounded boxDDP, riccati 'seq' or 'parallel').

No tick reads the device on the host: the iterations are bounded and
the constrained tick's tolerances are 0, so no stop test can pass and
none is read (`admm.can_stop`, `ilqr_admm.outer_can_stop`). `run_mpc`
therefore runs its ticks back to back with the host never waiting on the
card, and with graph=True (CUDA) it captures one closed-loop iteration,
the tick, the plant, the noise and the log writes, as a CUDA graph and
replays it n_steps times: the counterpart of the JAX package's
`lax.scan`.

Where the JAX package vmaps a tick over a fleet of controllers, the port
has a fleet form with a leading fleet axis on every state tensor:
`make_mpc_fleet_step` and `make_mpc_fleet_step_boxddp` (`torch.func.vmap`
of the DP and boxDDP ticks) and `make_mpc_fleet_step_constrained`
(through `ilqr_admm_fleet`). `run_mpc` drives each with a plant that
takes the fleet's rows.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Callable, NamedTuple

import torch
from torch.func import vmap

from ilqr_admm_tpu_torch.ops.boxqp import box_bounds
from ilqr_admm_tpu_torch.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu_torch.problem import ILQRConfig, SolveStatus, line_search_alphas
from ilqr_admm_tpu_torch.solvers.batched_ilqr_admm import ilqr_admm_fleet
from ilqr_admm_tpu_torch.solvers.boxddp import boxddp_iterate
from ilqr_admm_tpu_torch.solvers.fleet import _graphed
from ilqr_admm_tpu_torch.solvers.ilqr import ILQRState, ilqr_iterate_dp
from ilqr_admm_tpu_torch.solvers.ilqr_admm import _to_device, ilqr_admm
from ilqr_admm_tpu_torch.utils.device import resolve_device


class MPCState(NamedTuple):
    x_nom: torch.Tensor  # (N, d) warm-started nominal
    u_nom: torch.Tensor  # (N, m)


class MPCConstrainedState(NamedTuple):
    """Warm start of the constrained tick: the nominal trajectory and the
    ADMM consensus and dual variables carried across ticks."""

    x_nom: torch.Tensor  # (N, d)
    u_nom: torch.Tensor  # (N, m)
    z_x: torch.Tensor  # (N*d,)
    z_u: torch.Tensor  # (N*m,)
    lmb_x: torch.Tensor  # (N*d,)
    lmb_u: torch.Tensor  # (N*m,)


def mpc_init(f: Callable, x0, u_guess, *, device=None) -> MPCState:
    """The nominal of u_guess rolled out from x0. device: where the ticks
    run (default the CUDA card)."""
    device = resolve_device(device)
    x0, u_guess = _to_device(x0, device), _to_device(u_guess, device)
    return MPCState(x_nom=rollout_nonlinear(f, x0, u_guess), u_nom=u_guess)


def mpc_constrained_init(f: Callable, x0, u_guess, *, device=None) -> MPCConstrainedState:
    """`mpc_init` with z = the nominal and zero duals."""
    st = mpc_init(f, x0, u_guess, device=device)
    xs, us = st.x_nom, st.u_nom
    return MPCConstrainedState(x_nom=xs, u_nom=us, z_x=xs.reshape(-1), z_u=us.reshape(-1),
                               lmb_x=torch.zeros_like(xs).reshape(-1),
                               lmb_u=torch.zeros_like(us).reshape(-1))


def _shift(u):
    """One step earlier in time, repeating the terminal step: (..., N, k)."""
    return torch.cat([u[..., 1:, :], u[..., -1:, :]], dim=-2)


def _shift_flat(v, N, dim):
    """Shift flattened (..., N*dim) trajectory-shaped vectors one step
    earlier in time, repeating the terminal block."""
    return _shift(v.reshape(v.shape[:-1] + (N, dim))).reshape(v.shape)


def _fresh_state(cost_fn, xs, us) -> ILQRState:
    c = cost_fn(xs, us)
    return ILQRState(x_nom=xs, u_nom=us, cost=c, prev_cost=torch.full_like(c, float("inf")),
                     iteration=0, status=int(SolveStatus.RUNNING))


def make_mpc_step(f: Callable, get_AB: Callable, get_Cs: Callable, cost_fn: Callable,
                  n_ilqr_iters: int = 2, cfg: ILQRConfig = ILQRConfig(max_line_search_iter=10)):
    """The DP tick: (state, x_measured) -> (u_apply, state').

    Runs `n_ilqr_iters` DP-iLQR iterations (`ilqr_iterate_dp`) around the
    shifted warm start from the measured state. The line-search grid is
    `line_search_alphas(cfg)` made in f32 and cast, as the JAX package's.
    """
    def step(state: MPCState, x_measured):
        u_shift = _shift(state.u_nom)
        xs = rollout_nonlinear(f, x_measured, u_shift)
        alphas = line_search_alphas(cfg, torch.float32, xs.device).to(xs.dtype)
        s = _fresh_state(cost_fn, xs, u_shift)
        for _ in range(n_ilqr_iters):
            s, _, _ = ilqr_iterate_dp(f, get_AB, get_Cs, cost_fn, s, alphas)
        return s.u_nom[0], MPCState(x_nom=s.x_nom, u_nom=s.u_nom)

    return step


def make_mpc_fleet_step(f: Callable, get_AB: Callable, get_Cs: Callable, cost_fn: Callable,
                        n_ilqr_iters: int = 2,
                        cfg: ILQRConfig = ILQRConfig(max_line_search_iter=10)):
    """The DP tick for a fleet of controllers, `torch.func.vmap` of
    `make_mpc_step`'s tick (the tick reads nothing on the host): (state
    with (F, N, .) fields, x_measured (F, d)) -> (u_apply (F, m), state').
    f, get_AB, get_Cs and cost_fn must work under vmap."""
    return vmap(make_mpc_step(f, get_AB, get_Cs, cost_fn, n_ilqr_iters, cfg))


def _tick_alphas(n_line_search):
    """like -> 10^linspace(0, -3, n) made in f64 once a (dtype, device), as
    the JAX package's `make_mpc_step_constrained` grid (a graph capture
    then finds it made)."""
    cache = {}

    def alphas(like):
        key = (like.dtype, like.device)
        if key not in cache:
            grid = 10.0 ** torch.linspace(0.0, -3.0, n_line_search, dtype=torch.float64)
            cache[key] = grid.to(device=like.device, dtype=like.dtype)
        return cache[key]

    return alphas


def _check_iters(n_outer_iters, n_admm_iters):
    if n_outer_iters < 1 or n_admm_iters < 1:
        raise ValueError("n_outer_iters and n_admm_iters must be >= 1, got "
                         f"{n_outer_iters}, {n_admm_iters}")


def _constrained_tick(solve, rollout, f, get_AB, cost_fn, get_Cs=None, quad_cost=None,
                      project_x=None, project_u=None, rho_x=None, rho_u=None,
                      n_outer_iters=2, n_admm_iters=5, n_line_search=10, method="dp",
                      line_search="inner"):
    """The constrained tick on `solve` (`ilqr_admm`, or `ilqr_admm_fleet`
    with a leading fleet axis on every state tensor) and `rollout`
    (x0, us) -> xs of the same layout."""
    _check_iters(n_outer_iters, n_admm_iters)
    alphas = _tick_alphas(n_line_search)

    def step(state: MPCConstrainedState, x_measured):
        N, d = state.x_nom.shape[-2:]
        m = state.u_nom.shape[-1]
        u_shift = _shift(state.u_nom)
        xs = rollout(x_measured, u_shift)
        warm = (_shift_flat(state.z_x, N, d), _shift_flat(state.z_u, N, m),
                _shift_flat(state.lmb_x, N, d), _shift_flat(state.lmb_u, N, m))
        res = solve(
            f, get_AB, cost_fn, xs, u_shift, get_Cs=get_Cs, quad_cost=quad_cost,
            project_x=project_x, project_u=project_u, rho_x=rho_x, rho_u=rho_u,
            max_iter=n_outer_iters, max_admm_iter=n_admm_iters, alphas=alphas(xs),
            tol=0.0, outer_tol=0.0, osc_tol=0.0, method=method, line_search=line_search,
            warm=warm, device=xs.device)
        new_state = MPCConstrainedState(x_nom=res.x_nom, u_nom=res.u_nom, z_x=res.z_x,
                                        z_u=res.z_u, lmb_x=res.lmb_x, lmb_u=res.lmb_u)
        # truncated ADMM leaves the x-update's iterate slightly outside the
        # set; one more projection holds the input constraint exactly
        u_nom = res.u_nom
        if project_u is not None:
            u_nom = project_u(u_nom.flatten(-2)).reshape(u_nom.shape)
        return u_nom[..., 0, :], new_state

    return step


def make_mpc_step_constrained(f: Callable, get_AB: Callable, cost_fn: Callable, *args,
                              **kwargs):
    """The constrained tick: bounded-iteration iLQR-ADMM with the duals
    warm-started across ticks. (state, x_measured) -> (u_apply, state').

    The arguments after cost_fn are get_Cs, quad_cost, project_x,
    project_u, rho_x, rho_u, n_outer_iters (2), n_admm_iters (5),
    n_line_search (10), method ('dp') and line_search ('inner'), as the
    JAX package's. Each tick shifts the nominal and the ADMM consensus and
    dual variables one step, runs `n_outer_iters` outer iLQR-ADMM steps
    of `n_admm_iters` ADMM iterations each (`ilqr_admm` with tol =
    outer_tol = osc_tol = 0: the full budget every tick, no host read)
    from the measured state and applies the first control, projected by
    `project_u` when given. line_search='outer' with method='batch' is
    the SQP serving tick (rollout-free inner ADMM, one line search an
    outer step).
    """
    return _constrained_tick(ilqr_admm, partial(rollout_nonlinear, f), f, get_AB, cost_fn,
                             *args, **kwargs)


def make_mpc_fleet_step_constrained(f: Callable, get_AB: Callable, cost_fn: Callable, *args,
                                    **kwargs):
    """The constrained tick for a fleet of controllers, through
    `ilqr_admm_fleet` (the counterpart of `jax.vmap` of the JAX tick):
    (state with (F, ...) fields, x_measured (F, d)) -> (u_apply (F, m),
    state'). The arguments are `make_mpc_step_constrained`'s; f, get_AB,
    get_Cs and cost_fn are single-instance and must work under vmap, and
    project_x / project_u take the fleet's rows (F, N*d) / (F, N*m).
    """
    return _constrained_tick(ilqr_admm_fleet, vmap(partial(rollout_nonlinear, f)), f, get_AB,
                             cost_fn, *args, **kwargs)


def make_mpc_step_boxddp(f: Callable, get_AB: Callable, cost_fn: Callable, get_Cs: Callable,
                         u_lower, u_upper, n_iters: int = 3, n_line_search: int = 10,
                         qp_iters: int = 8, riccati: str = "seq", mask_iters: int = 3):
    """The control-limited tick on bounded-iteration boxDDP: no penalty
    parameters, no duals to carry, and the applied control inside the box
    by construction (clipped rollouts). (MPCState, x_measured) ->
    (u_apply, state').

    Each tick clips the shifted nominal into the box, runs `n_iters`
    boxDDP iterations (`boxddp_iterate`) from the measured state and
    applies the first control. riccati='parallel' takes the time-parallel
    backward with its active set seeded fresh each tick and `mask_iters`
    exchange passes.
    """
    if n_iters < 1:
        raise ValueError(f"n_iters must be >= 1, got {n_iters}")
    alphas = _tick_alphas(n_line_search)

    def step(state: MPCState, x_measured):
        u_shift = _shift(state.u_nom)
        m = u_shift.shape[-1]
        u_shift = torch.clamp(u_shift, box_bounds(u_lower, m, u_shift),
                              box_bounds(u_upper, m, u_shift))
        xs = rollout_nonlinear(f, x_measured, u_shift)
        s = _fresh_state(cost_fn, xs, u_shift)
        for _ in range(n_iters):
            s, _, _ = boxddp_iterate(f, get_AB, get_Cs, cost_fn, s, alphas(xs), u_lower,
                                     u_upper, qp_iters=qp_iters, riccati=riccati,
                                     mask_iters=mask_iters)
        return s.u_nom[0], MPCState(x_nom=s.x_nom, u_nom=s.u_nom)

    return step


def make_mpc_fleet_step_boxddp(f: Callable, get_AB: Callable, cost_fn: Callable,
                               get_Cs: Callable, u_lower, u_upper, *args, **kwargs):
    """The boxDDP tick for a fleet of controllers, `torch.func.vmap` of
    `make_mpc_step_boxddp`'s tick (the counterpart of `jax.vmap` of the
    JAX tick): (state with (F, N, .) fields, x_measured (F, d)) ->
    (u_apply (F, m), state'). The arguments are `make_mpc_step_boxddp`'s;
    f, get_AB, get_Cs and cost_fn must work under vmap, and the bounds
    are shared by the fleet."""
    return vmap(make_mpc_step_boxddp(f, get_AB, cost_fn, get_Cs, u_lower, u_upper, *args,
                                     **kwargs))


def _closed_loop_iteration(f_plant: Callable, mpc_step: Callable, kind, ws):
    """One closed-loop tick as a function of the carry (x, t, xs, us,
    *state fields) -> (x', t + 1, xs, us, *state', t): the tick from the
    measured x, x and u written into the logs at the tick counter t (a
    0-d int64 tensor on the device), the plant and ws[t]. The logs are
    written in place, and nothing is read on the host."""
    def iteration(x, t, xs, us, *fields):
        u, state = mpc_step(kind(*fields), x)
        at = t.reshape(1)
        xs.index_copy_(0, at, x.unsqueeze(0))
        us.index_copy_(0, at, u.unsqueeze(0))
        x = f_plant(x, u)
        if ws is not None:
            x = x + ws.index_select(0, at)[0]
        return (x, t + 1, xs, us, *state, t)

    return iteration


def run_mpc(f_plant: Callable, mpc_step: Callable, state, x0, n_steps: int, ws=None, *,
            graph: bool = False, stats: dict | None = None):
    """Closed-loop MPC on a (possibly different) plant: n_steps ticks back
    to back, with no host read between them.

    f_plant may differ from the model of mpc_step (model mismatch,
    disturbance studies); ws is optional (n_steps, d) additive noise
    ((n_steps, F, d) for a fleet), moved to the device once. With a fleet
    tick, x0 is (F, d) and f_plant takes the fleet's rows. Runs where the
    state lies. Returns (xs (n_steps, ..., d), us (n_steps, ..., m), final
    state), xs[t] the state tick t measured.

    graph=True (CUDA only) captures one iteration, the tick, the plant,
    the noise and the log writes, as a CUDA graph and replays it n_steps
    times (`fleet._graphed`; a capture that fails raises): the same
    kernels on the same inputs as the eager loop, without the host's
    per-op cost. stats, if given, receives 'capture_seconds' (the host
    time of the warm-up and the capture).
    """
    device = state.x_nom.device
    if graph and device.type != "cuda":
        raise ValueError(f"graph=True captures a CUDA graph; the state is on {device}")
    x, ws = _to_device(x0, device), _to_device(ws, device)
    xs = torch.empty((n_steps,) + tuple(x.shape), dtype=x.dtype, device=device)
    us = torch.empty((n_steps,) + tuple(x.shape[:-1]) + (state.u_nom.shape[-1],),
                     dtype=state.u_nom.dtype, device=device)
    if n_steps == 0:
        return xs, us, state
    kind = type(state)
    iteration = _closed_loop_iteration(f_plant, mpc_step, kind, ws)
    carry = (x, torch.zeros((), dtype=torch.int64, device=device), xs, us, *state)
    capture = 0.0
    if graph:
        t0 = time.perf_counter()
        replay, carry = _graphed(iteration, carry)
        capture = time.perf_counter() - t0
    for _ in range(n_steps):
        if graph:
            replay()
        else:
            *carry, _ = iteration(*carry)
    _, _, xs, us, *fields = carry
    if stats is not None:
        stats["capture_seconds"] = stats.get("capture_seconds", 0.0) + capture
    return xs, us, kind(*fields)
