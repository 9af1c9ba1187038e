"""The loops of the DP solvers (`ilqr_solve`, `boxddp_solve`), single
and as a fleet, around one body function each solver defines: body(*carry)
-> (new carry, status), one iteration with no host read.

`run_single` is the JAX package's `lax.while_loop`: the body while the
status is RUNNING below the iteration cap, one host read of the status an
iteration. `run_fleet` is `jax.vmap` of it, run over the body vmapped
over a leading fleet axis. A vmapped while loop runs its body for every
instance while any
instance's condition holds, and an instance whose condition fails keeps
its carry. `run_fleet` does the same around a step function that runs
one iteration of every instance (the single solver's iterate function
under `torch.func.vmap`) and returns each instance's new status: an
instance that is no longer RUNNING keeps its carry, its status and its
iteration count. One host read of a flag serves the whole fleet: a solve
reads once an iteration, whatever F, and not after the last iteration
the cap allows.

With graph=True (CUDA only) one iteration, a fleet's freeze included, is
captured as a CUDA graph on static buffers and replayed between the
reads: a boxDDP or iLQR iteration is tens of thousands of small kernels,
and a replay launches them without the host's per-op cost. The graph
runs the same kernels on the same inputs as the eager loop.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from ilqr_admm_tpu_torch.problem import SolveStatus
from ilqr_admm_tpu_torch.solvers.admm import keep, read_flags, read_status

RUNNING = int(SolveStatus.RUNNING)


def bind(fn: Callable, extra) -> Callable:
    """fn with trailing arguments bound: (*a) -> fn(*a, *extra)."""
    if not extra:
        return fn
    return lambda *a: fn(*a, *extra)


def _graphed(iteration: Callable, state: tuple) -> tuple[Callable, tuple]:
    """Capture iteration(*state) -> (*state', flag) as a CUDA graph whose
    replay writes the new state over static copies of `state` (an element
    the iteration writes in place and returns is kept as it is). The
    warm-up runs on copies, so the static state is `state` at the first
    replay. Returns (replay() -> the static flag, the static state)."""
    static = tuple(t.clone() for t in state)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: workspaces, handles, lazily made constants
        iteration(*(t.clone() for t in static))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        *new, flag = iteration(*static)
        for old, t in zip(static, new):
            old.copy_(t)

    def replay():
        graph.replay()
        return flag

    replay.graph = graph  # keeps the graph, and with it its memory pool, alive
    return replay, static


def run_single(body: Callable, carry: tuple, iteration: int, status: int, max_iter: int, *,
               graph: bool = False):
    """Run body while status is RUNNING and iteration < max_iter, reading
    the status on the host after each iteration. Returns (carry,
    iteration, status), a status still RUNNING at the cap made MAX_ITER."""
    if graph and carry[0].device.type != "cuda":
        raise ValueError(f"graph=True captures a CUDA graph; the solve is on {carry[0].device}")
    if graph and iteration < max_iter and status == RUNNING:
        def flat(*state):
            new, st = body(*state)
            return (*new, st)

        replay, carry = _graphed(flat, carry)
    while iteration < max_iter and status == RUNNING:
        if graph:
            st = replay()
        else:
            carry, st = body(*carry)
        status = read_status(st)
        iteration += 1
    if status == RUNNING:
        status = int(SolveStatus.MAX_ITER)
    return tuple(carry), iteration, status


def run_fleet(step: Callable, carry: tuple, status, iters, max_iter: int, *,
              graph: bool = False, stats: dict | None = None):
    """Run step while any instance is RUNNING below max_iter iterations.

    step(*carry) -> (new carry, status (F,) int64): one iteration of every
    instance with no host read; carry is a tuple of tensors with a
    leading fleet axis F; status and iters (F,) int64 are where each
    instance starts. Returns (carry, status, iters), a status still
    RUNNING at the cap made MAX_ITER. stats, if given, receives
    'iterations' (the fleet's), 'host_reads' and, with graph=True,
    'capture_seconds' (the host time of the warm-up and the capture).
    """
    device = carry[0].device
    if graph and device.type != "cuda":
        raise ValueError(f"graph=True captures a CUDA graph; the fleet is on {device}")
    n = len(carry)

    def running(status, iters):
        return (status == RUNNING) & (iters < max_iter)

    def iteration(*state):
        carry, status, iters = state[:n], state[n], state[n + 1]
        live = running(status, iters)
        new, status_new = step(*carry)
        carry = tuple(keep(live, a, b) for a, b in zip(new, carry))
        status = torch.where(live, status_new, status)
        iters = iters + live.to(iters.dtype)
        return (*carry, status, iters, torch.any(running(status, iters)))

    state = (*carry, status, iters)
    t0 = time.perf_counter()
    if graph and max_iter > 0:
        replay, state = _graphed(iteration, state)
    capture = time.perf_counter() - t0
    k, reads = 0, 0
    while k < max_iter:
        if graph:
            flag = replay()
        else:
            *state, flag = iteration(*state)
        k += 1
        if k < max_iter:
            reads += 1
            (go,) = read_flags(flag)
            if not go:
                break
    carry, status, iters = tuple(state[:n]), state[n], state[n + 1]
    status = torch.where(status == RUNNING, torch.full_like(status, int(SolveStatus.MAX_ITER)),
                         status)
    if stats is not None:
        stats["iterations"] = stats.get("iterations", 0) + k
        stats["host_reads"] = stats.get("host_reads", 0) + reads
        stats["capture_seconds"] = stats.get("capture_seconds", 0.0) + capture
    return carry, status, iters
