"""The line-search rollout of every candidate in one CUDA kernel.

Counterpart of `ilqr_admm_tpu/ops/pallas_rollout.py`. The Pallas kernel
(`make_pallas_linesearch_rollout`, its inner `kernel` at
`pallas_rollout.py:90`) rolls the whole alpha grid of a line search out
at once, candidates on the TPU's lanes, through whatever elementwise
`step_cols` it is given. Here the step picks one of two hand-written
kernels:

- `CarFrontWheel` (the plant, or its bound `step_cols` or `step`): the
  staged kernel of `csrc/linesearch_rollout.cu`, one block a candidate,
  the car's step compiled in by hand: the step is triangular in its
  state, so the kernel runs its few chains of f32 additions one thread
  each and every transcendental in parallel over the horizon, in the
  plain version's order, bit for bit.
- any other step (a `step_cols` callable, a plant's `step_cols`, or a
  callable plant without one, such as CarSimple, rolled out through its
  `__call__` as JAX's builder rolls it out): the generated route.
  `ops/rollout_codegen.py` traces the step, plans it (`StagePlan`: the
  state graph's strongly connected components by level, which values run
  in series and which in parallel over the horizon) and emits it as C++,
  each operation as ATen's CUDA kernel computes it, and
  `_build.build_rollouts` compiles it into the template
  `csrc/linesearch_rollout_generic.cuh` (staged as the car's kernel is:
  one block a candidate, each chain on a thread of its own, the rest in
  parallel over t), a library of its own a step. A step the
  emitter does not take raises ValueError when the rollout is built,
  naming the operation, on every device; there is no fallback.

A fleet's line searches go to the same kernel in one launch: F initial
states and each one's A candidates, the counterpart of the Pallas call
under `jax.vmap` (a grid axis over the instances). Every row is what a
single launch gives it, bit for bit.

- `linesearch_rollout(step_or_plant, x0, u_cands)`: the wrapper, single
  (x0 (d,), u_cands (A, N, m)) or fleet (x0 (F, d), u_cands (F, A, N,
  m)). On a CUDA tensor it launches a kernel or raises (the generated
  route traces the step at each call and its library is loaded once, so
  calls that repeat should go through the factory below, which traces
  once); on a CPU tensor it runs the plain version,
  `linesearch_rollout_reference`, for any `step_cols`.
- `make_fused_linesearch_rollout(step_or_plant, N, d, m, n_alphas,
  device=...)`: the `linesearch_rollout` callable of `solvers/ilqr_admm.py`,
  `(x0 (d,), u_cands (A, N, m)) -> xs (A, N, d)`, which also takes the
  fleet form, as `ilqr_admm_fleet` calls it. It traces the step once and,
  on the card, builds the generated kernel when it is made.
- `linesearch_rollout_torch(f, x0, u_cands)`: the counterpart of
  `linesearch_rollout_xla`, `torch.func.vmap` of `rollout_nonlinear`.

Launches are counted apart: `launch_count` (the staged car kernel) and
`generated_launch_count` (the generated route).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import vmap

from ilqr_admm_tpu_torch.models.car import CarFrontWheel
from ilqr_admm_tpu_torch.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu_torch.ops.rollout_codegen import MAX_DIM, GeneratedStep, emit_step
from ilqr_admm_tpu_torch.utils.device import resolve_device

# Number of times the wrappers have launched each CUDA kernel in this process.
launch_count = 0  # the staged CarFrontWheel kernel
generated_launch_count = 0  # the generated route

_F32 = torch.float32
# the JAX contract (one lane block of candidates, pallas_rollout.py:76-80)
MAX_CANDIDATES = 128
# CarFrontWheel's state and control dims, which its staged kernel has compiled in
_CAR_DIMS = (4, 2)


class Route(NamedTuple):
    """The kernel a step runs on: the staged car kernel (`car` set) or the
    generated route (`generated` set, once traced). `step_cols` is the
    plain version's step."""
    step_cols: Callable
    car: Optional[CarFrontWheel] = None
    generated: Optional[GeneratedStep] = None


def _staged_car(step_or_plant) -> Optional[CarFrontWheel]:
    """The CarFrontWheel whose staged kernel this step is: the plant
    itself, or its bound `step_cols` or `step`; else None."""
    if type(step_or_plant) is CarFrontWheel:
        return step_or_plant
    owner = getattr(step_or_plant, "__self__", None)
    if type(owner) is CarFrontWheel and getattr(step_or_plant, "__func__", None) in (
            CarFrontWheel.step_cols, CarFrontWheel.step):
        return owner
    return None


def step_route(step_or_plant) -> Route:
    """The route of a step or plant, not yet traced: a plant with
    `step_cols` rolls out its `step_cols`; any other callable (a step
    function, or a callable plant such as CarSimple, whose `__call__` is
    its step) is the step itself, as JAX's builder calls whatever it is
    given on columns."""
    car = _staged_car(step_or_plant)
    if car is not None:
        return Route(car.step_cols, car=car)
    step_cols = getattr(step_or_plant, "step_cols", None)
    if callable(step_cols):
        return Route(step_cols)
    if callable(step_or_plant):
        return Route(step_or_plant)
    raise TypeError(f"linesearch_rollout takes a step_cols callable, a callable plant or a "
                    f"plant with step_cols, got {type(step_or_plant).__name__}")


def _check_dims(route: Route, d: int, m: int):
    if route.car is not None:
        if (d, m) != _CAR_DIMS:
            raise ValueError(f"CarFrontWheel's CUDA step has d={_CAR_DIMS[0]}, "
                             f"m={_CAR_DIMS[1]}; got d={d}, m={m}")
    elif not (1 <= d <= MAX_DIM and 1 <= m <= MAX_DIM):
        raise ValueError(f"d={d}, m={m}: the rollout takes state and control dims 1..{MAX_DIM} "
                         "(the JAX contract: one sublane tile)")


def linesearch_rollout_reference(step_cols: Callable, x0: torch.Tensor,
                                 u_cands: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel, in the Pallas kernel's own
    layout: a loop over t on the (d, A) state, one `step_cols` a step.
    x0 (d,), u_cands (A, N, m) -> xs (A, N, d), xs[:, 0] = x0; or a
    fleet's, x0 (F, d), u_cands (F, A, N, m) -> xs (F, A, N, d), the
    F * A candidates as the columns of one loop."""
    if x0.ndim == 2:
        F, A, N, m = u_cands.shape
        d = x0.shape[1]
        x0_cols = x0.T[:, :, None].expand(d, F, A).reshape(d, F * A)
        return _rollout_cols(step_cols, x0_cols, u_cands.reshape(F * A, N, m)).reshape(F, A, N, d)
    A = u_cands.shape[0]
    return _rollout_cols(step_cols, x0[:, None].expand(x0.shape[0], A), u_cands)


def _rollout_cols(step_cols, x, u_cands):
    """The loop over t from the (d, C) start x for the C candidates u_cands
    (C, N, m) -> xs (C, N, d). The state and each step's controls are
    contiguous (d, C) and (m, C) tensors of at least two columns, so that
    ATen's CUDA reductions over the state axis fold each column in the one
    order the generated kernel computes (`rollout_codegen.ro_fold`): on a
    block whose candidates are not its fastest axis, or of one column, ATen
    reduces in other orders. Elementwise ops give the same bits either way."""
    if u_cands.shape[0] == 1:
        return _rollout_cols(step_cols, x.expand(x.shape[0], 2), u_cands.expand(2, -1, -1))[:1]
    x = x.contiguous()
    u_cols = u_cands.permute(1, 2, 0).contiguous()  # (N, m, C)
    xs = []
    for t in range(u_cands.shape[1]):
        xs.append(x)
        x = step_cols(x, u_cols[t])
    return torch.stack(xs, dim=0).permute(2, 0, 1).contiguous()


def linesearch_rollout_torch(f: Callable, x0: torch.Tensor, u_cands: torch.Tensor) -> torch.Tensor:
    """`rollout_nonlinear` of each candidate through `torch.func.vmap`: the
    counterpart of `linesearch_rollout_xla` and of the default candidate
    rollout of `solvers/ilqr_admm.py`."""
    return vmap(lambda us: rollout_nonlinear(f, x0, us))(u_cands)


def _check(x0, u_cands, d=None, m=None):
    """(R, A, N, device) of float32 contiguous x0 (d,) and u_cands (A, N,
    m) (R = 1), or x0 (R, d) and u_cands (R, A, N, m), on one device; d
    and m the route's where it has them compiled in."""
    for name, t in (("x0", x0), ("u_cands", u_cands)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"linesearch_rollout: {name} must be a tensor")
        if t.dtype != _F32:
            raise TypeError(f"linesearch_rollout takes float32, got {name} as {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"linesearch_rollout: {name} must be contiguous")
    fleet = x0.ndim == 2
    dn, mn = ("d" if d is None else d), ("m" if m is None else m)
    if (x0.ndim not in (1, 2) or (d is not None and x0.shape[-1] != d)
            or (fleet and x0.shape[0] < 1)):
        raise ValueError(f"linesearch_rollout: x0 must be ({dn},) or (F, {dn}) with F >= 1, "
                         f"got {tuple(x0.shape)}")
    lead = (x0.shape[0],) if fleet else ()
    if (u_cands.ndim != len(lead) + 3 or tuple(u_cands.shape[:len(lead)]) != lead
            or (m is not None and u_cands.shape[-1] != m)
            or min(u_cands.shape[len(lead):-1]) < 1):
        want = f"({x0.shape[0]}, A, N, {mn})" if fleet else f"(A, N, {mn})"
        raise ValueError(
            f"linesearch_rollout: u_cands must be {want} with A, N >= 1 for x0 "
            f"{tuple(x0.shape)}, got {tuple(u_cands.shape)}"
        )
    R, A, N = (lead or (1,))[0], u_cands.shape[-3], u_cands.shape[-2]
    if A > MAX_CANDIDATES:
        raise ValueError(f"linesearch_rollout takes at most {MAX_CANDIDATES} candidates "
                         f"an instance, got {A}")
    if R * A > 2**31 - 1:
        raise ValueError(f"linesearch_rollout: {R} x {A} rows exceed the kernel's grid")
    if x0.device != u_cands.device:
        raise ValueError(f"linesearch_rollout: x0 is on {x0.device} but u_cands on "
                         f"{u_cands.device}")
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"linesearch_rollout runs on CPU or CUDA tensors, got {x0.device}")
    return R, A, N, x0.device


def _check_shapes(route: Route, x0, u_cands):
    """`_check` with the route's dims: CarFrontWheel's or the traced
    step's, which its kernel has compiled in; else the tensors' own,
    1..MAX_DIM."""
    if route.car is not None:
        return _check(x0, u_cands, *_CAR_DIMS)
    if route.generated is not None:
        return _check(x0, u_cands, route.generated.d, route.generated.m)
    checked = _check(x0, u_cands)
    _check_dims(route, x0.shape[-1], u_cands.shape[-1])
    return checked


def _launch(route: Route, x0, u_cands, R, A, N, device):
    """Launch the route's kernel on CUDA tensors; returns xs."""
    global launch_count, generated_launch_count
    from ilqr_admm_tpu_torch import _build

    d = x0.shape[-1]
    xs = torch.empty(tuple(u_cands.shape[:-1]) + (d,), dtype=_F32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if route.car is not None:
            lib, fn_name = _build.load_library(), "linesearch_rollout_car_front_wheel_launch"
            car = route.car
            params = (float(car.dt), float(car.dist), float(car.dist) ** 2)
            err = getattr(lib, fn_name)(x0.data_ptr(), u_cands.data_ptr(), xs.data_ptr(), R, A,
                                        N, *params, stream)
            error_string = lib.linesearch_rollout_error_string
        else:
            lib, fn_name = _build.load_rollout(route.generated.source), \
                "linesearch_rollout_generic_launch"
            err = lib.linesearch_rollout_generic_launch(x0.data_ptr(), u_cands.data_ptr(),
                                                        xs.data_ptr(), R, A, N, stream)
            error_string = lib.linesearch_rollout_generic_error_string
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: {error_string(err).decode()} (cudaError {err})")
    if route.car is not None:
        launch_count += 1
    else:
        generated_launch_count += 1
    return xs


def _traced(route: Route, d: int, m: int) -> Route:
    """The route with its step traced and emitted (generated route)."""
    if route.car is not None or route.generated is not None:
        return route
    return route._replace(generated=emit_step(route.step_cols, d, m))


def _rollout(route: Route, x0, u_cands):
    """The route's rollout of checked tensors: the plain version on the
    CPU, the route's kernel on the card."""
    R, A, N, device = _check_shapes(route, x0, u_cands)
    if device.type == "cpu":
        return linesearch_rollout_reference(route.step_cols, x0, u_cands)
    return _launch(route, x0, u_cands, R, A, N, device)


def linesearch_rollout(step_or_plant, x0: torch.Tensor, u_cands: torch.Tensor) -> torch.Tensor:
    """Open-loop rollout of each candidate control sequence from x0:
    x0 (d,), u_cands (A, N, m) float32 -> xs (A, N, d), xs[a, 0] = x0,
    xs[a, t + 1] = step(xs[a, t], u_cands[a, t]). A fleet's: x0 (F, d),
    u_cands (F, A, N, m) -> xs (F, A, N, d), each instance's candidates
    from its own x0[f], in one launch. A <= 128 an instance, d, m <= 8.

    step_or_plant: a `step_cols(x (d, A), u (m, A)) -> (d, A)` callable
    or a plant (module docstring). CUDA tensors go to a kernel (the staged
    CarFrontWheel kernel, built at first use, or the generated route,
    traced at each call and built at its first use); CPU tensors to
    `linesearch_rollout_reference`, for any step.
    """
    route = step_route(step_or_plant)
    _, _, _, device = _check_shapes(route, x0, u_cands)
    if device.type == "cuda":
        route = _traced(route, x0.shape[-1], u_cands.shape[-1])
    return _rollout(route, x0, u_cands)


def make_fused_linesearch_rollout(step_or_plant, N: int, d: int, m: int, n_alphas: int, *,
                                  device=None):
    """Build rollout_all(x0 (d,), u_cands (n_alphas, N, m)) -> xs (n_alphas, N, d),
    the `linesearch_rollout` of `solvers/ilqr_admm.py`, through a kernel.
    It also takes a fleet, rollout_all(x0s (F, d), u_cands (F, n_alphas,
    N, m)) -> xs (F, n_alphas, N, d) in one launch, as `ilqr_admm_fleet`
    calls it.

    step_or_plant: what JAX's `make_pallas_linesearch_rollout` takes, a
    `step_cols` callable, a plant with `step_cols` or a callable plant (a
    CarFrontWheel, or its bound `step_cols` or `step`, keeps the staged
    car kernel; any other step the generated route; an object that is not
    callable and has no `step_cols` raises TypeError). The step is traced
    and emitted here, on every
    device, so a step the generated kernel does not take raises
    ValueError here, naming the operation (`ops/rollout_codegen.py`); on
    the card its library is built here too (a step nvcc refuses raises
    with nvcc's output). Also raises ValueError for d or m outside 1..8
    (CarFrontWheel: other than 4 and 2) and for n_alphas > 128 (the JAX
    contract). There is no horizon limit: the TPU kernel kept the whole
    trajectory in 12 MiB of VMEM, these write it to device memory.
    device: where the rollouts run (default the CUDA card; "cpu" runs the
    plain version). `rollout_all.route` is the route it runs.
    """
    route = step_route(step_or_plant)
    _check_dims(route, d, m)
    if n_alphas > MAX_CANDIDATES:
        raise ValueError(
            f"n_alphas={n_alphas} > {MAX_CANDIDATES}: split the alpha grid (the JAX contract)"
        )
    if n_alphas < 1 or N < 1:
        raise ValueError(f"N and n_alphas must be >= 1, got N={N}, n_alphas={n_alphas}")
    route = _traced(route, d, m)
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:  # tensors report their card's index
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type == "cuda" and route.generated is not None:
        from ilqr_admm_tpu_torch import _build

        _build.load_rollout(route.generated.source)

    def rollout_all(x0: torch.Tensor, u_cands: torch.Tensor) -> torch.Tensor:
        if tuple(u_cands.shape[-3:]) != (n_alphas, N, m) or u_cands.ndim != x0.ndim + 2:
            raise ValueError(f"u_cands must be {(n_alphas, N, m)}, or (F, {n_alphas}, {N}, {m}) "
                             f"for x0s (F, {d}); got {tuple(u_cands.shape)}")
        if x0.device != device or u_cands.device != device:
            raise ValueError(f"this rollout runs on {device}; got x0 on {x0.device}, "
                             f"u_cands on {u_cands.device}")
        return _rollout(route, x0, u_cands)

    rollout_all.route = route
    return rollout_all
