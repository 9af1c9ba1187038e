"""The line-search rollout of every candidate in one CUDA kernel.

Counterpart of `ilqr_admm_tpu/ops/pallas_rollout.py`. The Pallas kernel
(`make_pallas_linesearch_rollout`, its inner `kernel` at
`pallas_rollout.py:90`) rolls the whole alpha grid of a line search out
at once, candidates on the TPU's lanes; here it is the hand-written
kernel of `csrc/linesearch_rollout.cu`, one block a candidate, with the
plant's step compiled in and staged: the car's step is triangular in its
state, so the kernel runs its few chains of f32 additions one thread
each and every transcendental in parallel over the horizon, in the
plain version's order, bit for bit. The plants with a compiled step are
listed in `_CUDA_STEPS` (so far `CarFrontWheel`).

A fleet's line searches go to the same kernel in one launch: F initial
states and each one's A candidates, F * A blocks, the counterpart of the
Pallas call under `jax.vmap` (a grid axis over the instances). Every row
is what a single launch gives it, bit for bit.

- `linesearch_rollout(plant, x0, u_cands)`: the wrapper, single (x0
  (d,), u_cands (A, N, m)) or fleet (x0 (F, d), u_cands (F, A, N, m)).
  On a CUDA tensor it launches the kernel or raises; on a CPU tensor it
  runs the plain version, `linesearch_rollout_reference`.
- `make_fused_linesearch_rollout(plant, N, d, m, n_alphas, device=...)`:
  the `linesearch_rollout` callable of `solvers/ilqr_admm.py`,
  `(x0 (d,), u_cands (A, N, m)) -> xs (A, N, d)`, which also takes the
  fleet form, as `ilqr_admm_fleet` calls it.
- `linesearch_rollout_torch(f, x0, u_cands)`: the counterpart of
  `linesearch_rollout_xla`, `torch.func.vmap` of `rollout_nonlinear`.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import vmap

from ilqr_admm_tpu_torch.models.car import CarFrontWheel
from ilqr_admm_tpu_torch.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu_torch.utils.device import resolve_device

# Number of times `linesearch_rollout` has launched its CUDA kernel in this process.
launch_count = 0

_F32 = torch.float32
# the JAX contract (one lane block of candidates, pallas_rollout.py:76-80)
MAX_CANDIDATES = 128


def _car_front_wheel(plant):
    return (float(plant.dt), float(plant.dist), float(plant.dist) ** 2)


# plant class -> (C entry point, its float parameters, state dim, control dim)
_CUDA_STEPS = {
    CarFrontWheel: ("linesearch_rollout_car_front_wheel_launch", _car_front_wheel, 4, 2),
}


def _cuda_step(plant):
    entry = _CUDA_STEPS.get(type(plant))
    if entry is None:
        known = ", ".join(cls.__name__ for cls in _CUDA_STEPS)
        raise ValueError(
            f"{type(plant).__name__} has no CUDA step in csrc/linesearch_rollout.cu "
            f"(plants with one: {known})"
        )
    return entry


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
    (C, N, m) -> xs (C, N, d)."""
    u_cols = u_cands.permute(1, 2, 0)  # (N, m, C)
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


def _check(plant, x0, u_cands):
    """(R, A, N, device) of float32 contiguous x0 (d,) and u_cands (A, N,
    m) (R = 1), or x0 (R, d) and u_cands (R, A, N, m), on one device, with
    d and m the plant's compiled dims."""
    _, _, d, m = _cuda_step(plant)
    for name, t in (("x0", x0), ("u_cands", u_cands)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"linesearch_rollout: {name} must be a tensor")
        if t.dtype != _F32:
            raise TypeError(f"linesearch_rollout takes float32, got {name} as {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"linesearch_rollout: {name} must be contiguous")
    fleet = x0.ndim == 2
    if x0.ndim not in (1, 2) or x0.shape[-1] != d or (fleet and x0.shape[0] < 1):
        raise ValueError(f"linesearch_rollout: x0 must be ({d},) or (F, {d}) with F >= 1, "
                         f"got {tuple(x0.shape)}")
    lead = (x0.shape[0],) if fleet else ()
    if (u_cands.ndim != len(lead) + 3 or tuple(u_cands.shape[:len(lead)]) != lead
            or u_cands.shape[-1] != m or min(u_cands.shape[len(lead):-1]) < 1):
        want = f"({x0.shape[0]}, A, N, {m})" if fleet else f"(A, N, {m})"
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


def linesearch_rollout(plant, x0: torch.Tensor, u_cands: torch.Tensor) -> torch.Tensor:
    """Open-loop rollout of each candidate control sequence from x0:
    x0 (d,), u_cands (A, N, m) float32 -> xs (A, N, d), xs[a, 0] = x0,
    xs[a, t + 1] = plant.step(xs[a, t], u_cands[a, t]). A fleet's: x0
    (F, d), u_cands (F, A, N, m) -> xs (F, A, N, d), each instance's
    candidates from its own x0[f], in one launch. A <= 128 an instance.

    CUDA tensors go to the kernel in `csrc/linesearch_rollout.cu` (built
    at first use); CPU tensors to `linesearch_rollout_reference`.
    """
    global launch_count
    fn_name, params, d, _ = _cuda_step(plant)
    R, A, N, device = _check(plant, x0, u_cands)
    if device.type == "cpu":
        return linesearch_rollout_reference(plant.step_cols, x0, u_cands)
    from ilqr_admm_tpu_torch._build import load_library

    lib = load_library()
    xs = torch.empty(tuple(u_cands.shape[:-1]) + (d,), dtype=_F32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(x0.data_ptr(), u_cands.data_ptr(), xs.data_ptr(), R, A, N,
                                    *params(plant), stream)
    if err != 0:
        msg = lib.linesearch_rollout_error_string(err).decode()
        raise RuntimeError(f"{fn_name} failed: {msg} (cudaError {err})")
    launch_count += 1
    return xs


def make_fused_linesearch_rollout(plant, N: int, d: int, m: int, n_alphas: int, *, device=None):
    """Build rollout_all(x0 (d,), u_cands (n_alphas, N, m)) -> xs (n_alphas, N, d),
    the `linesearch_rollout` of `solvers/ilqr_admm.py`, through the kernel.
    It also takes a fleet, rollout_all(x0s (F, d), u_cands (F, n_alphas,
    N, m)) -> xs (F, n_alphas, N, d) in one launch, as `ilqr_admm_fleet`
    calls it.

    plant: the plant object (its type picks the compiled step, its
    attributes the parameters). Raises ValueError for a plant with no
    CUDA step, for d or m other than the plant's, and for n_alphas > 128
    (the JAX contract). There is no horizon limit: the TPU kernel kept
    the whole trajectory in 12 MiB of VMEM, this one writes it to device
    memory. device: where the rollouts run (default the CUDA card; "cpu"
    runs the plain version).
    """
    _, _, d_plant, m_plant = _cuda_step(plant)
    if (d, m) != (d_plant, m_plant):
        raise ValueError(
            f"{type(plant).__name__}'s CUDA step has d={d_plant}, m={m_plant}; got d={d}, m={m}"
        )
    if n_alphas > MAX_CANDIDATES:
        raise ValueError(
            f"n_alphas={n_alphas} > {MAX_CANDIDATES}: split the alpha grid (the JAX contract)"
        )
    if n_alphas < 1 or N < 1:
        raise ValueError(f"N and n_alphas must be >= 1, got N={N}, n_alphas={n_alphas}")
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:  # tensors report their card's index
        device = torch.device("cuda", torch.cuda.current_device())

    def rollout_all(x0: torch.Tensor, u_cands: torch.Tensor) -> torch.Tensor:
        if tuple(u_cands.shape[-3:]) != (n_alphas, N, m) or u_cands.ndim != x0.ndim + 2:
            raise ValueError(f"u_cands must be {(n_alphas, N, m)}, or (F, {n_alphas}, {N}, {m}) "
                             f"for x0s (F, {d}); got {tuple(u_cands.shape)}")
        if x0.device != device or u_cands.device != device:
            raise ValueError(f"this rollout runs on {device}; got x0 on {x0.device}, "
                             f"u_cands on {u_cands.device}")
        return linesearch_rollout(plant, x0, u_cands)

    return rollout_all
