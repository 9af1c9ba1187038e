#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Drives the port's paths on the card:

- the box-constrained LQT-ADMM fleet of the repository's bench (16,384
  double-integrator instances, N = 100, |u| <= 5, rho_u = 0.1, 100
  iterations) through `make_fused_lqt_admm`;
- the same fleet with a velocity box |v| <= 1.3 (position free), rho_x =
  10, 200 iterations, through `make_fused_lqt_admm(..., x_lower, x_upper)`,
  whose loop is the `admm_box` kernel;
- the robust SLS-ADMM scenario fleet of `benchmarks/bench_pallas_sls.py`
  (1,024 chance-constrained syntheses, N = 100, robust_dim 1, bounds
  U(2, 4), rho_u = 1.0, 200 iterations) through `make_fused_sls_admm`
  in its serving configuration (exact diamond z-update, per-tile early
  exit at 3e-3 every 16 iterations, fleet sorted by bound);
- the blocked time-parallel LQT Riccati backward pass of
  `benchmarks/bench_parallel_riccati.py` (2-D double integrator, dt =
  0.01, Q = 100 I, R = 0.01 I, N = 10,000, nb = 128 blocks) through
  `lqt_backward_parallel_fused`, whose scan is the `riccati_scan` and
  `riccati_join` kernels (the level-2 suffix as the join's prologue, one
  launch), then the closed loop from x0 through
  `rollout_closed_loop_parallel`;
- the control-limited car of `benchmarks/run_all.py:274-329` through the
  nonlinear constrained solver `ilqr_admm` (CarFrontWheel, N = 500, the
  parking cost, |w| <= 0.5, |a| <= 2, rho_u = diag(1e-2, 1e-3), 60 outer
  steps, 30 ADMM iterations, 20 alphas, SQP-style outer line search,
  f32), whose line-search rollout is the `linesearch_rollout` kernel;
- the 3DoF arm fleet of `benchmarks/bench_arm_admm.py:58-179` through
  `ilqr_admm_fleet` (1,024 instances, N = 100, |u| <= 2.5, rho_u = 1e-2,
  12 outer steps, 20 ADMM iterations, 5 alphas, f32) in both line-search
  modes; no kernel lies on it (the arm's state dimension, 9, is past
  what the JAX package's rollout and Riccati kernels take);
- the robust arm of `tests/test_isls_robust.py:28-200` through
  `isls_admm` in f64: without projections, with the per-row SOC
  projection at Psi^-1(0.82) and with `joint_alpha` = 0.958, each
  validated by 1,000 Monte-Carlo closed-loop rollouts.

Phases:

1. device: a CUDA card must be present (there is no CPU path);
2. build: compile the CUDA kernel library from the sources in the tree;
3. for each path: kernel vs plain, the kernel against its plain torch
   version on the same card inputs (the LQT fleet's `admm_u_only` in
   three modes and at an odd width, against the plain version with its
   tensor-core products and against the f32 one, and the iterations its
   early-exit tiles ran; `admm_box` at the full width, with a
   state box only, and at an odd width, also against the plain version
   with its 3xTF32 products; `sls_admm` in the diamond,
   early-exit and consensus modes, at an odd width and with 16-instance
   tiles, against the plain version with its 3xTF32 products and
   against the f32 one, and the iterations its early-exit tiles ran; the
   two Riccati kernels (each against the plain version in its order:
   the scan's chunks, the join's level 2 for 16 lanes a block; beside
   them the sequential scan and the JAX package's level-2 order) at N =
   10,000 with d = 4, N = 1,001 with nb = 8, d = 3 and the ADMM
   regularizers, d = 2, d = 1, N = 100 < nb, N = 10,000 with nb = 32 and
   16 (a lane the scan kernel stages in more than 48 KB of shared memory,
   and one too long to stage) and with nb = 1,024 (the join's longest
   prologue);
   `linesearch_rollout` at N = 500 with 20, 1 and 128 candidates, N = 60,
   N = 37, N = 10,000, and a candidate set with NaN states, bit for bit);
4. for each path: main path, one fleet solve (one backward pass, one car
   solve) with every launch counter set to 0 just before it and read
   just after, checked against the certificates (`utils/certify.py`;
   for the car the cost and bound gates of `tests/test_ilqr_admm.py`, an
   f64 solve on the host, and an inner-line-search solve);
5. for each path: time, the kernel and the plain version with CUDA
   events (for the u-only path also 100 f32 cuBLAS products of the
   loop's shape as a yardstick, for the SLS path 200; for the
   state-bounded path also the whole forward and the
   plain fleet `make_batched_lqt_admm`; for the Riccati path, at N =
   100, 1,000 and 10,000, each kernel's device time from a CUDA graph of
   its launches and its wrapper's time a call, the whole backward pass,
   its plain version, the plain torch blocked and flat scans and the
   sequential pass, then an nb sweep, the parallel against the
   sequential closed-loop rollout, and a `torch.profiler` split of the
   pass; for the car, the kernel, its plain version, a CUDA graph of the
   plain version, the whole solve and a `torch.profiler` split of a
   solve);
6. the arm: the fleet's main path in each mode with its host reads of
   stop flags and the bench's certificates (`certify_arm`: converged
   fraction, violation, an f64 L-BFGS-B oracle on 8 instances; where f32
   misses a gate, the fleet again in f64, certified and labelled so);
   the fleet of 8 against 8 single `ilqr_admm` solves; solves/s (median
   and IQR of 3 windows of one solve); a `torch.profiler` split of one
   inner-mode solve; the robust arm in f64 with the gates of
   `tests/test_isls_robust.py`.

Any failure exits non-zero before the last line. The last line is
{"ok": true, "device": {...}}; the line before it lists each kernel with
its launches on its main path, its error against its plain version, its
time, its plain version's time and its bound on an H100 (`bound_ops`:
the f32 CUDA cores, 3xTF32 on the tensor cores, or a dependency chain of
f32 additions); the line before that, the seconds each phase took.

Run from the repository root: python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch
from scipy.stats import chi, norm
from torch.func import vmap

from ilqr_admm_tpu_torch import _build
from ilqr_admm_tpu_torch.chance import make_box_chance_projection
from ilqr_admm_tpu_torch.models.arm import PlanarArm
from ilqr_admm_tpu_torch.models.car import CarFrontWheel, CarParkingCost
from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.ops import fused_admm, fused_riccati, fused_rollout, fused_sls
from ilqr_admm_tpu_torch.ops.fused_admm import (
    admm_box,
    admm_box_reference,
    admm_u_only,
    admm_u_only_reference,
    make_fused_lqt_admm,
)
from ilqr_admm_tpu_torch.ops.fused_riccati import (
    JOIN_GROUP,
    SCAN_CHUNKS,
    lqt_backward_parallel_fused,
    pack_elements,
    riccati_join,
    riccati_join_reference,
    riccati_scan,
    riccati_scan_reference,
)
from ilqr_admm_tpu_torch.ops.fused_rollout import (
    linesearch_rollout,
    linesearch_rollout_reference,
    make_fused_linesearch_rollout,
)
from ilqr_admm_tpu_torch.ops.fused_sls import make_fused_sls_admm, sls_admm, sls_admm_reference
from ilqr_admm_tpu_torch.ops.parallel_riccati import (
    lqt_backward_parallel,
    rollout_closed_loop_parallel,
    value_elements,
)
from ilqr_admm_tpu_torch.ops.riccati import lqt_backward
from ilqr_admm_tpu_torch.ops.rollout import (
    rollout_closed_loop,
    rollout_nonlinear,
    rollout_sls_delta,
)
from ilqr_admm_tpu_torch.problem import SolveStatus
from ilqr_admm_tpu_torch.solvers import admm as admm_solver
from ilqr_admm_tpu_torch.solvers import batched_ilqr_admm
from ilqr_admm_tpu_torch.solvers.batched import make_batched_lqt_admm
from ilqr_admm_tpu_torch.solvers.batched_ilqr_admm import ilqr_admm_fleet
from ilqr_admm_tpu_torch.solvers.ilqr_admm import ilqr_admm
from ilqr_admm_tpu_torch.solvers.isls_admm import isls_admm
from ilqr_admm_tpu_torch.solvers.lqt import sls_controller
from ilqr_admm_tpu_torch.utils.certify import (
    ARM_N_ORACLE,
    arm_gate_failures,
    certify,
    certify_arm,
    certify_riccati,
    certify_sls,
    certify_state_box,
    gate_failures,
    riccati_gate_failures,
    sls_gate_failures,
    state_box_gate_failures,
)
from ilqr_admm_tpu_torch.utils.cost_assembly import get_double_integrator_AB, viapoint_cost
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul

N = 100
BATCH = 16384
ADMM_ITERS = 100
RHO_U = 0.1
U_MAX = 5.0
BATCH_TILE = 64
# kernel and plain version with the same tensor-core products differ only
# in the order of f32 sums (and, with early exit, a tile may leave a
# chunk apart); against the f32 plain version the gate is KERNEL_TOL x
# max(1, max|u_hat|, max|x_hat|), as for the state box
KERNEL_TOL = 1e-4
MODES = {
    "default (refresh_every=1, polish_iters=8)": dict(refresh_every=1, polish_iters=8),
    "refresh_every=8": dict(refresh_every=8),
    "stop_tol=1e-5, check_every=4": dict(stop_tol=1e-5, check_every=4),
}
TIMING_WINDOWS = 7
CALLS_PER_WINDOW = 10

# The state-bounded fleet: the bench problem with a velocity box
BOX_ITERS = 200
RHO_X = 10.0
V_MAX = 1.3
BOX_TILE = 32
BOX_TOL = 1e-4  # times max(1, max|u_hat|, max|x_hat|)

# The robust SLS fleet of benchmarks/bench_pallas_sls.py:41-160
SLS_BATCH = 1024
SLS_TIME_BATCHES = (1024, 16384)
SLS_ITERS = 200
SLS_CONS_ITERS = 30
SLS_CONS_RHO = 10.0
SLS_RHO_U = 1.0
SLS_TILE = 8
SLS_STOP_TOL = 3e-3
SLS_CHECK_EVERY = 16
PSI_INV = float(norm.ppf(0.95))
SIGMA = 0.1
C_COEF = PSI_INV * SIGMA
# Fixed schedules differ only in f32 summation order; with early exit a
# tile may leave one chunk apart, so the JAX package's own early-exit
# tolerance on U applies (tests/test_pallas_sls.py:211-212).
SLS_FIXED_TOL = 1e-4  # times max(1, max|U|)
SLS_EARLY_EXIT_TOL = 2e-3
SLS_MODES = ("diamond", "diamond_ee", "consensus")

# The time-parallel Riccati of benchmarks/bench_parallel_riccati.py:36-44:
# the 2-D double integrator at dt = 0.01, Q = 100 I, R = 0.01 I, xd = 0
# but for xd[N-1, 0] = 1, blocked with nb = 128 lanes
RICCATI_N = 10_000
RICCATI_NB = 128
RICCATI_HORIZONS = (100, 1_000, 10_000)
RICCATI_NB_SWEEP = (128, 256, 512, 1024)
# kernel and plain version differ only in the order of f32 operations and
# FMA contraction; times max(1, max|ref|), per component. An H100 showed
# at most 4.1e-6 at these shapes (the scan at L = 625; 1.6e-6 before the
# scan was chunked), so 1e-5 keeps a margin of two.
RICCATI_KERNEL_TOL = 1e-5
RICCATI_PROFILED_CALLS = 20
# (windows, calls a window) of the plain versions' timings, cut from the
# fleets' (5, 2) to keep the run near the earlier slices' length; the
# sequential pass (6-10 s a call) and rollout (~1 s) at N = 10,000 run once
RICCATI_PLAIN = (3, 1)
# (N, nb, state dim, with regularizers): the main width, a non-divisible N
# with L > nb and the ADMM regularizers on the triple integrator, d = 2 and
# d = 1, N < nb (L = 1, most lanes identity padding), L = 313, whose lane's
# elements the scan kernel stages in more than 48 KB of shared memory,
# L = 625, too many to stage, and nb = 1,024 (L = 10), the join's longest
# level-2 prologue (63 totals a chunk)
RICCATI_CASES = ((10_000, 128, 4, False), (1_001, 8, 3, True), (500, 16, 2, False),
                 (300, 32, 1, False), (100, 128, 4, False), (10_000, 32, 4, False),
                 (10_000, 16, 4, False), (10_000, 1024, 4, False))
RICCATI_KERNELS = ("riccati_scan", "riccati_join")

# The control-limited car of benchmarks/run_all.py:274-329 through ilqr_admm
CAR_N = 500
CAR_X0 = (1.0, 1.0, 3.0 * np.pi / 2, 0.0)
CAR_U_LO, CAR_U_HI = (-0.5, -2.0), (0.5, 2.0)
CAR_RHO_U = (1e-2, 1e-3)
CAR_SOLVE = dict(max_iter=60, max_admm_iter=30, tol=1e-3, outer_tol=1e-5, osc_tol=1e-5,
                 line_search="outer")
CAR_ALPHAS = 20
# the inner-line-search configuration of tests/test_ilqr_admm.py:27-46,
# its u0 from default_rng(3) included (from default_rng(0) the port's f32
# solve ends at 1.9643 on an H100 80GB HBM3)
CAR_INNER = dict(max_iter=60, max_admm_iter=8, tol=1e-3, outer_tol=1e-5, osc_tol=1e-5,
                 line_search="inner")
CAR_INNER_ALPHAS = 40
CAR_INNER_SEED = 3
# gates: tests/test_ilqr_admm.py:73-82 (outer), :50-55 (inner); the f64
# host solve of the same problem within 1e-3 of the cost
CAR_COST_MAX, CAR_COST_MIN, CAR_VIOLATION_MAX = 1.907, 0.9, 3e-4
CAR_INNER_COST_MAX, CAR_INNER_VIOLATION_MAX = 1.92, 1e-3
CAR_F64_REL = 1e-3
CAR_STATUSES = (SolveStatus.CONVERGED, SolveStatus.OSCILLATING, SolveStatus.MAX_ITER)
# (N, candidates): the main path's, the JAX test's, one and the most
# candidates, an odd horizon, and ten chunks of the kernel's staging
ROLLOUT_CASES = ((500, 20), (60, 20), (500, 1), (500, 128), (37, 20), (10_000, 20))
# the rollout's chain bound: an FADD's latency on the SM in cycles (4.03
# on an H100 80GB HBM3, tools/rollout_variants.py) at the card's maximum
# SM clock (`nvidia-smi --query-gpu=clocks.max.sm`)
FADD_LATENCY_CYCLES = 4
# f32 operations of one car step of one candidate, a transcendental or a
# square root counting one
CAR_STEP_OPS = 22
CAR_SOLVES_TIMED = 3
# outer steps of the profiled solve: the profiler's post-processing of a
# whole 44-step solve (~100,000 device ops) took 79 s on the H100's host
CAR_PROFILED_STEPS = 10

# The 3DoF arm fleet of benchmarks/bench_arm_admm.py:58-179 through
# ilqr_admm_fleet, at its own size: N = 100, 1,024 instances, |u| <= 2.5
ARM_N = 100
ARM_FLEET = 1024
ARM_U_BOUND = 2.5
ARM_SOLVE = dict(rho_u=1e-2, max_iter=12, max_admm_iter=20, tol=1e-4)
ARM_ALPHAS = 5
ARM_MODES = ("inner", "outer")
# the fleet against single ilqr_admm solves of its first instances: f32
# batched and unbatched reductions may round apart
ARM_COMPARE = 8
ARM_COMPARE_REL = 1e-3
ARM_TIMING_WINDOWS = 3
# The robust arm of tests/test_isls_robust.py:28-200 (the reference
# notebook `3DoF robot/State bounds and robust control bounds`) in f64
ARM_ROBUST_VAR = 0.1
ARM_ROBUST_U = 6.0
ARM_ROBUST_ALPHA = 0.82
ARM_ROBUST_JOINT = 0.958
ARM_MC = 1000
ARM_MC_SEED = 11

# Published peaks of one H100 SXM: f32 outside the tensor cores, dense
# TF32 on the tensor cores, and HBM3
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def bench_problem(device, horizon: int = N, batch: int = BATCH, seed: int = 0):
    """The bench's problem: same cost, f32 dynamics and x0s."""
    plant = DoubleIntegrator(1, 2, dt=1.0 / horizon, dtype=torch.float32)
    d, m = plant.x_dim, plant.u_dim
    zs = np.stack([np.zeros(d), [1.0, 0.0]]).astype(np.float32)
    Qs = np.stack([np.zeros((d, d)), np.eye(d) * 1e3]).astype(np.float32)
    seq = np.zeros(horizon, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m, dtype=torch.float32)
    A, B = plant.AB(horizon)
    rng = np.random.default_rng(seed)
    x0s = torch.tensor(rng.normal(0.0, 0.1, size=(batch, d)), dtype=torch.float32, device=device)
    return A, B, cost, x0s


def soc_sets():
    """The two-SOC chance constraint |du| + psi sigma |phi| <= bound
    (bench_pallas_sls.py:67-75): (soc_A, soc_b_fixed, soc_b_bound)."""
    mu = np.array([1.0, 0.0])
    Au = np.diag(np.sqrt([0.0, SIGMA**2]))
    A_hi = np.concatenate([Au, (-mu / PSI_INV)[None]], 0)
    A_lo = np.concatenate([Au, (mu / PSI_INV)[None]], 0)
    b_fixed = np.zeros(3)
    b_bound = np.array([0.0, 0.0, 1.0 / PSI_INV])
    return [A_hi, A_lo], [b_fixed, b_fixed], [b_bound, b_bound]


def sls_bounds(device, batch: int = SLS_BATCH, seed: int = 0, sort: bool = False):
    """Scenario bounds ~ U(2, 4) (binding: the unconstrained |du| peaks near 4-5)."""
    b = np.random.default_rng(seed).uniform(2.0, 4.0, batch).astype(np.float32)
    return torch.tensor(np.sort(b) if sort else b, device=device)


def sls_solver(device, mode: str, horizon: int = N, **overrides):
    """`make_fused_sls_admm` in one of the bench's kernel configurations."""
    A, B, cost, _ = bench_problem(device, horizon=horizon, batch=1)
    kw = dict(rho_u=SLS_RHO_U, robust_dim=1, n_iters=SLS_ITERS, batch_tile=SLS_TILE,
              device=device)
    if mode == "consensus":
        kw.update(n_cons_iters=SLS_CONS_ITERS, cons_rho=SLS_CONS_RHO)
        sets = soc_sets()
    else:
        kw.update(z_update="diamond", diamond_w=(1.0, C_COEF))
        sets = ((), (), ())
        if mode == "diamond_ee":
            kw.update(stop_tol=SLS_STOP_TOL, check_every=SLS_CHECK_EVERY)
    kw.update(overrides)
    return (A, B, cost), make_fused_sls_admm(A, B, cost, *sets, **kw)


def velocity_box(horizon: int = N, v_max=V_MAX):
    """(x_lower, x_upper) as (N*d,) vectors: position free, |v| <= v_max
    (a scalar or one limit a step)."""
    v = np.broadcast_to(np.asarray(v_max, np.float64), (horizon,))
    inf = np.full(horizon, np.inf)
    return np.stack([-inf, -v], 1).reshape(-1), np.stack([inf, v], 1).reshape(-1)


def box_solver(device, horizon: int = N, **overrides):
    """`make_fused_lqt_admm` with the velocity box (the state-bounded main path)."""
    A, B, cost, _ = bench_problem(device, horizon=horizon, batch=1)
    x_lower, x_upper = velocity_box(horizon)
    kw = dict(u_lower=-U_MAX, u_upper=U_MAX, x_lower=x_lower, x_upper=x_upper, rho_x=RHO_X,
              rho_u=RHO_U, n_iters=BOX_ITERS, batch_tile=BOX_TILE, device=device)
    kw.update(overrides)
    return (A, B, cost), make_fused_lqt_admm(A, B, cost, **kw)


def reset_launch_counts():
    fused_admm.launch_count = 0
    fused_admm.box_launch_count = 0
    fused_sls.launch_count = 0
    fused_riccati.scan_launch_count = 0
    fused_riccati.join_launch_count = 0
    fused_rollout.launch_count = 0


@contextlib.contextmanager
def _swapped(module, **attrs):
    """Sets attributes of a module for the duration of the block."""
    saved = {name: getattr(module, name) for name in attrs}
    for name, value in attrs.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(module, name, value)


def bound(flops: float, nbytes: float, products: bool = False) -> dict:
    """The least time of a kernel's work on an H100: the larger of its f32
    operations over the f32 peak and its bytes (each input read once, each
    output written once) over the HBM rate. products: the operations are
    f32-accurate matrix products, which the tensor cores can also take as
    three TF32 products (3xTF32), so their least time is the smaller of
    the f32 CUDA-core time and 3 flops over the TF32 peak; `bound_ops`
    says which route sets it."""
    ms_ops = 1e3 * flops / PEAK_F32_FLOPS
    route = "f32 CUDA cores"
    if products and 3e3 * flops / PEAK_TF32_FLOPS < ms_ops:
        ms_ops, route = 3e3 * flops / PEAK_TF32_FLOPS, "3xTF32 tensor cores"
    ms_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    return {"bound_ms": max(ms_ops, ms_bytes),
            "bound_by": "operations" if ms_ops >= ms_bytes else "bytes", "bound_ops": route}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_device():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: no CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    print(f"[device] {name}; {torch.cuda.device_count()} card(s); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(card)
    return name, card


def phase_build():
    prebuilt = (_build.build_dir() / _build.LIB_NAME).exists()
    t0 = time.perf_counter()
    _build.load_library()
    seconds = time.perf_counter() - t0
    print(f"[build] {_build.build_dir() / _build.LIB_NAME}: "
          f"{'found prebuilt, loaded' if prebuilt else 'built and loaded'} in {seconds:.2f} s")
    log = _build.build_dir() / "nvcc.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "entry function")):
                print(f"[build] ptxas: {line.strip()}")
    return seconds


def odd_width_case(device):
    """A width that is not a multiple of the kernel's 8-column n-tile
    (Nm = 98, 13 n-tiles: the last one single and masked), the smallest
    tile (16 instances), over-relaxation and a tighter box that binds on
    ~70% of the controls: exercises the padded columns and the alpha != 1
    build. It converges within its 100 iterations, so summation-order
    differences stay near f32 rounding. Returns the solver and its kernel
    inputs."""
    A, B, cost, x0s = bench_problem(device, horizon=98, batch=64, seed=1)
    solver = make_fused_lqt_admm(
        A, B, cost, u_lower=-4.0, u_upper=4.0, rho_u=RHO_U, n_iters=ADMM_ITERS, alpha=1.6,
        batch_tile=16, device=device,
    )
    return solver, solver.kernel_inputs(x0s)


def chunks_run(solve, max_chunks):
    """Main-phase chunks each tile of an early-exit solve ran. solve(k):
    the per-tile outputs (n_tiles, -1) of the solve cut to k chunks. The
    kernels are deterministic, and a tile that leaves after chunk j gives
    the same bits under every schedule of at least j chunks, so it ran the
    fewest chunks k at which a k-chunk solve matches the full one."""
    full = solve(max_chunks)
    chunks = torch.full((full.shape[0],), max_chunks, device=full.device)
    for k in range(max_chunks - 1, 0, -1):
        same = (solve(k) == full).all(dim=1)
        chunks = torch.where(same, k, chunks)
    return chunks


def u_only_tile_iterations(run, kw, batch):
    """Iterations each tile of an early-exit u-only solve ran (its main-
    phase chunks, then the tail). run(**options) -> (x, u, z_u): the kernel
    or its plain version on fixed inputs; kw: the solve's options."""
    chunk_len, n_chunks, n_tail = fused_admm._schedule(
        kw["n_iters"], kw["refresh_every"], kw["polish_iters"], kw["stop_tol"], kw["check_every"])

    def solve(k):
        u = run(**dict(kw, n_iters=k * chunk_len + n_tail))[1]
        return u.reshape(batch // kw["batch_tile"], -1)

    return chunks_run(solve, n_chunks) * chunk_len + n_tail


def _tile_errs(got, want, tile):
    """Each tile's max |got - want| over (x, u, z_u)."""
    return torch.stack([(g - w).abs().reshape(-1, tile * g.shape[1]).amax(dim=1)
                        for g, w in zip(got, want)]).amax(dim=0)


def phase_compare(cases):
    """cases: (label, solver, kernel inputs, extra options). The kernel
    against its plain version with the same tensor-core products (the
    gate, KERNEL_TOL) and against the f32 plain version (KERNEL_TOL x
    max(1, max|u_hat|, max|x_hat|)). In the early-exit mode, also the
    iterations each tile ran in each version: some tiles must leave
    before the fixed schedule; the tolerances hold on the tiles that left
    after the same chunk in both versions, and a tile that left after
    another chunk (its residual, flat near stop_tol, crossed it a chunk or
    more apart) is held to the JAX package's early-exit tolerance,
    SLS_EARLY_EXIT_TOL."""
    worst = 0.0
    for mode, solver, inputs, extra in cases:
        kw = dict(solver.kernel_options, **extra)
        tile, batch = kw["batch_tile"], inputs[0].shape[0]
        runs = {"kernel": lambda **o: admm_u_only(*inputs, solver.packed, **o),
                "3xTF32 plain": lambda **o: admm_u_only_reference(*inputs, **o, products="tf32x3"),
                "f32 plain": lambda **o: admm_u_only_reference(*inputs, **o)}
        got, emulated, want = (run(**kw) for run in runs.values())
        torch.cuda.synchronize()
        for name, g in zip(("x", "u", "z_u"), got):
            check(bool(torch.isfinite(g).all()), f"{mode}: kernel {name} has non-finite values")
        scale = max(1.0, float(want[0].abs().max()), float(want[1].abs().max()))
        errs = {"3xTF32 plain": _tile_errs(got, emulated, tile), "f32 plain": _tile_errs(got, want, tile)}
        tols = {"3xTF32 plain": KERNEL_TOL, "f32 plain": KERNEL_TOL * scale}
        aligned = {name: torch.ones_like(e, dtype=torch.bool) for name, e in errs.items()}
        split = max(float((e - w).abs().max()) for e, w in zip(emulated, want))
        if kw["stop_tol"] > 0.0:
            chunk_len, n_chunks, n_tail = fused_admm._schedule(
                kw["n_iters"], kw["refresh_every"], kw["polish_iters"], kw["stop_tol"],
                kw["check_every"])
            iters = {name: u_only_tile_iterations(run, kw, batch) for name, run in runs.items()}
            full = chunk_len * n_chunks + n_tail
            for name, it in iters.items():
                print(f"[kernel vs plain] {mode}: the {name}'s {it.numel()} tiles ran "
                      f"{int(it.min())}-{int(it.max())} iterations, {float(it.float().mean()):.2f} "
                      f"on average, against {full} in the fixed schedule")
            check(int(iters["kernel"].min()) < full, f"{mode}: no tile left the main phase early")
            for name in errs:
                aligned[name] = iters["kernel"] == iters[name]
                apart = ~aligned[name]
                if bool(apart.any()):
                    gap = int((iters["kernel"] - iters[name])[apart].abs().max())
                    err = float(errs[name][apart].max())
                    print(f"[kernel vs plain] {mode}: {int(apart.sum())} tiles left after another "
                          f"chunk than in the {name} version (up to {gap} iterations apart): max "
                          f"difference {err:.3e} (tolerance {SLS_EARLY_EXIT_TOL:g})")
                    check(err <= SLS_EARLY_EXIT_TOL,
                          f"{mode}: tiles that left apart from the {name} version disagree")
        same = {name: float(e[aligned[name]].max()) if bool(aligned[name].any()) else 0.0
                for name, e in errs.items()}
        worst = max(worst, same["3xTF32 plain"])
        print(f"[kernel vs plain] {mode}: against the 3xTF32 plain version {same['3xTF32 plain']:.3e} "
              f"(tolerance {KERNEL_TOL:g}), against the f32 plain version {same['f32 plain']:.3e} "
              f"(tolerance {tols['f32 plain']:.3g}), max over (x, u, z_u) and the tiles that left "
              f"after the same chunk; 3xTF32 plain vs f32 plain {split:.3e}")
        for name, err in same.items():
            check(err <= tols[name], f"{mode}: kernel disagrees with the {name} version")
    return worst


def phase_main_path(solver, A, B, cost, x0s):
    reset_launch_counts()
    x, u, z_x, z_u = solver(x0s)
    torch.cuda.synchronize()
    launches = fused_admm.launch_count
    print(f"[main path] admm_u_only kernel launches: {launches}")
    check(launches > 0, "the main path did not launch the admm_u_only kernel")
    check(tuple(x.shape) == (BATCH, 2 * N) and tuple(u.shape) == (BATCH, N)
          and tuple(z_u.shape) == (BATCH, N), "unexpected output shapes")
    for name, t in (("x", x), ("u", u), ("z_x", z_x), ("z_u", z_u)):
        check(bool(torch.isfinite(t).all()), f"main path output {name} has non-finite values")
    t0 = time.perf_counter()
    cert = certify(A, B, cost, x0s, u, z_u, -U_MAX, U_MAX)
    print(f"[main path] certificates ({time.perf_counter() - t0:.1f} s): "
          f"max_violation {cert['max_violation']}, converged_frac {cert['converged_frac']}, "
          f"cost_gap median {cert['cost_gap_median']:.3e} max {cert['cost_gap_max']:.3e}")
    failures = gate_failures(cert)
    check(not failures, "; ".join(failures))
    return launches, cert


def _median_iqr(samples):
    q1, med, q3 = np.percentile(np.asarray(samples), [25, 50, 75])
    return float(med), float(q1), float(q3)


def cublas_products(u_base, W_u, n=ADMM_ITERS):
    """n f32 cuBLAS products of the loop's shape, (B x 104) @ (104 x 104)
    with TF32 off: a yardstick of the loop's products, used nowhere in the
    port."""
    nm = -(-u_base.shape[1] // 8) * 8
    s = torch.nn.functional.pad(u_base, (0, nm - u_base.shape[1]))
    W = torch.nn.functional.pad(W_u, (0, nm - W_u.shape[1], 0, nm - W_u.shape[0]))

    def run():
        with full_f32_matmul():
            for _ in range(n):
                torch.matmul(s, W)

    return run


def phase_time(solver, inputs, card):
    """The kernel, its plain version and, as a yardstick the port never
    calls, 100 f32 cuBLAS products of the loop's shape; windows alternate."""
    kw = solver.kernel_options
    yardstick = f"{ADMM_ITERS} f32 cuBLAS products ({BATCH} x 104) @ (104 x 104)"
    timed = _timed({
        "kernel": (lambda: admm_u_only(*inputs, solver.packed, **kw), TIMING_WINDOWS,
                   CALLS_PER_WINDOW),
        "plain": (lambda: admm_u_only_reference(*inputs, **kw), TIMING_WINDOWS, CALLS_PER_WINDOW),
        yardstick: (cublas_products(inputs[0], inputs[2]), TIMING_WINDOWS, CALLS_PER_WINDOW),
    })
    for name, (med, q1, q3, n) in timed.items():
        print(f"[time] {name}: {med:.4f} ms per solve (IQR {q1:.4f}-{q3:.4f}, {n} windows of "
              f"{CALLS_PER_WINDOW}) = {BATCH * ADMM_ITERS / (med * 1e-3):.4g} ADMM iterations/s "
              f"at B={BATCH}, Nm={N}, {ADMM_ITERS} iterations, batch_tile={BATCH_TILE}; "
              f"card: {card}")
    return {name: med for name, (med, *_) in timed.items()}


def box_cases(device, batch: int = BATCH):
    """(label, solver, kernel inputs) of the three kernel-vs-plain cases;
    batch: the full-width case's (the state-box-only case takes at most
    1,024 of it)."""
    _, full = box_solver(device)
    x0s = bench_problem(device, batch=batch)[3]
    # state box only (the u block is off): rho_u is dropped with the bounds;
    # 16 instances a block, so that with the two others the card checks
    # each of the kernel's four builds (16 or 32 instances, alpha = 1 or not)
    _, x_only = box_solver(device, u_lower=None, u_upper=None, rho_u=None, batch_tile=16)
    # Nm = 98 is not a multiple of the kernel's 8-column n-tile; over-
    # relaxation (1.3: at 1.6 the JAX package's relaxed step, whose dual
    # update takes the unrelaxed x_hat, diverges on every state box), a
    # velocity limit that varies along the horizon, and control bounds that
    # vary too
    A, B, cost, x0_odd = bench_problem(device, horizon=98, batch=64, seed=1)
    x_lower, x_upper = velocity_box(98, 1.2 + 0.3 * np.cos(np.linspace(0.0, 3.0, 98)))
    odd = make_fused_lqt_admm(
        A, B, cost, u_lower=np.full(98, -4.0), u_upper=np.linspace(3.0, 5.0, 98),
        x_lower=x_lower, x_upper=x_upper, rho_x=RHO_X, rho_u=RHO_U, n_iters=BOX_ITERS,
        alpha=1.3, batch_tile=32, device=device,
    )
    return [
        (f"full width (batch {batch}, tile {BOX_TILE})", full, full.kernel_inputs(x0s)),
        (f"state box only, |v| <= 1.3 (batch {min(batch, 1024)}, tile 16)", x_only,
         x_only.kernel_inputs(x0s[:1024])),
        ("Nm=98, alpha=1.3, vector bounds (batch 64, tile 32)", odd, odd.kernel_inputs(x0_odd)),
    ]


def phase_box_compare(device):
    """`admm_box` against `admm_box_reference` on the same card inputs: the
    gate is the f32 plain version; the plain version with the kernel's
    3xTF32 products beside it separates the split from the order of the
    sums."""
    worst = 0.0
    for label, solver, inputs in box_cases(device):
        kw = solver.kernel_options
        got = admm_box(*inputs, solver.packed, **kw)
        torch.cuda.synchronize()
        want = admm_box_reference(*inputs, **kw)
        emulated = admm_box_reference(*inputs, **kw, products="tf32x3")
        torch.cuda.synchronize()
        scale = max(1.0, float(want[0].abs().max()), float(want[1].abs().max()))
        errs = {}
        for name, g, w in zip(("x", "u", "z_x", "z_u"), got, want):
            check(bool(torch.isfinite(g).all()), f"box {label}: kernel {name} has non-finite values")
            errs[name] = float((g - w).abs().max())
        err = max(errs.values())
        worst = max(worst, err)
        err3 = max(float((g - e).abs().max()) for g, e in zip(got, emulated))
        split = max(float((e - w).abs().max()) for e, w in zip(emulated, want))
        print(f"[box kernel vs plain] {label}: " + ", ".join(
            f"max|d{k}| {v:.3e}" for k, v in errs.items()) + f" (tolerance {BOX_TOL * scale:.3g}); "
            f"kernel vs 3xTF32 plain {err3:.3e}, 3xTF32 plain vs f32 plain {split:.3e}")
        check(err <= BOX_TOL * scale, f"box {label}: kernel disagrees with plain version")
    return worst


def phase_box_main_path(box, x0s):
    """The state-bounded fleet at full width, through the kernel only,
    certified. box: `box_solver`'s ((A, B, cost), solver)."""
    (A, B, cost), solver = box

    def plain_must_not_run(*args, **kwargs):
        raise SmokeFailure("the state-bounded main path ran admm_box_reference")

    reset_launch_counts()
    with _swapped(fused_admm, admm_box_reference=plain_must_not_run):
        x, u, z_x, z_u = solver(x0s)
        torch.cuda.synchronize()
    launches = fused_admm.box_launch_count
    print(f"[box main path] admm_box kernel launches: {launches}; admm_u_only: "
          f"{fused_admm.launch_count}")
    check(launches == 1, f"the state-bounded main path launched admm_box {launches} times, not 1")
    check(fused_admm.launch_count == 0, "the state-bounded main path launched admm_u_only")
    check(tuple(x.shape) == tuple(z_x.shape) == (BATCH, 2 * N)
          and tuple(u.shape) == tuple(z_u.shape) == (BATCH, N), "unexpected output shapes")
    for name, t in (("x", x), ("u", u), ("z_x", z_x), ("z_u", z_u)):
        check(bool(torch.isfinite(t).all()), f"box main path output {name} has non-finite values")
    x_lower, x_upper = velocity_box()
    t0 = time.perf_counter()
    cert = certify_state_box(A, B, cost, x0s, x, u, z_x, z_u, -U_MAX, U_MAX, x_lower, x_upper)
    print(f"[box main path] certificates ({time.perf_counter() - t0:.1f} s): max_violation "
          f"z_x {cert['max_violation_x']}, z_u {cert['max_violation_u']}; converged_frac "
          f"{cert['converged_frac']} (max ||x - z_x|| {cert['prim_x_max']:.3e}, ||u - z_u|| "
          f"{cert['prim_u_max']:.3e}); oracle |cost gap| median {cert['cost_gap_median']:.3e} "
          f"max {cert['cost_gap_max']:.3e}, state excursion of free + Su z_u "
          f"{cert['state_violation_max']:.3e}, on instances {cert['oracle_indices']} "
          f"(oracle failures: {len(cert['oracle_failures'])})")
    failures = state_box_gate_failures(cert)
    check(not failures, "; ".join(failures))
    return launches, cert


def phase_box_time(device, card):
    """The kernel, the whole forward, the plain version and the plain
    fleet, per solve; windows alternate."""
    (A, B, cost), solver = box_solver(device)
    x0s = bench_problem(device)[3]
    inputs = solver.kernel_inputs(x0s)
    kw = solver.kernel_options
    xb, ub = solver.xb, solver.ub
    fleet = make_batched_lqt_admm(
        A, B, cost, project_x=lambda x: torch.minimum(torch.maximum(x, xb[0]), xb[1]),
        project_u=lambda u: torch.minimum(torch.maximum(u, ub[0]), ub[1]),
        rho_x=RHO_X, rho_u=RHO_U, n_iters=BOX_ITERS, device=device, dtype=torch.float32,
    )
    fleet_u = make_batched_lqt_admm(
        A, B, cost, project_u=lambda u: torch.clamp(u, -U_MAX, U_MAX), rho_u=RHO_U,
        n_iters=ADMM_ITERS, device=device, dtype=torch.float32,
    )
    paths = {
        "kernel": (lambda: admm_box(*inputs, solver.packed, **kw), TIMING_WINDOWS,
                   CALLS_PER_WINDOW),
        "forward": (lambda: solver(x0s), TIMING_WINDOWS, CALLS_PER_WINDOW),
        "plain": (lambda: admm_box_reference(*inputs, **kw), 5, 2),
        "plain fleet": (lambda: fleet(x0s), 5, 2),
        "plain fleet, u-only bench": (lambda: fleet_u(x0s), 5, 2),
    }
    for fn, _, _ in paths.values():  # warm up
        fn()
    torch.cuda.synchronize()
    ms = {name: [] for name in paths}
    for w in range(TIMING_WINDOWS):
        for name, (fn, windows, calls) in paths.items():
            if w < windows:
                ms[name].append(_event_ms(fn, calls))
    result = {}
    for name, samples in ms.items():
        med, q1, q3 = _median_iqr(samples)
        result[name] = med
        iters = ADMM_ITERS if name.endswith("u-only bench") else BOX_ITERS
        print(f"[box time] {name}: {med:.4f} ms per solve (IQR {q1:.4f}-{q3:.4f}, "
              f"{len(samples)} windows) = {BATCH * iters / (med * 1e-3):.4g} ADMM iterations/s "
              f"at B={BATCH}, {iters} iterations; card: {card}")
    return result


def sls_cases(device):
    """(label, solver, bounds) of the SLS kernel-vs-plain cases: the three
    modes at the bench's width and tile; Nm = 98 (13 n-tiles, the last
    single with four padded columns) with over-relaxation; 16-instance
    tiles (two m-tiles a block) in both z-updates; and 2,048 instances,
    more blocks than SMs, so that the pieces are not split over two warps
    (`fused_sls.k_split`): every build of the kernel is checked."""
    cases = [(f"{mode} (batch {SLS_BATCH}, tile {SLS_TILE}"
              f"{', sorted' if mode == 'diamond_ee' else ''})",
              sls_solver(device, mode)[1],
              sls_bounds(device, batch=SLS_BATCH, sort=mode == "diamond_ee"))
             for mode in SLS_MODES]
    cases += [
        ("diamond, Nm=98, alpha=1.6 (batch 64, tile 8)",
         sls_solver(device, "diamond", horizon=98, alpha=1.6)[1], sls_bounds(device, 64, seed=1)),
        (f"diamond_ee (batch {SLS_BATCH}, tile 16, sorted)",
         sls_solver(device, "diamond_ee", batch_tile=16)[1],
         sls_bounds(device, batch=SLS_BATCH, sort=True)),
        ("consensus, Nm=98 (batch 64, tile 16)",
         sls_solver(device, "consensus", horizon=98, batch_tile=16)[1],
         sls_bounds(device, 64, seed=2)),
        ("diamond (batch 2048, tile 8, unsplit)", sls_solver(device, "diamond")[1],
         sls_bounds(device, 2048, seed=3)),
        ("consensus (batch 2048, tile 8, unsplit)", sls_solver(device, "consensus")[1],
         sls_bounds(device, 2048, seed=4)),
    ]
    return cases


def phase_sls_compare(device):
    """`sls_admm` against `sls_admm_reference` on the same card inputs: the
    gate is the plain version with the kernel's 3xTF32 products
    (SLS_FIXED_TOL x max(1, max|U|) on a fixed schedule, SLS_EARLY_EXIT_TOL
    with early exit), the f32 plain version beside it. With early exit,
    also the iterations each tile ran in the kernel and in the 3xTF32
    plain version; some tiles must leave before the fixed schedule."""
    worst = 0.0
    for label, solver, bounds in sls_cases(device):
        kw = solver.kernel_options
        ops = (bounds, solver.U_base, solver.W)
        runs = {"kernel": lambda **o: sls_admm(*ops, solver.packed, **o),
                "3xTF32 plain": lambda **o: sls_admm_reference(*ops, **o, products="tf32x3")}
        got = runs["kernel"](**kw)
        torch.cuda.synchronize()
        emulated = runs["3xTF32 plain"](**kw)
        want = sls_admm_reference(*ops, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"sls {label}: kernel U has non-finite values")
        err = float((got - emulated).abs().max())
        if kw["stop_tol"] > 0.0:
            tol = SLS_EARLY_EXIT_TOL
        else:
            tol = SLS_FIXED_TOL * max(1.0, float(emulated.abs().max()))
        worst = max(worst, err)
        print(f"[sls kernel vs plain] {label}: against the 3xTF32 plain version max|dU| {err:.3e} "
              f"(tolerance {tol:.3g}); against the f32 plain version "
              f"{float((got - want).abs().max()):.3e}; 3xTF32 plain vs f32 plain "
              f"{float((emulated - want).abs().max()):.3e}")
        if kw["stop_tol"] > 0.0:
            full = -(-kw["n_iters"] // kw["check_every"]) * kw["check_every"]
            iters = {name: sls_tile_iterations(run, kw, bounds.shape[0])
                     for name, run in runs.items()}
            for name, it in iters.items():
                print(f"[sls kernel vs plain] {label}: the {name}'s {it.numel()} tiles ran "
                      f"{int(it.min())}-{int(it.max())} iterations, {float(it.float().mean()):.2f} "
                      f"on average, against {full} in the fixed schedule; "
                      f"{int((it != iters['kernel']).sum())} tiles apart from the kernel's")
            check(int(iters["kernel"].min()) < full, f"sls {label}: no tile left early")
        check(err <= tol, f"sls {label}: kernel disagrees with the 3xTF32 plain version")
    return worst


def phase_sls_main_path(sls, bounds):
    """The serving configuration on the sorted bench fleet, certified.
    sls: `sls_solver`'s ((A, B, cost), solver) in the diamond_ee mode."""
    (A, B, cost), solver = sls
    reset_launch_counts()
    du, phi_u, U = solver(bounds)
    torch.cuda.synchronize()
    launches = fused_sls.launch_count
    print(f"[sls main path] sls_admm kernel launches: {launches}")
    check(launches > 0, "the SLS main path did not launch the sls_admm kernel")
    Nm, Nd = N, 2 * N
    check(tuple(du.shape) == (SLS_BATCH, Nm) and tuple(phi_u.shape) == (SLS_BATCH, Nm, Nd)
          and tuple(U.shape) == (SLS_BATCH, Nm, 2), "unexpected SLS output shapes")
    for name, t in (("du", du), ("phi_u", phi_u), ("U", U)):
        check(bool(torch.isfinite(t).all()), f"SLS main path output {name} has non-finite values")
    check(torch.equal(du, U[:, :, 0]) and torch.equal(phi_u[:, :, 0], U[:, :, 1])
          and torch.equal(phi_u[:, :, 1:], solver.PHI_unc[:, 1:].expand(SLS_BATCH, -1, -1)),
          "phi_u is not [U's feedback column | PHI_unc's other columns]")
    t0 = time.perf_counter()
    cert = certify_sls(A, B, cost, bounds, U, C_COEF)
    print(f"[sls main path] certificates ({time.perf_counter() - t0:.1f} s): converged_frac "
          f"{cert['converged_frac']} (||U - P(U)|| < 5e-3; max {cert['prim_max']:.3e}), "
          f"oracle cost gap median {cert['cost_gap_median']:.3e} max {cert['cost_gap_max']:.3e} "
          f"on instances {cert['oracle_indices']}")
    failures = sls_gate_failures(cert)
    check(not failures, "; ".join(failures))
    return launches, cert


def _event_ms(fn, calls):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _graph_ms(fn, windows=TIMING_WINDOWS, calls=CALLS_PER_WINDOW):
    """Device time of one call of fn: `calls` back-to-back calls captured
    in one CUDA graph, replayed under CUDA events, so the host's work a
    call (a wrapper's checks, allocations and ctypes call) drops out.
    Returns (median, q1, q3) in ms over the windows."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    return _median_iqr([_event_ms(graph.replay, 1) / calls for _ in range(windows)])


def sls_cublas_products(solver, batch=SLS_BATCH, n=SLS_ITERS):
    """n f32 cuBLAS products of the SLS loop's shape, (2 batch x Nm) @
    (Nm x Nm) with TF32 off: a yardstick of the loop's products, used
    nowhere in the port."""
    s = solver.U_base.repeat(batch, 1)

    def run():
        with full_f32_matmul():
            for _ in range(n):
                torch.matmul(s, solver.W)

    return run


def phase_sls_time(device, card):
    """Kernel alone, whole forward (kernel + phi_u) and the plain version,
    per mode and batch; windows alternate between the three. Then, as a
    yardstick the port never calls, 200 f32 cuBLAS products of the loop's
    shape at 1,024 instances."""
    result = {}
    for mode in SLS_MODES:
        # the plain consensus loop issues ~4e5 small launches a solve
        plain_windows, plain_calls = (3, 1) if mode == "consensus" else (5, 2)
        _, solver = sls_solver(device, mode)
        for batch in SLS_TIME_BATCHES:
            bounds = sls_bounds(device, batch=batch, sort=mode == "diamond_ee")
            kw = solver.kernel_options
            ops = (bounds, solver.U_base, solver.W)
            paths = {
                "kernel": (lambda: sls_admm(*ops, solver.packed, **kw), TIMING_WINDOWS,
                           CALLS_PER_WINDOW),
                "forward": (lambda: solver(bounds), TIMING_WINDOWS, CALLS_PER_WINDOW),
                "plain": (lambda: sls_admm_reference(*ops, **kw), plain_windows, plain_calls),
            }
            for fn, _, _ in paths.values():  # warm up
                fn()
            torch.cuda.synchronize()
            ms = {name: [] for name in paths}
            for w in range(TIMING_WINDOWS):
                for name, (fn, windows, calls) in paths.items():
                    if w < windows:
                        ms[name].append(_event_ms(fn, calls))
            for name, samples in ms.items():
                med, q1, q3 = _median_iqr(samples)
                result[(mode, batch, name)] = med
                print(f"[sls time] {mode}, batch {batch}, {name}: {med:.4f} ms per solve "
                      f"(IQR {q1:.4f}-{q3:.4f}, {len(samples)} windows) = "
                      f"{batch / (med * 1e-3):.6g} syntheses/s; card: {card}")
    _, solver = sls_solver(device, "diamond")
    Nm = solver.W.shape[0]
    yardstick = f"{SLS_ITERS} f32 cuBLAS products ({2 * SLS_BATCH} x {Nm}) @ ({Nm} x {Nm})"
    med, q1, q3, n = _timed({yardstick: (sls_cublas_products(solver), TIMING_WINDOWS,
                                         CALLS_PER_WINDOW)})[yardstick]
    print(f"[sls time] {yardstick}: {med:.4f} ms (IQR {q1:.4f}-{q3:.4f}, {n} windows); "
          f"card: {card}")
    return result


# ---- the time-parallel Riccati ---------------------------------------------


def riccati_problem(device, horizon: int = RICCATI_N, d: int = 4, regularized: bool = False,
                    seed: int = 0):
    """bench_parallel_riccati.py's problem on the n-th order integrator of
    state dim d (d = 4: the 2-D double integrator; d = 3: the 1-D triple,
    d = 2: the 1-D double, d = 1: the 1-D single integrator), f32. Returns
    ((A, B, Q, xd, R), regularizers, x0)."""
    A1, B1 = get_double_integrator_AB(2, 2, dt=0.01) if d == 4 else \
        get_double_integrator_AB(1, d, dt=0.01)
    m = B1.shape[1]
    f32 = dict(dtype=torch.float32, device=device)
    A = A1.to(**f32).expand(horizon, d, d).contiguous()
    B = B1.to(**f32).expand(horizon, d, m).contiguous()
    Q = (1e2 * torch.eye(d, **f32)).expand(horizon, d, d).contiguous()
    R = (1e-2 * torch.eye(m, **f32)).expand(horizon, m, m).contiguous()
    xd = torch.zeros((horizon, d), **f32)
    xd[-1, 0] = 1.0
    rng = np.random.default_rng(seed)
    reg = {}
    if regularized:
        reg = dict(Qr=(0.4 * torch.eye(d, **f32)).expand(horizon, d, d).contiguous(),
                   xr=torch.tensor(rng.normal(size=(horizon, d)), **f32),
                   Rr=(0.2 * torch.eye(m, **f32)).expand(horizon, m, m).contiguous(),
                   ur=torch.tensor(rng.normal(size=(horizon, m)), **f32))
    x0 = torch.tensor(np.random.default_rng(0).normal(0.0, 0.1, size=d), **f32)
    return (A, B, Q, xd, R), reg, x0


def riccati_slabs(device, horizon, nb, d=4, regularized=False):
    """The packed (L, rows, nb) element slabs the scan kernel takes."""
    data, reg, _ = riccati_problem(device, horizon, d, regularized)
    elems, _, _ = value_elements(*data, **reg, fast_inverse=True)
    return pack_elements(elems, horizon, d, nb)


def _max_errs(got, want):
    """(max abs difference, max of it over max(1, max|ref|)) over components."""
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel = max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
              for g, w in zip(got, want))
    return abs_err, rel


def phase_riccati_compare(device):
    """Each Riccati kernel against its plain version in the kernel's order
    on the same card inputs; beside it the distance to the plain version
    in the other order (the sequential scan, the JAX package's level 2)."""
    worst = {k: 0.0 for k in RICCATI_KERNELS}
    for horizon, nb, d, regularized in RICCATI_CASES:
        slabs = riccati_slabs(device, horizon, nb, d, regularized)
        r = riccati_scan(*slabs)
        torch.cuda.synchronize()
        out = riccati_join(*r, horizon)
        torch.cuda.synchronize()
        for t in (*r, *out):
            check(bool(torch.isfinite(t).all()), f"riccati N={horizon}: non-finite kernel output")
        errs = {
            "riccati_scan": _max_errs(r, riccati_scan_reference(*slabs, chunks=SCAN_CHUNKS)),
            "riccati_join": _max_errs(out, riccati_join_reference(*r, horizon, order=JOIN_GROUP)),
        }
        sequential = _max_errs(r, riccati_scan_reference(*slabs))
        jax_order = _max_errs(out, riccati_join_reference(*r, horizon))
        label = (f"N={horizon}, nb={nb}, d={d}" + (", Qr/xr/Rr/ur" if regularized else ""))
        print(f"[riccati kernel vs plain] {label}: " + ", ".join(
            f"{k} max abs {a:.3e} (scaled {s:.3e})" for k, (a, s) in errs.items())
            + f"; tolerance {RICCATI_KERNEL_TOL:g} x max(1, max|ref|); riccati_scan against the "
            f"sequential plain version max abs {sequential[0]:.3e} (scaled {sequential[1]:.3e}), "
            f"riccati_join against the JAX-order level 2 max abs {jax_order[0]:.3e} (scaled "
            f"{jax_order[1]:.3e})")
        for k, (abs_err, scaled) in errs.items():
            worst[k] = max(worst[k], abs_err)
            check(scaled <= RICCATI_KERNEL_TOL, f"{k} at {label}: kernel disagrees with plain")
    return worst


def phase_riccati_main_path(device):
    """One N = 10,000 backward pass through the kernels only, certified."""
    data, _, x0 = riccati_problem(device)

    def plain_must_not_run(*args, **kwargs):
        raise SmokeFailure("the Riccati main path ran a plain version of a kernel")

    reset_launch_counts()
    with _swapped(fused_riccati, **{f"{k}_reference": plain_must_not_run for k in RICCATI_KERNELS}):
        gains = lqt_backward_parallel_fused(*data, nb=RICCATI_NB, device=device)
        torch.cuda.synchronize()
    launches = {"riccati_scan": fused_riccati.scan_launch_count,
                "riccati_join": fused_riccati.join_launch_count}
    print(f"[riccati main path] N={RICCATI_N}, nb={RICCATI_NB}: kernel launches {launches}")
    check(all(v == 1 for v in launches.values()),
          f"the Riccati main path did not launch each kernel once: {launches}")
    d, m = data[0].shape[-1], data[1].shape[-1]
    check(tuple(gains.K.shape) == (RICCATI_N, m, d) and tuple(gains.k.shape) == (RICCATI_N, m),
          "unexpected gain shapes")
    t0 = time.perf_counter()
    cert = certify_riccati(*data, gains, x0)
    print(f"[riccati main path] certificates ({time.perf_counter() - t0:.1f} s) against the f64 "
          f"sequential pass: max|K - K*|/max|K*| {cert['K_rel']:.3e} (gate 5e-5), max|k - k*| "
          f"{cert['k_max_err']:.3e} (ratio to atol = rtol = 2e-4: {cert['k_ratio']:.3g}), "
          f"max|Quu - Quu*| {cert['Quu_max_err']:.3e} (ratio to 1e-4: {cert['Quu_ratio']:.3g}), "
          f"closed-loop cost {cert['cost']:.9g} vs {cert['cost_star']:.9g} "
          f"(relative {cert['cost_rel']:.3e}, gate 1e-4)")
    failures = riccati_gate_failures(cert)
    check(not failures, "; ".join(failures))
    return launches, cert


def combine_flops(d: int, join: bool = False) -> int:
    """f32 operations of one combine as csrc/riccati_scan.cu computes it
    (an FMA counts two); join=True: only the (eta, J) part."""
    mm, mv = d * d * (2 * d - 1), d * (2 * d - 1)
    minor = {1: 0, 2: 0, 3: 3, 4: 14}[d]
    inv = 1 if d == 1 else 4 * d * d + d * d * minor + 2 * d + 1
    if join:
        return 4 * mm + 2 * mv + d * d + 3 * d + inv
    return 8 * mm + 4 * mv + 2 * d * d + 5 * d + inv


def riccati_bounds(slabs, r, out):
    """Bounds of the two kernels on these inputs. The join's work is the
    nb - 1 combines a sequential level-2 suffix needs and one join an
    element; the prologue its blocks repeat is not counted."""
    d, nb = slabs[1].shape[1], slabs[0].shape[2]
    n_elems = slabs[0].shape[0] * nb
    return {
        "riccati_scan": bound(n_elems * combine_flops(d), nbytes(*slabs, *r)),
        "riccati_join": bound((nb - 1) * combine_flops(d)
                              + n_elems * combine_flops(d, join=True), nbytes(*r, *out)),
    }


def _timed(paths, windows=TIMING_WINDOWS):
    """paths: name -> (fn, windows, calls); windows alternate between paths.
    Returns name -> (median, q1, q3, number of windows) in ms a call. Paths
    timed one call a window are not warmed up: each of their windows is
    a whole slow call, and the median drops a first-call outlier."""
    for fn, _, calls in paths.values():
        if calls > 1:
            fn()
    torch.cuda.synchronize()
    ms = {name: [] for name in paths}
    for w in range(windows):
        for name, (fn, n_windows, calls) in paths.items():
            if w < n_windows:
                ms[name].append(_event_ms(fn, calls))
    return {name: (*_median_iqr(v), len(v)) for name, v in ms.items()}


def plain_backward(*data, nb, device):
    """`lqt_backward_parallel_fused` with its two wrappers swapped for
    their plain versions: the yardstick of the kernels on the card."""
    with _swapped(fused_riccati, **{k: getattr(fused_riccati, f"{k}_reference")
                                    for k in RICCATI_KERNELS}):
        return lqt_backward_parallel_fused(*data, nb=nb, device=device)


def riccati_kernel_calls(slabs, horizon):
    """name -> (kernel call, plain call) of the two kernels on these slabs
    (the plain versions in the kernels' orders), and the outputs (r, out)
    of one kernel pass."""
    r = riccati_scan(*slabs)
    out = riccati_join(*r, horizon)
    calls = {"riccati_scan": (lambda: riccati_scan(*slabs),
                              lambda: riccati_scan_reference(*slabs, chunks=SCAN_CHUNKS)),
             "riccati_join": (lambda: riccati_join(*r, horizon),
                              lambda: riccati_join_reference(*r, horizon, order=JOIN_GROUP))}
    return calls, (r, out)


def phase_riccati_time(device, card):
    """Kernels (device time from a CUDA graph, and the wrapper's time a
    call), their plain versions, the whole backward pass and its plain
    version, the plain torch scans and the sequential pass at each
    horizon; then the nb sweep and the rollouts."""
    result = {}
    for horizon in RICCATI_HORIZONS:
        data, _, _ = riccati_problem(device, horizon)
        slabs = riccati_slabs(device, horizon, RICCATI_NB)
        calls, (r, out) = riccati_kernel_calls(slabs, horizon)
        long = horizon >= 10_000
        paths = {}
        for kname, (kernel, plain) in calls.items():
            paths[f"{kname} wrapper"] = (kernel, TIMING_WINDOWS, CALLS_PER_WINDOW)
            paths[f"{kname} plain"] = (plain, *RICCATI_PLAIN)
        paths.update({
            "fused forward": (lambda: lqt_backward_parallel_fused(*data, nb=RICCATI_NB,
                                                                  device=device),
                              TIMING_WINDOWS, CALLS_PER_WINDOW),
            "fused forward, plain versions": (
                lambda: plain_backward(*data, nb=RICCATI_NB, device=device), *RICCATI_PLAIN),
            "lqt_backward_parallel(block_size=128, fast_inverse=True)": (
                lambda: lqt_backward_parallel(*data, block_size=128, fast_inverse=True),
                *RICCATI_PLAIN),
            "lqt_backward (sequential)": (lambda: lqt_backward(*data), 1 if long else 3, 1),
        })
        if not long:  # the flat scan is left out at 10k, as in the JAX bench
            paths["lqt_backward_parallel(block_size=None)"] = (
                lambda: lqt_backward_parallel(*data), *RICCATI_PLAIN)
        timed = _timed(paths)
        for kname, (kernel, _) in calls.items():
            timed[f"{kname} kernel"] = (*_graph_ms(kernel), TIMING_WINDOWS)
        for name, (med, q1, q3, n) in timed.items():
            result[(horizon, name)] = med
            how = "CUDA graph of 10 calls" if name.endswith(" kernel") else "CUDA events"
            print(f"[riccati time] N={horizon}, nb={RICCATI_NB}, {name}: {med:.4f} ms "
                  f"(IQR {q1:.4f}-{q3:.4f}, {n} windows, {how}); card: {card}")
        if long:
            result["bounds"] = riccati_bounds(slabs, r, out)
            device_ms = sum(result[(horizon, f"{k} kernel")] for k in calls)
            wrapper_ms = sum(result[(horizon, f"{k} wrapper")] for k in calls)
            print(f"[riccati split] N={horizon}, nb={RICCATI_NB}: of a "
                  f"{result[(horizon, 'fused forward')]:.4f} ms pass, the two wrapper calls "
                  f"take {wrapper_ms:.4f} ms back to back (host-bound: checks, allocations, "
                  f"ctypes), their kernels {device_ms:.4f} ms of device time; card: {card}")
    for nb in RICCATI_NB_SWEEP:
        data, _, _ = riccati_problem(device)
        calls, _ = riccati_kernel_calls(riccati_slabs(device, RICCATI_N, nb), RICCATI_N)
        timed = {f"{kname} device": _graph_ms(kernel)[0] for kname, (kernel, _) in calls.items()}
        timed["fused forward"] = _timed({"fused forward": (
            lambda: lqt_backward_parallel_fused(*data, nb=nb, device=device),
            TIMING_WINDOWS, CALLS_PER_WINDOW)})["fused forward"][0]
        print(f"[riccati nb sweep] N={RICCATI_N}, nb={nb} (L={-(-RICCATI_N // nb)}): " + ", ".join(
            f"{name} {med:.4f} ms" for name, med in timed.items()) + f"; card: {card}")
    data, _, x0 = riccati_problem(device)
    gains = lqt_backward_parallel_fused(*data, nb=RICCATI_NB, device=device)
    A, B = data[0], data[1]
    step = iter(())

    def plant(x, u):
        t = next(step)
        return A[t] @ x + B[t] @ u

    def sequential():
        nonlocal step
        step = iter(range(A.shape[0]))
        return rollout_closed_loop(plant, x0, gains.K, gains.k)

    paths = {"rollout_closed_loop_parallel": (
                 lambda: rollout_closed_loop_parallel(A, B, gains.K, gains.k, x0),
                 TIMING_WINDOWS, CALLS_PER_WINDOW),
             "rollout_closed_loop (sequential)": (sequential, 1, 1)}
    for name, (med, q1, q3, n) in _timed(paths).items():
        print(f"[riccati rollout time] N={RICCATI_N}, {name}: {med:.4f} ms (IQR {q1:.4f}-{q3:.4f}, "
              f"{n} windows); card: {card}")
    return result


def phase_riccati_profile(device, card):
    """Device time of back-to-back N = 10,000 backward passes under
    `torch.profiler`: the kernels' share, everything else the card ran
    (the plain torch around the kernels), and the idle share of the wall
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    data, _, _ = riccati_problem(device)

    def forward():
        return lqt_backward_parallel_fused(*data, nb=RICCATI_NB, device=device)

    for _ in range(3):
        forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(RICCATI_PROFILED_CALLS):
            forward()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    on_device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in on_device)
    if busy_us <= 0.0:
        print("[riccati profile] the profiler saw no device time: not measured")
        return None
    ours = {e.key: e.self_device_time_total / RICCATI_PROFILED_CALLS for e in on_device
            if "riccati_" in e.key}
    n = RICCATI_PROFILED_CALLS
    kernel_us = sum(ours.values())
    print(f"[riccati profile] {n} backward passes, N={RICCATI_N}, nb={RICCATI_NB}: wall "
          f"{wall_us / n / 1e3:.4f} ms a pass; device busy {busy_us / n / 1e3:.4f} ms "
          f"({100 * busy_us / wall_us:.2f}% of wall), of which the two kernels "
          f"{kernel_us / 1e3:.4f} ms and {len(on_device) - len(ours)} other kernels "
          f"{(busy_us / n - kernel_us) / 1e3:.4f} ms; card: {card}")
    for key, us in sorted(ours.items()):
        print(f"[riccati profile] device time a pass: {us / 1e3:.4f} ms {key[:90]}")
    return {"busy_share": busy_us / wall_us, "kernel_ms": kernel_us / 1e3}


def sls_tile_iterations(run, kw, batch):
    """Iterations each tile of an early-exit SLS solve ran (`chunks_run`).
    run(**options) -> U: the kernel or its plain version on fixed bounds;
    kw: the solve's options."""
    every, tile = kw["check_every"], kw["batch_tile"]
    max_chunks = -(-kw["n_iters"] // every)

    def solve(k):
        n_iters = kw["n_iters"] if k == max_chunks else k * every
        return run(**dict(kw, n_iters=n_iters)).reshape(batch // tile, -1)

    return chunks_run(solve, max_chunks) * every


def existing_bounds(solver, inputs, box, x0s, sls, sls_fleet):
    """Bounds of the fleet kernels on their main paths' inputs: products
    only (the clips and dual updates are O(1) a coordinate against O(Nm)
    or more multiply-adds a coordinate), on the f32 CUDA cores or as
    3xTF32 on the tensor cores, whichever is faster; bytes of inputs and
    outputs.
    box and sls: the state-bounded and diamond_ee solvers of the main
    paths; sls_fleet: the bounds that path solved."""
    ko = solver.kernel_options
    chunk_len, n_chunks, n_tail = fused_admm._schedule(
        ko["n_iters"], ko["refresh_every"], ko["polish_iters"], ko["stop_tol"], ko["check_every"])
    iters = chunk_len * n_chunks + n_tail
    u_base, x_base = inputs[:2]
    Nm, Nd = u_base.shape[1], x_base.shape[1]
    u_only = bound(iters * 2 * BATCH * Nm * Nm + 2 * BATCH * Nm * Nd,
                   nbytes(*inputs) + nbytes(x_base, u_base, u_base), products=True)
    free, bu, u0, W_s, SuT, xb, ub = box.kernel_inputs(x0s)
    nnz = int(torch.count_nonzero(W_s)) + int(torch.count_nonzero(SuT))
    box_bound = bound(2 * BATCH * (BOX_ITERS * nnz + int(torch.count_nonzero(SuT))),
                      nbytes(free, bu, u0, *box.packed, xb, ub) + 2 * nbytes(free, bu),
                      products=True)
    kw = sls.kernel_options
    tile_iters = sls_tile_iterations(
        lambda **o: sls_admm(sls_fleet, sls.U_base, sls.W, sls.packed, **o), kw, SLS_BATCH)
    instance_iters = int(tile_iters.sum()) * kw["batch_tile"]
    print(f"[sls bound] diamond_ee tiles ran {int(tile_iters.min())}-{int(tile_iters.max())} "
          f"iterations, {instance_iters / SLS_BATCH:.2f} an instance on average")
    p1, sNm = sls.U_base.shape
    sls_bound = bound(instance_iters * 2 * p1 * sNm * sNm,
                      nbytes(sls_fleet, sls.U_base, sls.W) + 4 * SLS_BATCH * sNm * p1,
                      products=True)
    # one tile's iterations run on one SM: the slowest tile's, as 3xTF32
    # on the kernel's padded tile, at one SM's share of the TF32 peak
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_pad = 8 * -(-sNm // 8)
    tile_flop = 3 * 2 * (p1 * kw["batch_tile"]) * n_pad * n_pad
    floor_ms = 1e3 * int(tile_iters.max()) * tile_flop / (PEAK_TF32_FLOPS / sms)
    print(f"[sls bound] per-SM floor of the tiling: the slowest tile's {int(tile_iters.max())} "
          f"iterations x {tile_flop:.4g} TF32 FLOP (3 x 2 x {p1 * kw['batch_tile']} x {n_pad} x "
          f"{n_pad}) at 1/{sms} of {PEAK_TF32_FLOPS / 1e12:g} TFLOP/s: {floor_ms:.4f} ms; the "
          f"card-wide bound {sls_bound['bound_ms']:.4f} ms")
    return {"admm_u_only": u_only, "admm_box": box_bound, "sls_admm": sls_bound}


# ---- the control-limited car through ilqr_admm -----------------------------


def car_problem(device, dtype=torch.float32, n_alphas=CAR_ALPHAS, seed=0):
    """run_all.py's car: the plant, the parking cost, x_nom0 (the open-loop
    rollout of u0 ~ 0.1 N(0, 1) from default_rng(seed)), u0, the clip
    projection and the alpha grid, on `device` in `dtype`."""
    kw = dict(dtype=dtype, device=device)
    car = CarFrontWheel(dt=15.0 / CAR_N)
    cost = CarParkingCost(**kw)
    u0 = torch.tensor(np.random.default_rng(seed).normal(size=(CAR_N, 2)) * 0.1, **kw)
    x_nom0 = rollout_nonlinear(car.step, torch.tensor(CAR_X0, **kw), u0)
    lo, hi = torch.tensor(CAR_U_LO, **kw), torch.tensor(CAR_U_HI, **kw)

    def project_u(u):
        return torch.minimum(torch.maximum(u.reshape(CAR_N, 2), lo), hi).reshape(-1)

    alphas = (10.0 ** torch.linspace(0.0, -5.0, 50, **kw))[:n_alphas]
    return car, cost, x_nom0, u0, project_u, alphas


def car_solve(device, dtype=torch.float32, fused=True, config=CAR_SOLVE, n_alphas=CAR_ALPHAS,
              seed=0):
    """One ilqr_admm solve of the car; fused: the line-search rollout is
    the kernel (else the default vmapped plain rollout)."""
    car, cost, x_nom0, u0, project_u, alphas = car_problem(device, dtype, n_alphas, seed)
    kw = dict(config, get_Cs=cost.get_Cs, project_u=project_u, alphas=alphas,
              rho_u=torch.diag(torch.tensor(CAR_RHO_U, dtype=dtype, device=device)),
              device=device)
    if fused:
        kw["linesearch_rollout"] = make_fused_linesearch_rollout(car, CAR_N, 4, 2, n_alphas,
                                                                 device=device)
    return ilqr_admm(car.step, car.get_AB, cost, x_nom0, u0, **kw)


def car_violation(u_nom) -> float:
    u = u_nom.double().cpu()
    lo, hi = torch.tensor(CAR_U_LO, dtype=torch.float64), torch.tensor(CAR_U_HI, dtype=torch.float64)
    return float(torch.clamp(torch.maximum(u - hi, lo - u), min=0.0).max())


def rollout_case(device, horizon, n_cands, nan=False, seed=0):
    """(car, x0, u_cands) for the kernel: alphas x a random step, N(0, 0.1^2);
    nan: the first three candidates steer at 1.5 rad with a large
    acceleration, so that their asin argument leaves [-1, 1]."""
    f32 = dict(dtype=torch.float32, device=device)
    delta = np.random.default_rng(seed).normal(size=(horizon, 2)) * 0.1
    alphas = 10.0 ** np.linspace(0.0, -5.0, max(50, n_cands))[:n_cands]
    u = torch.tensor(alphas[:, None, None] * delta[None], **f32)
    if nan:
        u[:3, :, 0], u[:3, :, 1] = 1.5, 40.0
    return CarFrontWheel(dt=15.0 / horizon), torch.tensor(CAR_X0, **f32), u.contiguous()


def phase_car_compare(device):
    """`linesearch_rollout` against `linesearch_rollout_reference` on the
    same card inputs: they run the same f32 operations in the same order
    (no FMA contraction, the same libdevice transcendentals), so they must
    agree bit for bit, NaN positions included."""
    worst = 0.0
    cases = [(n, a, False) for n, a in ROLLOUT_CASES] + [(CAR_N, CAR_ALPHAS, True)]
    for horizon, n_cands, nan in cases:
        car, x0, u = rollout_case(device, horizon, n_cands, nan)
        got = linesearch_rollout(car, x0, u)
        torch.cuda.synchronize()
        want = linesearch_rollout_reference(car.step_cols, x0, u)
        torch.cuda.synchronize()
        label = f"N={horizon}, A={n_cands}" + (", NaN candidates" if nan else "")
        check(tuple(got.shape) == (n_cands, horizon, 4), f"rollout {label}: shape {got.shape}")
        check(torch.equal(torch.isnan(got), torch.isnan(want)), f"rollout {label}: NaN positions differ")
        check(torch.equal(got[:, 0], x0.expand(n_cands, 4)), f"rollout {label}: xs[:, 0] != x0")
        fin = torch.isfinite(want)
        n_nan = int((~fin).sum())
        check(n_nan > 0 if nan else n_nan == 0, f"rollout {label}: {n_nan} non-finite states")
        err = float((got - want)[fin].abs().max())
        same = torch.equal(torch.nan_to_num(got, nan=7.0), torch.nan_to_num(want, nan=7.0))
        worst = max(worst, err)
        print(f"[car kernel vs plain] {label}: max|dxs| {err:.3e} over finite states; "
              f"bit-identical {same}; NaN states {n_nan}")
        check(same, f"rollout {label}: kernel and plain version are not bit-identical")
    return worst


def _car_gates(res, label, cost_max, violation_max):
    """Shapes, finiteness, status and the cost and bound gates of a solve."""
    cost, viol = float(res.cost), car_violation(res.u_nom)
    check(tuple(res.x_nom.shape) == (CAR_N, 4) and tuple(res.u_nom.shape) == (CAR_N, 2),
          f"{label}: unexpected shapes")
    check(bool(torch.isfinite(res.x_nom).all() and torch.isfinite(res.u_nom).all()),
          f"{label}: non-finite trajectory")
    check(res.status in CAR_STATUSES, f"{label}: status {SolveStatus(res.status).name}")
    check(CAR_COST_MIN < cost <= cost_max, f"{label}: cost {cost} outside ({CAR_COST_MIN}, {cost_max}]")
    check(viol <= violation_max, f"{label}: bound violation {viol:.3e} > {violation_max}")
    return cost, viol


def phase_car_main_path(device):
    """The outer-mode solve through the kernel only: one launch an outer
    step, the gates of tests/test_ilqr_admm.py."""

    def plain_must_not_run(*args, **kwargs):
        raise SmokeFailure("the car main path ran linesearch_rollout_reference")

    reset_launch_counts()
    syncs0 = admm_solver.host_sync_count
    t0 = time.perf_counter()
    with _swapped(fused_rollout, linesearch_rollout_reference=plain_must_not_run):
        res = car_solve(device)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fused_rollout.launch_count
    syncs = admm_solver.host_sync_count - syncs0
    cost, viol = _car_gates(res, "car main path", CAR_COST_MAX, CAR_VIOLATION_MAX)
    print(f"[car main path] outer-mode solve: cost {cost:.6f} (gate <= {CAR_COST_MAX}; JAX on the "
          f"TPU 1.9055, reference 1.903), max bound violation {viol:.3e} (gate {CAR_VIOLATION_MAX}), "
          f"{res.outer_iters} outer steps, status {SolveStatus(res.status).name}, "
          f"{seconds:.2f} s with the build loaded; linesearch_rollout launches {launches}; "
          f"host reads of stop flags {syncs}")
    check(launches == res.outer_iters,
          f"linesearch_rollout launched {launches} times in {res.outer_iters} outer steps")
    return launches, res


def phase_car_host_f64(main):
    """The same problem solved by the port in f64 on the host CPU with the
    plain vmapped rollout: the f32 card solve must be within 1e-3 of it."""
    t0 = time.perf_counter()
    ref = car_solve("cpu", torch.float64, fused=False)
    seconds = time.perf_counter() - t0
    cost, viol = _car_gates(ref, "car f64 host solve", CAR_COST_MAX, CAR_VIOLATION_MAX)
    rel = abs(float(main.cost) - cost) / cost
    print(f"[car f64 host] cost {cost:.6f}, violation {viol:.3e}, {ref.outer_iters} outer steps, "
          f"status {SolveStatus(ref.status).name}, {seconds:.1f} s on the host; card f32 cost "
          f"{float(main.cost):.6f}, |dcost|/cost {rel:.3e} (gate {CAR_F64_REL:g})")
    check(rel <= CAR_F64_REL, f"card f32 cost differs from the f64 host solve by {rel:.3e}")
    return ref


def phase_car_inner(device):
    """The inner-line-search configuration through the kernel: a rollout
    in each ADMM iteration."""
    reset_launch_counts()
    t0 = time.perf_counter()
    res = car_solve(device, config=CAR_INNER, n_alphas=CAR_INNER_ALPHAS, seed=CAR_INNER_SEED)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fused_rollout.launch_count
    cost, viol = _car_gates(res, "car inner mode", CAR_INNER_COST_MAX, CAR_INNER_VIOLATION_MAX)
    most = CAR_INNER["max_admm_iter"] * res.outer_iters
    print(f"[car inner mode] cost {cost:.6f} (gate < {CAR_INNER_COST_MAX}), violation {viol:.3e} "
          f"(gate {CAR_INNER_VIOLATION_MAX}), {res.outer_iters} outer steps, status "
          f"{SolveStatus(res.status).name}, {seconds:.2f} s; linesearch_rollout launches "
          f"{launches} (between {res.outer_iters} and {most})")
    check(res.outer_iters <= launches <= most, f"inner mode launched the kernel {launches} times")
    return launches, res


def max_sm_clock_hz() -> float:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return 1e6 * float(smi.stdout.split()[0])


def car_bound(x0, u, xs, sm_clock_hz):
    """The larger of: bytes of x0, the candidates and the trajectories
    once each; the step's operations for every candidate and step; and
    the dependency chain, N - 1 f32 additions in a row (each state's
    component at t + 1 needs the one at t) at an FADD's latency and the
    card's maximum SM clock. The chain is a bound of operations, so it is
    reported as one, with `bound_ops` naming it."""
    n_cands, horizon = u.shape[0], u.shape[1]
    result = bound(CAR_STEP_OPS * n_cands * horizon, nbytes(x0, u, xs))
    chain_ms = 1e3 * (horizon - 1) * FADD_LATENCY_CYCLES / sm_clock_hz
    if chain_ms > result["bound_ms"]:
        result.update(bound_ms=chain_ms, bound_by="operations", bound_ops=(
            f"dependency chain: {horizon - 1} FADD at {FADD_LATENCY_CYCLES} cycles, "
            f"{sm_clock_hz / 1e6:.0f} MHz"))
    return result


def phase_car_time(device, card):
    """The kernel (device time from a CUDA graph of 10 wrapper calls, and
    the wrapper's event time), its plain version, and the whole solve."""
    car, x0, u = rollout_case(device, CAR_N, CAR_ALPHAS)
    kernel = (lambda: linesearch_rollout(car, x0, u))
    plain = (lambda: linesearch_rollout_reference(car.step_cols, x0, u))
    timed = _timed({"wrapper": (kernel, TIMING_WINDOWS, CALLS_PER_WINDOW),
                    "plain": (plain, 3, 1)})
    timed["kernel"] = (*_graph_ms(kernel), TIMING_WINDOWS)
    # the yardstick of the TPU's own comparison (the kernel against the XLA
    # scan): the plain version's ~10,000 launches replayed as one CUDA graph
    timed["plain, CUDA graph"] = (*_graph_ms(plain, calls=1), TIMING_WINDOWS)
    for name, (med, q1, q3, n) in timed.items():
        how = {"kernel": "CUDA graph of 10 calls", "plain, CUDA graph": "CUDA graph of 1 call"}
        print(f"[car time] linesearch_rollout {name}: {med:.4f} ms (IQR {q1:.4f}-{q3:.4f}, "
              f"{n} windows, {how.get(name, 'CUDA events')}) at N={CAR_N}, A={CAR_ALPHAS}; "
              f"card: {card}")
    car_solve(device)  # warm-up
    torch.cuda.synchronize()
    solves = []
    for _ in range(CAR_SOLVES_TIMED):
        t0 = time.perf_counter()
        res = car_solve(device)
        torch.cuda.synchronize()
        solves.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(solves))
    print(f"[car time] whole outer-mode solve: median {med:.1f} ms of {CAR_SOLVES_TIMED} "
          f"({', '.join(f'{t:.1f}' for t in solves)}), {res.outer_iters} outer steps = "
          f"{med / res.outer_iters:.2f} ms an outer step; card: {card}")
    xs = linesearch_rollout(car, x0, u)
    return {"kernel": timed["kernel"][0], "wrapper": timed["wrapper"][0],
            "plain": timed["plain"][0], "solve_ms": med,
            "bound": car_bound(x0, u, xs, max_sm_clock_hz())}


def phase_car_profile(device, card):
    """The first CAR_PROFILED_STEPS outer steps of the main path's solve
    under `torch.profiler`: device busy share of the wall time, the top
    device ops, and the host syncs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    config = dict(CAR_SOLVE, max_iter=CAR_PROFILED_STEPS)
    car_solve(device, config=config)
    torch.cuda.synchronize()
    syncs0 = admm_solver.host_sync_count
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = car_solve(device, config=config)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    flag_reads = admm_solver.host_sync_count - syncs0
    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in on_device)
    waits = {e.key: e.count for e in events
             if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "aten::_local_scalar_dense",
                          "aten::item", "cudaMemcpyAsync")}
    print(f"[car profile] the solve's first {res.outer_iters} outer steps: wall {wall_us / 1e3:.1f} ms "
          f"under the profiler; host reads of stop flags {flag_reads}; host-side sync and copy "
          f"calls {waits}; card: {card}")
    if busy_us <= 0.0:
        print("[car profile] the profiler saw no device time: not measured")
        return None
    print(f"[car profile] device busy {busy_us / 1e3:.1f} ms = {100 * busy_us / wall_us:.2f}% of "
          f"the wall time; {sum(e.count for e in on_device)} device ops of {len(on_device)} kinds")
    for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[car profile] {e.self_device_time_total / 1e3:9.3f} ms, {e.count:6d} calls: "
              f"{e.key[:90]}")
    return {"busy_share": busy_us / wall_us}

def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def arm_cost(device, dtype, x_std, ee_target, ee_weight):
    """The via-point cost of the arm benches: at the last step zero joint
    velocity (weight x_std) and the end effector at ee_target (x, y) with
    weights ee_weight; u_std = 1e-4."""
    d, n = 9, 3
    kw = dict(dtype=dtype, device=device)
    target = torch.tensor([0.0] * 2 * n + list(ee_target) + [0.0], **kw)
    w = torch.tensor([0.0] * n + [x_std] * n + list(ee_weight) + [0.0], **kw)
    seq = np.zeros(ARM_N, dtype=np.int32)
    seq[-1] = 1
    return viapoint_cost(torch.stack([torch.zeros(d, **kw), target]),
                         torch.stack([torch.zeros((d, d), **kw), torch.diag(w)]), seq, 1e-4, n)


def arm_fleet_problem(device, dtype=torch.float32, batch=ARM_FLEET):
    """bench_arm_admm.py's fleet: the arm, its cost (x_std = 1e4, ee height
    1.0), q0 = [pi/3, -pi/2, -pi/4] + N(0, 0.1^2) from default_rng(0), u0 =
    ones, x_nom0 the rollout of u0, and the first 5 of 50 log-spaced
    alphas, on `device` in `dtype`."""
    kw = dict(dtype=dtype, device=device)
    arm = PlanarArm((1.0, 1.0, 1.0), dt=1.0 / ARM_N)
    cost = arm_cost(device, dtype, 1e4, (1.5, 1.0), (0.0, 1e4))
    q0s = torch.tensor(np.array([np.pi / 3, -np.pi / 2, -np.pi / 4])
                       + np.random.default_rng(0).normal(0.0, 0.1, (batch, 3)), **kw)
    u0 = torch.ones((batch, ARM_N, 3), **kw)
    x_nom0 = vmap(lambda x0, us: rollout_nonlinear(arm.step, x0, us))(arm.initial_state(q0s), u0)
    alphas = (10.0 ** torch.linspace(0.0, -5.0, 50, **kw))[:ARM_ALPHAS]
    return arm, cost, q0s, x_nom0, u0, alphas


def arm_project(u):
    return torch.clamp(u, -ARM_U_BOUND, ARM_U_BOUND)


def arm_fleet_solve(problem, line_search, stats=None, **over):
    arm, cost, _, x_nom0, u0, alphas = problem
    return ilqr_admm_fleet(arm.step, arm.get_AB, cost, x_nom0, u0, quad_cost=cost,
                           project_u=arm_project, alphas=alphas, line_search=line_search,
                           device=x_nom0.device, stats=stats, **dict(ARM_SOLVE, **over))


def _arm_compare(device, mode, dtype):
    """The fleet of ARM_COMPARE instances against as many single-instance
    ilqr_admm solves of the same instances: (max |dcost|/cost, statuses
    equal)."""
    problem = arm_fleet_problem(device, dtype, batch=ARM_COMPARE)
    arm, cost, _, x_nom0, u0, alphas = problem
    syncs0 = admm_solver.host_sync_count
    fleet = arm_fleet_solve(problem, mode)
    sync(device)
    reads = admm_solver.host_sync_count - syncs0
    singles = [ilqr_admm(arm.step, arm.get_AB, cost, x_nom0[i], u0[i], quad_cost=cost,
                         project_u=arm_project, alphas=alphas, line_search=mode, device=device,
                         **ARM_SOLVE) for i in range(ARM_COMPARE)]
    cost_s = torch.stack([r.cost for r in singles])
    rel = float(((fleet.cost - cost_s).abs() / cost_s.abs()).max())
    du = float((fleet.u_nom - torch.stack([r.u_nom for r in singles])).abs().max())
    status_s = [r.status for r in singles]
    print(f"[arm compare] {mode} line search, {ARM_COMPARE} instances, "
          f"{str(dtype).replace('torch.', '')}: max |dcost|/cost {rel:.3e} (gate "
          f"{ARM_COMPARE_REL:g}), max |du| {du:.3e}; statuses fleet {fleet.status.tolist()}, "
          f"single {status_s}; outer steps fleet {fleet.outer_iters.tolist()}, single "
          f"{[r.outer_iters for r in singles]}; host reads of the fleet {reads}")
    return rel, fleet.status.tolist() == status_s


def phase_arm_compare(device, used):
    """The fleet against single solves in each mode, in the dtype its main
    path was certified in (gated); where that is f64, also in f32 (printed,
    not gated)."""
    for mode in ARM_MODES:
        if used[mode] != torch.float32:
            _arm_compare(device, mode, torch.float32)
        rel, same_status = _arm_compare(device, mode, used[mode])
        check(rel <= ARM_COMPARE_REL, f"arm fleet ({mode}) differs from single solves by {rel:.3e}")
        check(same_status, f"arm fleet ({mode}) statuses differ from single solves")


def phase_arm_main_path(device, mode, problem):
    """One fleet solve with its host reads and the bench's certificates.
    Returns (result, certificate, gate failures)."""
    arm, cost, q0s, _, _, _ = problem
    dtype = str(q0s.dtype).replace("torch.", "")
    stats = {}
    syncs0 = admm_solver.host_sync_count
    t0 = time.perf_counter()
    res = arm_fleet_solve(problem, mode, stats=stats)
    sync(device)
    seconds = time.perf_counter() - t0
    reads = admm_solver.host_sync_count - syncs0
    n_inst = q0s.shape[0]
    check(tuple(res.u_nom.shape) == (n_inst, ARM_N, 3), f"arm fleet: u_nom {res.u_nom.shape}")
    check(bool(torch.isfinite(res.u_nom).all() and torch.isfinite(res.cost).all()),
          f"arm fleet ({mode}, {dtype}): non-finite result")
    alone = (res.outer_iters + stats["admm_iters"]).cpu()
    most = ARM_SOLVE["max_iter"] * (1 + ARM_SOLVE["max_admm_iter"])
    cert = certify_arm(arm, cost, q0s, res, ARM_U_BOUND)
    failures = arm_gate_failures(cert, mode)
    print(f"[arm fleet main path] {mode} line search, {n_inst} instances, {dtype}: "
          f"converged_frac {cert['converged_frac']:.4f}, max violation "
          f"{cert['max_violation']:.3e}, bounds active {cert['bounds_active_frac']:.3f}, "
          f"mean cost {cert['mean_cost']:.6f}, outer iterations mean "
          f"{cert['mean_outer_iters']:.2f} max {cert['max_outer_iters']}, oracle gap median "
          f"{cert['cost_gap_median']:.3e} max {cert['cost_gap_max']:.3e} (f64 L-BFGS-B polish "
          f"of {ARM_N_ORACLE} instances, {cert['oracle_seconds']:.1f} s on the host); "
          f"{seconds:.2f} s; gates {'pass' if not failures else 'MISSED: ' + '; '.join(failures)}")
    print(f"[arm fleet main path] {mode}: host reads of stop flags {reads} = "
          f"{stats['outer_steps']} outer steps + {stats['fleet_admm_iters']} fleet ADMM "
          f"iterations; the slowest instance alone would read {int(alone.max())} (instance "
          f"{int(alone.argmax())}); at most {most} for any fleet size")
    check(reads == stats["outer_steps"] + stats["fleet_admm_iters"] <= most,
          f"arm fleet ({mode}): {reads} host reads")
    return res, cert, failures


def phase_arm_fleet(device, batch=ARM_FLEET):
    """The main path in each line-search mode, in f32; where f32 misses a
    gate, the same fleet in f64 on the card, certified and labelled so,
    with the f32 numbers printed beside it."""
    problems = {torch.float32: arm_fleet_problem(device, batch=batch)}
    used = {}
    for mode in ARM_MODES:
        res, cert, failures = phase_arm_main_path(device, mode, problems[torch.float32])
        used[mode] = torch.float32
        if failures:
            print(f"[arm fleet main path] {mode}: f32 misses the bench's gates; the certified "
                  f"fleet runs in f64 on the card")
            if torch.float64 not in problems:
                problems[torch.float64] = arm_fleet_problem(device, torch.float64, batch)
            res, cert, failures = phase_arm_main_path(device, mode, problems[torch.float64])
            used[mode] = torch.float64
        check(not failures, f"arm fleet ({mode}): " + "; ".join(failures))
    return problems, used


def phase_arm_time(device, card, problems, used):
    """Solves/s of the fleet in each mode: a warm-up, then ARM_TIMING_WINDOWS
    windows of one solve each on the host clock with a synchronize."""
    rates = {}
    for mode in ARM_MODES:
        problem = problems[used[mode]]
        arm_fleet_solve(problem, mode)
        sync(device)
        ms = []
        for _ in range(ARM_TIMING_WINDOWS):
            t0 = time.perf_counter()
            arm_fleet_solve(problem, mode)
            sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        med, q1, q3 = _median_iqr(ms)
        n_inst = problem[2].shape[0]
        rates[mode] = n_inst / (med / 1e3)
        print(f"[arm fleet time] {mode} line search, {n_inst} instances, "
              f"{str(used[mode]).replace('torch.', '')}: {med:.1f} ms a solve (IQR {q1:.1f}-"
              f"{q3:.1f}, {len(ms)} windows: {', '.join(f'{t:.1f}' for t in ms)}) = "
              f"{rates[mode]:.1f} solves/s; card: {card}")
    return rates


def phase_arm_profile(device, card, problems, used):
    """`torch.profiler` over one inner-mode fleet solve: the device busy
    share of the wall time, the device ops, and the device time under the
    solver's three ranges (linearization + normal equations + Cholesky,
    the ADMM iterations, the line-search rollouts inside them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    problem = problems[used["inner"]]
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        res = arm_fleet_solve(problem, "inner")
        sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    names = (batched_ilqr_admm.PROFILE_LINEARIZE, batched_ilqr_admm.PROFILE_ADMM,
             batched_ilqr_admm.PROFILE_ROLLOUT)
    events = prof.key_averages()
    # the solver's ranges also appear as spans on the device's timeline:
    # they are not device work
    on_device = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in names]
    busy_us = sum(e.self_device_time_total for e in on_device)
    print(f"[arm profile] one inner-mode fleet solve, {int(res.outer_iters.max())} outer steps: "
          f"wall {wall_us / 1e3:.1f} ms under the profiler; card: {card}")
    if busy_us <= 0.0:
        print("[arm profile] the profiler saw no device time: not measured")
        return None
    print(f"[arm profile] device busy {busy_us / 1e3:.1f} ms = {100 * busy_us / wall_us:.2f}% of "
          f"the wall time; {sum(e.count for e in on_device)} device ops of {len(on_device)} kinds")
    # a host range's device time is that of the kernels launched inside it
    ranges = {e.key: e for e in events if e.device_type == DeviceType.CPU and e.key in names}
    for name in names:
        e = ranges.get(name)
        if e is not None:
            print(f"[arm profile] {name}: {e.count} ranges, kernels {e.device_time_total / 1e3:.1f} "
                  f"ms, host {e.cpu_time_total / 1e3:.1f} ms")
    for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[arm profile] {e.self_device_time_total / 1e3:9.3f} ms, {e.count:6d} calls: "
              f"{e.key[:90]}")
    return {"busy_share": busy_us / wall_us}


def arm_mc_success(arm, res, device):
    """tests/test_isls_robust.py::_mc_success: the joint rate of ARM_MC
    closed-loop rollouts (q0 ~ N(q0_nom, var), default_rng(11)) through
    the SLS controller of res in which every control stays within the
    bound."""
    n, d, m = 3, 9, 3
    A, B = arm.get_AB(res.x_nom, res.u_nom)
    PHI_U = torch.zeros((m * ARM_N, d * ARM_N), dtype=A.dtype, device=device)
    PHI_U[:, :n] = res.phi_u
    K, k = sls_controller(A, B, PHI_U, res.du)
    q0s = np.random.default_rng(ARM_MC_SEED).normal(
        res.x_nom[0, :n].cpu().numpy(), np.sqrt(ARM_ROBUST_VAR), size=(ARM_MC, n))
    x0s = arm.initial_state(torch.tensor(q0s, dtype=A.dtype, device=device))
    _, us = vmap(lambda x0: rollout_sls_delta(arm.step, x0, K, k, res.x_nom, res.u_nom))(x0s)
    return float((us.abs() <= ARM_ROBUST_U + 1e-3).all(dim=2).all(dim=1).double().mean())


def arm_z_scores(res):
    """Each control row's distance to the bound in spreads: (min over rows
    of the upper side, of the lower side)."""
    u_abs = res.u_nom.reshape(-1) + res.du
    spread = torch.clamp(np.sqrt(ARM_ROBUST_VAR) * torch.linalg.vector_norm(res.phi_u, dim=-1),
                         min=1e-12)
    return (float(((ARM_ROBUST_U - u_abs) / spread).min()),
            float(((u_abs + ARM_ROBUST_U) / spread).min()))


def phase_arm_robust(device):
    """Path B, the robust arm of tests/test_isls_robust.py, in f64 on the
    card: isls_admm (i) without projections, (ii) with the per-row SOC
    projection at Psi^-1(0.82), (iii) with joint_alpha = 0.958; each
    validated by ARM_MC Monte-Carlo closed-loop rollouts."""
    f64 = dict(dtype=torch.float64, device=device)
    arm = PlanarArm((1.0, 1.0, 1.0), dt=1.0 / ARM_N)
    cost = arm_cost(device, torch.float64, 1e3, (1.5, 2.0), (1e3, 1e3))
    x0 = arm.initial_state(torch.tensor([np.pi / 3, -np.pi / 2, -np.pi / 4], **f64))
    u0 = torch.zeros((ARM_N, 3), **f64)
    x_nom0 = rollout_nonlinear(arm.step, x0, u0)
    alphas = 10.0 ** torch.linspace(0.0, -5.0, 50, **f64)
    psi_row = float(norm.ppf(ARM_ROBUST_ALPHA))
    project_u, _ = make_box_chance_projection(
        ARM_ROBUST_VAR, 3, -ARM_ROBUST_U, ARM_ROBUST_U, alpha_row=ARM_ROBUST_ALPHA, shifted=True,
        **f64)
    robust = dict(rho_u=1.0, k_max=50, max_admm_iter=10, alphas=alphas[:30], outer_tol=1e-4)
    configs = {
        "plain": dict(k_max=60, max_admm_iter=10, alphas=alphas[:10], outer_tol=1e-4),
        "per-row SOC": dict(robust, project_u=project_u),
        "joint": dict(robust, joint_alpha=ARM_ROBUST_JOINT,
                      u_bounds=(-ARM_ROBUST_U, ARM_ROBUST_U), x0_var=ARM_ROBUST_VAR),
    }
    out = {}
    for label, kw in configs.items():
        t0 = time.perf_counter()
        res = isls_admm(arm.step, arm.get_AB, cost, x_nom0, u0, 3, quad_cost=cost, device=device,
                        **kw)
        sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        rate = arm_mc_success(arm, res, device)
        z_hi, z_lo = arm_z_scores(res)
        ee_y = float(res.x_nom[-1, 7])
        out[label] = dict(rate=rate, z=min(z_hi, z_lo), ms=ms)
        print(f"[arm robust] {label}: MC joint rate {rate:.3f} over {ARM_MC} rollouts, min "
              f"z-score {min(z_hi, z_lo):.4f}, x_N[ee_y] {ee_y:.4f}, {res.outer_iters} outer "
              f"steps, status {SolveStatus(res.status).name}, {ms:.0f} ms (f64 on the card)")
        check(bool(torch.isfinite(res.du).all() and torch.isfinite(res.phi_u).all()),
              f"robust arm ({label}): non-finite controller")
        check(abs(ee_y - 2.0) < 0.2, f"robust arm ({label}): x_N[ee_y] = {ee_y}")
    plain, row, joint = out["plain"]["rate"], out["per-row SOC"]["rate"], out["joint"]["rate"]
    psi_joint = float(chi.ppf(ARM_ROBUST_JOINT, 3))
    print(f"[arm robust] gates: per-row {row:.3f} > plain {plain:.3f} + 0.05, >= 0.85, plain <= "
          f"0.82; per-row min z {out['per-row SOC']['z']:.4f} >= Psi^-1(0.82) - 1e-3 = "
          f"{psi_row - 1e-3:.4f}; joint {joint:.3f} >= 0.93, min z {out['joint']['z']:.4f} >= "
          f"chi_3^-1(0.958) - 5e-2 = {psi_joint - 5e-2:.4f} (reference: 77.3% plain, 95.8% robust)")
    check(row > plain + 0.05 and row >= 0.85 and plain <= 0.82,
          f"robust arm MC rates: plain {plain}, per-row {row}")
    check(out["per-row SOC"]["z"] >= psi_row - 1e-3, "robust arm: a row misses its SOC")
    check(joint >= 0.93 and out["joint"]["z"] >= psi_joint - 5e-2,
          f"robust arm joint calibration: rate {joint}, min z {out['joint']['z']}")
    return out


def main() -> int:
    seconds = {}

    def run(label, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[label] = time.perf_counter() - t0

    try:
        name, card = run("device", phase_device)
        run("build", phase_build)
        A, B, cost, x0s = bench_problem("cuda")
        solver = make_fused_lqt_admm(
            A, B, cost, u_lower=-U_MAX, u_upper=U_MAX, rho_u=RHO_U,
            n_iters=ADMM_ITERS, batch_tile=BATCH_TILE, device="cuda",
        )
        inputs = solver.kernel_inputs(x0s)
        odd, odd_inputs = odd_width_case("cuda")
        cases = [(mode, solver, inputs, extra) for mode, extra in MODES.items()]
        cases.append(("Nm=98, alpha=1.6, |u|<=4, batch_tile=16", odd, odd_inputs, {}))
        max_err = run("u-only compare", phase_compare, cases)
        launches, _ = run("u-only main path", phase_main_path, solver, A, B, cost, x0s)
        times = run("u-only time", phase_time, solver, inputs, card)
        box = box_solver("cuda")
        box_max_err = run("box compare", phase_box_compare, "cuda")
        box_launches, _ = run("box main path", phase_box_main_path, box, x0s)
        box_times = run("box time", phase_box_time, "cuda", card)
        sls = sls_solver("cuda", "diamond_ee")
        sls_fleet = sls_bounds("cuda", batch=SLS_BATCH, sort=True)
        sls_max_err = run("sls compare", phase_sls_compare, "cuda")
        sls_launches, _ = run("sls main path", phase_sls_main_path, sls, sls_fleet)
        sls_times = run("sls time", phase_sls_time, "cuda", card)
        riccati_max_err = run("riccati compare", phase_riccati_compare, "cuda")
        riccati_launches, _ = run("riccati main path", phase_riccati_main_path, "cuda")
        riccati_times = run("riccati time", phase_riccati_time, "cuda", card)
        run("riccati profile", phase_riccati_profile, "cuda", card)
        car_max_err = run("car compare", phase_car_compare, "cuda")
        car_launches, car_main = run("car main path", phase_car_main_path, "cuda")
        run("car f64 host solve", phase_car_host_f64, car_main)
        run("car inner mode", phase_car_inner, "cuda")
        car_times = run("car time", phase_car_time, "cuda", card)
        run("car profile", phase_car_profile, "cuda", card)
        arm_problems, arm_dtypes = run("arm fleet main path", phase_arm_fleet, "cuda")
        run("arm compare", phase_arm_compare, "cuda", arm_dtypes)
        run("arm fleet time", phase_arm_time, "cuda", card, arm_problems, arm_dtypes)
        run("arm profile", phase_arm_profile, "cuda", card, arm_problems, arm_dtypes)
        run("arm robust", phase_arm_robust, "cuda")
        bounds = dict(run("fleet bounds", existing_bounds, solver, inputs, box[1], x0s,
                          sls[1], sls_fleet), **riccati_times["bounds"],
                      linesearch_rollout=car_times["bound"])
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", flush=True)
        return 1
    print("[phases] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"; total {sum(seconds.values()):.1f}")
    # no single PyTorch call computes any of these functions
    kernels = [{
        "name": "admm_u_only",
        "route": "cuda",
        "source": "ilqr_admm_tpu_torch/csrc/admm_u_only.cu",
        "replaces": "ilqr_admm_tpu/ops/pallas_admm.py:90",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times["kernel"],
        "plain_ms": times["plain"],
    }, {
        "name": "sls_admm",
        "route": "cuda",
        "source": "ilqr_admm_tpu_torch/csrc/sls_admm.cu",
        "replaces": "ilqr_admm_tpu/ops/pallas_sls.py:99",
        "launches": sls_launches,
        "max_abs_err": sls_max_err,
        "ms": sls_times[("diamond_ee", SLS_BATCH, "kernel")],
        "plain_ms": sls_times[("diamond_ee", SLS_BATCH, "plain")],
    }, {
        "name": "admm_box",
        "route": "cuda",
        "source": "ilqr_admm_tpu_torch/csrc/admm_box.cu",
        "replaces": "ilqr_admm_tpu/ops/pallas_admm.py:229",
        "launches": box_launches,
        "max_abs_err": box_max_err,
        "ms": box_times["kernel"],
        "plain_ms": box_times["plain"],
    }]
    riccati_replaces = {
        "riccati_scan": "ilqr_admm_tpu/ops/pallas_riccati.py:145",
        # the join and, as its prologue, the XLA scan over the block totals
        # between the two Pallas kernels
        "riccati_join": "ilqr_admm_tpu/ops/pallas_riccati.py:171, :267-283",
    }
    for kname, replaces in riccati_replaces.items():
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": "ilqr_admm_tpu_torch/csrc/riccati_scan.cu",
            "replaces": replaces,
            "launches": riccati_launches[kname],
            "max_abs_err": riccati_max_err[kname],
            # device time (a CUDA graph of the wrapper's launches): a call
            # through the wrapper is bounded by the host at these sizes
            "ms": riccati_times[(RICCATI_N, f"{kname} kernel")],
            "plain_ms": riccati_times[(RICCATI_N, f"{kname} plain")],
        })
    kernels.append({
        "name": "linesearch_rollout",
        "route": "cuda",
        "source": "ilqr_admm_tpu_torch/csrc/linesearch_rollout.cu",
        "replaces": "ilqr_admm_tpu/ops/pallas_rollout.py:90",
        "launches": car_launches,
        "max_abs_err": car_max_err,
        # device time (a CUDA graph of the wrapper's launches), as for the
        # Riccati kernels
        "ms": car_times["kernel"],
        "plain_ms": car_times["plain"],
    })
    for k in kernels:
        k.update(bounds[k["name"]], library_ms=None)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
