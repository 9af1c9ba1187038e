#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Drives the port's paths on the card:

- the box-constrained LQT-ADMM fleet of the repository's bench (16,384
  double-integrator instances, N = 100, |u| <= 5, rho_u = 0.1, 100
  iterations) through `make_fused_lqt_admm`;
- the certified wide fleet of `benchmarks/bench_wide_certified.py:36-103`
  (8,192 instances of DoubleIntegrator(4, 2), N = 128, so Nm = 512 and Nd
  = 1,024; |u| <= 5, rho_u = 0.1, 100 iterations with delta products,
  refresh_every 8) through `make_fused_lqt_admm`, whose loop is the wide
  route `admm_u_only_wide` (W_u streamed from L2);
- the same fleet with a velocity box |v| <= 1.3 (position free), rho_x =
  10, 200 iterations, through `make_fused_lqt_admm(..., x_lower, x_upper)`,
  whose loop is the `admm_box` kernel;
- the robust SLS-ADMM scenario fleet of `benchmarks/bench_pallas_sls.py`
  (1,024 chance-constrained syntheses, N = 100, robust_dim 1, bounds
  U(2, 4), rho_u = 1.0, 200 iterations) through `make_fused_sls_admm`
  in its serving configuration (exact diamond z-update, per-tile early
  exit at 3e-3 every 16 iterations, fleet sorted by bound), and its
  consensus configuration with uncertainty on both initial-state
  components (robust_dim 2: p1 = 3 slabs, two SOC sets of q = 4 rows);
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
  validated by 1,000 Monte-Carlo closed-loop rollouts;
- the receding-horizon MPC of `benchmarks/bench_mpc.py:54-201` through
  `solvers/mpc.py` (CarSimple(dt=0.1), H = 40, the via-point cost to
  (2, 1), |u| <= 0.6, rho_u = 1, 2 outer x 5 ADMM iterations a tick, 10
  alphas, x0 = (0, 0, 0.5, 0), 100 ticks, f32) in its dp and SQP ticks,
  alone and as a fleet of 256, and the boxDDP tick of
  `tests/test_mpc.py:117-181` (1-D double integrator, N = 50, |u| <= 3,
  200 ticks) with each backward; no kernel lies on it (the car is
  `CarSimple`, and the ticks pass no `linesearch_rollout`);
- single barrier, AL and primal-dual iLQR solves (the barrier problem of
  `tests/test_boxddp.py:184-207`, `examples/al_obstacle_avoidance.py`,
  `examples/pd_ilqr_infeasible_start.py`) in f32 against the same solves
  in f64 on the host;
- the boxDDP car fleet of `benchmarks/bench_boxddp.py:44-93` (256
  CarFrontWheel instances, N = 500, |w| <= 0.5, |a| <= 2, 150 iterations,
  f32) through `boxddp_fleet_solve`, each iteration a replayed CUDA
  graph, and the AL arm fleet of `benchmarks/bench_al_arm.py:38-95` (512
  arms, N = 100, state and control bounds and the terminal ee window, 7
  AL stages of 8 iterations, f32) through `batched_al_solve`; no kernel
  lies on them (the rollout kernel rolls out open-loop controls, the
  boxDDP line search a clipped closed loop; the arm has d = 9);
- the reference library's own API, the `SLS` / `iSLS` facade, at the
  examples' sizes in f32: `examples/double_integrator_state_bounds.py`
  (ADMM batch, DP and robust SLS, 10,000 Monte-Carlo rollouts),
  `double_integrator_obstacles.py` (project_quadratic, consensus and
  Dykstra), `tutorial_car_parking.py` (CarFrontWheel, N = 500, iLQR then
  iLQR-ADMM), `car_state_constraints.py` (CarSimple, N = 500, consensus
  and the exact rotated-box projection), and in f64
  `inverse_lqt_learning.py` (the IFT gradient of `lqt_admm_implicit`
  and its 150 Adam steps); no kernel lies on them;
- the scale-out layer `parallel/` on `torch.distributed`, in worlds of
  ranks this script spawns (each a process that imports only the port):
  the bench fleet through `admm_u_only` and the diamond_ee SLS fleet
  through `sls_admm` under `sharded_instance_solve`, the consensus
  projection with its blocks sharded, the time-sharded Riccati pass and
  the box backward with `mesh=`. The card is one H100, so two ranks share
  it over gloo and one rank runs NCCL: the phases show that a sharded
  solve gives the single-process outputs, not how it scales.
- the examples' twins (`examples_torch/`): nine of the eleven examples
  that no other phase re-codes, each as a user runs it (`python
  examples_torch/<name>.py --device cuda`) in a process of its own, six
  at once, held to the reference notebooks' goldens of
  `tests/test_examples.py`; beside them an audit of the batched
  `torch.linalg` ops the port calls (cholesky, cholesky_ex, solve,
  solve_triangular, inv, pinv, qr, cholesky_solve) on memory that held
  NaN, with a zero or singular block, against numpy.

Phases:

1. device: a CUDA card must be present (there is no CPU path);
2. build: compile the CUDA kernel library from the sources in the tree;
3. for each path: kernel vs plain, the kernel against its plain torch
   version on the same card inputs (the LQT fleet's `admm_u_only` in
   three modes and at an odd width, against the plain version with its
   tensor-core products and against the f32 one, and the iterations its
   early-exit tiles ran; `admm_u_only_wide` likewise on the wide fleet,
   with refresh_every 8 and 1, 16-instance tiles, over-relaxation and
   early exit, and at an odd width (Nm = 516); `admm_box` at the full width, with a
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
   just after (the wide and robust_dim 2 fleets with their plain versions
   patched to raise), checked against the certificates (`utils/certify.py`;
   the wide fleet against its bench's gates, the robust_dim 2 fleet
   against its set's violation and an f64 SLSQP oracle;
   for the car the cost and bound gates of `tests/test_ilqr_admm.py`, an
   f64 solve on the host, and an inner-line-search solve);
5. for each path: time, the kernel and the plain version with CUDA
   events (for the u-only paths also 100 f32 cuBLAS products of the
   loop's shape as a yardstick, and the wide kernel with refresh_every 1;
   for the SLS path 200; for the
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
   `tests/test_isls_robust.py`;
7. MPC, for each car tick alone, each tick as a fleet of 256 and each
   boxDDP backward: 9 ticks through `run_mpc` with no host read between
   them and the launch counters read around them, then a CUDA graph of
   the tick replayed 100 times (200 for boxDDP) whose first 9 ticks must
   be the eager ones; the gates on the graph's loop (max|u| <= 0.6 +
   1e-4, the car parked within 0.05 of the target; the boxDDP gates of
   `tests/test_mpc.py`; f64, labelled, where f32 misses); for one
   controller the per-tick serving loop with the u readback in the timed
   region, and the car's again with every stop flag read on the host;
   the fleet's first 8 against 8 single ticks; a `torch.profiler` split
   of one dp tick. Times are the median and IQR of 3 windows;
8. slice 12: the single barrier, AL and PD solves with their gates (cost
   within 1e-3 of the f64 host solve, the same stop, the keep-out
   margin, the box and its boxDDP cost, the final defect); the boxDDP
   car fleet: 3 iterations eagerly and as a CUDA graph, bit for bit, the
   main path with its host reads and certificates (`certify_boxddp_fleet`:
   the bound, an f64 L-BFGS-B polish of 8 instances in worker processes),
   the fleet of 8 against 8 single `boxddp_solve` calls, solves/s (3
   windows) and a `torch.profiler` split; the AL arm fleet: its main path
   with its host reads and the gates against the JAX package's f32
   numbers (`certify_al_fleet`), the fleet of 8 against 8 single
   `al_ilqr_solve` calls, and solves/s (1 window);
9. slice 13, the facade: each workflow on the card with its host reads
   (synchronizing CUDA calls, in sync debug mode) and the time of that
   run (FACADE_REPEATS more runs after it where it is set),
   against the same workflow in f64 on the host (worker processes beside
   the card's phases): costs within 1e-3 where the solve is converged or
   deterministic, the bounds, the obstacle clearances, the exact
   certificate, and the IFT gradient against a central difference and the
   host's;
10. slice 15, the scale-out layer: single-process references on the card,
   then a gloo world of 2 ranks on the card runs [parallel data] (the
   16,384-instance bench fleet under `sharded_instance_solve`: the
   gathered x, u and z_u equal the single-process call bit for bit, each
   rank's `admm_u_only` counter set to 0 just before and > 0 after, the
   bench certificates on the gathered fleet, the `mc_success_rate` of the
   converged flags equal to the single-process rate), [parallel sls] (the
   1,024-instance diamond_ee fleet through `sls_admm`, likewise),
   [parallel consensus] (`project_set_convex_sharded`, the two SOC blocks
   of the chance constraint over 2 ranks, 1,024 points, against the
   stacked form on one device: f64 within 1e-12, f32 within 1e-4, times
   max(1, max|x|)) and [parallel time] (`lqt_backward_time_sharded` at N
   = 10,000, d = 4 and `ilqr_backward_box_parallel(mesh=...)` against
   their one-device calls in f64, within 1e-10 relative); then an NCCL
   world of 1 rank runs [parallel data]. A rank that exits non-zero or
   outlasts PARALLEL_TIMEOUT fails the run. Each line carries the wall
   times and the card's name and power limit.
11. slice 17: [linalg audit] (`linalg_audit` in f64 and f32: each
   batched op's well-conditioned blocks against numpy, the zero or
   singular block as numpy has it; a fault fails the run), then
   [examples] (`phase_examples`: EXAMPLES_ON_CARD, each twin's process,
   its exit code, wall time and golden numbers; a twin that fails, times
   out or misses a golden row fails the run).

Any failure exits non-zero before the last line. The last line is
{"ok": true, "device": {...}}; the line before it lists each kernel with
its launches on its main path, its error against its plain version, its
time, its plain version's time and its bound on an H100 (`bound_ops`:
the f32 CUDA cores, 3xTF32 on the tensor cores, or a dependency chain of
f32 additions); the line before that, the seconds each phase took.

Run from the repository root: python3 chip_smoke.py
"""

from __future__ import annotations

import bisect
import concurrent.futures
import contextlib
import copy
import io
import json
import multiprocessing
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
from scipy.stats import chi, norm
from torch.func import vmap

from ilqr_admm_tpu_torch import SLS, _build, iSLS
from ilqr_admm_tpu_torch.chance import make_box_chance_projection
from ilqr_admm_tpu_torch.models.arm import PlanarArm
from ilqr_admm_tpu_torch.models.car import CarFrontWheel, CarParkingCost, CarSimple
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
from ilqr_admm_tpu_torch.ops.constrained_riccati import ilqr_backward_box_parallel
from ilqr_admm_tpu_torch.ops.riccati import lqt_backward, quad_cost_model
from ilqr_admm_tpu_torch.ops.rollout import (
    rollout_closed_loop,
    rollout_nonlinear,
    rollout_sls_delta,
)
from ilqr_admm_tpu_torch.parallel import (
    batched_al_solve,
    distributed,
    lqt_backward_time_sharded,
    make_mesh,
    mc_success_rate,
    project_set_convex_sharded,
    project_set_convex_stacked,
    sharded_instance_solve,
)
from ilqr_admm_tpu_torch.problem import ILQRConfig, SolveStatus
from ilqr_admm_tpu_torch.projections import (
    project_bound,
    project_outside_rotated_boxes,
    project_quadratic,
    project_set_convex,
    project_set_convex_dykstra,
    project_soc_unit,
    project_square,
)
from ilqr_admm_tpu_torch.projections import sets as projection_sets
from ilqr_admm_tpu_torch.solvers import admm as admm_solver
from ilqr_admm_tpu_torch.solvers import batched_ilqr_admm
from ilqr_admm_tpu_torch.solvers import ilqr_admm as ilqr_admm_solver
from ilqr_admm_tpu_torch.solvers.batched import make_batched_lqt_admm
from ilqr_admm_tpu_torch.solvers.al_ilqr import al_ilqr_solve
from ilqr_admm_tpu_torch.solvers.barrier_ilqr import barrier_ilqr_solve, make_barrier
from ilqr_admm_tpu_torch.solvers.batched_ilqr_admm import ilqr_admm_fleet
from ilqr_admm_tpu_torch.solvers.boxddp import (
    boxddp_fleet_init,
    boxddp_fleet_solve,
    boxddp_init,
    boxddp_solve,
)
from ilqr_admm_tpu_torch.solvers.ilqr_admm import ilqr_admm
from ilqr_admm_tpu_torch.solvers.implicit import lqt_admm_implicit
from ilqr_admm_tpu_torch.solvers.isls_admm import isls_admm
from ilqr_admm_tpu_torch.solvers.lqt import sls_controller, sqrt_psd_stacked
from ilqr_admm_tpu_torch.solvers.pd_ilqr import pd_ilqr_init, pd_ilqr_solve
from ilqr_admm_tpu_torch.solvers.mpc import (
    make_mpc_fleet_step_constrained,
    make_mpc_step_boxddp,
    make_mpc_step_constrained,
    mpc_constrained_init,
    mpc_init,
    run_mpc,
)
from ilqr_admm_tpu_torch.utils.certify import (
    ARM_N_ORACLE,
    converged_flags,
    converged_frac,
    max_violation,
    sls_converged_flags,
    oracle_cost_gap,
    al_gate_failures,
    arm_gate_failures,
    boxddp_gate_failures,
    certify,
    certify_al_fleet,
    certify_arm,
    certify_boxddp_fleet,
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

# The certified wide fleet of benchmarks/bench_wide_certified.py:36-103:
# d = 8, m = 4, N = 128 (Nm = 512, Nd = 1,024), 8,192 instances, |u| <= 5,
# rho_u = 0.1, 100 iterations with delta products (refresh_every 8),
# polish_iters 8, f32; its gates, the oracle on the first 32
WIDE_N = 128
WIDE_BATCH = 8192
WIDE_ITERS = 100
WIDE_REFRESH = 8
WIDE_TARGET = (1.0, 0.5, -0.5, 0.8, 0.0, 0.0, 0.0, 0.0)
WIDE_N_ORACLE = 32
WIDE_PLAIN_WINDOWS = 3  # windows of one call for the plain version's time

# The robust SLS fleet with uncertainty on both initial-state components
# (robust_dim 2, p1 = 3), bench_pallas_sls.py's consensus configuration.
# Its limits come from the port's f64 plain version of the same 1,024
# instances on the host: U's rows leave their set
# |du| + psi sigma ||phi|| <= bound by up to 2.63e-3, and the
# oracle's cost gap on instances 0 and 1023 is 3.29e-4 / 3.33e-4, where
# 30 consensus iterations leave the z-update inexact (1,000 outer and 150
# inner iterations close it to 8.6e-10 in f64)
ROBUST2_VIOLATION_TOL = 5e-3
ROBUST2_GAP_MEDIAN = 5e-4
ROBUST2_GAP_MAX = 1e-3
ROBUST2_N_ORACLE = 2

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

# receding-horizon MPC, benchmarks/bench_mpc.py:54-91 (the constrained car)
# and tests/test_mpc.py:117-181 (the boxDDP tick)
MPC_H = 40
MPC_TICKS = 100
MPC_FLEET = 256
MPC_U_MAX = 0.6
MPC_U_TOL = 1e-4  # bench_mpc.py:206-211
MPC_TARGET = (2.0, 1.0)
MPC_PARK_TOL = 0.05  # bench_mpc.py:209, 212
MPC_X0 = (0.0, 0.0, 0.5, 0.0)
MPC_TICK_KW = {"dp": {}, "sqp": dict(method="batch", line_search="outer")}
MPC_WINDOWS = 3
MPC_EAGER_TICKS = 9  # the eager and served loops: 3 windows of 3 ticks
MPC_GRAPH_TOL = 1e-6  # max |du| of a tick's CUDA graph against its eager run
MPC_COMPARE = 8
MPC_COMPARE_TICKS = 2
# max |du| of the fleet against single ticks, f32: about 8x the largest
# reading on an H100 (4.8e-7 dp, 1.3e-6 SQP)
MPC_COMPARE_TOL = 1e-5
MPC_BOX_N = 50
MPC_BOX_TICKS = 200
MPC_BOX_U = 3.0
MPC_BOX_RICCATI = ("seq", "parallel")

# Slice 12, single solves on the card in f32 against the port's f64 solve
# of the same problem on the host: the AL keep-out of
# examples/al_obstacle_avoidance.py (N = 100, Gauss-Newton, n_al 12, mu0
# 10, x5), the elementwise barrier of tests/test_boxddp.py:184-207 (N =
# 80, |u| <= 5, n_barrier 7, mu 1 / 8^i; within 5e-3 of the card's boxDDP)
# and the PD car of examples/pd_ilqr_infeasible_start.py (CarSimple, N =
# 60, a straight-line state path, no controls; final defect <= 1e-5).
# Statuses: CONVERGED and LINE_SEARCH_FAILED count as one stop (a
# converged solve's last step is a rounding-level tie, decided apart in
# f32 and f64); MAX_ITER must match.
SINGLE_COST_REL = 1e-3
BARRIER_BOX_REL = 5e-3
AL_MARGIN_TOL = 1e-4
PD_DEFECT_TOL = 1e-5
STOPS = (SolveStatus.CONVERGED, SolveStatus.LINE_SEARCH_FAILED)
# The boxDDP car fleet of benchmarks/bench_boxddp.py:44-93: 256 x
# CarFrontWheel(dt = 15/500), CarParkingCost(), N = 500, |w| <= 0.5, |a|
# <= 2, 150 iterations at tol_fun 1e-8, qp_iters 8, sequential backward;
# x0 = golden + N(0, 0.05^2), u0 ~ N(0, 0.1^2) from default_rng(0). Each
# iteration replays as a CUDA graph (graph=True), held bit for bit to the
# eager loop over BOXDDP_GRAPH_ITERS iterations.
BOXDDP_N = 500
BOXDDP_FLEET = 256
BOXDDP_SOLVE = dict(max_iter=150, tol_fun=1e-8)
BOXDDP_QP_ITERS = 8
BOXDDP_BOUND = (0.5, 2.0)
BOXDDP_X0 = (1.0, 1.0, 3.0 * np.pi / 2, 0.0)
BOXDDP_GRAPH_ITERS = 3
# The fleet of 8 against 8 single solves (each a CUDA graph, ~20 s).
# tol_fun 1e-8 is below the f32 resolution of a cost near 2
# (2.4e-7), so no f32 solve ends CONVERGED: each ends LINE_SEARCH_FAILED
# (15 rejected steps in a row at the rounding floor) or at the cap
# (MAX_ITER), whichever comes first by rounding; the two count as one stop.
# (8 instances before the facade phases; 1 since, for their time: the 8
# singles took 201 s, PERF.md section 6)
BOXDDP_COMPARE = 1
BOXDDP_COMPARE_REL = 1e-3
BOXDDP_STOPS = (SolveStatus.LINE_SEARCH_FAILED, SolveStatus.MAX_ITER)
BOXDDP_WINDOWS = 1  # the main path's solve (3 before the facade phases, 2 before PR 15)
BOXDDP_PROFILED_ITERS = 3
# worker processes of the f64 oracles (the boxDDP, arm and SLS polishes)
ORACLE_WORKERS = 7
# The AL arm fleet of benchmarks/bench_al_arm.py:38-95: 512 x
# PlanarArm((1, 1, 1), dt = 1/100), N = 100, |q_dot| <= 1.5, |u| <= 6, the
# terminal ee-x window [0.5, 1], x_std 1e3, u_std 1e-4, 8 iterations of 15
# alphas a stage, n_al 7, mu0 1e2, x8, tol_con 1e-5; q0 = (pi/3, -pi/2,
# -pi/4) + N(0, 0.05^2) from default_rng(0), u0 = 1. Gates:
# utils/certify.py::AL_GATES against the JAX package's own f32 run.
AL_ARM_FLEET = 512
AL_ARM_SOLVE = dict(max_iter=8, max_line_search_iter=15)
AL_ARM_KW = dict(n_al=7, mu0=1e2, mu_factor=8.0, tol_con=1e-5)
AL_ARM_COMPARE = 2  # 8 before the facade phases (cut for their time, as BOXDDP_COMPARE)
AL_ARM_COMPARE_REL = 1e-3
AL_ARM_WINDOWS = 1  # 3 before, cut for the run's length
# Slice 13, the reference library's own API on the card: the SLS / iSLS
# facade at the examples' sizes, none cut, each workflow in the examples'
# dtype against the port's f64 run of the same workflow on the host (in a
# worker process beside the card's phases):
# - [facade sls] examples/double_integrator_state_bounds.py (N = 100,
#   |u| <= 3, the end pinned to (0.5, 0), ADMM batch / DP / robust SLS,
#   10,000 Monte-Carlo rollouts), with the three unconstrained solves on
#   the control-bounds notebook's cost (tests/test_facade.py:18-88);
# - [facade obstacles] examples/double_integrator_obstacles.py (2-D, N =
#   100, two circles): ADMM batch with one project_quadratic, then with
#   the example's project_set_convex + project_set_convex_dykstra;
# - [facade car] examples/tutorial_car_parking.py (CarFrontWheel, N =
#   500): iSLS.solve (dp) and iSLS.ilqr_admm with the control box;
# - [facade maze] examples/car_state_constraints.py (CarSimple, N = 500):
#   the batch iLQR, then ilqr_admm with the consensus projection and with
#   the exact project_outside_rotated_boxes;
# - [implicit] examples/inverse_lqt_learning.py (f64, N = 40): the IFT
#   gradient against a central difference and the host's, then the
#   example's 150 Adam steps.
# Gates (set before the first chip run): cost within FACADE_COST_REL of
# the host's f64 run (for the obstacles only the unconstrained solve: the
# example's ADMM on the circles' non-convex exteriors ends at its
# 500-iteration cap unconverged, residuals 0.07-0.75, where the iterate
# depends on rounding: f32 and f64 costs 8% apart on the CPU, two f64 runs
# with different thread counts 0.3%; and for the maze not the ilqr_admm
# runs, whose 10 outer steps end mid-descent: two f64 host runs with 1 and
# 4 threads pick different line-search steps at step 5 and end 3.9%
# apart, and the first chip run's f32 exact-projection run ended 1.96e-2
# from the host's); |u| <= bound + FACADE_U_TOL
# (tests/test_facade.py:138-139); an `exact` certificate on every point
# the exact maze projection touched; obstacle clearance >=
# -FACADE_CLEARANCE_TOL; the IFT gradient within IFT_FD_RTOL of the
# central difference (tests/test_implicit.py:53-54) and IFT_HOST_RTOL of
# the host's f64 gradient. Times: the host clock around a workflow with a
# sync around the gated run (FACADE_REPEATS runs after it where set);
# host reads: the card's synchronizing calls in the first run
# (torch.cuda sync debug mode).
FACADE_COST_REL = 1e-3
FACADE_U_TOL = 5e-2
FACADE_CLEARANCE_TOL = 1e-4
IFT_FD_RTOL = 1e-3
IFT_HOST_RTOL = 1e-8
FACADE_REPEATS = 0  # timed runs after the counted one (3, then 1, cut for the run's length)
FACADE_MC = 10_000

# Slice 15, the scale-out layer: worlds of ranks spawned here, each a
# process that imports only the port. Two ranks share the one card over
# gloo (NCCL refuses two ranks on one device); one rank runs NCCL, the
# backend of a machine with a card a rank. One card shows that a sharded
# fleet gives the unsharded outputs, not how a fleet scales.
PARALLEL_WORLDS = (("gloo", 2), ("nccl", 1))
PARALLEL_TIMEOUT = 300  # seconds a world may take, its ranks' start included
# the consensus projection of tests/test_consensus_parallel.py's chance
# constraint, one point an instance of the SLS fleet
CONSENSUS_RHO = 10.0
CONSENSUS_ITERS = 50
CONSENSUS_THRESHOLD = 1e-6
CONSENSUS_F64_TOL = 1e-12  # sharded against stacked: the order of two sums
CONSENSUS_F32_TOL = 1e-4  # times max(1, max|x|): f32 rounding through 50 iterations
TIME_SHARDED_TOL = 1e-10  # f64, relative to max(1, max|ref|)
TIME_BOX_U = 0.5  # |u| bound of the box backward on riccati_problem's data

# Slice 17, the examples as torch twins (`examples_torch/`): nine of the
# eleven that no earlier phase re-codes run here, each in its own process
# with --device cuda, EXAMPLES_POOL at once, the longest first (the order
# of EXAMPLES_ON_CARD, by their card times alone: 26.2 s down to 9.9 s,
# H100 80GB HBM3 at 700 W). Each is held to its tests/test_examples.py
# GOLDENS rows (`examples_torch/goldens.py`) and its own asserts (exit 0).
# Left out for the run's length: boxddp_car_parking (453 s alone: an eager
# N = 500 boxDDP, 100 + 250 iterations of small launches) and
# car_control_bounds (101 s alone), each run once on the card with every
# golden met (PERF.md section 6).
EXAMPLES_ON_CARD = (
    "batched_multistart", "robust_fleet_diamond", "double_integrator_control_bounds",
    "admm_acceleration", "mpc_car", "arm_robust", "robust_joint_calibration",
    "arm_constrained", "sparse_control_l1",
)
EXAMPLES_POOL = 6
EXAMPLES_TIMEOUT = 600  # seconds a twin may take on the card
# [linalg audit]: the batched torch.linalg calls of the port's paths on
# memory that held NaN, a zero or singular block among well-conditioned
# ones, block by block against numpy (relative to max(1, max|ref|))
LINALG_BATCH = 500
LINALG_TOL = {torch.float64: 1e-10, torch.float32: 1e-4}

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


def soc_sets_2d():
    """The chance constraint with uncertainty on both initial-state
    components, |du| + psi sigma ||phi|| <= bound, as two SOC sets of q = 4
    rows: A = [diag(sqrt([0, sigma^2, sigma^2])); -+e0^T / psi], b_fixed =
    0, b_bound = (0, 0, 0, 1 / psi). (soc_A, soc_b_fixed, soc_b_bound)."""
    mu = np.array([1.0, 0.0, 0.0])
    Au = np.diag(np.sqrt([0.0, SIGMA**2, SIGMA**2]))
    A_hi = np.concatenate([Au, (-mu / PSI_INV)[None]], 0)
    A_lo = np.concatenate([Au, (mu / PSI_INV)[None]], 0)
    b_fixed = np.zeros(4)
    b_bound = np.array([0.0, 0.0, 0.0, 1.0 / PSI_INV])
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


def sls_robust2_solver(device, horizon: int = N, **overrides):
    """`make_fused_sls_admm` with robust_dim = 2 (uncertainty on position
    and velocity, p1 = 3): `bench_pallas_sls.py`'s consensus configuration
    (rho_u = 1, cons_rho = 10, 200 iterations, 30 consensus iterations)
    with the sets of `soc_sets_2d`."""
    A, B, cost, _ = bench_problem(device, horizon=horizon, batch=1)
    kw = dict(rho_u=SLS_RHO_U, robust_dim=2, n_iters=SLS_ITERS, batch_tile=SLS_TILE,
              n_cons_iters=SLS_CONS_ITERS, cons_rho=SLS_CONS_RHO, device=device)
    kw.update(overrides)
    return (A, B, cost), make_fused_sls_admm(A, B, cost, *soc_sets_2d(), **kw)


def wide_problem(device, batch: int = WIDE_BATCH, seed: int = 0, horizon: int = WIDE_N):
    """bench_wide_certified.py's problem: DoubleIntegrator(4, 2, dt =
    1/N), the via-point cost to WIDE_TARGET with Q = 1e3 I at the end and
    r = 1e-2, f32 dynamics, x0 ~ N(0, 0.1^2) from default_rng(seed); the
    bench's N is 128."""
    plant = DoubleIntegrator(4, 2, dt=1.0 / horizon, dtype=torch.float32)
    d, m = plant.x_dim, plant.u_dim
    zs = np.stack([np.zeros(d), WIDE_TARGET]).astype(np.float32)
    Qs = np.stack([np.zeros((d, d)), np.eye(d) * 1e3]).astype(np.float32)
    seq = np.zeros(horizon, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m, dtype=torch.float32)
    A, B = plant.AB(horizon)
    rng = np.random.default_rng(seed)
    x0s = torch.tensor(rng.normal(0.0, 0.1, size=(batch, d)), dtype=torch.float32, device=device)
    return A, B, cost, x0s


def wide_solver(device, problem=None, **overrides):
    """`make_fused_lqt_admm` in the wide bench's configuration (its
    default batch_tile: 32 on the wide route)."""
    A, B, cost, _ = problem if problem is not None else wide_problem(device, batch=1)
    kw = dict(u_lower=-U_MAX, u_upper=U_MAX, rho_u=RHO_U, n_iters=WIDE_ITERS,
              refresh_every=WIDE_REFRESH, device=device)
    kw.update(overrides)
    return make_fused_lqt_admm(A, B, cost, **kw)


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
    fused_admm.wide_launch_count = 0
    fused_admm.box_launch_count = 0
    fused_sls.launch_count = 0
    fused_riccati.scan_launch_count = 0
    fused_riccati.join_launch_count = 0
    fused_rollout.launch_count = 0


def launch_counts() -> dict:
    return {"admm_u_only": fused_admm.launch_count,
            "admm_u_only_wide": fused_admm.wide_launch_count,
            "admm_box": fused_admm.box_launch_count,
            "sls_admm": fused_sls.launch_count, "riccati_scan": fused_riccati.scan_launch_count,
            "riccati_join": fused_riccati.join_launch_count,
            "linesearch_rollout": fused_rollout.launch_count}


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


def wide_cases(device):
    """(label, solver, kernel inputs, extra options) of the wide route's
    kernel-vs-plain cases, on the full fleet of the wide bench: its delta
    schedule (refresh_every 8), refresh_every 1, 16-instance tiles, the
    over-relaxed build (alpha 1.3: at 1.6 this problem does not converge in
    100 iterations, and f32 and 3xTF32 plain versions end 0.86 apart on
    the CPU), and early exit with delta products; and the bench's problem
    at N = 129 (Nm = 516: the last n-tile single, four padded columns,
    tile 16) on 1,024 instances."""
    problem = wide_problem(device)
    solver = wide_solver(device, problem)
    x0s = problem[3]
    inputs = solver.kernel_inputs(x0s)
    cases = [(f"wide, refresh_every={WIDE_REFRESH} (the bench)", solver, inputs, {}),
             ("wide, refresh_every=1", solver, inputs, dict(refresh_every=1))]
    for label, over in (("wide, batch_tile=16", dict(batch_tile=16)),
                        ("wide, alpha=1.3", dict(alpha=1.3)),
                        ("wide, stop_tol=1e-5, check_every=4",
                         dict(stop_tol=1e-5, check_every=4))):
        other = wide_solver(device, problem, **over)
        cases.append((label, other, other.kernel_inputs(x0s), {}))
    odd = wide_problem(device, batch=1024, seed=1, horizon=WIDE_N + 1)
    odd_solver = wide_solver(device, odd, batch_tile=16)
    cases.append(("wide, Nm=516, batch_tile=16", odd_solver, odd_solver.kernel_inputs(odd[3]), {}))
    return problem, solver, inputs, cases


def wide_ptxas(log: str) -> dict:
    """{(instances a block, relax, delta): "stack and spills; registers"}
    of each wide kernel build, from ptxas's -v output in nvcc.log (its
    entry line, the function's properties, its stack and spills, its
    registers)."""
    lines = log.splitlines()
    out = {}
    for i, line in enumerate(lines):
        m = re.search(r"admm_u_only_wide_kernelILi(\d)ELb([01])ELb([01])E", line)
        if m and "Compiling entry function" in line and i + 3 < len(lines):
            key = (16 * int(m.group(1)), int(m.group(2)), int(m.group(3)))
            out[key] = f"{lines[i + 2].strip()}; {lines[i + 3].split(':', 1)[-1].strip()}"
    return out


def phase_wide_geometry(cases):
    """Each wide case's launch as `admm_u_only` makes it: instances a
    block, threads, shared memory, the blocks an SM holds by shared memory
    and the waves the grid takes on this card, and its kernel build's
    registers and spills."""
    ptxas = wide_ptxas((_build.build_dir() / "nvcc.log").read_text())
    props = torch.cuda.get_device_properties(0)
    sm_smem = getattr(props, "shared_memory_per_multiprocessor", 233472)
    for label, solver, inputs, extra in cases:
        kw = dict(solver.kernel_options, **extra)
        B, Nm = inputs[0].shape
        threads, smem = fused_admm.wide_launch_geometry(kw["batch_tile"], Nm)
        per_sm = min(sm_smem // (smem + 1024), 2048 // threads)
        blocks = B // kw["batch_tile"]
        build = ptxas.get((kw["batch_tile"], int(kw["alpha"] != 1.0), int(kw["refresh_every"] > 1)))
        print(f"[wide u-only geometry] {label}: {kw['batch_tile']} instances a block, {threads} "
              f"threads, {smem} B of shared memory, {per_sm} block(s) an SM: "
              f"{-(-blocks // (per_sm * props.multi_processor_count))} waves of {blocks} "
              f"blocks on {props.multi_processor_count} SMs; ptxas: {build}")
        check(per_sm > 0 and build is not None, f"{label}: no build or no room for the wide block")


def phase_wide_main_path(solver, problem):
    """The wide bench fleet through the factory's forward with the launch
    counters set to 0 and the plain version patched to raise: one launch
    of the wide kernel, none of the narrow one; then the bench's gates
    (violation 0, converged_frac >= 0.99 at 1e-4, the f64 L-BFGS-B oracle
    gap on the first 32 instances, median and max <= 1e-4)."""
    A, B, cost, x0s = problem

    def plain_must_not_run(*args, **kwargs):
        raise SmokeFailure("the wide main path ran the plain version of the kernel")

    reset_launch_counts()
    with _swapped(fused_admm, admm_u_only_reference=plain_must_not_run):
        x, u, z_x, z_u = solver(x0s)
    torch.cuda.synchronize()
    counts = launch_counts()
    launches = counts["admm_u_only_wide"]
    print(f"[wide u-only main path] launches: admm_u_only_wide {launches}, admm_u_only "
          f"{counts['admm_u_only']}; batch_tile {solver.kernel_options['batch_tile']}")
    check(launches == 1 and counts["admm_u_only"] == 0,
          "the wide main path did not launch the wide kernel exactly once")
    Nm, Nd = u.shape[1], x.shape[1]
    check(tuple(x.shape) == (WIDE_BATCH, 2 * Nm) and Nm == 4 * WIDE_N and z_x is x,
          "unexpected wide output shapes")
    for name, t in (("x", x), ("u", u), ("z_u", z_u)):
        check(bool(torch.isfinite(t).all()), f"wide main path output {name} has non-finite values")
    t0 = time.perf_counter()
    gap_med, gap_max = oracle_cost_gap(A, B, cost, x0s[:WIDE_N_ORACLE], z_u[:WIDE_N_ORACLE],
                                       -U_MAX, U_MAX)
    cert = {"max_violation": max_violation(z_u, -U_MAX, U_MAX),
            "converged_frac": converged_frac(u, z_u),
            "cost_gap_median": gap_med, "cost_gap_max": gap_max}
    print(f"[wide u-only main path] certificates ({time.perf_counter() - t0:.1f} s): "
          f"max_violation {cert['max_violation']}, converged_frac {cert['converged_frac']}, "
          f"cost_gap median {gap_med:.3e} max {gap_max:.3e} on the first {WIDE_N_ORACLE} "
          f"(Nm={Nm}, Nd={Nd})")
    failures = gate_failures(cert)
    check(not failures, "; ".join(failures))
    return launches, cert


def wide_bound(solver, inputs):
    """The least time of the wide solve's work: its products as the
    kernel's route issues them on the tensor cores (3xTF32 refreshes,
    one-pass TF32 deltas, the 6xTF32 tail, the 3xTF32 x product) at the
    dense TF32 peak, against its inputs and outputs at the HBM rate."""
    kw = solver.kernel_options
    chunk_len, n_chunks, n_tail = fused_admm._schedule(
        kw["n_iters"], kw["refresh_every"], kw["polish_iters"], kw["stop_tol"], kw["check_every"])
    r, test = kw["refresh_every"], kw["stop_tol"] > 0.0
    kinds = [6 if test and it == chunk_len - 1 else 1 if it % r else 3
             for it in range(chunk_len)] * n_chunks + [6] * n_tail
    passes, refresh = sum(kinds), kinds.count(3)
    u_base, x_base = inputs[:2]
    B, Nm = u_base.shape
    Nd = x_base.shape[1]
    tf32_flop = passes * 2 * B * Nm * Nm + 3 * 2 * B * Nm * Nd
    ms_ops = 1e3 * tf32_flop / PEAK_TF32_FLOPS
    ms_bytes = 1e3 * (nbytes(*inputs) + nbytes(x_base, u_base, u_base)) / PEAK_BYTES_PER_S
    print(f"[wide u-only bound] {passes} TF32 passes of ({B} x {Nm}) @ ({Nm} x {Nm}) "
          f"({refresh} 3xTF32 refreshes, {kinds.count(1)} one-pass deltas, "
          f"{kinds.count(6)} 6xTF32 iterations) and a 3xTF32 x product: {tf32_flop:.4g} TF32 FLOP, {ms_ops:.4f} ms "
          f"at {PEAK_TF32_FLOPS / 1e12:g} TFLOP/s; bytes {ms_bytes:.4f} ms")
    return {"bound_ms": max(ms_ops, ms_bytes),
            "bound_by": "operations" if ms_ops >= ms_bytes else "bytes",
            "bound_ops": "TF32 tensor cores: 3xTF32 refreshes, one-pass deltas, 6xTF32 tail"}


def phase_wide_time(solver, inputs, card):
    """The wide kernel (the bench's delta schedule, and refresh_every 1),
    its plain version and, as a yardstick the port never calls, 100 f32
    cuBLAS products of the loop's shape; windows alternate."""
    kw = solver.kernel_options
    B, Nm = inputs[0].shape
    yardstick = f"{WIDE_ITERS} f32 cuBLAS products ({B} x {Nm}) @ ({Nm} x {Nm})"
    one = dict(kw, refresh_every=1)
    timed = _timed({
        "kernel": (lambda: admm_u_only(*inputs, solver.packed, **kw), TIMING_WINDOWS,
                   CALLS_PER_WINDOW),
        "kernel, refresh_every=1": (lambda: admm_u_only(*inputs, solver.packed, **one),
                                    TIMING_WINDOWS, CALLS_PER_WINDOW),
        "plain": (lambda: admm_u_only_reference(*inputs, **kw), WIDE_PLAIN_WINDOWS, 1),
        yardstick: (cublas_products(inputs[0], inputs[2], n=WIDE_ITERS), TIMING_WINDOWS,
                    CALLS_PER_WINDOW),
    })
    for name, (med, q1, q3, n) in timed.items():
        print(f"[wide u-only time] {name}: {med:.4f} ms per solve (IQR {q1:.4f}-{q3:.4f}, {n} "
              f"windows) = {B * WIDE_ITERS / (med * 1e-3):.4g} ADMM iterations/s at B={B}, "
              f"Nm={Nm}, {WIDE_ITERS} iterations, batch_tile={kw['batch_tile']}; card: {card}")
    return {name: med for name, (med, *_) in timed.items()}


def robust2_flops(solver, batch: int, iters: int) -> tuple[float, float]:
    """(f32 CUDA-core FLOP of the consensus z-update, FLOP of the products)
    of `iters` iterations of the robust_dim 2 fleet, counted from the
    kernel's loops over the nonzero coefficients (csrc/sls_admm.cu,
    `Consensus`): per row and inner iteration the x-update (4 an A
    nonzero, 2 an l_inv nonzero) and each set's A x + b, SOC projection
    and dual update (2 an A nonzero + 6 q + 5); once a row the start (2 an
    A nonzero + q a set), the last x-update and the row's u, y, z and
    lambda (7 a slab)."""
    ko = solver.kernel_options
    A = np.stack(ko["soc_A"])
    nnz_a = int(np.count_nonzero(A))
    nnz_l = int(np.count_nonzero(ko["l_inv_cons"]))
    n_sets, q = A.shape[0], A.shape[1]
    p1, Nm = solver.U_base.shape
    inner = 6 * nnz_a + 2 * nnz_l + n_sets * (6 * q + 5)
    row = ko["n_cons_iters"] * inner + (4 * nnz_a + 2 * nnz_l) + (2 * nnz_a + n_sets * q) + 7 * p1
    return float(row * Nm * batch * iters), float(2 * p1 * Nm * Nm * batch * iters)


def phase_robust2(device, card):
    """The robust_dim 2 consensus fleet (p1 = 3): the kernel against its
    plain version on the same card inputs, with the kernel's 3xTF32
    products and in f32 (SLS_FIXED_TOL x max(1, max|U|)); the main path
    with the counters set to 0 and the plain version patched to raise;
    the gates (converged_frac >= 0.99, the largest violation of a row's
    set by U's rows <= ROBUST2_VIOLATION_TOL, the f64 oracle's cost gap on
    2 instances, median and max <= ROBUST2_GAP_MEDIAN and _MAX); the kernel
    and plain times and the bound."""
    (A, B, cost), solver = sls_robust2_solver(device)
    bounds = sls_bounds(device, batch=SLS_BATCH)
    kw = solver.kernel_options
    ops = (bounds, solver.U_base, solver.W)
    got = sls_admm(*ops, solver.packed, **kw)
    torch.cuda.synchronize()
    emulated = sls_admm_reference(*ops, **kw, products="tf32x3")
    want = sls_admm_reference(*ops, **kw)
    tol = SLS_FIXED_TOL * max(1.0, float(emulated.abs().max()))
    errs = {"3xTF32": float((got - emulated).abs().max()), "f32": float((got - want).abs().max())}
    print(f"[sls robust_dim 2 kernel vs plain] consensus p1=3 (batch {SLS_BATCH}, tile "
          f"{kw['batch_tile']}): against the 3xTF32 plain version {errs['3xTF32']:.3e}, against "
          f"the f32 plain version {errs['f32']:.3e} (tolerance {tol:.3g}); 3xTF32 plain vs f32 "
          f"plain {float((emulated - want).abs().max()):.3e}")
    check(bool(torch.isfinite(got).all()), "robust_dim 2: kernel U has non-finite values")
    for name, err in errs.items():
        check(err <= tol, f"robust_dim 2: kernel disagrees with the {name} plain version")

    def plain_must_not_run(*args, **kwargs):
        raise SmokeFailure("the robust_dim 2 main path ran the plain version of the kernel")

    reset_launch_counts()
    with _swapped(fused_sls, sls_admm_reference=plain_must_not_run):
        du, phi_u, U = solver(bounds)
    torch.cuda.synchronize()
    launches = fused_sls.launch_count
    print(f"[sls robust_dim 2 main path] sls_admm kernel launches: {launches}")
    check(launches == 1, "the robust_dim 2 main path did not launch the sls_admm kernel once")
    check(tuple(U.shape) == (SLS_BATCH, N, 3) and tuple(phi_u.shape) == (SLS_BATCH, N, 2 * N)
          and torch.equal(du, U[:, :, 0]) and torch.equal(phi_u[:, :, :2], U[:, :, 1:]),
          "unexpected robust_dim 2 outputs")
    t0 = time.perf_counter()
    cert = certify_sls(A, B, cost, bounds, U, C_COEF, n_oracle=ROBUST2_N_ORACLE,
                       workers=ROBUST2_N_ORACLE)
    print(f"[sls robust_dim 2 main path] certificates ({time.perf_counter() - t0:.1f} s): "
          f"converged_frac {cert['converged_frac']} (||U - P(U)|| < 5e-3; max "
          f"{cert['prim_max']:.3e}), cone violation of U's rows {cert['cone_violation']:.3e} "
          f"(limit {ROBUST2_VIOLATION_TOL:g}; f64 on the host 2.63e-3), oracle cost gap median "
          f"{cert['cost_gap_median']:.3e} max {cert['cost_gap_max']:.3e} on instances "
          f"{cert['oracle_indices']} (limits {ROBUST2_GAP_MEDIAN:g}, {ROBUST2_GAP_MAX:g}; f64 on "
          f"the host 3.29e-4, 3.33e-4)")
    check(cert["converged_frac"] >= 0.99, f"robust_dim 2 converged_frac {cert['converged_frac']}")
    check(cert["cone_violation"] <= ROBUST2_VIOLATION_TOL,
          f"robust_dim 2 cone violation {cert['cone_violation']}")
    check(cert["cost_gap_median"] <= ROBUST2_GAP_MEDIAN and cert["cost_gap_max"] <= ROBUST2_GAP_MAX,
          f"robust_dim 2 cost gap {cert['cost_gap_median']}, {cert['cost_gap_max']}")
    timed = _timed({
        "kernel": (lambda: sls_admm(*ops, solver.packed, **kw), TIMING_WINDOWS, CALLS_PER_WINDOW),
        "plain": (lambda: sls_admm_reference(*ops, **kw), 1, 1),
    })
    for name, (med, q1, q3, n) in timed.items():
        print(f"[sls robust_dim 2 time] {name}: {med:.4f} ms per solve (IQR {q1:.4f}-{q3:.4f}, "
              f"{n} windows) = {SLS_BATCH / (med * 1e-3):.6g} syntheses/s; card: {card}")
    z_flop, mm_flop = robust2_flops(solver, SLS_BATCH, kw["n_iters"])
    ms_z = 1e3 * z_flop / PEAK_F32_FLOPS
    ms_mm = 3e3 * mm_flop / PEAK_TF32_FLOPS
    ms_bytes = 1e3 * (nbytes(bounds, solver.U_base, solver.W) + 4 * U.numel()) / PEAK_BYTES_PER_S
    print(f"[sls robust_dim 2 bound] z-update {z_flop:.4g} f32 FLOP ({ms_z:.4f} ms at "
          f"{PEAK_F32_FLOPS / 1e12:g} TFLOP/s), products {mm_flop:.4g} FLOP as 3xTF32 "
          f"({ms_mm:.4f} ms), bytes {ms_bytes:.4f} ms")
    bound_ms = max(ms_z, ms_mm, ms_bytes)
    return {"launches": launches, "max_abs_err": errs["3xTF32"], "ms": timed["kernel"][0],
            "plain_ms": timed["plain"][0], "bound_ms": bound_ms,
            "bound_by": "bytes" if ms_bytes == bound_ms else "operations",
            "bound_ops": "f32 CUDA cores (the consensus z-update)" if ms_z >= ms_mm
            else "3xTF32 tensor cores"}


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
    cert = certify_sls(A, B, cost, bounds, U, C_COEF, workers=ORACLE_WORKERS)
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
        # the plain consensus loop issues ~4e5 small launches a solve (~4 s):
        # one window since PR 12 (three before), for the run's length
        plain_windows, plain_calls = (1, 1) if mode == "consensus" else (5, 2)
        _, solver = sls_solver(device, mode)
        for batch in SLS_TIME_BATCHES:
            # consensus at 16,384 is ~0.11 s a call: 2 calls a window (10
            # before, cut for the run's length)
            per_window = 2 if mode == "consensus" and batch > SLS_BATCH else CALLS_PER_WINDOW
            bounds = sls_bounds(device, batch=batch, sort=mode == "diamond_ee")
            kw = solver.kernel_options
            ops = (bounds, solver.U_base, solver.W)
            paths = {
                "kernel": (lambda: sls_admm(*ops, solver.packed, **kw), TIMING_WINDOWS,
                           per_window),
                "forward": (lambda: solver(bounds), TIMING_WINDOWS, per_window),
                "plain": (lambda: sls_admm_reference(*ops, **kw), plain_windows, plain_calls),
            }
            for fn, _, calls in paths.values():  # warm up all but one-call paths, as _timed
                if calls > 1:
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
    busy, n_ops, kernels, _ = kineto_split(prof)
    busy_us = busy * 1e6
    waits = kineto_counts(prof, HOST_WAITS)
    print(f"[car profile] the solve's first {res.outer_iters} outer steps: wall {wall_us / 1e3:.1f} ms "
          f"under the profiler; host reads of stop flags {flag_reads}; host-side sync and copy "
          f"calls {waits}; card: {card}")
    if busy_us <= 0.0:
        print("[car profile] the profiler saw no device time: not measured")
        return None
    print(f"[car profile] device busy {busy_us / 1e3:.1f} ms = {100 * busy_us / wall_us:.2f}% of "
          f"the wall time; {n_ops} device ops of {len(kernels)} kinds")
    for name, (t, c) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[car profile] {t * 1e3:9.3f} ms, {c:6d} calls: {name[:90]}")
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
    cert = certify_arm(arm, cost, q0s, res, ARM_U_BOUND, workers=ORACLE_WORKERS)
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


def kineto_split(prof, ranges=()):
    """A profile's device time from its raw kineto events (the profiler's
    `key_averages` builds an event tree that takes minutes at the ~10^6
    events of a fleet solve): (device seconds, device ops, {kernel:
    (seconds, calls)}, {range: (calls, host seconds, device seconds of
    the kernels its CPU ops launched)}) for the `record_function` ranges
    named."""
    from torch.autograd import DeviceType

    op_start, spans, device = {}, {name: [] for name in ranges}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and e.name() not in spans:
                device.append(e)
        elif e.is_user_annotation():
            if e.name() in spans:
                spans[e.name()].append((e.start_ns(), e.end_ns()))
        else:
            op_start[e.correlation_id()] = e.start_ns()
    busy, kernels = 0.0, {}
    in_range = {name: 0.0 for name in spans}
    starts = {name: sorted(v) for name, v in spans.items()}
    for e in device:
        sec = e.duration_ns() * 1e-9
        busy += sec
        t, c = kernels.get(e.name(), (0.0, 0))
        kernels[e.name()] = (t + sec, c + 1)
        launched = op_start.get(e.linked_correlation_id())
        if launched is None:
            continue
        for name, v in starts.items():
            i = bisect.bisect_right(v, (launched, float("inf"))) - 1
            if i >= 0 and v[i][0] <= launched <= v[i][1]:
                in_range[name] += sec
    split = {name: (len(v), sum(b - a for a, b in v) * 1e-9, in_range[name])
             for name, v in spans.items()}
    return busy, len(device), kernels, split


HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "aten::_local_scalar_dense",
              "aten::item", "cudaMemcpyAsync")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def kineto_counts(prof, names):
    """{name: calls} of the profile's host-side events with those names,
    from the raw kineto events (as `kineto_split`, without the event tree
    of `key_averages`)."""
    from torch.autograd import DeviceType

    counts = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA and e.name() in names:
            counts[e.name()] = counts.get(e.name(), 0) + 1
    return counts


def phase_arm_profile(device, card, problems, used):
    """`torch.profiler` over one inner-mode fleet solve: the device busy
    share of the wall time, the device ops, and the device time under the
    solver's three ranges (linearization + normal equations + Cholesky,
    the ADMM iterations, the line-search rollouts inside them)."""
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
    busy, n_ops, kernels, split = kineto_split(prof, names)
    busy_us = busy * 1e6
    print(f"[arm profile] one inner-mode fleet solve, {int(res.outer_iters.max())} outer steps: "
          f"wall {wall_us / 1e3:.1f} ms under the profiler; card: {card}")
    if busy_us <= 0.0:
        print("[arm profile] the profiler saw no device time: not measured")
        return None
    print(f"[arm profile] device busy {busy_us / 1e3:.1f} ms = {100 * busy_us / wall_us:.2f}% of "
          f"the wall time; {n_ops} device ops of {len(kernels)} kinds")
    for name in names:
        count, host, dev = split[name]
        if count:
            print(f"[arm profile] {name}: {count} ranges, kernels {dev * 1e3:.1f} ms, host "
                  f"{host * 1e3:.1f} ms")
    for name, (t, c) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[arm profile] {t * 1e3:9.3f} ms, {c:6d} calls: {name[:90]}")
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


def mpc_problem(device, dtype=torch.float32):
    """bench_mpc.py's build(H=40): CarSimple(dt=0.1), the via-point cost to
    (2, 1) (diag(1, 1, 0, 0.1) on the way, diag(20, 20, 0, 1) at the end,
    u_std 1e-2), its quadratic model, and x0 = (0, 0, 0.5, 0)."""
    kw = dict(dtype=dtype, device=device)
    target = torch.tensor([*MPC_TARGET, 0.0, 0.0], **kw)
    Qs = torch.stack([torch.diag(torch.tensor([1.0, 1.0, 0.0, 0.1], **kw)),
                      torch.diag(torch.tensor([20.0, 20.0, 0.0, 1.0], **kw))])
    seq = np.zeros(MPC_H, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(torch.stack([target, target]), Qs, seq, 1e-2, 2)
    return dict(car=CarSimple(dt=0.1), quad=quad, x0=torch.tensor(MPC_X0, **kw),
                get_Cs=lambda xs, us: quad_cost_model(quad.Q, quad.xd, quad.R, xs, us))


def mpc_project(u):
    return torch.clamp(u, -MPC_U_MAX, MPC_U_MAX)


def mpc_step(problem, tick, fleet=False):
    """bench_mpc.py's ticks: 'dp' (the default) or 'sqp' (method='batch',
    line_search='outer'); |u| <= 0.6, rho_u = 1, 2 outer x 5 ADMM
    iterations, 10 alphas. fleet: the fleet form."""
    make = make_mpc_fleet_step_constrained if fleet else make_mpc_step_constrained
    return make(problem["car"].step, problem["car"].get_AB, problem["quad"],
                get_Cs=problem["get_Cs"], project_u=mpc_project, rho_u=1.0, n_outer_iters=2,
                n_admm_iters=5, **MPC_TICK_KW[tick])


def mpc_state(problem):
    x0 = problem["x0"]
    return mpc_constrained_init(problem["car"].step, x0, torch.zeros((MPC_H, 2), dtype=x0.dtype),
                                device=x0.device)


def mpc_fleet(problem, batch=MPC_FLEET):
    """The fleet's x0 ~ N(0, 0.3^2) from default_rng(0) (bench_mpc.py:136-140)
    and its initial states."""
    x0 = problem["x0"]
    x0s = torch.tensor(np.random.default_rng(0).normal(0, 0.3, size=(batch, 4)), dtype=x0.dtype,
                       device=x0.device)
    zeros = torch.zeros((MPC_H, 2), dtype=x0.dtype, device=x0.device)
    states = vmap(lambda a: mpc_constrained_init(problem["car"].step, a, zeros,
                                                 device=x0.device))(x0s)
    return x0s, states


def mpc_box_problem(device, dtype=torch.float32, horizon=MPC_BOX_N):
    """tests/test_mpc.py:117-149: the 1-D double integrator, N = 50, position
    1 at weight 1e3 at the end, u_std 1e-2, |u| <= 3, x0 = 0 (the horizon
    N = 80 is the barrier test's)."""
    kw = dict(dtype=dtype, device=device)
    plant = DoubleIntegrator(1, 2, dt=1.0 / horizon, **kw)
    zs = torch.stack([torch.zeros(2, **kw), torch.tensor([1.0, 0.0], **kw)])
    Qs = torch.stack([torch.zeros((2, 2), **kw), torch.eye(2, **kw) * 1e3])
    seq = np.zeros(horizon, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, 1)
    A, B = plant.AB(horizon)
    return dict(f=plant.step, get_AB=lambda xs, us: (A, B), cost=cost, x0=torch.zeros(2, **kw),
                get_Cs=lambda xs, us: quad_cost_model(cost.Q, cost.xd, cost.R, xs, us))


def mpc_box_step(problem, riccati):
    return make_mpc_step_boxddp(problem["f"], problem["get_AB"], problem["cost"],
                                problem["get_Cs"], -MPC_BOX_U, MPC_BOX_U, n_iters=3,
                                riccati=riccati)


def mpc_box_state(problem):
    x0 = problem["x0"]
    return mpc_init(problem["f"], x0, torch.zeros((MPC_BOX_N, 1), dtype=x0.dtype),
                    device=x0.device)


def _window_sizes(n_ticks, windows=MPC_WINDOWS):
    return [n_ticks // windows + (i < n_ticks % windows) for i in range(windows)]


def mpc_closed_loop(step, plant, state, x0, n_ticks):
    """`run_mpc` over n_ticks in MPC_WINDOWS windows, the state carried
    across; each window on the host clock with a synchronize at its ends
    and no host read inside. Returns (xs, us, ms a tick of each window,
    host reads of stop flags)."""
    device = x0.device
    xs_all, us_all, ms = [], [], []
    x = x0
    reads0 = admm_solver.host_sync_count
    for n in _window_sizes(n_ticks):
        sync(device)
        t0 = time.perf_counter()
        xs, us, state = run_mpc(plant, step, state, x, n)
        x = plant(xs[-1], us[-1])
        sync(device)
        ms.append((time.perf_counter() - t0) * 1e3 / n)
        xs_all.append(xs)
        us_all.append(us)
    return torch.cat(xs_all), torch.cat(us_all), ms, admm_solver.host_sync_count - reads0


def mpc_served(step, plant, state, x, n_ticks):
    """The per-tick serving loop of bench_mpc.py:105-116: each tick one host
    call whose time closes on the readback of max|u|; the plant advances
    outside the timer. Returns (ms a tick of each window, max|u|, host reads
    a tick)."""
    ms, u_max = [], 0.0
    reads0 = admm_solver.host_sync_count
    for n in _window_sizes(n_ticks):
        t = 0.0
        for _ in range(n):
            t0 = time.perf_counter()
            u, state = step(state, x)
            u_max = max(u_max, float(u.abs().max()))
            t += time.perf_counter() - t0
            x = plant(x, u)
        ms.append(t * 1e3 / n)
    return ms, u_max, (admm_solver.host_sync_count - reads0) / n_ticks


@contextlib.contextmanager
def _stop_flags_read():
    """Every stop flag read on the host, as in a tick whose tolerances are
    not all 0 (what the port did before the zero-tolerance skip)."""
    always = dict(can_stop=lambda cfg: True)
    outer = dict(outer_can_stop=lambda outer_tol, osc_tol: True)
    with _swapped(admm_solver, **always), _swapped(ilqr_admm_solver, **outer), \
            _swapped(batched_ilqr_admm, **always, **outer):
        yield


def mpc_graph(step, plant, state, x0):
    """A CUDA graph of one closed-loop tick on static buffers: each replay
    runs the tick and the plant and writes the new state and x over the
    old. A capture that fails raises. Returns (graph, the static x, the
    static u of the last replay, the static state)."""
    static = type(state)(*(t.clone() for t in state))
    x_s = x0.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: workspaces, caches, handles
        step(static, x_s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        u, new = step(static, x_s)
        x_next = plant(x_s, u)
        for old, t in zip(static, new):
            old.copy_(t)
        x_s.copy_(x_next)
    return graph, x_s, u, static


def mpc_graph_loop(graph, x_s, u_s, n_ticks):
    """n_ticks replays in MPC_WINDOWS windows, each x and u copied to a log
    on the device. Returns (xs, us, ms a tick of each window)."""
    xs = torch.empty((n_ticks,) + tuple(x_s.shape), dtype=x_s.dtype, device=x_s.device)
    us = torch.empty((n_ticks,) + tuple(u_s.shape), dtype=u_s.dtype, device=u_s.device)
    ms, t = [], 0
    for n in _window_sizes(n_ticks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            xs[t].copy_(x_s)
            graph.replay()
            us[t].copy_(u_s)
            t += 1
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / n)
    return xs, us, ms


def _ms(label, ms):
    med, q1, q3 = _median_iqr(ms)
    return f"{label + ' ' if label else ''}{med:.3f} ms a tick (IQR {q1:.3f}-{q3:.3f}; {', '.join(f'{v:.3f}' for v in ms)})"


def _park_error(xs, us, problem):
    """The car's distance to the target after the last tick."""
    x_end = problem["car"].step(xs[-1], us[-1])
    target = torch.tensor(MPC_TARGET, dtype=x_end.dtype, device=x_end.device)
    return float(torch.linalg.norm(x_end[:2] - target))


def _mpc_car_gates(xs, us, problem):
    u_max = float(us.abs().max())
    park = _park_error(xs, us, problem)
    failures = []
    if not u_max <= MPC_U_MAX + MPC_U_TOL:
        failures.append(f"max|u| {u_max:.6f} > {MPC_U_MAX} + {MPC_U_TOL:g}")
    if not park <= MPC_PARK_TOL:
        failures.append(f"parked {park:.4f} from the target > {MPC_PARK_TOL}")
    return failures


def mpc_loops(step, plant, state, x0, n_ticks, label):
    """The closed loops of one tick from one start: MPC_EAGER_TICKS ticks
    through `run_mpc` with no host read between them (the launch counters
    set to 0 before, read after), then a CUDA graph of the tick replayed
    n_ticks times, whose first ticks must be the eager loop's. Returns
    (xs, us of the graph's loop, eager ms a tick by window, graph ms a
    tick by window)."""
    reset_launch_counts()
    exs, eus, ems, reads = mpc_closed_loop(step, plant, state, x0, MPC_EAGER_TICKS)
    counts = launch_counts()
    check(reads == 0, f"mpc {label}: {reads} host reads in the closed loop")
    graph, x_s, u_s, _ = mpc_graph(step, plant, state, x0)
    xs, us, gms = mpc_graph_loop(graph, x_s, u_s, n_ticks)
    du = float((us[:MPC_EAGER_TICKS] - eus).abs().max())
    print(f"[mpc] {label}: {_ms(f'eager closed loop ({MPC_EAGER_TICKS} ticks, no host read)', ems)}"
          f"; host reads of stop flags {reads}; kernel launches {sum(counts.values())} (no TPU "
          f"kernel lies on this path); {_ms(f'one CUDA graph of the tick replayed {n_ticks} times', gms)}"
          f"; max |du| of its first {MPC_EAGER_TICKS} ticks against the eager loop {du:.3e}")
    check(du <= MPC_GRAPH_TOL, f"mpc {label}: the graph's ticks differ from the eager ones by {du}")
    return xs, us, ems, gms


def _f32_then_f64(run, label):
    """run(dtype) -> (result, gate failures) in f32, and again in f64,
    labelled, where f32 misses a gate."""
    for dtype in (torch.float32, torch.float64):
        out, failures = run(dtype)
        name = f"{label}, {str(dtype).replace('torch.', '')}"
        print(f"[mpc] {name}: gates {'pass' if not failures else 'MISSED: ' + '; '.join(failures)}")
        if not failures:
            return out
        check(dtype == torch.float32, f"mpc {name}: " + "; ".join(failures))
        print(f"[mpc] {label}: f32 misses the gates; the loops run again in f64")


def phase_mpc_car(device, card):
    """Each tick of bench_mpc.py on one controller, f32 (f64 where f32
    misses a gate, labelled): `mpc_loops` over MPC_TICKS ticks, gated on
    the graph's loop (max|u|, parking within 0.05), then the per-tick
    serving loop with its u readback, and the same with every stop flag
    read on the host."""
    out = {}
    for tick in MPC_TICK_KW:
        def run(dtype):
            problem = mpc_problem(device, dtype)
            step, plant = mpc_step(problem, tick), problem["car"].step
            label = f"car {tick} tick, {str(dtype).replace('torch.', '')}"
            xs, us, ems, gms = mpc_loops(step, plant, mpc_state(problem), problem["x0"], MPC_TICKS,
                                         label)
            print(f"[mpc] {label}: max|u| {float(us.abs().max()):.6f} (bound {MPC_U_MAX}), parked "
                  f"{_park_error(xs, us, problem):.5f} from (2, 1) after {MPC_TICKS} ticks (gate "
                  f"{MPC_PARK_TOL}); card: {card}")
            return (problem, step, ems, gms, str(dtype).replace("torch.", "")), \
                _mpc_car_gates(xs, us, problem)

        problem, step, ems, gms, dtype = _f32_then_f64(run, f"car {tick} tick")
        plant, label = problem["car"].step, f"car {tick} tick, {dtype}"
        served, served_u, served_reads = mpc_served(step, plant, mpc_state(problem), problem["x0"],
                                                    MPC_EAGER_TICKS)
        with _stop_flags_read():
            read_ms, _, read_reads = mpc_served(step, plant, mpc_state(problem), problem["x0"],
                                                MPC_EAGER_TICKS)
        check(served_u <= MPC_U_MAX + MPC_U_TOL, f"mpc {label}: served max|u| {served_u}")
        print(f"[mpc] {label}: {_ms('served (a host call and the u readback a tick)', served)}, "
              f"{served_reads:g} host reads a tick; with every stop flag read on the host "
              f"{_ms('', read_ms)}, {read_reads:g} reads a tick; card: {card}")
        out[tick] = dict(eager=ems, graph=gms, served=served, served_reads=read_ms, dtype=dtype)
    return out


def phase_mpc_fleet(device, card):
    """The fleet of MPC_FLEET controllers in each tick, f32: `mpc_loops`
    over MPC_TICKS ticks (gated: max|u|), ms a fleet tick and
    controller-ticks/s; then the first MPC_COMPARE controllers against as
    many single ticks over MPC_COMPARE_TICKS ticks."""
    problem = mpc_problem(device)
    plant = vmap(problem["car"].step)
    x0s, states = mpc_fleet(problem)
    out = {}
    for tick in MPC_TICK_KW:
        step = mpc_step(problem, tick, fleet=True)
        label = f"fleet of {MPC_FLEET}, {tick} tick, f32"
        xs, us, ems, gms = mpc_loops(step, plant, states, x0s, MPC_TICKS, label)
        u_max = float(us.abs().max())
        rates = [MPC_FLEET / _median_iqr(v)[0] * 1e3 for v in (ems, gms)]
        print(f"[mpc] {label}: {rates[0]:.1f} controller-ticks/s eager, {rates[1]:.1f} as a graph; "
              f"max|u| {u_max:.6f} (bound {MPC_U_MAX}); card: {card}")
        check(u_max <= MPC_U_MAX + MPC_U_TOL, f"mpc {label}: max|u| {u_max}")
        check(bool(torch.isfinite(xs).all()), f"mpc {label}: non-finite states")
        out[tick] = dict(eager=ems, graph=gms)
        single = mpc_step(problem, tick)
        sub = type(states)(*(t[:MPC_COMPARE] for t in states))
        singles = [type(states)(*(t[i] for t in states)) for i in range(MPC_COMPARE)]
        xf, xi = x0s[:MPC_COMPARE], list(x0s[:MPC_COMPARE])
        du = 0.0
        for _ in range(MPC_COMPARE_TICKS):
            uf, sub = step(sub, xf)
            for i in range(MPC_COMPARE):
                ui, singles[i] = single(singles[i], xi[i])
                du = max(du, float((uf[i] - ui).abs().max()))
                xi[i] = problem["car"].step(xi[i], ui)
            xf = plant(xf, uf)
        print(f"[mpc] {tick} tick: the fleet of {MPC_COMPARE} against {MPC_COMPARE} single ticks "
              f"over {MPC_COMPARE_TICKS} ticks: max |du| {du:.3e} (gate {MPC_COMPARE_TOL:g})")
        check(du <= MPC_COMPARE_TOL, f"mpc fleet {tick}: {du:.3e} from the single ticks")
    return out


def _box_gates(xs, us, riccati):
    """tests/test_mpc.py:143-149 (seq), :179-180 (parallel)."""
    u_max = float(us.abs().max())
    err = abs(float(xs[-1, 0]) - 1.0)
    tail = float((xs[-20:, 0] - 1.0).abs().max())
    failures = []
    if not u_max <= MPC_BOX_U + 1e-12:
        failures.append(f"max|u| {u_max} > {MPC_BOX_U}")
    if not err < 0.05:
        failures.append(f"final position {err:.4f} from 1")
    if riccati == "seq" and not tail < 0.08:
        failures.append(f"last 20 ticks up to {tail:.4f} from 1 (limit cycle)")
    if riccati == "seq" and not u_max > 2.99:
        failures.append(f"the bound never binds (max|u| {u_max})")
    return failures


def phase_mpc_boxddp(device, card):
    """The boxDDP tick of tests/test_mpc.py:117-181 with each backward, f32
    (f64 where f32 misses a gate, labelled): `mpc_loops` over
    MPC_BOX_TICKS ticks with the test's gates on the graph's loop, and
    the served loop."""
    out = {}
    for riccati in MPC_BOX_RICCATI:
        def run(dtype):
            problem = mpc_box_problem(device, dtype)
            step = mpc_box_step(problem, riccati)
            label = f"boxDDP tick, riccati={riccati}, {str(dtype).replace('torch.', '')}"
            xs, us, ems, gms = mpc_loops(step, problem["f"], mpc_box_state(problem), problem["x0"],
                                         MPC_BOX_TICKS, label)
            print(f"[mpc] {label}: max|u| {float(us.abs().max()):.6f} (bound {MPC_BOX_U}), position "
                  f"{float(xs[-1, 0]):.5f} after {MPC_BOX_TICKS} ticks, the last 20 within "
                  f"{float((xs[-20:, 0] - 1.0).abs().max()):.5f} of 1; card: {card}")
            return (problem, step, ems, gms, label), _box_gates(xs, us, riccati)

        problem, step, ems, gms, label = _f32_then_f64(run, f"boxDDP tick, riccati={riccati}")
        served, served_u, _ = mpc_served(step, problem["f"], mpc_box_state(problem), problem["x0"],
                                         MPC_EAGER_TICKS)
        check(served_u <= MPC_BOX_U, f"mpc {label}: served max|u| {served_u}")
        print(f"[mpc] {label}: {_ms('served', served)}; card: {card}")
        out[riccati] = dict(eager=ems, graph=gms, served=served)
    return out


def phase_mpc_profile(device, card):
    """`torch.profiler` over one dp tick of the car (the default tick,
    f32): device busy share of the wall time, the top device ops, and the
    host-side sync and copy calls."""
    from torch.profiler import ProfilerActivity, profile

    problem = mpc_problem(device)
    step, state = mpc_step(problem, "dp"), mpc_state(problem)
    step(state, problem["x0"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, problem["x0"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, n_ops, kernels, _ = kineto_split(prof)
    busy_us = busy * 1e6
    waits = kineto_counts(prof, HOST_WAITS)
    launches = sum(kineto_counts(prof, LAUNCHES).values())
    print(f"[mpc profile] one dp tick: wall {wall_us / 1e3:.1f} ms under the profiler; kernel "
          f"launches {launches}; host-side sync and copy calls {waits}; card: {card}")
    if busy_us <= 0.0:
        print("[mpc profile] the profiler saw no device time: not measured")
        return None
    print(f"[mpc profile] device busy {busy_us / 1e3:.2f} ms = {100 * busy_us / wall_us:.2f}% of "
          f"the wall time; {n_ops} device ops of {len(kernels)} kinds")
    for name, (t, c) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[mpc profile] {t * 1e3:8.3f} ms, {c:6d} calls: {name[:90]}")
    return {"busy_share": busy_us / wall_us}


# ---- slice 12: barrier, AL and PD iLQR; the boxDDP car and AL arm fleets ----


def _same_stop(a, b) -> bool:
    return a == b or (a in STOPS and b in STOPS)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def al_obstacle_problem(device, dtype=torch.float32):
    """examples/al_obstacle_avoidance.py: a 2-D double integrator, N = 100,
    (1, 1) at weight 1e3 at the end, u_std 1e-2, two keep-out circles."""
    N = 100
    kw = dict(dtype=dtype, device=device)
    plant = DoubleIntegrator(2, 2, dt=1.0 / N, **kw)
    A, B = plant.AB(N)
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(torch.stack([torch.zeros(4, **kw), torch.tensor([1.0, 1.0, 0.0, 0.0], **kw)]),
                         torch.stack([torch.zeros((4, 4), **kw), torch.eye(4, **kw) * 1e3]), seq,
                         1e-2, 2)
    centers = torch.tensor([[0.32, 0.28], [0.68, 0.77]], **kw)
    radii = torch.tensor([0.18, 0.15], **kw)

    def keep_out(x, u):
        return radii - torch.linalg.norm(x[:2][None, :] - centers, dim=-1)

    return dict(f=plant.step, get_AB=lambda xs, us: (A, B), cost=cost, x0=torch.zeros(4, **kw),
                u0=torch.zeros((N, 2), **kw), ineq=keep_out, centers=centers, radii=radii,
                get_Cs=lambda xs, us: quad_cost_model(cost.Q, cost.xd, cost.R, xs, us))


def al_obstacle_solve(p):
    return al_ilqr_solve(p["f"], p["get_AB"], p["get_Cs"], p["cost"], p["x0"], p["u0"],
                         ineq=p["ineq"], cfg=ILQRConfig(max_iter=40, tol_fun=1e-10), n_al=12,
                         mu0=10.0, mu_factor=5.0, tol_con=1e-7, device=p["x0"].device)


def barrier_problem(device, dtype=torch.float32):
    """tests/test_boxddp.py::_lq_setup(m=1, N=80) (`mpc_box_problem` at N =
    80) with the barrier of |u| <= 5, from u = 0."""
    p = mpc_box_problem(device, dtype, horizon=80)
    p["u0"] = torch.zeros((80, 1), dtype=dtype, device=device)
    p["barrier"] = make_barrier(ineq=lambda x, u: torch.cat([u + 5.0, 5.0 - u]))
    return p


def barrier_solve(p):
    return barrier_ilqr_solve(p["f"], p["get_AB"], p["get_Cs"], p["cost"], p["x0"], p["u0"],
                              p["barrier"], cfg=ILQRConfig(max_iter=40, tol_fun=1e-10), mu0=1.0,
                              mu_factor=8.0, n_barrier=7, device=p["x0"].device)


def barrier_boxddp(p):
    fns = (p["f"], p["get_AB"], p["get_Cs"], p["cost"])
    st = boxddp_init(p["f"], p["cost"], p["x0"], p["u0"], -5.0, 5.0, device=p["x0"].device)
    return boxddp_solve(*fns, st, -5.0, 5.0, cfg=ILQRConfig(max_iter=60, tol_fun=1e-10))


def pd_problem(device, dtype=torch.float32):
    """examples/pd_ilqr_infeasible_start.py: CarSimple(dt=0.1), N = 60, the
    via-point cost to (1.5, 1) and the straight-line state path from x0 =
    (0, 0, 0.3, 0) with zero controls."""
    N = 60
    kw = dict(dtype=dtype, device=device)
    target = torch.tensor([1.5, 1.0, 0.0, 0.0], **kw)
    Qs = torch.stack([torch.diag(torch.tensor([1.0, 1.0, 0.0, 0.1], **kw)) * 1e-2,
                      torch.diag(torch.tensor([20.0, 20.0, 0.0, 1.0], **kw))])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(torch.stack([target, target]), Qs, seq, 1e-2, 2)
    x0 = torch.tensor([0.0, 0.0, 0.3, 0.0], **kw)
    line = torch.linspace(0.0, 1.0, N, **kw)[:, None] * (target - x0)[None] + x0[None]
    line[0] = x0

    def cost_fn(xs, us):
        dx = xs - quad.xd
        return (torch.einsum("ti,tij,tj->", dx, quad.Q, dx)
                + torch.einsum("ti,tij,tj->", us, quad.R, us))

    car = CarSimple(dt=0.1)
    return dict(f=car.step, get_AB=car.get_AB, cost=cost_fn, line=line,
                u0=torch.zeros((N, 2), **kw),
                get_Cs=lambda xs, us: quad_cost_model(quad.Q, quad.xd, quad.R, xs, us))


def pd_solve(p):
    st = pd_ilqr_init(p["cost"], p["f"], p["line"], p["u0"], device=p["line"].device)
    return pd_ilqr_solve(p["f"], p["get_AB"], p["get_Cs"], p["cost"], st,
                         ILQRConfig(max_iter=80, tol_fun=1e-9))


def _timed_solve(fn, device):
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


SINGLE_CASES = {"AL keep-out": (al_obstacle_problem, al_obstacle_solve),
                "barrier |u| <= 5": (barrier_problem, barrier_solve),
                "PD car from a straight line": (pd_problem, pd_solve)}


def _single_host_f64(name):
    """(result, seconds) of a single solve in f64 on this host (a worker
    process with one thread, beside the card's solves)."""
    torch.set_num_threads(1)
    problem, solve = SINGLE_CASES[name]
    return _timed_solve(lambda: solve(problem("cpu", torch.float64)), "cpu")


def phase_single_solves(device, card):
    """The barrier, AL and PD single solves on the card in f32, each against
    the port's f64 solve of the same problem on the host (in worker
    processes beside the card's solves, since PR 15): cost within
    SINGLE_COST_REL, statuses the same stop, and each problem's own gates.
    Returns {name: seconds of the card's solve}."""
    out = {}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(len(SINGLE_CASES), mp_context=ctx) as pool:
        hosts = {name: pool.submit(_single_host_f64, name) for name in SINGLE_CASES}
        cards = {}
        for name, (problem, solve) in SINGLE_CASES.items():
            p_card = problem(device)
            cards[name] = (p_card, *_timed_solve(lambda: solve(p_card), device))
        hosts = {name: future.result() for name, future in hosts.items()}
    for name, (p_card, res, seconds) in cards.items():
        host, host_s = hosts[name]
        status = int(res.status)
        rel = abs(float(res.cost) - float(host.cost)) / abs(float(host.cost))
        print(f"[single] {name}: card f32 cost {float(res.cost):.7f}, status {status}, "
              f"{seconds:.2f} s; host f64 cost {float(host.cost):.7f}, status {int(host.status)}, "
              f"{host_s:.2f} s; |dcost|/cost {rel:.3e} (gate {SINGLE_COST_REL:g}); card: {card}")
        check(bool(torch.isfinite(res.u_nom).all() and torch.isfinite(res.x_nom).all()),
              f"{name}: non-finite result")
        check(rel <= SINGLE_COST_REL, f"{name}: f32 cost {rel:.3e} from the f64 host solve")
        check(_same_stop(status, int(host.status)),
              f"{name}: status {status} on the card, {int(host.status)} on the host")
        if name.startswith("AL"):
            ps = res.x_nom[:, :2]
            dists = torch.linalg.norm(ps[:, None, :] - p_card["centers"][None], dim=-1)
            margin = float((dists - p_card["radii"][None]).min())
            print(f"[single] {name}: keep-out margin {margin:.3e} (gate >= {-AL_MARGIN_TOL:g}), "
                  f"max violation {float(res.max_violation):.3e}, final position "
                  f"({float(ps[-1, 0]):.4f}, {float(ps[-1, 1]):.4f})")
            check(margin >= -AL_MARGIN_TOL, f"{name}: keep-out margin {margin:.3e}")
        elif name.startswith("barrier"):
            box = barrier_boxddp(p_card)
            rel_box = abs(float(res.cost) - float(box.cost)) / max(1.0, abs(float(box.cost)))
            u_max = float(res.u_nom.abs().max())
            print(f"[single] {name}: max|u| {u_max:.6f} (bound 5), the card's boxDDP cost "
                  f"{float(box.cost):.7f}, |dcost| / max(1, cost) {rel_box:.3e} "
                  f"(gate {BARRIER_BOX_REL:g})")
            check(u_max <= 5.0, f"{name}: max|u| {u_max}")
            check(rel_box < BARRIER_BOX_REL, f"{name}: {rel_box:.3e} from the card's boxDDP")
        else:
            defect = float(res.defect)
            print(f"[single] {name}: final defect {defect:.3e} (gate {PD_DEFECT_TOL:g}), "
                  f"{res.iteration} iterations (host {host.iteration})")
            check(defect <= PD_DEFECT_TOL, f"{name}: defect {defect:.3e}")
        out[name] = seconds
    return out


def car_fleet_problem(device, dtype=torch.float32, batch=BOXDDP_FLEET, horizon=BOXDDP_N):
    """bench_boxddp.py's fleet: the car, its parking cost, the bounds, u0 ~
    N(0, 0.1^2) and x0s = golden + N(0, 0.05^2), both from default_rng(0)
    in that order, on `device` in `dtype`."""
    kw = dict(dtype=dtype, device=device)
    rng = np.random.default_rng(0)
    u0 = torch.tensor(rng.normal(size=(horizon, 2)) * 0.1, **kw)
    x0s = torch.tensor(np.array(BOXDDP_X0) + rng.normal(0, 0.05, (batch, 4)), **kw)
    hi = torch.tensor(BOXDDP_BOUND, **kw)
    return dict(car=CarFrontWheel(dt=15.0 / horizon), cost=CarParkingCost(**kw), x0s=x0s,
                u0s=u0.expand(batch, horizon, 2), lo=-hi, hi=hi)


def car_fleet_solve(p, graph=True, stats=None, **over):
    car, cost = p["car"], p["cost"]
    st = boxddp_fleet_init(car.step, cost, p["x0s"], p["u0s"], p["lo"], p["hi"],
                           device=p["x0s"].device)
    return boxddp_fleet_solve(car.step, car.get_AB, cost.get_Cs, cost, st, p["lo"], p["hi"],
                               cfg=ILQRConfig(**dict(BOXDDP_SOLVE, **over)),
                               qp_iters=BOXDDP_QP_ITERS, stats=stats, graph=graph)


def phase_boxddp_graph(device):
    """BOXDDP_GRAPH_ITERS iterations of the whole fleet eagerly and as a
    replayed CUDA graph: the same state bit for bit."""
    p = car_fleet_problem(device)
    (eager, s_eager), (graphed, s_graph) = (
        _timed_solve(lambda g=g: car_fleet_solve(p, graph=g, max_iter=BOXDDP_GRAPH_ITERS),
                     device) for g in (False, True))
    same = all(torch.equal(getattr(eager, k), getattr(graphed, k))
               for k in ("x_nom", "u_nom", "cost", "prev_cost", "iteration", "status"))
    print(f"[boxddp graph] {BOXDDP_GRAPH_ITERS} fleet iterations eager {s_eager:.2f} s, as a "
          f"CUDA graph (capture included) {s_graph:.2f} s; bit-identical {same}")
    check(same, "boxDDP fleet: the CUDA graph's iterations differ from the eager loop's")
    return dict(eager_s=s_eager, graph_s=s_graph)


def phase_boxddp_main_path(device, card):
    """The 256-instance bench fleet: one solve (CUDA graph) with its host
    reads; its certificate (`certify_boxddp_fleet`: the bound, an f64
    polish of 8 instances in worker processes) starts on the host in a
    thread beside the next phases, which run on the card. Returns (the
    problem, the result, the certificate's future, the solve's ms)."""
    p = car_fleet_problem(device)
    stats = {}
    reads0 = admm_solver.host_sync_count
    res, seconds = _timed_solve(lambda: car_fleet_solve(p, stats=stats), device)
    reads = admm_solver.host_sync_count - reads0
    check(tuple(res.u_nom.shape) == (BOXDDP_FLEET, BOXDDP_N, 2), f"boxDDP fleet: {res.u_nom.shape}")
    host = type(res)(*(t.cpu() if torch.is_tensor(t) else t for t in res))
    status = host.status
    print(f"[boxddp fleet main path] {BOXDDP_FLEET} instances, f32: mean cost "
          f"{float(host.cost.double().mean()):.6f}, statuses "
          f"{ {int(k): int((status == k).sum()) for k in torch.unique(status)} }, iterations mean "
          f"{float(host.iteration.double().mean()):.2f} max {int(host.iteration.max())}; "
          f"{seconds:.2f} s (CUDA graph; capture {stats['capture_seconds']:.2f} s); card: {card}")
    print(f"[boxddp fleet main path] host reads {reads} = {stats['iterations']} fleet iterations "
          f"- 1 (none after the cap's last)")
    check(reads == stats["host_reads"] <= BOXDDP_SOLVE["max_iter"],
          f"boxDDP fleet: {reads} host reads")
    # everything the certificate reads is on the host first: its thread
    # makes no CUDA call while the card's phases capture graphs
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(certify_boxddp_fleet, p["car"],
                         copy.deepcopy(p["cost"]).to("cpu", torch.float64), p["x0s"].cpu(), host,
                         p["lo"].cpu(), p["hi"].cpu(), workers=ORACLE_WORKERS)
    pool.shutdown(wait=False)
    return p, res, future, seconds * 1e3


def phase_boxddp_certificate(future, card):
    """The main path's certificate, started by `phase_boxddp_main_path`,
    and the bench's gates."""
    cert = future.result()
    failures = boxddp_gate_failures(cert)
    print(f"[boxddp certificate] {BOXDDP_FLEET} instances, f32: max |u|/bound - 1 "
          f"{cert['max_violation']:.3e} (gate 1e-5), mean cost {cert['mean_cost']:.6f}, statuses "
          f"{cert['statuses']}; oracle gap median {cert['cost_gap_median']:.3e} max "
          f"{cert['cost_gap_max']:.3e} (f64 L-BFGS-B polish of {len(cert['oracle_iterations'])} "
          f"instances, "
          f"{cert['oracle_iterations']} iterations, {cert['oracle_seconds']:.1f} s in "
          f"{ORACLE_WORKERS} processes beside the card's phases); gates "
          f"{'pass' if not failures else 'MISSED: ' + '; '.join(failures)}; card: {card}")
    check(not failures, "boxDDP fleet: " + "; ".join(failures))
    return cert


def phase_boxddp_compare(device):
    """The fleet's first BOXDDP_COMPARE instances against as many single
    boxddp_solve calls (both with graph=True): |dcost|/cost and statuses
    (BOXDDP_STOPS as one)."""
    p = car_fleet_problem(device, batch=BOXDDP_COMPARE)
    car, cost = p["car"], p["cost"]
    fleet = car_fleet_solve(p)

    t0 = time.perf_counter()
    singles = []
    for i in range(BOXDDP_COMPARE):
        st = boxddp_init(car.step, cost, p["x0s"][i], p["u0s"][i], p["lo"], p["hi"], device=device)
        singles.append(boxddp_solve(car.step, car.get_AB, cost.get_Cs, cost, st, p["lo"], p["hi"],
                                    cfg=ILQRConfig(**BOXDDP_SOLVE), qp_iters=BOXDDP_QP_ITERS,
                                    graph=True))
    seconds = time.perf_counter() - t0
    cost_s = torch.stack([s.cost for s in singles])
    rels = ((fleet.cost - cost_s).abs() / cost_s.abs()).tolist()
    rel = max(rels)
    status_f, status_s = fleet.status.tolist(), [s.status for s in singles]
    same = all(a == b or (a in BOXDDP_STOPS and b in BOXDDP_STOPS)
               for a, b in zip(status_f, status_s))
    print(f"[boxddp compare] fleet of {BOXDDP_COMPARE} vs single solves, f32: |dcost|/cost "
          f"{', '.join(f'{r:.3e}' for r in rels)} (gate {BOXDDP_COMPARE_REL:g}); statuses fleet "
          f"{status_f}, single {status_s}; iterations fleet {fleet.iteration.tolist()}, single "
          f"{[s.iteration for s in singles]}; the {BOXDDP_COMPARE} singles {seconds:.1f} s")
    check(rel <= BOXDDP_COMPARE_REL, f"boxDDP fleet differs from single solves by {rel:.3e}")
    check(same, "boxDDP fleet statuses differ from single solves")


def _windows(fn, device, windows):
    """`windows` timed calls of fn() (host clock, a synchronize at each
    end), after a main path that warmed it up: (median, q1, q3, samples)
    in ms."""
    ms = [_timed_solve(fn, device)[1] * 1e3 for _ in range(windows)]
    return (*_median_iqr(ms), ms)


def phase_boxddp_time(device, card, p, main_ms):
    """Solves/s of the 256-instance fleet (graph=True, capture included):
    BOXDDP_WINDOWS windows of one solve, the main path's the first."""
    ms = [main_ms] + [_timed_solve(lambda: car_fleet_solve(p), device)[1] * 1e3
                      for _ in range(BOXDDP_WINDOWS - 1)]
    med, q1, q3 = _median_iqr(ms)
    rate = BOXDDP_FLEET / (med / 1e3)
    print(f"[boxddp time] {BOXDDP_FLEET} instances, f32, CUDA graph: {med:.1f} ms a solve (IQR "
          f"{q1:.1f}-{q3:.1f}; {', '.join(f'{t:.1f}' for t in ms)}) = {rate:.1f} solves/s; "
          f"card: {card}")
    return dict(ms=med, solves_per_s=rate)


def _device_events(fn):
    """fn() under `torch.profiler` with CUDA activity only: (wall seconds,
    device seconds, device ops, {kernel: (seconds, calls)})."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, n, kernels, _ = kineto_split(prof)
    return wall, busy, n, kernels


def phase_boxddp_profile(device, card, p, solve_ms):
    """The card's busy share of a 150-iteration graph solve, from two
    profiles: one eager iteration (the capture's warm-up runs one) and a
    solve cut at BOXDDP_PROFILED_ITERS iterations (the warm-up, the
    capture, the replays). A whole solve, ~15 million kernel events, is
    too many to trace: its busy share is (warm-up + 150 replays' device
    time) / the timed solve's wall."""
    eager_wall, eager_busy, eager_n, _ = _device_events(
        lambda: car_fleet_solve(p, graph=False, max_iter=1))
    stats = {}
    wall, busy, n, names = _device_events(
        lambda: car_fleet_solve(p, stats=stats, max_iter=BOXDDP_PROFILED_ITERS))
    replay = (busy - eager_busy) / BOXDDP_PROFILED_ITERS
    iters = BOXDDP_SOLVE["max_iter"]
    share = (eager_busy + iters * replay) / (solve_ms / 1e3)
    print(f"[boxddp profile] one eager iteration: {eager_n} device ops, {eager_busy * 1e3:.1f} ms "
          f"busy of {eager_wall * 1e3:.1f} ms ({100 * eager_busy / eager_wall:.2f}%); card: {card}")
    print(f"[boxddp profile] {BOXDDP_PROFILED_ITERS} graph iterations: {n} device ops, "
          f"{busy * 1e3:.1f} ms busy of {wall * 1e3:.1f} ms under the tracer, capture "
          f"{stats['capture_seconds']:.2f} s; a replay {replay * 1e3:.1f} ms of device time, "
          f"{(n - eager_n) / BOXDDP_PROFILED_ITERS:.0f} kernels")
    print(f"[boxddp profile] a {iters}-iteration solve of {solve_ms:.1f} ms: busy "
          f"{100 * share:.1f}% (warm-up + {iters} replays' device time over its wall)")
    for name, (t, c) in sorted(names.items(), key=lambda kv: -kv[1][0])[:5]:
        print(f"[boxddp profile] {t * 1e3:9.3f} ms, {c:7d} calls: {name[:90]}")
    return dict(busy_share=share)


def al_arm_problem(device, dtype=torch.float32, batch=AL_ARM_FLEET):
    """bench_al_arm.py's fleet: the arm, its cost (x_std 1e3, u_std 1e-4, ee
    target (1.5, 1) weighted on its height), the stagewise bounds, x0s from
    q0 = (pi/3, -pi/2, -pi/4) + N(0, 0.05^2) (default_rng(0), the bench's
    512 draws, the first `batch` of them) and u0 = 1."""
    kw = dict(dtype=dtype, device=device)
    arm = PlanarArm((1.0, 1.0, 1.0), dt=1.0 / ARM_N)
    cost = arm_cost(device, dtype, 1e3, (1.5, 1.0), (0.0, 1e3))
    q0s = torch.tensor(np.array([np.pi / 3, -np.pi / 2, -np.pi / 4])
                       + np.random.default_rng(0).normal(0, 0.05, (max(batch, AL_ARM_FLEET), 3)),
                       **kw)[:batch]
    last = ARM_N - 1

    def ineq(x, u, t):
        dq, ee_x = x[3:6], x[6]
        window = torch.stack([ee_x - 1.0, 0.5 - ee_x])
        return torch.cat([dq - 1.5, -dq - 1.5, u - 6.0, -u - 6.0,
                          torch.where(t == last, window, torch.full_like(window, -1.0))])

    return dict(arm=arm, cost=cost, x0s=arm.initial_state(q0s), u0s=torch.ones((batch, ARM_N, 3), **kw),
                ineq=ineq, get_Cs=lambda xs, us: quad_cost_model(cost.Q, cost.xd, cost.R, xs, us))


def al_arm_solve(p, stats=None):
    arm = p["arm"]
    return batched_al_solve(arm.step, arm.get_AB, p["get_Cs"], p["cost"], p["x0s"], p["u0s"],
                            ineq=p["ineq"], cfg=ILQRConfig(**AL_ARM_SOLVE), device=p["x0s"].device,
                            stats=stats, **AL_ARM_KW)


def _al_arm_compare(device, dtype):
    """The fleet of AL_ARM_COMPARE arms against as many single
    al_ilqr_solve calls in `dtype`: (max |dcost|/cost, the same stops:
    CONVERGED and LINE_SEARCH_FAILED count as one), each instance's
    printed."""
    small = al_arm_problem(device, dtype, batch=AL_ARM_COMPARE)
    fleet = al_arm_solve(small)
    arm = small["arm"]
    singles = [al_ilqr_solve(arm.step, arm.get_AB, small["get_Cs"], small["cost"], small["x0s"][i],
                             small["u0s"][i], ineq=small["ineq"], cfg=ILQRConfig(**AL_ARM_SOLVE),
                             device=device, **AL_ARM_KW) for i in range(AL_ARM_COMPARE)]
    cost_s = torch.stack([s.cost for s in singles])
    rels = ((fleet.cost - cost_s).abs() / cost_s.abs()).tolist()
    status_s = [int(s.status) for s in singles]
    print(f"[al arm compare] fleet of {AL_ARM_COMPARE} vs single solves, {_dtype_name(dtype)}: "
          f"|dcost|/cost {', '.join(f'{r:.3e}' for r in rels)} (gate {AL_ARM_COMPARE_REL:g} in "
          f"f64); costs fleet {', '.join(f'{c:.6f}' for c in fleet.cost.tolist())}, single "
          f"{', '.join(f'{c:.6f}' for c in cost_s.tolist())}; statuses fleet "
          f"{fleet.status.tolist()}, single {status_s}")
    return max(rels), all(map(_same_stop, fleet.status.tolist(), status_s))


def phase_al_arm(device, card):
    """The 512-instance AL arm fleet: one solve with its host reads and the
    gates against the JAX package's own f32 numbers, the fleet of 8 against
    8 single al_ilqr_solve calls (f32 printed, f64 gated), and solves/s."""
    p = al_arm_problem(device)
    stats = {}
    reads0 = admm_solver.host_sync_count
    res, seconds = _timed_solve(lambda: al_arm_solve(p, stats), device)
    reads = admm_solver.host_sync_count - reads0
    cert = certify_al_fleet(res)
    failures = al_gate_failures(cert)
    ref = cert["reference"]
    most = AL_ARM_KW["n_al"] * AL_ARM_SOLVE["max_iter"]
    bad = (~torch.isfinite(res.cost)).nonzero().flatten().tolist()
    print(f"[al arm main path] {AL_ARM_FLEET} instances, f32: median max_violation "
          f"{cert['median_violation']:.3e} (first {ref['n']}: {cert['median_violation_ref']:.3e}; "
          f"JAX f32 {ref['median_violation']:.3e}), largest {cert['max_violation']:.3e}, mean cost "
          f"{cert['mean_cost']:.6f} (first {ref['n']}: {cert['mean_cost_ref']:.6f}; JAX f32 "
          f"{ref['mean_cost']:.6f}), statuses {cert['statuses']}, non-finite instances {bad}, "
          f"max|u| {float(res.u_nom.abs().max()):.4f}; {seconds:.2f} s; gates "
          f"{'pass' if not failures else 'MISSED: ' + '; '.join(failures)}; card: {card}")
    print(f"[al arm main path] host reads {reads} = {stats['iterations']} inner fleet iterations "
          f"less one a stage that reached its cap; at most {most} whatever the fleet size")
    check(reads == stats["host_reads"] <= most, f"AL arm fleet: {reads} host reads")
    check(not failures, "AL arm fleet: " + "; ".join(failures))

    for dtype in (torch.float32, torch.float64):
        rel, same = _al_arm_compare(device, dtype)
    # the gate in f64: in f32 the arm's weights (x_std 1e3 against u_std
    # 1e-4) leave the Riccati pass's Cholesky ill-conditioned, and the
    # fleet's batched kernels and the single solve's round it apart (f32
    # printed above; ROADMAP.md section 3)
    check(rel <= AL_ARM_COMPARE_REL, f"AL arm fleet differs from single solves by {rel:.3e} (f64)")
    check(same, "AL arm fleet statuses differ from single solves (f64)")

    med, q1, q3, ms = _windows(lambda: al_arm_solve(p), device, AL_ARM_WINDOWS)
    rate = AL_ARM_FLEET / (med / 1e3)
    print(f"[al arm time] {AL_ARM_FLEET} instances, f32: {med:.1f} ms a solve (IQR {q1:.1f}-"
          f"{q3:.1f}; {', '.join(f'{t:.1f}' for t in ms)}) = {rate:.1f} solves/s, {reads} host "
          f"reads a solve; card: {card}")
    return dict(ms=med, solves_per_s=rate, reads=reads)



@contextlib.contextmanager
def _working_dtype(dtype):
    """torch's default dtype, the facade's working dtype, for the body."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


def _viapoint(d, N, target, weight):
    zs = np.stack([np.zeros(d), np.asarray(target, dtype=float)])
    Qs = np.stack([np.zeros((d, d)), np.eye(d) * weight])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    return zs, Qs, seq


def _soc_pair(Au, mu, hi, lo, psi_inv, like):
    """The two chance-constraint SOCs of a row bounded by [lo, hi]
    (examples/double_integrator_state_bounds.py, soc_pair)."""
    A_hi = torch.tensor(np.concatenate([Au, (-mu / psi_inv)[None]], 0), **like)
    A_lo = torch.tensor(np.concatenate([Au, (mu / psi_inv)[None]], 0), **like)
    b_hi = torch.tensor(np.append(np.zeros(2), hi / psi_inv), **like)
    b_lo = torch.tensor(np.append(np.zeros(2), -lo / psi_inv), **like)
    return [A_hi, A_lo], [b_hi, b_lo]


def facade_sls(device, dtype=torch.float32):
    """[facade sls]: the three unconstrained solves of the control-bounds
    notebook, then examples/double_integrator_state_bounds.py through SLS
    (ADMM batch, DP and robust SLS, 10,000 Monte-Carlo rollouts). Returns
    host numbers."""
    out = {}
    N, d = 100, 2
    like = dict(dtype=dtype, device=device)
    with _working_dtype(dtype):
        A, B = get_double_integrator_AB(1, 2, dt=1.0 / N, **like)
        x0 = np.zeros(d)
        s = SLS(d, 1, N, device=device)
        s.AB = [A, B]
        with warnings.catch_warnings():
            # the notebook's 1e6 / 1e-2 weights are past float32's ~1e7
            warnings.simplefilter("ignore")
            s.set_quadratic_cost(*_viapoint(d, N, [1.0, 0.0], 1e6), 1e-2)
        x_b, u_b = s.solve(x0, method="batch")
        K, k = s.solve(method="dp")
        x_d, u_d = s.get_trajectory_dp(x0, K, k)
        PHI_U, du = s.solve(method="sls")
        out["unconstrained"] = [float(s.compute_cost(x_b, u_b)), float(s.compute_cost(x_d, u_d)),
                                float(s.compute_cost(s.Su @ du, du))]

        x_final, u_max = 0.5, 3.0
        s = SLS(d, 1, N, device=device)
        s.AB = [A, B]
        zs = np.stack([np.zeros(d), np.array([1.0, 1.0])])
        s.set_quadratic_cost(zs, np.zeros((2, d, d)), _viapoint(d, N, [0, 0], 0)[2], 1e-4)

        def project_x(x):
            end = torch.tensor([x_final, 0.0], dtype=x.dtype, device=x.device)
            return torch.cat([x[:-d], end])

        def project_u(u):
            return project_bound(u, -u_max, u_max)

        rho_x = np.zeros((N, d, d))
        rho_x[-1] = np.eye(d) * 1e1
        x_ab, u_ab = s.ADMM_LQT_Batch(x0, project_x=project_x, project_u=project_u, max_iter=500,
                                      rho_x=rho_x, rho_u=1e-3, tol=1e-3)
        x_ad, u_ad, K_dp, k_dp = s.ADMM_LQT_DP(x0, project_x=project_x, project_u=project_u,
                                               max_iter=5000, rho_x=rho_x, rho_u=1e-3, tol=1e-4)

        var_x0, psi_inv = 0.02, float(norm.ppf(0.9))
        mu, Au = np.array([1.0, 0.0]), np.diag(np.sqrt([0.0, var_x0]))
        As_u, bs_u = _soc_pair(Au, mu, u_max, -u_max, psi_inv, like)
        As_xf, bs_xf = _soc_pair(Au, mu, x_final, x_final, psi_inv, like)
        As_vf, bs_vf = _soc_pair(Au, mu, 0.0, 0.0, psi_inv, like)
        projs = [project_soc_unit] * 2
        kw = dict(rho=1e1, max_iter=20, threshold=1e-2)

        def project_u_rob(y):
            return project_set_convex(y, As_u, bs_u, projs, **kw)

        def project_x_rob(y):
            pos = project_set_convex(y[-2:-1], As_xf, bs_xf, projs, **kw)
            vel = project_set_convex(y[-1:], As_vf, bs_vf, projs, **kw)
            return torch.cat([y[:-2], pos, vel])

        rho_x_r = np.zeros((N, d, d))
        rho_x_r[-1] = np.eye(d) * 1e3
        du_r, PHI_U_r = s.ADMM_SLS(project_x=project_x_rob, project_u=project_u_rob,
                                   max_iter=100, rho_x=rho_x_r, rho_u=1e-3, tol=1e-5,
                                   robust_dim=1)
        x_r = s.Su @ du_r  # the nominal trajectory from x0 = 0
        out["admm"] = [float(s.compute_cost(x_ab, u_ab)), float(s.compute_cost(x_ad, u_ad)),
                       float(s.compute_cost(x_r, du_r))]
        out["u_max"] = [float(u.abs().max()) for u in (u_ab, u_ad, du_r)]
        out["end_error"] = [float((x.reshape(N, d)[-1] - torch.tensor([x_final, 0.0], **like))
                                  .abs().max()) for x in (x_ab, x_ad, x_r)]

        x0s = np.zeros((FACADE_MC, d))
        x0s[:, 0] = np.random.default_rng(0).normal(0, np.sqrt(var_x0), FACADE_MC)
        K_sls, k_sls = s.controller(PHI_U_r, du_r)
        thr, rates = 1e-2, []
        for xs, us in (s.get_trajectory_dp(x0s, K_dp, k_dp),
                       s.get_trajectory_sls(x0s, K_sls, k_sls)):
            ok = ((xs[:, -1, 0] - x_final).abs() <= thr) & (xs[:, -1, 1].abs() <= thr)
            ok = ok & ((us >= -u_max - thr) & (us <= u_max + thr)).all(dim=2).all(dim=1)
            rates.append(float(ok.double().mean()))
        out["mc_success"] = rates
        out["finite"] = all(bool(torch.isfinite(t).all()) for t in (x_ab, x_ad, du_r, PHI_U_r))
    return out


def facade_obstacles(device, dtype=torch.float32):
    """[facade obstacles]: examples/double_integrator_obstacles.py through
    SLS, ADMM batch with the first circle's project_quadratic alone, then
    with both circles through project_set_convex and Dykstra. Returns host
    numbers (costs, clearances of the x-iterate and the projected one)."""
    out = {}
    x_dim, u_dim, N = 2, 2, 100
    d = 2 * x_dim
    like = dict(dtype=dtype, device=device)
    with _working_dtype(dtype):
        A, B = get_double_integrator_AB(x_dim, 2, dt=1.0 / N, **like)
        s = SLS(d, u_dim, N, device=device)
        s.AB = [A, B]
        s.set_quadratic_cost(*_viapoint(d, N, [1.0, 1.0, 0.0, 0.0], 1e3), 1e-4)
        x0 = np.zeros(d)
        x_opt, u_opt = s.solve(x0, method="batch")
        out["unconstrained"] = float(s.compute_cost(x_opt, u_opt))
        radii = np.array([0.1, 0.15])
        centers = torch.tensor([[0.5, 0.5], [0.5, 0.2]], **like)
        lowers, upper = 0.5 * (radii * 1.1) ** 2, 1e2
        projs = [(lambda c, l: (lambda y: project_quadratic(y - c, l, upper) + c))(c, l)
                 for c, l in zip(centers, lowers)]
        As, bs = [torch.eye(x_dim, **like)] * 2, [torch.zeros(x_dim, **like)] * 2

        def with_positions(x, place):
            x_ = x.reshape(N, d)
            return torch.cat([place(x_[:, :x_dim]), x_[:, x_dim:]], 1).reshape(-1)

        def project_one(x):
            return with_positions(x, projs[0])

        def project_state(x):
            def place(pos):
                pos = project_set_convex(pos, As, bs, projs, rho=1.0, max_iter=5, threshold=1e-2)
                return project_set_convex_dykstra(pos, projs, max_iter=50, tol=1e-5)
            return with_positions(x, place)

        rho_x = np.zeros((N, d, d))
        rho_x[:, :x_dim, :x_dim] = np.eye(x_dim)
        for name, proj, n_obst in (("one circle", project_one, 1),
                                   ("two circles", project_state, 2)):
            x_c, u_c = s.ADMM_LQT_Batch(x0, project_x=proj, max_iter=500, rho_x=rho_x, tol=1e-3)
            clear = {}
            for label, xv in (("x-iterate", x_c), ("projected", proj(x_c))):
                pos = xv.reshape(N, d)[:, :x_dim]
                clear[label] = [float(torch.linalg.norm(pos - centers[i], dim=-1).min()) - radii[i]
                                for i in range(n_obst)]
            out[name] = dict(cost=float(s.compute_cost(x_c, u_c)), clearance=clear,
                             finite=bool(torch.isfinite(x_c).all() and torch.isfinite(u_c).all()))
    return out


def facade_car(device, dtype=torch.float32):
    """[facade car]: examples/tutorial_car_parking.py through iSLS: the dp
    iLQR solve, then ilqr_admm with |w| <= 0.5, |a| <= 2. Returns host
    numbers."""
    N = 500
    with _working_dtype(dtype):
        car, cost = CarFrontWheel(dt=15.0 / N), CarParkingCost(dtype=dtype, device=device)
        s = iSLS(x_dim=4, u_dim=2, N=N, device=device)
        s.forward_model, s.cost_function = car.step, cost
        u0 = np.random.default_rng(0).normal(size=(N, 2)) * 0.1
        x_nom, u_nom = s.get_trajectory_batch(np.array([1.0, 1.0, 3 * np.pi / 2, 0.0]), u0)
        s.reset()
        s.nominal_values = x_nom, u_nom
        with contextlib.redirect_stdout(io.StringIO()):
            s.solve(car.get_AB, cost.get_Cs, max_iter=100, max_line_search_iter=40, method="dp")
        ilqr = dict(cost=s.cost, evals=len(s.cost_log), final=s.x_nom[-1].tolist())
        lo = torch.tensor([-0.5, -2.0], dtype=dtype, device=device)
        hi = torch.tensor([0.5, 2.0], dtype=dtype, device=device)

        def project_u(u):
            return torch.clamp(u.reshape(N, 2), lo, hi).reshape(-1)

        s.reset()
        s.nominal_values = x_nom, u_nom
        res = s.ilqr_admm(get_AB=car.get_AB, get_Cs=cost.get_Cs, project_u=project_u,
                          max_iter=50, max_admm_iter=5, max_line_search_iter=40,
                          rho_u=np.diag([1e-1, 1e-2]), tol=1e-3)
        us = s.u_nom.abs().amax(dim=0)
        admm = dict(cost=s.cost, outer_iters=int(res.outer_iters), status=int(res.status),
                    u_max=us.tolist(), finite=bool(torch.isfinite(s.u_nom).all()))
    return dict(ilqr=ilqr, ilqr_admm=admm)


def facade_maze(device, dtype=torch.float32):
    """[facade maze]: examples/car_state_constraints.py through iSLS: the
    batch iLQR, then ilqr_admm with the consensus projection of the two
    rotated rectangles and with the exact project_outside_rotated_boxes.
    Returns host numbers (costs, the inf-norm clearances, and whether every
    point of every exact projection was certified)."""
    N, x_dim = 500, 4
    like = dict(dtype=dtype, device=device)
    out = {}
    with _working_dtype(dtype):
        car = CarSimple(dt=15.0 / N)
        s = iSLS(x_dim, 2, N, device=device)
        s.forward_model = car.step
        s.set_quadratic_cost(*_viapoint(x_dim, N, [-5.0, -5.0, np.pi / 4, 0.0], 1e2), 1e-2)
        x0 = np.array([0.0, -2.0, np.pi / 2, 0.0])
        x_nom, u_nom = s.rollout_batch(x0[None], np.zeros((1, N, 2)))
        s.reset()
        s.nominal_values = x_nom[0], u_nom[0]
        with contextlib.redirect_stdout(io.StringIO()):
            s.solve(car.get_AB, method="batch", max_iter=50, max_line_search_iter=40)
        out["ilqr"] = dict(cost=s.cost, evals=len(s.cost_log))

        centers = np.stack([np.array([-7.0, -3.0]), np.array([-3.0, -7.0])])
        a_safe = np.array([[2.5, 1.5], [2.5, 1.5]])
        alpha = -np.pi / 4
        R = np.array([[np.cos(alpha), -np.sin(alpha)], [np.sin(alpha), np.cos(alpha)]])
        Ws = [np.diag(a_safe[i, 0] / a_safe[i]) @ R.T for i in range(2)]
        lower_sq = a_safe[:, 0] / 2
        tW = [torch.tensor(W, **like) for W in Ws]
        tW_inv = [torch.tensor(np.linalg.inv(W), **like) for W in Ws]
        tc = [torch.tensor(c, **like) for c in centers]

        def make_proj(i):
            def proj(y):  # y: (N, x_dim) states
                z = project_square((y[:, :2] - tc[i]) @ tW[i].T, lower_sq[i], 1e5)
                return torch.cat([z @ tW_inv[i].T + tc[i], y[:, 2:]], 1)
            return proj

        projs = [make_proj(0), make_proj(1)]
        As, bs = [torch.eye(x_dim, **like)] * 2, [torch.zeros(x_dim, **like)] * 2

        def project_state(x):
            return project_set_convex(x.reshape(N, x_dim), As, bs, projs, rho=1e1, max_iter=15,
                                      threshold=1e-3).reshape(-1)

        As_box = torch.tensor(np.stack([Ws[i] / lower_sq[i] for i in range(2)]), **like)
        bs_box = torch.tensor(np.stack([-(Ws[i] / lower_sq[i]) @ centers[i] for i in range(2)]),
                              **like)
        certified = []  # one device flag a call: read once, after the solve

        def project_state_exact(x):
            x_ = x.reshape(N, x_dim)
            p, exact = project_outside_rotated_boxes(x_[:, :2], As_box, bs_box, l=1.0)
            certified.append(exact.all())
            return torch.cat([p, x_[:, 2:]], 1).reshape(-1)

        rho_x = np.zeros((N, x_dim, x_dim))
        rho_x[:, :2, :2] = np.eye(2) * 1e-1
        for name, proj in (("consensus", project_state), ("exact", project_state_exact)):
            s.reset()
            s.nominal_values = x_nom[0], u_nom[0]
            res = s.ilqr_admm(car.get_AB, project_x=proj, max_admm_iter=10, max_line_search=50,
                              rho_x=rho_x, k_max=10, threshold=1e-1)
            pos = s.x_nom[:, :2]
            clear = [float(((pos - tc[i]) @ tW[i].T).abs().amax(dim=-1).min()) - lower_sq[i]
                     for i in range(2)]
            out[name] = dict(cost=s.cost, clearance=clear, outer_iters=int(res.outer_iters),
                             final=s.x_nom[-1].tolist(), finite=bool(torch.isfinite(s.x_nom).all()))
        out["exact"]["calls"] = len(certified)
        out["exact"]["certified"] = bool(torch.stack(certified).all())
    return out


def _inverse_lqt(device, dtype):
    """examples/inverse_lqt_learning.py's problem: (solve(target, bound) ->
    (xs, us), the demonstration's (xs, us))."""
    N = 40
    like = dict(dtype=dtype, device=device)
    plant = DoubleIntegrator(1, 2, dt=1.0 / N, **like)
    d, m = plant.x_dim, plant.u_dim
    zs, Qs, seq = _viapoint(d, N, [1.0, 0.0], 1e3)
    quad = viapoint_cost(torch.tensor(zs, **like), torch.tensor(Qs, **like), seq, 1e-2, m)
    A, B = plant.AB(N)

    def solve(target, bound):
        xd = torch.cat([quad.xd[:-1], torch.stack([target, quad.xd[-1, 1]])[None]])
        theta = dict(Q=quad.Q, R=quad.R, xd=xd, x0=torch.zeros(d, **like), pu=bound)
        return lqt_admm_implicit(A, B, theta, project_u=lambda v, p: project_bound(v, -p, p),
                                 rho_u=1e-1)

    demo = solve(torch.tensor(0.7, **like), torch.tensor(2.5, **like))
    return solve, demo


def inverse_lqt_gradient(device, dtype=torch.float64, params=(0.2, 3.0)):
    """The IFT gradient of the example's loss at (target, bound) = params:
    (loss, [d/dtarget, d/dbound])."""
    solve, (xs_demo, us_demo) = _inverse_lqt(device, dtype)
    p = [torch.tensor(v, dtype=dtype, device=device, requires_grad=True) for v in params]
    xs, us = solve(*p)
    loss = torch.sum((xs - xs_demo) ** 2) + torch.sum((us - us_demo) ** 2)
    return float(loss), [float(g) for g in torch.autograd.grad(loss, p)]


IFT_POINTS = ((0.2, 3.0), (0.6, 2.0))  # the example's start (bound slack), bound active


def facade_implicit(device, dtype=torch.float64):
    """[implicit] on one device: the gradient at IFT_POINTS, its central
    difference (eps 1e-6), then the example's 150 Adam steps. Returns host
    numbers."""
    solve, (xs_demo, us_demo) = _inverse_lqt(device, dtype)

    def loss_of(target, bound):
        xs, us = solve(target, bound)
        return torch.sum((xs - xs_demo) ** 2) + torch.sum((us - us_demo) ** 2)

    points, eps = [], 1e-6
    for point in IFT_POINTS:
        loss, grad = inverse_lqt_gradient(device, dtype, point)
        fd = []
        with torch.no_grad():
            for i in range(2):
                hi, lo = list(point), list(point)
                hi[i] += eps
                lo[i] -= eps
                f = [float(loss_of(*(torch.tensor(v, dtype=dtype, device=device) for v in pt)))
                     for pt in (hi, lo)]
                fd.append((f[0] - f[1]) / (2 * eps))
        points.append(dict(loss=loss, grad=grad, fd=fd))
    params = [torch.tensor(v, dtype=dtype, device=device, requires_grad=True) for v in (0.2, 3.0)]
    opt = torch.optim.Adam(params, lr=5e-2)
    for _ in range(150):
        opt.zero_grad()
        loss_of(*params).backward()
        opt.step()
    return dict(points=points, recovered=[float(v) for v in params],
                u_demo_max=float(us_demo.abs().max()))


FACADE_WORKFLOWS = {"facade sls": facade_sls, "facade obstacles": facade_obstacles,
                    "facade car": facade_car, "facade maze": facade_maze}


def _host_f64(name):
    """A workflow on this host in f64 (one BLAS thread: it runs in a worker
    process beside the card's phases)."""
    torch.set_num_threads(1)
    if name == "implicit":
        return [inverse_lqt_gradient("cpu", torch.float64, point) for point in IFT_POINTS]
    return FACADE_WORKFLOWS[name]("cpu", torch.float64)


def start_facade_host_runs():
    """The host's f64 runs of the facade phases, in spawned worker
    processes that work beside the card: {name: future}."""
    ctx = multiprocessing.get_context("spawn")
    names = list(FACADE_WORKFLOWS) + ["implicit"]
    pool = concurrent.futures.ProcessPoolExecutor(len(names), mp_context=ctx)
    futures = {name: pool.submit(_host_f64, name) for name in names}
    pool.shutdown(wait=False)
    return futures


def _card_syncs(fn):
    """(fn(), the number of synchronizing CUDA calls it made, the port's own
    stop-flag reads): torch's sync debug mode warns at each."""
    flags0 = admm_solver.host_sync_count + projection_sets.host_sync_count
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    flags = admm_solver.host_sync_count + projection_sets.host_sync_count - flags0
    return out, syncs, flags


def _facade_times(fn, device, label, card, repeats=FACADE_REPEATS):
    """A run with its host reads, then `repeats` timed runs: (the first
    run's result, the median seconds). repeats=0 times the first run
    itself (the car and the maze: a run is a minute, PERF.md section 6)."""
    sync(device)
    t0 = time.perf_counter()
    out, syncs, flags = _card_syncs(fn)
    sync(device)
    seconds = [time.perf_counter() - t0]
    if repeats:
        seconds = [_timed_solve(fn, device)[1] for _ in range(repeats)]
    med = float(np.median(seconds))
    how = (f"median of {repeats} after a warm-up" if repeats else
           "one run, the gated one, with its host reads counted")
    print(f"[{label}] time to solve {med:.3f} s ({how}: {', '.join(f'{t:.3f}' for t in seconds)}); "
          f"host reads a solve: {syncs} synchronizing CUDA calls, {flags} of them the solvers' "
          f"stop-flag reads; card: {card}")
    return out, med


def _rel(a, b) -> float:
    """|a - b| / |b|; 0 when they are equal (a zero gradient included)."""
    a, b = float(a), float(b)
    return 0.0 if a == b else abs(a - b) / abs(b)


def _cost_gate(label, what, card_cost, host_cost):
    rel = _rel(card_cost, host_cost)
    print(f"[{label}] {what}: card {card_cost:.7e}, host f64 {host_cost:.7e}, |dcost|/cost "
          f"{rel:.3e} (gate {FACADE_COST_REL:g})")
    check(np.isfinite(card_cost) and rel <= FACADE_COST_REL,
          f"{label}: {what} cost {rel:.3e} from the host's f64 run")


def phase_facade_sls(device, card, host):
    # the square roots of the QR x-update take their eigenvalues from the
    # eigenvectors: the card's batched f32 eigh leaves a zero block's
    # unwritten (ops/sqrt_riccati.py::eigh_rayleigh). Held here on memory
    # that held NaN.
    junk = torch.full((1 << 24,), float("nan"), device=device)
    del junk
    roots = sqrt_psd_stacked(torch.zeros((100, 2, 2), device=device))
    check(bool((roots == 0).all()), "facade sls: the square root of a zero block is not zero")
    out, med = _facade_times(lambda: facade_sls(device), device, "facade sls", card)
    ref = host["facade sls"].result()
    check(out["finite"], "facade sls: non-finite result")
    for i, method in enumerate(("batch", "dp", "sls")):
        _cost_gate("facade sls", f"unconstrained {method}", out["unconstrained"][i],
                   ref["unconstrained"][i])
        _cost_gate("facade sls", f"unconstrained {method} vs batch", out["unconstrained"][i],
                   out["unconstrained"][0])
    for i, method in enumerate(("ADMM_LQT_Batch", "ADMM_LQT_DP", "ADMM_SLS(robust_dim=1)")):
        _cost_gate("facade sls", method, out["admm"][i], ref["admm"][i])
        print(f"[facade sls] {method}: max|u| {out['u_max'][i]:.6f} (gate <= 3 + {FACADE_U_TOL:g}),"
              f" end error {out['end_error'][i]:.3e} (host {ref['end_error'][i]:.3e})")
        check(out["u_max"][i] <= 3.0 + FACADE_U_TOL, f"facade sls: {method} max|u| {out['u_max'][i]}")
    print(f"[facade sls] Monte-Carlo success over {FACADE_MC} rollouts: DP "
          f"{100 * out['mc_success'][0]:.2f} %, SLS {100 * out['mc_success'][1]:.2f} % (host f64 "
          f"{100 * ref['mc_success'][0]:.2f} %, {100 * ref['mc_success'][1]:.2f} %; the reference "
          f"23.44 %, 89.59 %)")
    return med


def phase_facade_obstacles(device, card, host):
    out, med = _facade_times(lambda: facade_obstacles(device), device, "facade obstacles", card)
    ref = host["facade obstacles"].result()
    _cost_gate("facade obstacles", "unconstrained batch", out["unconstrained"], ref["unconstrained"])
    for name in ("one circle", "two circles"):
        got = out[name]
        check(got["finite"], f"facade obstacles: {name}: non-finite result")
        # not gated: the ADMM on these non-convex sets stops at its cap
        # unconverged, where its iterate depends on rounding (PERF.md section 2)
        print(f"[facade obstacles] ADMM_LQT_Batch, {name}: card cost {got['cost']:.7e}, host f64 "
              f"{ref[name]['cost']:.7e} (|dcost|/cost {_rel(got['cost'], ref[name]['cost']):.3e}; "
              f"the reference 2.680e-1 for two circles)")
        clear = got["clearance"]
        print(f"[facade obstacles] {name}: clearance of the x-iterate "
              f"{', '.join(f'{c:.3e}' for c in clear['x-iterate'])}, of the projected iterate "
              f"{', '.join(f'{c:.3e}' for c in clear['projected'])} (gate >= "
              f"{-FACADE_CLEARANCE_TOL:g}; host f64 "
              f"{', '.join(f'{c:.3e}' for c in ref[name]['clearance']['projected'])})")
        check(min(clear["projected"]) >= -FACADE_CLEARANCE_TOL,
              f"facade obstacles: {name}: clearance {min(clear['projected']):.3e}")
    return med


def phase_facade_car(device, card, host):
    out, med = _facade_times(lambda: facade_car(device), device, "facade car", card, repeats=0)
    ref = host["facade car"].result()
    _cost_gate("facade car", f"iSLS.solve dp ({out['ilqr']['evals']} costs logged, host "
               f"{ref['ilqr']['evals']})", out["ilqr"]["cost"], ref["ilqr"]["cost"])
    admm = out["ilqr_admm"]
    check(admm["finite"], "facade car: non-finite controls")
    _cost_gate("facade car", f"iSLS.ilqr_admm ({admm['outer_iters']} outer steps, status "
               f"{admm['status']}; host {ref['ilqr_admm']['outer_iters']}, "
               f"{ref['ilqr_admm']['status']})", admm["cost"], ref["ilqr_admm"]["cost"])
    print(f"[facade car] ilqr_admm max|w| {admm['u_max'][0]:.4f} (gate <= 0.5 + {FACADE_U_TOL:g}), "
          f"max|a| {admm['u_max'][1]:.4f} (gate <= 2 + {FACADE_U_TOL:g}); the reference reaches "
          f"0.9283 and 1.903")
    check(admm["u_max"][0] <= 0.5 + FACADE_U_TOL and admm["u_max"][1] <= 2.0 + FACADE_U_TOL,
          f"facade car: max|u| {admm['u_max']}")
    return med


def phase_facade_maze(device, card, host):
    out, med = _facade_times(lambda: facade_maze(device), device, "facade maze", card,
                             repeats=0)
    ref = host["facade maze"].result()
    _cost_gate("facade maze", "iSLS.solve batch", out["ilqr"]["cost"], ref["ilqr"]["cost"])
    for name in ("consensus", "exact"):
        got = out[name]
        check(got["finite"], f"facade maze: {name}: non-finite trajectory")
        # not gated: after the example's 10 outer steps the solve is
        # mid-descent, and a line-search pick that rounding decides moves
        # its end (PERF.md section 2)
        print(f"[facade maze] ilqr_admm, {name} projection: card cost {got['cost']:.7e}, host f64 "
              f"{ref[name]['cost']:.7e} (|dcost|/cost {_rel(got['cost'], ref[name]['cost']):.3e}; "
              f"{got['outer_iters']} outer steps)")
        print(f"[facade maze] {name}: inf-norm clearance of the trajectory "
              f"{', '.join(f'{c:.3e}' for c in got['clearance'])} (gate >= "
              f"{-FACADE_CLEARANCE_TOL:g}; host f64 "
              f"{', '.join(f'{c:.3e}' for c in ref[name]['clearance'])}), final state "
              f"{np.round(got['final'], 3).tolist()}")
        check(min(got["clearance"]) >= -FACADE_CLEARANCE_TOL,
              f"facade maze: {name}: clearance {min(got['clearance']):.3e}")
    print(f"[facade maze] exact projection: {out['exact']['calls']} calls, every point certified: "
          f"{out['exact']['certified']}")
    check(out["exact"]["certified"], "facade maze: a point without the exact certificate")
    return med


def phase_implicit(device, card, host):
    """[implicit] in f64 on the card: the gradient against a central
    difference and against the host's f64 gradient, the example's descent,
    and the time of one gradient (forward and backward)."""
    _, med = _facade_times(lambda: inverse_lqt_gradient(device, params=IFT_POINTS[1]), device,
                           "implicit gradient", card)
    out = facade_implicit(device)
    for point, got, (host_loss, host_grad) in zip(IFT_POINTS, out["points"],
                                                  host["implicit"].result()):
        for i, name in enumerate(("target", "bound")):
            g, fd = got["grad"][i], got["fd"][i]
            fd_rel, host_rel = _rel(g, fd), _rel(g, host_grad[i])
            print(f"[implicit] at (target, bound) = {point}: d loss / d {name}: card {g:.12e}, "
                  f"central difference {fd:.12e} (rel {fd_rel:.3e}, gate {IFT_FD_RTOL:g}), host "
                  f"f64 {host_grad[i]:.12e} (rel {host_rel:.3e}, gate {IFT_HOST_RTOL:g}); loss "
                  f"{got['loss']:.9e} (host {host_loss:.9e})")
            check(fd_rel <= IFT_FD_RTOL, f"implicit: d/d{name} {fd_rel:.3e} from the difference")
            check(host_rel <= IFT_HOST_RTOL, f"implicit: d/d{name} {host_rel:.3e} from the host")
    target, bound = out["recovered"]
    print(f"[implicit] 150 Adam steps: target {target:.5f} (true 0.7, gate 5e-3), bound "
          f"{bound:.5f} (true 2.5, gate 5e-2); card: {card}")
    check(abs(target - 0.7) < 5e-3 and abs(bound - 2.5) < 5e-2,
          f"implicit: recovered target {target}, bound {bound}")
    return med

def chance_soc_blocks():
    """`tests/test_consensus_parallel.py::_chance_soc_blocks`: the
    state-bounds chance-constraint pair, two SOCs a decision row [du |
    phi] (f64 numpy: As (2, 3, 2), bs (2, 3))."""
    psi_inv = float(norm.ppf(0.9))
    mu = np.array([0.0, 0.3])
    sig = np.diag(np.sqrt([0.0, 0.02]))
    b = np.array([0.0, 0.0, 5.0 / psi_inv])
    return (np.stack([np.concatenate([sig, (-mu / psi_inv)[None]]),
                      np.concatenate([sig, (mu / psi_inv)[None]])]), np.stack([b, b]))


def consensus_points(device, dtype, batch: int = SLS_BATCH):
    return torch.tensor(np.random.default_rng(0).standard_normal((batch, 2)) * 3.0,
                        dtype=dtype, device=device)


def consensus_projection(device, dtype, mesh=None):
    """The chance-constraint projection of `consensus_points`: over the
    mesh's 'consensus' axis, or stacked in one process with mesh=None."""
    As, bs = (torch.tensor(t, dtype=dtype, device=device) for t in chance_soc_blocks())
    return project_set_convex_sharded(
        consensus_points(device, dtype), As, bs, project_soc_unit, rho=CONSENSUS_RHO,
        max_iter=CONSENSUS_ITERS, threshold=CONSENSUS_THRESHOLD, mesh=mesh)


def time_box_inputs(data):
    """The boxDDP backward's inputs on riccati_problem's (f64) data: the
    cost's Taylor blocks at the zero nominal, |u| <= TIME_BOX_U."""
    A, B, Q, xd, R = data
    m = B.shape[-1]
    u_nom = torch.zeros((A.shape[0], m), dtype=A.dtype, device=A.device)
    cts, Cts = quad_cost_model(Q, xd, R, torch.zeros_like(xd), u_nom)
    return A, B, Cts, cts, u_nom, -TIME_BOX_U, TIME_BOX_U


def _rel_err(got, want) -> float:
    return float((got - want).abs().max() / max(1.0, float(want.abs().max())))


def parallel_references(device, path: Path):
    """The single-process results the worlds are held to, saved to `path`:
    the bench fleet through `admm_u_only`, the diamond_ee SLS fleet through
    `sls_admm`, the stacked consensus projection in f64 and f32, the time-
    parallel Riccati pass and the box backward in f64 (`riccati_problem`)."""
    A, B, cost, x0s = bench_problem(device)
    solver = make_fused_lqt_admm(A, B, cost, u_lower=-U_MAX, u_upper=U_MAX, rho_u=RHO_U,
                                 n_iters=ADMM_ITERS, batch_tile=BATCH_TILE, device=device)
    x, u, _, z_u = solver(x0s)
    _, sls = sls_solver(device, "diamond_ee")
    bounds = sls_bounds(device, batch=SLS_BATCH, sort=True)
    du, phi_u, U = sls(bounds)
    data = [t.double() for t in riccati_problem(device)[0]]
    refs = {
        "data": {"x": x, "u": u, "z_u": z_u,
                 "rate": float(mc_success_rate(converged_flags, None, u, z_u))},
        "sls": {"du": du, "phi_u": phi_u, "U": U, "rate": float(mc_success_rate(
            lambda U_, b_: sls_converged_flags(U_, b_, C_COEF), None, U, bounds))},
        "consensus": {str(dt): consensus_projection(device, dt)
                      for dt in (torch.float64, torch.float32)},
        "time": {"gains": lqt_backward_parallel(*data)._asdict(),
                 "box": ilqr_backward_box_parallel(*time_box_inputs(data))},
    }
    torch.save(refs, path)
    return refs


def _bitwise(got: dict, want: dict) -> dict:
    return {k: bool(torch.equal(t, want[k])) for k, t in got.items()}


def _rank_data(mesh, device, ref):
    """[parallel data]: the bench fleet sharded over 'data'."""
    A, B, cost, x0s = bench_problem(device)
    solver = make_fused_lqt_admm(A, B, cost, u_lower=-U_MAX, u_upper=U_MAX, rho_u=RHO_U,
                                 n_iters=ADMM_ITERS, batch_tile=BATCH_TILE, device=device)
    reset_launch_counts()
    t0 = time.perf_counter()
    x, u, _, z_u = sharded_instance_solve(solver, mesh, x0s)
    sync(device)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    cert = certify(A, B, cost, x0s, u, z_u, -U_MAX, U_MAX)
    return {"seconds": seconds, "launches": launches["admm_u_only"], "all_launches": launches,
            "bitwise": _bitwise({"x": x, "u": u, "z_u": z_u}, ref),
            "rate": float(mc_success_rate(converged_flags, mesh, u, z_u)),
            "certificate": cert, "gate_failures": gate_failures(cert)}


def _rank_sls(mesh, device, ref):
    """[parallel sls]: the diamond_ee SLS fleet sharded over 'data'."""
    _, solver = sls_solver(device, "diamond_ee")
    bounds = sls_bounds(device, batch=SLS_BATCH, sort=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    du, phi_u, U = sharded_instance_solve(solver, mesh, bounds)
    sync(device)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    flags = lambda U_, b_: sls_converged_flags(U_, b_, C_COEF)  # noqa: E731
    return {"seconds": seconds, "launches": launches["sls_admm"], "all_launches": launches,
            "bitwise": _bitwise({"du": du, "phi_u": phi_u, "U": U}, ref),
            "rate": float(mc_success_rate(flags, mesh, U, bounds))}


def _rank_consensus(device, ref):
    """[parallel consensus]: the chance-constraint projection with its two
    SOC blocks sharded over 'consensus', in f64 and f32."""
    mesh = make_mesh(axis_names=("consensus",), device=device)
    out = {}
    for dt in (torch.float64, torch.float32):
        reads = projection_sets.host_sync_count
        t0 = time.perf_counter()
        x = consensus_projection(device, dt, mesh)
        sync(device)
        want = ref[str(dt)]
        out[str(dt)] = {"seconds": time.perf_counter() - t0, "max_abs_err": float(
            (x - want).abs().max()), "scale": max(1.0, float(want.abs().max())),
            "iterations": projection_sets.host_sync_count - reads - 1}
    return out


def _rank_time(device, ref):
    """[parallel time]: the N = 10,000 LQT pass and the box backward with
    the horizon sharded over 'time', in f64."""
    mesh = make_mesh(axis_names=("time",), device=device)
    data = [t.double() for t in riccati_problem(device)[0]]
    t0 = time.perf_counter()
    gains = lqt_backward_time_sharded(*data, mesh=mesh)
    sync(device)
    lqt_seconds = time.perf_counter() - t0
    box = time_box_inputs(data)
    t0 = time.perf_counter()
    K, k = ilqr_backward_box_parallel(*box, mesh=mesh)
    sync(device)
    box_seconds = time.perf_counter() - t0
    K_ref, k_ref = ref["box"]
    clamped = (k_ref - box[4]).abs() >= TIME_BOX_U * (1 - 1e-12)
    return {"lqt_seconds": lqt_seconds, "box_seconds": box_seconds,
            "lqt_rel_err": {f: _rel_err(getattr(gains, f), ref["gains"][f])
                            for f in gains._fields},
            "box_rel_err": {"K": _rel_err(K, K_ref), "k": _rel_err(k, k_ref)},
            "box_clamped": int(clamped.sum())}


def parallel_rank(rank: int, nproc: int, port: int, backend: str, directory: str, device):
    """One rank of a world (a spawned process): joins the world, runs the
    [parallel ...] phases on the global arguments every rank makes, and
    writes what it measured to rank<r>.json. The parent judges it."""
    torch.set_num_threads(1)
    distributed.initialize(f"localhost:{port}", nproc, rank, device=device, backend=backend)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if torch.device(device).type == "cuda" else torch.device(device)
    refs = torch.load(Path(directory) / "refs.pt", map_location=dev)
    mesh = make_mesh(device=device)
    out = {"backend": torch.distributed.get_backend(), "world": torch.distributed.get_world_size(),
           "device": str(dev), "data": _rank_data(mesh, dev, refs["data"])}
    if nproc > 1:
        out["sls"] = _rank_sls(mesh, dev, refs["sls"])
        out["consensus"] = _rank_consensus(dev, refs["consensus"])
        out["time"] = _rank_time(dev, refs["time"])
    (Path(directory) / f"rank{rank}.json").write_text(json.dumps(out))
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_parallel_world(backend: str, nproc: int, directory: Path, device="cuda",
                       timeout: float = PARALLEL_TIMEOUT) -> list[dict]:
    """Spawn nproc ranks of `parallel_rank` and wait for them; any rank that
    exits non-zero or outlasts the timeout fails the run (every rank is
    stopped first). Returns each rank's measurements."""
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=parallel_rank,
                         args=(r, nproc, port, backend, str(directory), device))
             for r in range(nproc)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        late = [p for p in procs if p.is_alive()]
        for p in late:
            p.kill()
            p.join()
    check(not late, f"a {backend} world of {nproc} outlasted {timeout} s")
    codes = [p.exitcode for p in procs]
    check(all(c == 0 for c in codes), f"a {backend} world of {nproc} ranks exited {codes}")
    return [json.loads((directory / f"rank{r}.json").read_text()) for r in range(nproc)]


def _check_fleet(label, world, outs, refs, kernel, wall, card):
    for r, out in enumerate(outs):
        check(all(out["bitwise"].values()),
              f"[{label}] rank {r}: the gathered fleet differs from the single-process "
              f"call: {out['bitwise']}")
        check(out["launches"] > 0, f"[{label}] rank {r} launched no {kernel} kernel: "
              f"{out['all_launches']}")
        check(out["rate"] == refs["rate"], f"[{label}] rank {r}: converged rate "
              f"{out['rate']} != the single-process {refs['rate']}")
    print(f"[{label}] {world}: "
          f"gathered {sorted(outs[0]['bitwise'])} equal the single-process call bit for bit on "
          f"every rank; {kernel} launches per rank {[o['launches'] for o in outs]}; "
          f"converged rate {outs[0]['rate']} (single process {refs['rate']}); sharded solve "
          f"{[round(o['seconds'], 4) for o in outs]} s a rank, the world {wall:.1f} s; {card}; "
          "one card: equality, not scaling")


def phase_parallel(card, device="cuda"):
    """Slice 15's phases: [parallel data] and [parallel sls] (the bench and
    SLS fleets sharded through their kernels), [parallel consensus] and
    [parallel time], in a gloo world of 2 ranks on the one card, then
    [parallel data] in an NCCL world of 1."""
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    directory = Path(tempfile.mkdtemp(prefix="parallel_smoke_", dir=build))
    try:
        t0 = time.perf_counter()
        refs = parallel_references(device, directory / "refs.pt")
        print(f"[parallel] single-process references in {time.perf_counter() - t0:.1f} s")
        for backend, nproc in PARALLEL_WORLDS:
            t0 = time.perf_counter()
            outs = run_parallel_world(backend, nproc, directory, device)
            wall = time.perf_counter() - t0
            check(all(o["backend"] == backend and o["world"] == nproc for o in outs),
                  f"the {backend} world of {nproc} came up as "
                  f"{[(o['backend'], o['world']) for o in outs]}")
            world = f"{backend}, {nproc} rank(s) on {outs[0]['device']}"
            _check_fleet("parallel data", world, [o["data"] for o in outs], refs["data"],
                         "admm_u_only", wall, card)
            for r, o in enumerate(outs):
                check(not o["data"]["gate_failures"],
                      f"[parallel data] rank {r}: {'; '.join(o['data']['gate_failures'])}")
            cert = outs[0]["data"]["certificate"]
            print(f"[parallel data] certificates on the gathered fleet (every rank): "
                  f"max_violation {cert['max_violation']}, converged_frac "
                  f"{cert['converged_frac']}, cost_gap median {cert['cost_gap_median']:.3e} "
                  f"max {cert['cost_gap_max']:.3e}")
            if nproc == 1:
                continue
            _check_fleet("parallel sls", world, [o["sls"] for o in outs], refs["sls"],
                         "sls_admm", wall, card)
            for dt, tol in (("torch.float64", CONSENSUS_F64_TOL),
                            ("torch.float32", CONSENSUS_F32_TOL)):
                res = [o["consensus"][dt] for o in outs]
                for r, c in enumerate(res):
                    check(c["max_abs_err"] <= tol * c["scale"],
                          f"[parallel consensus] rank {r}, {dt}: max|x - stacked| "
                          f"{c['max_abs_err']:.3e} > {tol} x {c['scale']}")
                print(f"[parallel consensus] {dt}, {SLS_BATCH} points, 2 SOC blocks over 2 "
                      f"ranks: max|x - stacked on one device| "
                      f"{[c['max_abs_err'] for c in res]} (limit {tol} x max(1, max|x|)), "
                      f"{res[0]['iterations']} iterations, "
                      f"{[round(c['seconds'], 3) for c in res]} s a rank; {card}; "
                      "one card: equality, not scaling")
            for r, o in enumerate(outs):
                tm = o["time"]
                worst = max(list(tm["lqt_rel_err"].values()) + list(tm["box_rel_err"].values()))
                check(worst <= TIME_SHARDED_TOL,
                      f"[parallel time] rank {r}: relative errors {tm['lqt_rel_err']}, "
                      f"{tm['box_rel_err']} > {TIME_SHARDED_TOL}")
            tm = [o["time"] for o in outs]
            print(f"[parallel time] N = {RICCATI_N}, d = 4, f64, 2 ranks of {RICCATI_N // 2} "
                  f"stages: lqt_backward_time_sharded vs lqt_backward_parallel on one device, "
                  f"largest relative error {max(max(t['lqt_rel_err'].values()) for t in tm):.3e}; "
                  f"ilqr_backward_box_parallel(mesh=...) vs its unsharded call "
                  f"{max(max(t['box_rel_err'].values()) for t in tm):.3e} "
                  f"({tm[0]['box_clamped']} clamped controls) (limit {TIME_SHARDED_TOL}); "
                  f"{[round(t['lqt_seconds'], 3) for t in tm]} s and "
                  f"{[round(t['box_seconds'], 3) for t in tm]} s a rank; {card}; "
                  "one card: equality, not scaling")
    finally:
        shutil.rmtree(directory, ignore_errors=True)


# ---- slice 17: the examples' twins on the card, and the linalg audit ----


ROOT = Path(__file__).resolve().parent


def run_twin(name: str, device="cuda"):
    """examples_torch/<name>.py in its own process on `device` (one BLAS
    thread): (name, exit code or None at the timeout, stdout, stderr,
    seconds). subprocess.run kills the process at the timeout."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, str(ROOT / "examples_torch" / f"{name}.py"),
                               "--device", str(device)], capture_output=True, text=True,
                              timeout=EXAMPLES_TIMEOUT, cwd=ROOT, env=env)
        code, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as exc:
        code, out, err = None, exc.stdout or "", exc.stderr or ""
        out, err = (v.decode() if isinstance(v, bytes) else v for v in (out, err))
    return name, code, out, err, time.perf_counter() - t0


def phase_examples(card, device="cuda"):
    """[examples]: EXAMPLES_ON_CARD, each in its own process on the card,
    EXAMPLES_POOL at once in that order (the longest first). A twin passes
    when it exits 0 (its own asserts) and its output meets every GOLDENS
    row of its example. Returns {name: seconds}."""
    from examples_torch.goldens import check_output, load_goldens

    goldens = load_goldens()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(EXAMPLES_POOL) as workers:
        results = list(workers.map(lambda n: run_twin(n, device), EXAMPLES_ON_CARD))
    wall = time.perf_counter() - t0
    failures, seconds = [], {}
    for name, code, out, err, sec in results:
        fails, values = check_output(name, out, goldens)
        if code != 0:
            why = "timed out" if code is None else f"exited {code}"
            fails.insert(0, f"{name} {why} after {sec:.1f} s: {err.strip()[-1500:]}")
        seconds[name] = sec
        print(f"[examples] {name}: {sec:.1f} s on the card, exit {code}, golden numbers "
              f"{values}, {'every GOLDENS row met' if not fails else 'FAILED'}")
        failures += fails
    print(f"[examples] {len(EXAMPLES_ON_CARD)} twins, {EXAMPLES_POOL} processes at once, the "
          f"longest first: phase {wall:.1f} s of wall time ({sum(seconds.values()):.1f} s "
          f"summed); card: {card}")
    check(not failures, "[examples] " + "; ".join(failures))
    return seconds


def _nan_filled(device):
    """Fill, then free, 64 MiB with NaN: the caching allocator hands that
    memory to the next call's outputs, so an output the op leaves
    unwritten reads NaN (the trap of the batched f32 eigh that
    `ops/sqrt_riccati.py::eigh_rayleigh` works around)."""
    junk = torch.full((1 << 24,), float("nan"), device=device)
    del junk


def _spd(rng, batch, n):
    X = rng.normal(size=(batch, n, n))
    return X @ X.transpose(0, 2, 1) + n * np.eye(n)


def _rel_np(got, want) -> float:
    return float(np.max(np.abs(got - want)) / max(1.0, float(np.max(np.abs(want)))))


def _raises(fn, device) -> bool:
    try:
        fn()
        sync(device)
    except torch.linalg.LinAlgError:
        return True
    return False


def linalg_audit(device, dtype):
    """Each batched torch.linalg op of the port at one call site's shapes,
    on memory that held NaN, block by block against numpy: {op: (relative
    error of the well-conditioned blocks, whether the zero or singular
    block came out as numpy has it)}. The zero block z: cholesky, solve and
    inv must raise as numpy does (then the batch with z well-conditioned is
    compared); cholesky_ex must flag z alone; pinv must give z zeros;
    qr must give z's R zero and an orthonormal Q; solve_triangular and
    cholesky_solve take a zero right-hand side at z and must give zeros."""
    rng = np.random.default_rng(0)
    batch = LINALG_BATCH
    z = batch // 2

    def t(a):
        _nan_filled(device)
        return torch.tensor(a, dtype=dtype, device=device)

    def host(x):
        return x.double().cpu().numpy()

    out = {}
    # cholesky: Quu of the time-parallel backward (ops/parallel_riccati.py:302), m = 2
    M = _spd(rng, batch, 2)
    bad = M.copy()
    bad[z] = 0.0
    raised = _raises(lambda: torch.linalg.cholesky(t(bad)), device)
    L = host(torch.linalg.cholesky(t(M)))
    out["cholesky"] = (_rel_np(L, np.linalg.cholesky(M)), raised)
    # cholesky_ex, upper: the ADMM x-update's factor (solvers/lqt_admm.py:33)
    U, info = torch.linalg.cholesky_ex(t(bad), upper=True)
    info, U = info.cpu().numpy(), host(U)
    keep = np.arange(batch) != z
    flags = bool(info[z] > 0 and (info[keep] == 0).all())
    out["cholesky_ex"] = (_rel_np(U[keep], np.linalg.cholesky(M[keep]).transpose(0, 2, 1)),
                          flags)
    # solve: the combine's inverse T^-1 (ops/parallel_riccati.py:99), d = 4
    T = _spd(rng, batch, 4)
    bad = T.copy()
    bad[z] = 0.0
    eye = np.broadcast_to(np.eye(4), T.shape).copy()
    raised = _raises(lambda: torch.linalg.solve(t(bad), t(eye)), device)
    X = host(torch.linalg.solve(t(T), t(eye)))
    out["solve"] = (_rel_np(X, np.linalg.solve(T, eye)), raised)
    # inv: the pullbacks of the rotated boxes (projections/sets.py:238)
    raised = _raises(lambda: torch.linalg.inv(t(bad)), device)
    out["inv"] = (_rel_np(host(torch.linalg.inv(t(T))), np.linalg.inv(T)), raised)
    # solve_triangular, lower: the Cholesky solve (ops/riccati.py:64), rhs (4, 3)
    L4 = np.linalg.cholesky(T)
    rhs = rng.normal(size=(batch, 4, 3))
    rhs[z] = 0.0
    Y = host(torch.linalg.solve_triangular(t(L4), t(rhs), upper=False))
    out["solve_triangular"] = (_rel_np(Y[keep], np.linalg.solve(L4, rhs)[keep]),
                               bool((Y[z] == 0).all()))
    # cholesky_solve, lower (ops/riccati.py:128) and upper (solvers/lqt_admm.py:39)
    Y = host(torch.cholesky_solve(t(rhs), t(L4)))
    Yu = host(torch.cholesky_solve(t(rhs), t(L4.transpose(0, 2, 1).copy()), upper=True))
    want = np.linalg.solve(T, rhs)
    out["cholesky_solve"] = (max(_rel_np(Y[keep], want[keep]), _rel_np(Yu[keep], want[keep])),
                             bool((Y[z] == 0).all() and (Yu[z] == 0).all()))
    # pinv: the nullspace projector (utils/cost_assembly.py:108), J (3, 9)
    J = rng.normal(size=(batch, 3, 9))
    J[z] = 0.0
    P = host(torch.linalg.pinv(t(J)))
    out["pinv"] = (_rel_np(P[keep], np.linalg.pinv(J[keep])), bool((P[z] == 0).all()))
    # qr: reduced (solvers/lqt.py:134) and R only (ops/sqrt_riccati.py:152), (6, 4) blocks
    G = rng.normal(size=(batch, 6, 4))
    G[z] = 0.0
    Q, R = (host(v) for v in torch.linalg.qr(t(G)))
    R_only = host(torch.linalg.qr(t(G), mode="r").R)
    R_np = np.linalg.qr(G[keep], mode="r")
    orth = np.abs(Q.transpose(0, 2, 1) @ Q - np.eye(4)).max()
    err = max(_rel_np(np.abs(R[keep]), np.abs(R_np)), _rel_np(np.abs(R_only[keep]), np.abs(R_np)),
              _rel_np(Q[keep] @ R[keep], G[keep]), float(orth))
    out["qr"] = (err, bool((R[z] == 0).all() and (R_only[z] == 0).all()
                           and np.isfinite(Q[z]).all()))
    return out


def phase_linalg_audit(card, device="cuda"):
    """[linalg audit]: `linalg_audit` in f64 and f32 (eigh: `[facade sls]`).
    A wrong block or a zero block that does not come out as numpy's is a
    fault and fails the run."""
    faults = []
    for dtype in (torch.float64, torch.float32):
        tol = LINALG_TOL[dtype]
        for op, (err, zero_ok) in linalg_audit(device, dtype).items():
            ok = err <= tol and zero_ok
            print(f"[linalg audit] {op}, {_dtype_name(dtype)}, {LINALG_BATCH} blocks: well-"
                  f"conditioned blocks {err:.3e} from numpy (limit {tol:g}), the zero or singular "
                  f"block {'as numpy' if zero_ok else 'NOT as numpy'}: {'ok' if ok else 'FAULT'}")
            if not ok:
                faults.append(f"{op} {_dtype_name(dtype)}")
    print(f"[linalg audit] card: {card}")
    check(not faults, f"[linalg audit] faults: {faults}")


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
        wide_problem_, wide, wide_inputs, wide_cases_ = wide_cases("cuda")
        run("wide u-only geometry", phase_wide_geometry, wide_cases_)
        wide_max_err = run("wide u-only compare", phase_compare, wide_cases_)
        wide_launches, _ = run("wide u-only main path", phase_wide_main_path, wide, wide_problem_)
        wide_times = run("wide u-only time", phase_wide_time, wide, wide_inputs, card)
        box = box_solver("cuda")
        box_max_err = run("box compare", phase_box_compare, "cuda")
        box_launches, _ = run("box main path", phase_box_main_path, box, x0s)
        box_times = run("box time", phase_box_time, "cuda", card)
        sls = sls_solver("cuda", "diamond_ee")
        sls_fleet = sls_bounds("cuda", batch=SLS_BATCH, sort=True)
        sls_max_err = run("sls compare", phase_sls_compare, "cuda")
        sls_launches, _ = run("sls main path", phase_sls_main_path, sls, sls_fleet)
        sls_times = run("sls time", phase_sls_time, "cuda", card)
        robust2 = run("sls robust_dim 2", phase_robust2, "cuda", card)
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
        run("mpc car", phase_mpc_car, "cuda", card)
        run("mpc fleet", phase_mpc_fleet, "cuda", card)
        run("mpc boxddp", phase_mpc_boxddp, "cuda", card)
        run("mpc profile", phase_mpc_profile, "cuda", card)
        run("single solves", phase_single_solves, "cuda", card)
        run("boxddp graph", phase_boxddp_graph, "cuda")
        car_fleet, _, certificate, main_ms = run("boxddp main path", phase_boxddp_main_path,
                                                 "cuda", card)
        run("boxddp compare", phase_boxddp_compare, "cuda")
        boxddp_time = run("boxddp time", phase_boxddp_time, "cuda", card, car_fleet, main_ms)
        run("boxddp certificate", phase_boxddp_certificate, certificate, card)
        run("boxddp profile", phase_boxddp_profile, "cuda", card, car_fleet, boxddp_time["ms"])
        run("al arm", phase_al_arm, "cuda", card)
        facade_host = run("facade host start", start_facade_host_runs)
        run("facade sls", phase_facade_sls, "cuda", card, facade_host)
        run("facade obstacles", phase_facade_obstacles, "cuda", card, facade_host)
        run("facade car", phase_facade_car, "cuda", card, facade_host)
        run("facade maze", phase_facade_maze, "cuda", card, facade_host)
        run("implicit", phase_implicit, "cuda", card, facade_host)
        run("parallel", phase_parallel, card)
        run("linalg audit", phase_linalg_audit, card)
        run("examples", phase_examples, card)
        bounds = dict(run("fleet bounds", existing_bounds, solver, inputs, box[1], x0s,
                          sls[1], sls_fleet), **riccati_times["bounds"],
                      linesearch_rollout=car_times["bound"],
                      admm_u_only_wide=wide_bound(wide, wide_inputs),
                      sls_admm_robust_dim_2={k: robust2[k] for k in
                                             ("bound_ms", "bound_by", "bound_ops")})
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
        # the wide route of the same TPU kernel, its own kernel: the bench
        # row of bench_wide_certified.py (Nm = 512, refresh_every 8)
        "name": "admm_u_only_wide",
        "route": "cuda",
        "source": "ilqr_admm_tpu_torch/csrc/admm_u_only_wide.cu",
        "replaces": "ilqr_admm_tpu/ops/pallas_admm.py:90",
        "launches": wide_launches,
        "max_abs_err": wide_max_err,
        "ms": wide_times["kernel"],
        "plain_ms": wide_times["plain"],
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
        # the same kernel's consensus build at p1 = 3 on its own main path
        "name": "sls_admm_robust_dim_2",
        "route": "cuda",
        "source": "ilqr_admm_tpu_torch/csrc/sls_admm.cu",
        "replaces": "ilqr_admm_tpu/ops/pallas_sls.py:99",
        "launches": robust2["launches"],
        "max_abs_err": robust2["max_abs_err"],
        "ms": robust2["ms"],
        "plain_ms": robust2["plain_ms"],
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
