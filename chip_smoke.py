#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Drives the port's three paths on the card:

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
  exit at 3e-3 every 16 iterations, fleet sorted by bound).

Phases:

1. device: a CUDA card must be present (there is no CPU path);
2. build: compile the CUDA kernel library from the sources in the tree;
3. for each path: kernel vs plain, the kernel against its plain torch
   version on the same card inputs (the LQT fleet's `admm_u_only` in
   three modes and at an odd width; `admm_box` at the full width, with a
   state box only, and at an odd width; `sls_admm` in the diamond,
   early-exit and consensus modes and at an odd width);
4. for each path: main path, one fleet solve with every launch counter
   set to 0 just before it and read just after, checked against the
   certificates (`utils/certify.py`);
5. for each path: time, the kernel and the plain version with CUDA
   events (for the state-bounded path also the whole forward and the
   plain fleet `make_batched_lqt_admm`).

Any failure exits non-zero before the last line. The last line is
{"ok": true, "device": {...}}; the line before it lists each kernel.

Run from the repository root: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
from scipy.stats import norm

from ilqr_admm_tpu_torch import _build
from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.ops import fused_admm, fused_sls
from ilqr_admm_tpu_torch.ops.fused_admm import (
    admm_box,
    admm_box_reference,
    admm_u_only,
    admm_u_only_reference,
    make_fused_lqt_admm,
)
from ilqr_admm_tpu_torch.ops.fused_sls import make_fused_sls_admm, sls_admm, sls_admm_reference
from ilqr_admm_tpu_torch.solvers.batched import make_batched_lqt_admm
from ilqr_admm_tpu_torch.utils.certify import (
    certify,
    certify_sls,
    certify_state_box,
    gate_failures,
    sls_gate_failures,
    state_box_gate_failures,
)
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost

N = 100
BATCH = 16384
ADMM_ITERS = 100
RHO_U = 0.1
U_MAX = 5.0
BATCH_TILE = 64
# kernel and plain version differ only in the order of f32 sums
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
    """A width that is not a multiple of the kernel's 4 x 4 thread tile
    (Nm = 98), with over-relaxation and a tighter box that binds on ~70%
    of the controls: exercises the masked columns and the alpha != 1
    branch. It converges within its 100 iterations, so summation-order
    differences stay near f32 rounding."""
    A, B, cost, x0s = bench_problem(device, horizon=98, batch=64, seed=1)
    solver = make_fused_lqt_admm(
        A, B, cost, u_lower=-4.0, u_upper=4.0, rho_u=RHO_U, n_iters=ADMM_ITERS, alpha=1.6,
        batch_tile=8, device=device,
    )
    return solver, *solver.bases(x0s)


def phase_compare(cases):
    """cases: (label, solver, u_base, x_base, extra options) to run both ways."""
    worst = 0.0
    for mode, solver, u_base, x_base, extra in cases:
        ops = (u_base, x_base, solver.W_u, solver.W_x, solver.lo, solver.hi)
        kw = dict(solver.kernel_options, **extra)
        got = admm_u_only(*ops, **kw)
        torch.cuda.synchronize()
        want = admm_u_only_reference(*ops, **kw)
        torch.cuda.synchronize()
        errs = {}
        for name, g, w in zip(("x", "u", "z_u"), got, want):
            check(bool(torch.isfinite(g).all()), f"{mode}: kernel {name} has non-finite values")
            errs[name] = float((g - w).abs().max())
        worst = max(worst, *errs.values())
        print(f"[kernel vs plain] {mode}: max|dx| {errs['x']:.3e}, max|du| {errs['u']:.3e}, "
              f"max|dz_u| {errs['z_u']:.3e} (tolerance {KERNEL_TOL:g})")
        check(max(errs.values()) <= KERNEL_TOL, f"{mode}: kernel disagrees with plain version")
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


def phase_time(solver, u_base, x_base, card):
    ops = (u_base, x_base, solver.W_u, solver.W_x, solver.lo, solver.hi)
    kw = solver.kernel_options
    paths = {"kernel": lambda: admm_u_only(*ops, **kw),
             "plain": lambda: admm_u_only_reference(*ops, **kw)}
    for fn in paths.values():  # warm up
        fn()
    torch.cuda.synchronize()
    ms = {name: [] for name in paths}
    for _ in range(TIMING_WINDOWS):  # windows alternate kernel, plain
        for name, fn in paths.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CALLS_PER_WINDOW):
                fn()
            end.record()
            end.synchronize()
            ms[name].append(start.elapsed_time(end) / CALLS_PER_WINDOW)
    result = {}
    for name, samples in ms.items():
        med, q1, q3 = _median_iqr(samples)
        rate = BATCH * ADMM_ITERS / (med * 1e-3)
        result[name] = med
        print(f"[time] {name}: {med:.4f} ms per solve (IQR {q1:.4f}-{q3:.4f}, "
              f"{TIMING_WINDOWS} windows of {CALLS_PER_WINDOW}) = {rate:.4g} ADMM iterations/s "
              f"at B={BATCH}, Nm={N}, {ADMM_ITERS} iterations, batch_tile={BATCH_TILE}; "
              f"card: {card}")
    return result


def box_cases(device):
    """(label, solver, kernel inputs) of the three kernel-vs-plain cases."""
    _, full = box_solver(device)
    x0s = bench_problem(device)[3]
    # state box only (the u block is off): rho_u is dropped with the bounds
    _, x_only = box_solver(device, u_lower=None, u_upper=None, rho_u=None)
    # Nm = 98 is not a multiple of the kernel's 4-column thread tile; over-
    # relaxation (1.3: at 1.6 the JAX package's relaxed step, whose dual
    # update takes the unrelaxed x_hat, diverges on every state box), a
    # velocity limit that varies along the horizon, control bounds that
    # vary too, and a small tile
    A, B, cost, x0_odd = bench_problem(device, horizon=98, batch=64, seed=1)
    x_lower, x_upper = velocity_box(98, 1.2 + 0.3 * np.cos(np.linspace(0.0, 3.0, 98)))
    odd = make_fused_lqt_admm(
        A, B, cost, u_lower=np.full(98, -4.0), u_upper=np.linspace(3.0, 5.0, 98),
        x_lower=x_lower, x_upper=x_upper, rho_x=RHO_X, rho_u=RHO_U, n_iters=BOX_ITERS,
        alpha=1.3, batch_tile=8, device=device,
    )
    return [
        (f"full width (batch {BATCH}, tile {BOX_TILE})", full, full.kernel_inputs(x0s)),
        ("state box only, |v| <= 1.3 (batch 1024)", x_only, x_only.kernel_inputs(x0s[:1024])),
        ("Nm=98, alpha=1.3, vector bounds (batch 64, tile 8)", odd, odd.kernel_inputs(x0_odd)),
    ]


def phase_box_compare(device):
    """`admm_box` against `admm_box_reference` on the same card inputs."""
    worst = 0.0
    for label, solver, inputs in box_cases(device):
        kw = solver.kernel_options
        got = admm_box(*inputs, solver.packed, **kw)
        torch.cuda.synchronize()
        want = admm_box_reference(*inputs, **kw)
        torch.cuda.synchronize()
        scale = max(1.0, float(want[0].abs().max()), float(want[1].abs().max()))
        errs = {}
        for name, g, w in zip(("x", "u", "z_x", "z_u"), got, want):
            check(bool(torch.isfinite(g).all()), f"box {label}: kernel {name} has non-finite values")
            errs[name] = float((g - w).abs().max())
        err = max(errs.values())
        worst = max(worst, err)
        print(f"[box kernel vs plain] {label}: " + ", ".join(
            f"max|d{k}| {v:.3e}" for k, v in errs.items()) + f" (tolerance {BOX_TOL * scale:.3g})")
        check(err <= BOX_TOL * scale, f"box {label}: kernel disagrees with plain version")
    return worst


def phase_box_main_path(device):
    """The state-bounded fleet at full width, through the kernel only, certified."""
    (A, B, cost), solver = box_solver(device)
    x0s = bench_problem(device)[3]

    def plain_must_not_run(*args, **kwargs):
        raise SmokeFailure("the state-bounded main path ran admm_box_reference")

    reset_launch_counts()
    fused_admm.admm_box_reference = plain_must_not_run
    try:
        x, u, z_x, z_u = solver(x0s)
        torch.cuda.synchronize()
    finally:
        fused_admm.admm_box_reference = admm_box_reference
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


def phase_sls_compare(device):
    """`sls_admm` against `sls_admm_reference` on the same card inputs."""
    cases = [(f"{mode} (batch {SLS_BATCH}, tile {SLS_TILE}"
              f"{', sorted' if mode == 'diamond_ee' else ''})",
              sls_solver(device, mode)[1],
              sls_bounds(device, batch=SLS_BATCH, sort=mode == "diamond_ee"))
             for mode in SLS_MODES]
    # Nm = 98 is not a multiple of the kernel's 4-control thread tile;
    # over-relaxation exercises the alpha != 1 branch of the z-update
    cases.append(("diamond, Nm=98, alpha=1.6 (batch 64, tile 8)",
                  sls_solver(device, "diamond", horizon=98, alpha=1.6)[1],
                  sls_bounds(device, batch=64, seed=1)))
    worst = 0.0
    for label, solver, bounds in cases:
        kw = solver.kernel_options
        got = sls_admm(bounds, solver.U_base, solver.W, **kw)
        torch.cuda.synchronize()
        want = sls_admm_reference(bounds, solver.U_base, solver.W, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"sls {label}: kernel U has non-finite values")
        err = float((got - want).abs().max())
        if kw["stop_tol"] > 0.0:
            tol = SLS_EARLY_EXIT_TOL
        else:
            tol = SLS_FIXED_TOL * max(1.0, float(want.abs().max()))
        worst = max(worst, err)
        print(f"[sls kernel vs plain] {label}: max|dU| {err:.3e} (tolerance {tol:.3g})")
        check(err <= tol, f"sls {label}: kernel disagrees with plain version")
    return worst


def phase_sls_main_path(device):
    """The serving configuration on the sorted bench fleet, certified."""
    (A, B, cost), solver = sls_solver(device, "diamond_ee")
    bounds = sls_bounds(device, batch=SLS_BATCH, sort=True)
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


def phase_sls_time(device, card):
    """Kernel alone, whole forward (kernel + phi_u) and the plain version,
    per mode and batch; windows alternate between the three."""
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
                "kernel": (lambda: sls_admm(*ops, **kw), TIMING_WINDOWS, CALLS_PER_WINDOW),
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
    return result


def main() -> int:
    try:
        name, card = phase_device()
        phase_build()
        A, B, cost, x0s = bench_problem("cuda")
        solver = make_fused_lqt_admm(
            A, B, cost, u_lower=-U_MAX, u_upper=U_MAX, rho_u=RHO_U,
            n_iters=ADMM_ITERS, batch_tile=BATCH_TILE, device="cuda",
        )
        u_base, x_base = solver.bases(x0s)
        odd, odd_u, odd_x = odd_width_case("cuda")
        cases = [(mode, solver, u_base, x_base, extra) for mode, extra in MODES.items()]
        cases.append(("Nm=98, alpha=1.6, |u|<=4, batch_tile=8", odd, odd_u, odd_x, {}))
        max_err = phase_compare(cases)
        launches, _ = phase_main_path(solver, A, B, cost, x0s)
        times = phase_time(solver, u_base, x_base, card)
        box_max_err = phase_box_compare("cuda")
        box_launches, _ = phase_box_main_path("cuda")
        box_times = phase_box_time("cuda", card)
        sls_max_err = phase_sls_compare("cuda")
        sls_launches, _ = phase_sls_main_path("cuda")
        sls_times = phase_sls_time("cuda", card)
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", flush=True)
        return 1
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
