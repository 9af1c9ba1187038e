#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Drives the port's two paths on the card:

- the box-constrained LQT-ADMM fleet of the repository's bench (16,384
  double-integrator instances, N = 100, |u| <= 5, rho_u = 0.1, 100
  iterations) through `make_fused_lqt_admm`;
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
   three modes and at an odd width; `sls_admm` in the diamond, early-exit
   and consensus modes and at an odd width);
4. for each path: main path, one fleet solve with every launch counter
   set to 0 just before it and read just after, checked against the
   bench certificates (`utils/certify.py`);
5. for each path: time, the kernel and the plain version with CUDA
   events.

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
    admm_u_only,
    admm_u_only_reference,
    make_fused_lqt_admm,
)
from ilqr_admm_tpu_torch.ops.fused_sls import make_fused_sls_admm, sls_admm, sls_admm_reference
from ilqr_admm_tpu_torch.utils.certify import (
    certify,
    certify_sls,
    gate_failures,
    sls_gate_failures,
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


def reset_launch_counts():
    fused_admm.launch_count = 0
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
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
