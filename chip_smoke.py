#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Drives the port's main path, the box-constrained LQT-ADMM fleet of the
repository's bench (16,384 double-integrator instances, N = 100,
|u| <= 5, rho_u = 0.1, 100 iterations), through `make_fused_lqt_admm`
on the card, in phases:

1. device: a CUDA card must be present (there is no CPU path);
2. build: compile the CUDA kernel library from the sources in the tree;
3. kernel vs plain: `admm_u_only` against `admm_u_only_reference` on
   the same card inputs, in three modes at the bench shapes and one at
   an odd width;
4. main path: one fleet solve with the launch counter reset, checked
   against the bench certificates (`utils/certify.py`);
5. time: the kernel and the plain version with CUDA events.

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

from ilqr_admm_tpu_torch import _build
from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.ops import fused_admm
from ilqr_admm_tpu_torch.ops.fused_admm import (
    admm_u_only,
    admm_u_only_reference,
    make_fused_lqt_admm,
)
from ilqr_admm_tpu_torch.utils.certify import certify, gate_failures
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
            if "registers" in line or "spill" in line or "smem" in line:
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
    fused_admm.launch_count = 0
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
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
