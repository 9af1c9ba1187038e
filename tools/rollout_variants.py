#!/usr/bin/env python3
"""The staged line-search rollout against the per-thread design it
replaced, on one CUDA card, and the chain it is bound by.

Builds `tools/linesearch_rollout_per_thread.cu` (one thread a candidate,
a loop over t) beside the port's own library, runs both on the same
candidates at N = 500 and N = 10,000 (20 candidates, chip_smoke's
`rollout_case`), checks that both are bit-identical to the plain version,
and times each kernel's device time from a CUDA graph of 10 wrapper calls
(chip_smoke's `_graph_ms`, median of 7 windows) in the order per-thread,
staged, staged, per-thread. Then builds and runs `tools/fadd_chain_bench.cu`
(an FADD's latency, the staged kernel's chain loop in cycles a link, the
SM clock). The builds go to build/rollout_variants/ under the repository
root.

Run from the repository root on a machine with a card and nvcc:
    python3 tools/rollout_variants.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ilqr_admm_tpu_torch import _build  # noqa: E402
from ilqr_admm_tpu_torch.ops import fused_rollout  # noqa: E402

ENTRY = "linesearch_rollout_car_front_wheel_launch"


def build(out_dir: Path):
    """(the per-thread library, the FADD benchmark's executable)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    so, exe = out_dir / "per_thread.so", out_dir / "fadd_chain_bench"
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in ([_build._nvcc(), *_build._FLAGS, "-shared", "-o", str(so),
                          str(ROOT / "tools" / "linesearch_rollout_per_thread.cu")],
                         [_build._nvcc(), *_build._ARCH, "-O3", "-o", str(exe),
                          str(ROOT / "tools" / "fadd_chain_bench.cu")])]
    for proc in procs:
        out, _ = proc.communicate()
        print(out, end="")
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed:\n{out}")
    lib = ctypes.CDLL(str(so))
    ours = _build.load_library()
    for name in (ENTRY, "linesearch_rollout_error_string"):
        getattr(lib, name).argtypes = getattr(ours, name).argtypes
        getattr(lib, name).restype = getattr(ours, name).restype
    return lib, exe


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    _, card = chip_smoke.phase_device()
    staged = _build.load_library()
    per_thread, exe = build(ROOT / "build" / "rollout_variants")
    libs = {"per-thread": per_thread, "staged": staged}
    saved = _build.load_library
    try:
        for horizon in (chip_smoke.CAR_N, 10_000):
            car, x0, u = chip_smoke.rollout_case("cuda", horizon, chip_smoke.CAR_ALPHAS)
            want = fused_rollout.linesearch_rollout_reference(car.step_cols, x0, u)
            for name in ("per-thread", "staged", "staged", "per-thread"):
                _build.load_library = lambda lib=libs[name]: lib
                got = fused_rollout.linesearch_rollout(car, x0, u)
                same = torch.equal(torch.nan_to_num(got, nan=7.0), torch.nan_to_num(want, nan=7.0))
                med, q1, q3 = chip_smoke._graph_ms(lambda: fused_rollout.linesearch_rollout(car, x0, u))
                print(f"[rollout variant] N={horizon}, A={chip_smoke.CAR_ALPHAS}, {name}: {med:.4f} ms "
                      f"(IQR {q1:.4f}-{q3:.4f}, CUDA graph of 10 calls); bit-identical to the "
                      f"plain version {same}; card: {card}", flush=True)
    finally:
        _build.load_library = saved
    return subprocess.run([str(exe)]).returncode


if __name__ == "__main__":
    sys.exit(main())
