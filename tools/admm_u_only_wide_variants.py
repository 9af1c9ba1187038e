#!/usr/bin/env python3
"""Builds of `csrc/admm_u_only_wide.cu` with other chunks and unrolls, timed
on one CUDA card.

Each build sets WIDE_KC (k-steps a product chains on the tensor cores
before it adds the chunk to its total in f32; 0: one chain over the whole
k range) and WIDE_UNROLL (k-steps in flight). Each is timed on the wide
bench fleet of `chip_smoke.py` (8,192 instances, Nm = 512, 100 iterations;
refresh_every 8 and 1; CUDA events, median of 3 windows of 3 calls, two
rounds in turn) and prints its largest difference to the plain version
with the kernel's products (`products="tf32x3"`) and the registers and
spills `ptxas` reports for its T = 32 builds. The builds go to
build/admm_u_only_wide_variants/ under the repository root.

Run from the repository root on a machine with a card and nvcc:
    python3 tools/admm_u_only_wide_variants.py
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ilqr_admm_tpu_torch import _build  # noqa: E402
from ilqr_admm_tpu_torch.ops import fused_admm  # noqa: E402

CSRC = ROOT / "ilqr_admm_tpu_torch" / "csrc"
VARIANTS = {
    "as committed (KC 8, unroll 2)": [],
    "one chain (KC 0)": ["-DWIDE_KC=0"],
    "KC 16": ["-DWIDE_KC=16"],
    "unroll 1": ["-DWIDE_UNROLL=1"],
}


def build(out_dir: Path) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in VARIANTS.items():
        tag = "".join(c if c.isalnum() else "_" for c in name)
        cmd = [_build._nvcc(), *_build._FLAGS, *flags, "-shared", "-o", str(out_dir / f"{tag}.so"),
               str(CSRC / "admm_u_only.cu"), str(CSRC / "admm_u_only_wide.cu")]
        procs[name] = (tag, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    ours = _build.load_library()
    for name, (tag, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name!r} failed to build:\n{out}")
        lib = ctypes.CDLL(str(out_dir / f"{tag}.so"))
        for fn in ("admm_u_only_launch", "admm_u_only_wide_launch", "admm_u_only_error_string"):
            getattr(lib, fn).argtypes = getattr(ours, fn).argtypes
            getattr(lib, fn).restype = getattr(ours, fn).restype
        libs[name] = (lib, out)
    return libs


def ptxas_lines(log: str) -> list[str]:
    """`kernel: spill line; registers line` of each T = 32 wide build, from
    ptxas's -v output (its entry line, the function's properties, its
    stack and spills, its registers)."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        m = re.search(r"(admm_u_only_wide_kernelILi2ELb[01]ELb[01]E)", line)
        if m and "Compiling entry function" in line and i + 3 < len(lines):
            out.append(f"{m.group(1)}: {lines[i + 2].strip()}; "
                       f"{lines[i + 3].split(':', 1)[-1].strip()}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    _, card = chip_smoke.phase_device()
    libs = build(ROOT / "build" / "admm_u_only_wide_variants")
    for name, (_, log) in libs.items():
        for line in ptxas_lines(log):
            print(f"[wide variant] {name}: ptxas {line}", flush=True)
    problem = chip_smoke.wide_problem("cuda")
    solver = chip_smoke.wide_solver("cuda", problem)
    inputs = solver.kernel_inputs(problem[3])
    saved = _build.load_library
    try:
        for rnd in range(2):
            for refresh in (chip_smoke.WIDE_REFRESH, 1):
                kw = dict(solver.kernel_options, refresh_every=refresh)
                want = fused_admm.admm_u_only_reference(*inputs, **kw, products="tf32x3")
                for name, (lib, _) in libs.items():
                    _build.load_library = lambda lib=lib: lib

                    def call():
                        return fused_admm.admm_u_only(*inputs, solver.packed, **kw)

                    got = call()
                    torch.cuda.synchronize()
                    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                    ms = sorted(chip_smoke._event_ms(call, 3) for _ in range(3))
                    print(f"[wide variant] round {rnd}, refresh_every {refresh}, {name}: "
                          f"{ms[1]:.4f} ms a solve (windows {', '.join(f'{m:.4f}' for m in ms)}); "
                          f"max diff to the 3xTF32 plain version {err:.3e}; card: {card}",
                          flush=True)
    finally:
        _build.load_library = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
