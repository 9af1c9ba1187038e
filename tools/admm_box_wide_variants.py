#!/usr/bin/env python3
"""Builds of `csrc/admm_box_wide.cu` with other unrolls and chunks, timed on
one CUDA card.

Each build is a copy of the source with one or more of its constants
rewritten: kUnroll32 / kUnroll16 (k-steps in flight at 32 and 16 instances
a block) or KC (k-steps a product chains on the tensor cores before it
adds the chunk to its total in f32; 0 is one chain). Each is timed on the planar state-bounded fleet of `chip_smoke.py`
(16,384 instances, Nm = 200, Nd = 400, 200 iterations) at batch_tile 32
and 16 (CUDA events, median of 3 windows of 2 calls, two rounds in turn),
and prints its largest difference to the plain version with the
kernel's products (`products="tf32x3"`) and to the f32 one, and the
registers and spills `ptxas` reports for each build. The builds go to
build/admm_box_wide_variants/ under the repository root.

Run from the repository root on a machine with a card and nvcc:
    python3 tools/admm_box_wide_variants.py
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
WIDE = CSRC / "admm_box_wide.cu"
# name: {constant: value} rewritten in the copy
VARIANTS = {
    "as committed (KC 8, unroll 1 at T = 32, 2 at 16)": {},
    "unroll 2 at T = 32": {"kUnroll32": 2},
    "unroll 1 at T = 16": {"kUnroll16": 1},
    "one chain (KC 0)": {"KC": 0},
    "KC 16": {"KC": 16},
}
FUNCTIONS = ("admm_box_launch", "admm_box_wide_launch", "admm_box_error_string")


def variant_source(values: dict) -> str:
    """The wide kernel's source with each `constexpr int name = ...;` of
    values rewritten."""
    text = WIDE.read_text()
    for name, value in values.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                          text)
        if n != 1:
            raise SystemExit(f"{WIDE.name} has {n} definitions of {name}, not 1")
    return text


def build(out_dir: Path) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, values in VARIANTS.items():
        tag = "".join(c if c.isalnum() else "_" for c in name)
        source = out_dir / f"{tag}.cu"
        source.write_text(variant_source(values))
        cmd = [_build._nvcc(), *_build._FLAGS, "-I", str(CSRC), "-shared", "-o",
               str(out_dir / f"{tag}.so"), str(CSRC / "admm_box.cu"), str(source)]
        procs[name] = (tag, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    ours = _build.load_library()
    for name, (tag, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name!r} failed to build:\n{out}")
        lib = ctypes.CDLL(str(out_dir / f"{tag}.so"))
        for fn in FUNCTIONS:
            getattr(lib, fn).argtypes = getattr(ours, fn).argtypes
            getattr(lib, fn).restype = getattr(ours, fn).restype
        libs[name] = (lib, out)
    return libs


def ptxas_lines(log: str) -> list[str]:
    """`kernel: spill line; registers line` of each wide build, from ptxas's
    -v output (its entry line, the function's properties, its stack and
    spills, its registers)."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        m = re.search(r"(admm_box_wide_kernelILi[12]ELb[01]E)", line)
        if m and "Compiling entry function" in line and i + 3 < len(lines):
            out.append(f"{m.group(1)}: {lines[i + 2].strip()}; "
                       f"{lines[i + 3].split(':', 1)[-1].strip()}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    _, card = chip_smoke.phase_device()
    libs = build(ROOT / "build" / "admm_box_wide_variants")
    for name, (_, log) in libs.items():
        for line in ptxas_lines(log):
            print(f"[box wide variant] {name}: ptxas {line}", flush=True)
    x0s = chip_smoke.via_point_problem("cuda", 2)[3]
    solvers = {tile: chip_smoke.box_solver("cuda", nb_dim=2, batch_tile=tile)[1]
               for tile in (32, 16)}
    saved = _build.load_library
    try:
        for rnd in range(2):
            for tile, solver in solvers.items():
                kw = solver.kernel_options
                inputs = solver.kernel_inputs(x0s)
                emulated = fused_admm.admm_box_reference(*inputs, **kw, products="tf32x3")
                want = fused_admm.admm_box_reference(*inputs, **kw)
                for name, (lib, _) in libs.items():
                    _build.load_library = lambda lib=lib: lib

                    def call():
                        return fused_admm.admm_box(*inputs, solver.packed, **kw,
                                                   route=solver.route)

                    got = call()
                    torch.cuda.synchronize()
                    err3 = max(float((g - w).abs().max()) for g, w in zip(got, emulated))
                    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                    ms = sorted(chip_smoke._event_ms(call, 2) for _ in range(3))
                    print(f"[box wide variant] round {rnd}, batch_tile {tile}, {name}: "
                          f"{ms[1]:.4f} ms a solve (windows {', '.join(f'{m:.4f}' for m in ms)}); "
                          f"max diff to the 3xTF32 plain version {err3:.3e}, to the f32 one "
                          f"{err:.3e}; card: {card}", flush=True)
    finally:
        _build.load_library = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
