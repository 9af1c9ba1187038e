#!/usr/bin/env python3
"""Where the time of `csrc/admm_u_only.cu` goes, on one CUDA card.

Builds copies of the kernel source with one part changed or taken out,
times each on the main path's solve (the 16,384-instance bench fleet,
100 iterations, batch_tile 64; CUDA events, median of 3 windows of 5
calls, two rounds in turn) and prints its largest difference to the
plain version with the kernel's products (`products="tf32x3"`; the
changed copies compute something else on purpose). The builds go to
build/admm_u_only_variants/ under the repository root.

Run from the repository root on a machine with a card and nvcc:
    python3 tools/admm_u_only_variants.py
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
from ilqr_admm_tpu_torch.ops import fused_admm  # noqa: E402

CSRC = ROOT / "ilqr_admm_tpu_torch" / "csrc"
PRODUCT = "b, klo, khi, lane, g, t);"
VARIANTS = {
    "as committed": [],
    # x = x_base + s W_x after the loop left out
    "no x product": [("piece < n_pairs_x * GX;", "piece < 0;")],
    # the tail in 3xTF32 instead of 6xTF32
    "3xTF32 tail": [("if (six) product_nb", "if (false) product_nb")],
    # no k-steps in the loop: staging, epilogues, barriers and x only
    "no loop products": [(PRODUCT, "b, klo, klo, lane, g, t);")],
}


def build(out_dir: Path) -> dict:
    src = (CSRC / "admm_u_only.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"variant {name!r}: the source no longer has {old!r}")
            text = text.replace(old, new)
        tag = "".join(c if c.isalnum() else "_" for c in name)
        (out_dir / f"{tag}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build._FLAGS, "-I", str(CSRC), "-shared",
               "-o", str(out_dir / f"{tag}.so"), str(out_dir / f"{tag}.cu")]
        procs[name] = (tag, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    ours = _build.load_library()
    for name, (tag, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name!r} failed to build:\n{out}")
        lib = ctypes.CDLL(str(out_dir / f"{tag}.so"))
        for fn in ("admm_u_only_launch", "admm_u_only_error_string"):
            getattr(lib, fn).argtypes = getattr(ours, fn).argtypes
            getattr(lib, fn).restype = getattr(ours, fn).restype
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    _, card = chip_smoke.phase_device()
    libs = build(ROOT / "build" / "admm_u_only_variants")
    A, B, cost, x0s = chip_smoke.bench_problem("cuda")
    solver = fused_admm.make_fused_lqt_admm(
        A, B, cost, u_lower=-chip_smoke.U_MAX, u_upper=chip_smoke.U_MAX, rho_u=chip_smoke.RHO_U,
        n_iters=chip_smoke.ADMM_ITERS, batch_tile=chip_smoke.BATCH_TILE, device="cuda")
    inputs = solver.kernel_inputs(x0s)
    kw = solver.kernel_options
    want = fused_admm.admm_u_only_reference(*inputs, **kw, products="tf32x3")
    saved = _build.load_library
    try:
        for rnd in range(2):
            for name, lib in libs.items():
                _build.load_library = lambda lib=lib: lib

                def call():
                    return fused_admm.admm_u_only(*inputs, solver.packed, **kw)

                got = call()
                torch.cuda.synchronize()
                err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                ms = sorted(chip_smoke._event_ms(call, 5) for _ in range(3))
                print(f"[admm_u_only variant] round {rnd}, {name}: {ms[1]:.4f} ms a solve "
                      f"(windows {', '.join(f'{m:.4f}' for m in ms)}); max diff to the 3xTF32 "
                      f"plain version {err:.3e}; card: {card}", flush=True)
    finally:
        _build.load_library = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
