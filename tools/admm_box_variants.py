#!/usr/bin/env python3
"""Where the time of `csrc/admm_box.cu` goes, on one CUDA card.

Builds copies of the kernel source with one part changed or taken out,
times each at the full width of the state-bounded fleet (16,384
instances, 200 iterations; CUDA events, median of 3 windows of 5 calls,
two rounds in turn) and prints its largest difference to the f32 plain
version (the changed copies compute something else on purpose, except
"rounded lo"). One more variant keeps the kernel and changes the host's
schedule: the last single n-tile of W_s on two warps instead of four
(no partial-sum slots, 14 warps). Then builds and runs
`tools/mma_sync_bench.cu`. The builds go to build/admm_box_variants/
under the repository root.

Run from the repository root on a machine with a card and nvcc:
    python3 tools/admm_box_variants.py
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

SPLIT = "  lo = __float_as_uint(sub(x, __uint_as_float(hi)));"
LOOP = "  for (int kk = klo; kk < khi; ++kk, b += NB * kBlock)"
VARIANTS = {
    "as committed": [],
    # lo rounded to nearest too, as cvt.rna.tf32.f32 would
    "rounded lo": [(SPLIT, "  lo = (__float_as_uint(sub(x, __uint_as_float(hi))) + 0x1000u) "
                           "& 0xFFFFE000u;")],
    "1xTF32 products": [("      mma(acc[n][mt], lo, b_hi[n][0], b_hi[n][1]);\n"
                         "      mma(acc[n][mt], hi, b_lo[n][0], b_lo[n][1]);\n", "")],
    "no operand split": [("  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;\n" + SPLIT,
                          "  hi = __float_as_uint(x);\n  lo = hi;")],
    "no products": [(LOOP, LOOP.replace("kk < khi", "kk < klo"))],
    "no A-buffer stores, no clip": [
        ("    for (int mt = 0; mt < MT; ++mt) p[8 * (frag_row(mt, i, 0)) + a_pos(2 * t + (i & 1))]"
         " = v[mt][i];", "    for (int mt = 0; mt < MT; ++mt) (void)v;"),
        ("  const float2 lo2 = *reinterpret_cast<const float2*>(lo + c);",
         "  return;\n  const float2 lo2 = *reinterpret_cast<const float2*>(lo + c);")],
}


def build(out_dir: Path) -> dict:
    src = (ROOT / "ilqr_admm_tpu_torch" / "csrc" / "admm_box.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name!r}: the source no longer has {old!r}")
            text = text.replace(old, new)
        tag = "".join(c if c.isalnum() else "_" for c in name)
        (out_dir / f"{tag}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build._FLAGS, "-shared", "-o", str(out_dir / f"{tag}.so"),
               str(out_dir / f"{tag}.cu")]
        procs[name] = (tag, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    signature = _build.load_library().admm_box_launch.argtypes
    for name, (tag, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name!r} failed to build:\n{out}")
        lib = ctypes.CDLL(str(out_dir / f"{tag}.so"))
        lib.admm_box_launch.argtypes = signature
        lib.admm_box_launch.restype = ctypes.c_int
        lib.admm_box_error_string.argtypes = [ctypes.c_int]
        lib.admm_box_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    _, card = chip_smoke.phase_device()
    libs = build(ROOT / "build" / "admm_box_variants")
    _, box = chip_smoke.box_solver("cuda")
    inputs = box.kernel_inputs(chip_smoke.bench_problem("cuda")[3])
    kw = box.kernel_options
    want = fused_admm.admm_box_reference(*inputs, **kw)
    slots = fused_admm._BOX_SLOTS
    fused_admm._BOX_SLOTS = 0
    two_warps = fused_admm.pack_box_operators(box.W_s, box.SuT)
    fused_admm._BOX_SLOTS = slots
    runs = {name: (lib, box.packed, slots) for name, lib in libs.items()}
    runs["last single n-tile on two warps"] = (libs["as committed"], two_warps, 0)
    saved = _build.load_library
    try:
        for rnd in range(2):
            for name, (lib, packed, n_slots) in runs.items():
                _build.load_library = lambda lib=lib: lib

                def call():
                    fused_admm._BOX_SLOTS = n_slots
                    return fused_admm.admm_box(*inputs, packed, **kw)

                got = call()
                torch.cuda.synchronize()
                err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                ms = sorted(chip_smoke._event_ms(call, 5) for _ in range(3))
                print(f"[admm_box variant] round {rnd}, {name}: {ms[1]:.4f} ms a solve "
                      f"(windows {', '.join(f'{m:.4f}' for m in ms)}); max diff to the f32 "
                      f"plain version {err:.3e}; card: {card}", flush=True)
    finally:
        _build.load_library = saved
        fused_admm._BOX_SLOTS = slots
    exe = ROOT / "build" / "admm_box_variants" / "mma_sync_bench"
    subprocess.run([_build._nvcc(), *_build._ARCH, "-O3", "-o", str(exe),
                    str(ROOT / "tools" / "mma_sync_bench.cu")], check=True)
    return subprocess.run([str(exe)]).returncode


if __name__ == "__main__":
    sys.exit(main())
