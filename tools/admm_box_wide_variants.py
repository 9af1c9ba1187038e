#!/usr/bin/env python3
"""Where the time of `csrc/admm_box_wide.cu` goes, on one CUDA card.

Builds copies of the kernel source with one or more of its constants
rewritten (kStages, the k-steps of A fragments in flight a warpgroup;
kGroup, the k-steps issued as one commit group, which the packing's
multiple of 2 must allow; KC, the k-steps a product chains on the tensor
cores before it adds the chunk to its total in f32) or with one part
taken out
(the copies without a part compute something else on purpose). Each is
timed on the planar state-bounded fleet of `chip_smoke.py` (16,384
instances, Nm = 200, Nd = 400, 200 iterations) at batch_tile 32 and 16
(CUDA events, median of 3 windows of 2 calls, two rounds in turn), and
prints its largest difference to the plain version with the kernel's
products (`products="tf32x3"`) and to the f32 one, and the registers and
spills `ptxas` reports and the local-memory loads and stores
(`cuobjdump -sass`) of each build. Then builds and runs
`tools/wgmma_tf32_bench.cu` (the SM's cycles a TF32 wgmma as the kernel
issues them). The builds go to build/admm_box_wide_variants/ under the
repository root.

Run from the repository root on a machine with a card and nvcc:
    python3 tools/admm_box_wide_variants.py
"""

from __future__ import annotations

import ctypes
import re
import shutil
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
LOAD = "    copy16(ring + (stage % kStages) * 128, frag + static_cast<size_t>(next) * 128);\n"
MMAS = ("      Mma<T>::run(part, hi[e], bh[e] + lo_step, (s + e) % KC != 0);\n"
        "      Mma<T>::run(part, lo[e], bh[e], 1);\n"
        "      Mma<T>::run(part, hi[e], bh[e], 1);\n")
LX = "        const float l = P.x_out[gi];\n"
# name: ({constant: value}, [(text, replacement)]) rewritten in the copy
VARIANTS = {
    "as committed": ({}, []),
    "kStages 8": ({"kStages": 8}, []),
    "kGroup 1 (each k-step waited for)": ({"kGroup": 1}, []),
    "KC 16": ({"KC": 16}, []),
    "1xTF32 products (hi_W hi_s only)": ({}, [(MMAS, MMAS.split("\n", 2)[2].replace(
        ", 1);", ", (s + e) % KC != 0);"))]),
    "l_x not kept (no x_out traffic)": ({}, [(LX, "        const float l = 0.0f;\n")]),
    "no fragment loads (the ring's stale contents)": ({}, [(LOAD, "    (void)stage;\n")]),
    "no products": ({}, [(MMAS, "")]),
}
FUNCTIONS = ("admm_box_launch", "admm_box_wide_launch", "admm_box_error_string")


def variant_source(values: dict, patches: list) -> str:
    """The wide kernel's source with each `constexpr int name = ...;` of
    values rewritten and each patch applied."""
    text = WIDE.read_text()
    for name, value in values.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                          text)
        if n != 1:
            raise SystemExit(f"{WIDE.name} has {n} definitions of {name}, not 1")
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"{WIDE.name} no longer has {old!r} once")
        text = text.replace(old, new)
    return text


def build(out_dir: Path) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (values, patches) in VARIANTS.items():
        tag = "".join(c if c.isalnum() else "_" for c in name)
        source = out_dir / f"{tag}.cu"
        source.write_text(variant_source(values, patches))
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
        libs[name] = (lib, out, out_dir / f"{tag}.so")
    return libs


def local_memory(so: Path) -> dict:
    """{build key: (LDL, STL)} instructions in each wide build's SASS."""
    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True).stdout
    out, key = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*admm_box_wide_kernelILi(\d+)ELb([01])E", line)
        if m:
            key = (int(m.group(1)), int(m.group(2)))
            out[key] = [0, 0]
        elif "Function :" in line:
            key = None
        elif key is not None:
            out[key][0] += " LDL" in line
            out[key][1] += " STL" in line
    return {k: tuple(v) for k, v in out.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    _, card = chip_smoke.phase_device()
    libs = build(ROOT / "build" / "admm_box_wide_variants")
    for name, (_, log, so) in libs.items():
        for key, line in sorted(chip_smoke.ptxas_builds(log, "admm_box_wide_kernel",
                                                         unit=1).items()):
            print(f"[box wide variant] {name}: ptxas {key}: {line}", flush=True)
        print(f"[box wide variant] {name}: (LDL, STL) in SASS {local_memory(so)}", flush=True)
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
                for name, (lib, _, _) in libs.items():
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
    exe = ROOT / "build" / "admm_box_wide_variants" / "wgmma_tf32_bench"
    subprocess.run([_build._nvcc(), *_build._ARCH, "-O3", "-o", str(exe),
                    str(ROOT / "tools" / "wgmma_tf32_bench.cu")], check=True)
    return subprocess.run([str(exe)]).returncode


if __name__ == "__main__":
    sys.exit(main())
