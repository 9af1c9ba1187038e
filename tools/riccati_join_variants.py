#!/usr/bin/env python3
"""The joined level-2 + join kernel against the designs around it, on one
CUDA card.

Builds versions of the Riccati pass's second half and times them in one
process, on the same local-suffix slabs (chip_smoke's `riccati_slabs`,
scanned by the committed `riccati_scan`), at N = 10,000 with nb = 128
and 1,024:

- "two launches": tools/riccati_level2_join_two_launch.cu, the level-2
  kernel (one block of 128 threads) and the slab join (one thread an
  element), then the two copies that unpack the slabs to the time-major
  rows the gains read;
- "one kernel, one thread a combine": csrc/riccati_scan.cu built with
  -DRICCATI_JOIN_ONE_THREAD (lever 1 alone: level 2 as the join's
  prologue, one launch);
- "one kernel, group combine": csrc/riccati_scan.cu as committed (levers 1
  and 2: each combine spread over a group of 16 threads), and built with
  8 and 32 lanes a block (-DRICCATI_JOIN_GROUP);
- copies of the committed source with parts taken out, to time the
  rest: without the level-2 rounds (the tree and the group's suffix),
  without the joins, and without the fold, the rounds and the joins
  (what is left: the launch, the staging, S_b and the stores).

Each one's device time comes from a CUDA graph of 10 calls (chip_smoke's
`_graph_ms`, median and IQR of 7 windows), in turns, forwards and then
backwards; each one's output is held against the plain version
(`riccati_join_reference`) in the JAX package's level-2 order and in its
own (`order=` its lanes a block). Prints the `ptxas` registers and
spills of the d = 4 kernels of every build. The builds go to
build/riccati_join_variants/ under the repository root.

Run from the repository root on a machine with a card and nvcc:
    python3 tools/riccati_join_variants.py
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
from ilqr_admm_tpu_torch.ops import fused_riccati  # noqa: E402

CSRC = ROOT / "ilqr_admm_tpu_torch" / "csrc"
N = 10_000
NBS = (128, 1024)
TWO, ONE_THREAD, GROUP = ("two launches", "one kernel, one thread a combine",
                          "one kernel, group combine")
ROUNDS = "for (int o = 1; o < G; o <<= 1) {"
JOINS = "for (int k = 0; k < nj; ++k)\n    cb.put_out("
FOLD = "for (int k = chunk - 2; k >= 0; --k)"
# name -> (source, nvcc flags, (old, new) patches, lanes a block); the
# patched copies compute something else on purpose: they time a part
VARIANTS = {
    TWO: (ROOT / "tools" / "riccati_level2_join_two_launch.cu", ["-I", str(CSRC)], [], None),
    ONE_THREAD: (CSRC / "riccati_scan.cu", ["-DRICCATI_JOIN_ONE_THREAD"], [], 16),
    GROUP: (None, [], [], 16),
    "group combine, 8 lanes a block": (CSRC / "riccati_scan.cu", ["-DRICCATI_JOIN_GROUP=8"],
                                       [], 8),
    "group combine, 32 lanes a block": (CSRC / "riccati_scan.cu", ["-DRICCATI_JOIN_GROUP=32"],
                                        [], 32),
    "group combine, no level-2 rounds": (CSRC / "riccati_scan.cu", [],
                                         [(ROUNDS, ROUNDS.replace("o = 1;", "o = G;"))], 16),
    "group combine, no joins": (CSRC / "riccati_scan.cu", [],
                                [(JOINS, JOINS.replace("k < nj", "k < 0"))], 16),
    "group combine, staging, S and stores only": (
        CSRC / "riccati_scan.cu", [],
        [(ROUNDS, ROUNDS.replace("o = 1;", "o = G;")), (JOINS, JOINS.replace("k < nj", "k < 0")),
         (FOLD, FOLD.replace("k = chunk - 2;", "k = -1;"))], 16),
}
_P, _I = ctypes.c_void_p, ctypes.c_int


def print_ptxas(name, log):
    """ptxas's lines (registers, spills) for the joined kernel (or the
    two-launch pair) in log, d = 4 .. 1."""
    ours = False
    for line in log.splitlines():
        if "entry function" in line:
            ours = "join" in line or "level2" in line
        if ours and any(w in line for w in ("registers", "spill")):
            print(f"[riccati variant build] {name}: {line.strip()}")


def build(out_dir: Path) -> dict:
    """name -> loaded library of every variant, the committed one included."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, (src, flags, patches, _) in VARIANTS.items():
        if src is None:
            continue
        text = src.read_text()
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"variant {name!r}: the source no longer has {old!r}")
            text = text.replace(old, new)
        tag = "".join(c if c.isalnum() else "_" for c in name)
        (out_dir / f"{tag}.cu").write_text(text)
        cmd = [nvcc, *_build._FLAGS, "-I", str(CSRC), *flags, "-shared",
               "-o", str(out_dir / f"{tag}.so"), str(out_dir / f"{tag}.cu")]
        procs[name] = (tag, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    ours = _build.load_library()
    print_ptxas(GROUP, (_build.build_dir() / "nvcc.log").read_text())
    libs = {GROUP: ours}
    for name, (tag, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name!r} failed to build:\n{out}")
        print_ptxas(name, out)
        lib = ctypes.CDLL(str(out_dir / f"{tag}.so"))
        lib.riccati_error_string.argtypes = [_I]
        lib.riccati_error_string.restype = ctypes.c_char_p
        if name == TWO:
            lib.riccati_level2_launch.argtypes = [_P] * 7 + [_I, _I, _P]
            lib.riccati_level2_launch.restype = _I
            lib.riccati_join_slabs_launch.argtypes = [_P] * 9 + [_I, _I, _I, _P]
            lib.riccati_join_slabs_launch.restype = _I
        else:
            for fn in ("riccati_scan_launch", "riccati_join_launch"):
                getattr(lib, fn).argtypes = getattr(ours, fn).argtypes
                getattr(lib, fn).restype = getattr(ours, fn).restype
        libs[name] = lib
    return libs


def two_launch_call(lib, r, horizon):
    """The two-launch pair on r, unpacked to (N, d) and (N, d, d)."""
    L, d, nb = r[0].shape[0], r[1].shape[1], r[0].shape[2]
    dev = r[0].device
    S_eta = torch.empty((d, nb), device=dev)
    S_J = torch.empty((d * d, nb), device=dev)
    eta_s = torch.empty((L, d, nb), device=dev)
    J_s = torch.empty((L, d * d, nb), device=dev)
    ptrs = [x.data_ptr() for x in r]

    def check(err, fn):
        if err != 0:
            raise RuntimeError(f"{fn} failed: {lib.riccati_error_string(err).decode()}")

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        check(lib.riccati_level2_launch(*ptrs, S_eta.data_ptr(), S_J.data_ptr(), nb, d, stream),
              "riccati_level2_launch")
        check(lib.riccati_join_slabs_launch(*ptrs, S_eta.data_ptr(), S_J.data_ptr(),
                                            eta_s.data_ptr(), J_s.data_ptr(), L, nb, d, stream),
              "riccati_join_slabs_launch")
        return (fused_riccati._unpack(eta_s, horizon, d),
                fused_riccati._unpack(J_s, horizon, d * d).reshape(horizon, d, d))

    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    _, card = chip_smoke.phase_device()
    libs = build(ROOT / "build" / "riccati_join_variants")
    saved = _build.load_library, fused_riccati.JOIN_GROUP
    try:
        for nb in NBS:
            r = fused_riccati.riccati_scan(*chip_smoke.riccati_slabs("cuda", N, nb))
            torch.cuda.synchronize()
            jax_order = fused_riccati.riccati_join_reference(*r, N)
            calls = {TWO: two_launch_call(libs[TWO], r, N)}
            for name, (_, _, patches, group) in VARIANTS.items():
                if name == TWO:
                    continue

                def call(lib=libs[name], group=group):
                    _build.load_library = lambda: lib
                    fused_riccati.JOIN_GROUP = group
                    return fused_riccati.riccati_join(*r, N)

                calls[name] = call
                got = call()
                torch.cuda.synchronize()
                own = fused_riccati.riccati_join_reference(*r, N, order=group)
                print(f"[riccati variant] N={N}, nb={nb}, {name}: scaled max diff "
                      f"{chip_smoke._max_errs(got, jax_order)[1]:.3e} to the JAX-order plain "
                      f"version, {chip_smoke._max_errs(got, own)[1]:.3e} to the plain version in "
                      f"its order" + (" (a part on purpose)" if patches else ""), flush=True)
            got = calls[TWO]()
            torch.cuda.synchronize()
            print(f"[riccati variant] N={N}, nb={nb}, {TWO}: scaled max diff "
                  f"{chip_smoke._max_errs(got, jax_order)[1]:.3e} to the JAX-order plain version",
                  flush=True)
            names = list(calls)
            for name in names + names[::-1]:
                med, q1, q3 = chip_smoke._graph_ms(calls[name])
                print(f"[riccati variant] N={N}, nb={nb} (L={-(-N // nb)}), {name}: device "
                      f"{med:.4f} ms (IQR {q1:.4f}-{q3:.4f}, CUDA graph of 10 calls); card: {card}",
                      flush=True)
    finally:
        _build.load_library, fused_riccati.JOIN_GROUP = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
