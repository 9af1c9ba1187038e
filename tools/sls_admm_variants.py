#!/usr/bin/env python3
"""Where the time of `csrc/sls_admm.cu` goes, on one CUDA card.

Builds the kernel as committed and copies of its source with one part
taken out (the loop's products; the z-update's projection), and
tools/sls_admm_cuda_cores.cu, the design before the tensor cores (a 2 x 4
register tile a thread, W dense). Times each, in turns over two rounds,
on the SLS main path's solve (1,024 sorted instances, diamond_ee), on the
diamond and consensus modes at 1,024 and on diamond at 16,384 (CUDA
events, median of 3 windows of 5 calls); the kernel as committed also
with its k split (`fused_sls.k_split`) forced off and on. Prints each
one's largest difference to the plain version: the tensor-core builds'
to the one with their 3xTF32 products (the changed copies compute
something else on purpose), the CUDA-core design's to the f32 one. The
builds go to build/sls_admm_variants/ under the repository root.

Run from the repository root on a machine with a card and nvcc:
    python3 tools/sls_admm_variants.py
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
from ilqr_admm_tpu_torch.ops import fused_sls  # noqa: E402

CSRC = ROOT / "ilqr_admm_tpu_torch" / "csrc"
PRODUCT = "product<1, NB, 2, LDA>(acc, s_in + a_off, b, k0, k1, lane, g, t);"
VARIANTS = {
    "as committed": (CSRC / "sls_admm.cu", []),
    # no k-steps in the loop: the z-update, stores, barriers and exchange
    "no loop products": (CSRC / "sls_admm.cu", [(PRODUCT, PRODUCT.replace("k0, k1", "k0, k0"))]),
    # z = y: no projection
    "no z-update projection": (CSRC / "sls_admm.cu", [
        ("zu.template project<R>(y, bound, zn);",
         "for (int k = 0; k < R; ++k) zn[k][0] = y[k][0], zn[k][1] = y[k][1];")]),
    "CUDA cores (first design)": (ROOT / "tools" / "sls_admm_cuda_cores.cu", []),
}
CUDA_CORES = "CUDA cores (first design)"
# (label, build, forced k split or None for the wrapper's choice)
RUNS = [("as committed", "as committed", None),
        ("as committed, k split off", "as committed", 1),
        ("as committed, k split on", "as committed", 2),
        ("no loop products", "no loop products", None),
        ("no z-update projection", "no z-update projection", None),
        (CUDA_CORES, CUDA_CORES, None)]
CASES = (("diamond_ee", 1024), ("diamond", 1024), ("consensus", 1024), ("diamond", 16384))
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build(out_dir: Path) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, patches) in VARIANTS.items():
        text = src.read_text()
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
        for line in out.splitlines():
            if any(w in line for w in ("registers", "spill", "entry function")):
                print(f"[sls variant build] {name}: {line.strip()}")
        lib = ctypes.CDLL(str(out_dir / f"{tag}.so"))
        if name == CUDA_CORES:
            lib.sls_admm_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                                            _I, _P, _I, _I, _I, _P]
            lib.sls_admm_launch.restype = _I
        else:
            for fn in ("sls_admm_launch", "sls_admm_error_string"):
                getattr(lib, fn).argtypes = getattr(ours, fn).argtypes
                getattr(lib, fn).restype = getattr(ours, fn).restype
        libs[name] = lib
    return libs


def cuda_cores_call(lib, bounds, solver):
    """The CUDA-core kernel on the solver's dense W: a call returning U."""
    kw = solver.kernel_options
    chunk_len, n_chunks = fused_sls._schedule(kw["n_iters"], kw["stop_tol"], kw["check_every"])
    p1, Nm = solver.U_base.shape
    mode, coeffs, n_sets, q = fused_sls.kernel_z_update(
        p1, kw["z_update"], kw["diamond_w"], kw["soc_A"], kw["soc_b_fixed"], kw["soc_b_bound"],
        kw["l_inv_cons"], kw["cons_rho"])
    U = torch.empty((bounds.shape[0], Nm, p1), device=bounds.device)

    def call():
        err = lib.sls_admm_launch(
            bounds.data_ptr(), solver.U_base.data_ptr(), solver.W.data_ptr(), U.data_ptr(),
            bounds.shape[0], Nm, kw["batch_tile"], p1, chunk_len, n_chunks,
            float(kw["alpha"]), float(1.0 - kw["alpha"]), float(kw["stop_tol"]),
            mode, coeffs.ctypes.data, n_sets, q, int(kw["n_cons_iters"]),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the CUDA-core kernel failed to launch (cudaError {err})")
        return U

    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    _, card = chip_smoke.phase_device()
    libs = build(ROOT / "build" / "sls_admm_variants")
    saved = _build.load_library, fused_sls.k_split
    try:
        for mode, batch in CASES:
            _, solver = chip_smoke.sls_solver("cuda", mode)
            bounds = chip_smoke.sls_bounds("cuda", batch=batch, sort=mode == "diamond_ee")
            kw = solver.kernel_options
            ops = (bounds, solver.U_base, solver.W)
            want = {"tf32x3": fused_sls.sls_admm_reference(*ops, **kw, products="tf32x3"),
                    "f32": fused_sls.sls_admm_reference(*ops, **kw)}
            calls = {}
            for label, name, forced in RUNS:
                lib = libs[name]
                if name == CUDA_CORES:
                    calls[label] = cuda_cores_call(lib, bounds, solver)
                    continue

                def call(lib=lib, forced=forced):
                    _build.load_library = lambda: lib
                    fused_sls.k_split = saved[1] if forced is None else lambda *a: forced
                    return fused_sls.sls_admm(*ops, solver.packed, **kw)

                calls[label] = call
            chosen = saved[1](batch, kw["batch_tile"], solver.W.shape[0],
                              torch.cuda.get_device_properties(0).multi_processor_count)
            for rnd in range(2):
                for label, call in calls.items():
                    got = call()
                    torch.cuda.synchronize()
                    ref = "f32" if label == CUDA_CORES else "tf32x3"
                    err = float((got - want[ref]).abs().max())
                    ms = sorted(chip_smoke._event_ms(call, 5) for _ in range(3))
                    print(f"[sls_admm variant] round {rnd}, {mode} at {batch} (k split "
                          f"{chosen} as committed), {label}: {ms[1]:.4f} ms a solve (windows "
                          f"{', '.join(f'{m:.4f}' for m in ms)}); max diff to the {ref} plain "
                          f"version {err:.3e}; card: {card}", flush=True)
    finally:
        _build.load_library, fused_sls.k_split = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
