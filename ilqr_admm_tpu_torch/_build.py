"""Build and load the port's CUDA kernels.

The sources under `csrc/` have plain `extern "C"` entry points. At first
use each is compiled with `nvcc` for `sm_90a` into an object, all at
once in parallel, and the objects are linked into one shared library,
`build/torch_kernels/<hash of sources and flags>/libilqr_admm_torch.so`
under the repository root, which is loaded with `ctypes`. The hash
covers the flags and every file under `csrc/` (`*.cu` and the `*.cuh`
headers they include), so an edited header builds a new library. Nothing
is built or loaded when the package is imported. A failed build raises
with `nvcc`'s output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_SOURCES = ("admm_u_only.cu", "admm_u_only_wide.cu", "sls_admm.cu", "sls_admm_wide.cu",
            "admm_box.cu", "admm_box_wide.cu", "riccati_scan.cu", "linesearch_rollout.cu")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libilqr_admm_torch.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def build_dir() -> Path:
    """Directory of the library for the current sources, headers and flags."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    csrc = _PKG / "csrc"
    for path in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return _PKG.parent / "build" / "torch_kernels" / h.hexdigest()[:16]


def _nvcc() -> str:
    """nvcc from PATH, else from the CUDA toolkit `torch.utils.cpp_extension` finds."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is not on PATH and CUDA_HOME is unset")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> Path:
    """Compile the library unless it exists; returns its path.

    One nvcc per source, started together, then one link. Their output
    (with `-Xptxas -v`: registers, shared memory and spills of each
    kernel) and each compile's seconds are kept beside the library as
    `nvcc.log`.
    """
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for name in _SOURCES:
        obj = out_dir / f"{name}.{tag}.o"
        out = out_dir / f"{name}.{tag}.log"
        cmd = [nvcc, *_FLAGS, "-c", str(_PKG / "csrc" / name), "-o", str(obj)]
        objs.append(obj)
        with open(out, "w") as sink:
            procs.append((cmd, out, subprocess.Popen(cmd, stdout=sink,
                                                     stderr=subprocess.STDOUT)))
    # each compile's seconds, for the log: the build lasts as long as the slowest
    seconds, running = {}, {i for i in range(len(procs))}
    while running:
        for i in list(running):
            if procs[i][2].poll() is not None:
                seconds[i] = time.perf_counter() - t0
                running.discard(i)
        time.sleep(0.05)
    log, failed = [], []
    for i, (cmd, out, proc) in enumerate(procs):
        log.append(f"$ {' '.join(cmd)}\n{out.read_text()}[{seconds[i]:.2f} s]\n")
        out.unlink(missing_ok=True)
        if proc.returncode != 0:
            failed.append(proc.returncode)
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    if not failed:
        cmd = [nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append(proc.returncode)
    for obj in objs:
        obj.unlink(missing_ok=True)
    text = "\n".join(log)
    (out_dir / "nvcc.log").write_text(text + f"\n[{time.perf_counter() - t0:.2f} s]\n")
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {failed[0]}:\n{text}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every signature."""
    lib = ctypes.CDLL(str(build()))
    for launch in (lib.admm_u_only_launch, lib.admm_u_only_wide_launch):
        launch.argtypes = [
            _P, _P, _P, _P, _P, _P,  # u_base, x_base, ops_f, ops_i (packed W_u, W_x), lo, hi
            _P, _P, _P,  # x_out, u_out, zu_out
            _I, _I, _I, _I,  # batch, Nm, Nd, batch_tile
            _I, _I, _I, _I,  # chunk_len, n_chunks, n_tail, refresh_every
            _F, _F, _F,  # alpha, 1 - alpha, stop_tol
            _P,  # stream
        ]
        launch.restype = _I
    lib.admm_u_only_error_string.argtypes = [_I]
    lib.admm_u_only_error_string.restype = ctypes.c_char_p
    lib.sls_admm_launch.argtypes = [
        _P, _P,  # bounds, U_base
        _P, _I, _P,  # ops_f (W packed), its length, ops_i (its pair table)
        _P,  # U_out
        _I, _I, _I, _I,  # batch, Nm, batch_tile, p1
        _I, _I,  # chunk_len, n_chunks
        _F, _F, _F,  # alpha, 1 - alpha, stop_tol
        _I, _P, _I, _I, _I,  # z_update, coeffs (host f32), n_sets, q, n_cons_iters
        _I,  # k_split
        _P,  # stream
    ]
    lib.sls_admm_launch.restype = _I
    lib.sls_admm_wide_launch.argtypes = [
        _P, _P,  # bounds, U_base
        _P, _P,  # ops_f (W^T's A fragments), state (Z and L scratch)
        _P,  # U_out
        _I, _I, _I, _I, _I,  # batch, Nm, M tiles, k-steps, k-steps a chunk
        _I, _I,  # batch_tile, p1
        _I, _I,  # chunk_len, n_chunks
        _F, _F, _F,  # alpha, 1 - alpha, stop_tol
        _I, _P, _I, _I, _I,  # z_update, coeffs (host f32), n_sets, q, n_cons_iters
        _P,  # stream
    ]
    lib.sls_admm_wide_launch.restype = _I
    lib.sls_admm_error_string.argtypes = [_I]
    lib.sls_admm_error_string.restype = ctypes.c_char_p
    lib.admm_box_launch.argtypes = [
        _P, _P, _P,  # free, u_base, u0
        _P, _I, _P, _I,  # ops_f, its length, the warp schedule, its warps
        _P, _P,  # xb, ub
        _P, _P, _P, _P,  # x_out, u_out, zx_out, zu_out
        _I, _I, _I, _I, _I,  # batch, Nm, Nd, batch_tile, n_iters
        _I, _F, _F,  # has_u, alpha, 1 - alpha
        _P,  # stream
    ]
    lib.admm_box_launch.restype = _I
    lib.admm_box_wide_launch.argtypes = [
        _P, _P, _P,  # free, u_base, u0 (the layout's column order)
        _P, _P,  # ops_f, ops_i (A fragment streams; header, tiles, k-steps)
        _P, _P,  # xb, ub
        _P, _P, _P, _P,  # x_out, u_out, zx_out, zu_out
        _I, _I, _I,  # batch, nx, nu
        _I, _I,  # tiles, k-steps
        _I, _I, _I, _F, _F,  # batch_tile, n_iters, has_u, alpha, 1 - alpha
        _P,  # stream
    ]
    lib.admm_box_wide_launch.restype = _I
    lib.admm_box_error_string.argtypes = [_I]
    lib.admm_box_error_string.restype = ctypes.c_char_p
    lib.riccati_scan_launch.argtypes = [
        _P, _P, _P, _P, _P,  # A, b, C, eta, J slabs
        _P, _P, _P, _P, _P,  # their local suffixes
        _I, _I, _I,  # L, nb, d
        _P,  # stream
    ]
    lib.riccati_scan_launch.restype = _I
    lib.riccati_join_launch.argtypes = [
        _P, _P, _P, _P, _P,  # the local suffix slabs (step 0: the block totals)
        _P, _P,  # eta_out (N, d), J_out (N, d, d)
        _I, _I, _I, _I, _I, _I,  # L, nb, N, d, steps a block, lanes a block
        _P,  # stream
    ]
    lib.riccati_join_launch.restype = _I
    lib.riccati_error_string.argtypes = [_I]
    lib.riccati_error_string.restype = ctypes.c_char_p
    lib.linesearch_rollout_car_front_wheel_launch.argtypes = [
        _P, _P, _P,  # x0s, u_cands, xs
        _I, _I, _I,  # R (initial states), A (candidates each), N
        _F, _F, _F,  # dt, dist, dist**2
        _P,  # stream
    ]
    lib.linesearch_rollout_car_front_wheel_launch.restype = _I
    lib.linesearch_rollout_error_string.argtypes = [_I]
    lib.linesearch_rollout_error_string.restype = ctypes.c_char_p
    return lib
