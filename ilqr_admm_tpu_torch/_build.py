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

The generated rollout steps (`ops/rollout_codegen.py`) build apart: each
step's C++ (its staged program too) and the template
`csrc/linesearch_rollout_generic.cuh` are
written into one `rollout.cu` under
`build/torch_kernels/rollout_<hash of template, step and flags>/` and
compiled there into `librollout.so` (`build_rollouts`, all at once),
which `load_rollout` loads. A build writes temporary files named by its
process and renames the finished library into place, so two processes
building the same step do not corrupt each other.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_SOURCES = ("admm_u_only.cu", "admm_u_only_wide.cu", "sls_admm.cu", "sls_admm_wide.cu",
            "admm_box.cu", "admm_box_wide.cu", "riccati_scan.cu", "linesearch_rollout.cu")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libilqr_admm_torch.so"
ROLLOUT_TEMPLATE = "linesearch_rollout_generic.cuh"
ROLLOUT_LIB = "librollout.so"

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


def _run_all(cmds, logs):
    """Start every command at once, each one's output into its log file,
    and wait for all: [(returncode, output, its seconds)]."""
    procs = []
    for cmd, log in zip(cmds, logs):
        with open(log, "w") as sink:
            procs.append((subprocess.Popen(cmd, stdout=sink, stderr=subprocess.STDOUT),
                          time.perf_counter()))
    seconds = {}
    while len(seconds) < len(procs):
        for i, (proc, start) in enumerate(procs):
            if i not in seconds and proc.poll() is not None:
                seconds[i] = time.perf_counter() - start
        time.sleep(0.05)
    results = []
    for i, log in enumerate(logs):
        results.append((procs[i][0].returncode, Path(log).read_text(), seconds[i]))
        Path(log).unlink(missing_ok=True)
    return results


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
    objs = [out_dir / f"{name}.{tag}.o" for name in _SOURCES]
    cmds = [[nvcc, *_FLAGS, "-c", str(_PKG / "csrc" / name), "-o", str(obj)]
            for name, obj in zip(_SOURCES, objs)]
    log, failed = [], []
    for cmd, (code, out, seconds) in zip(
            cmds, _run_all(cmds, [out_dir / f"{name}.{tag}.log" for name in _SOURCES])):
        log.append(f"$ {' '.join(cmd)}\n{out}[{seconds:.2f} s]\n")
        if code != 0:
            failed.append(code)
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


def rollout_dir(source: str) -> Path:
    """Directory of a generated step's library: a hash of the flags, the
    template and the step's source."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update((_PKG / "csrc" / ROLLOUT_TEMPLATE).read_bytes())
    h.update(source.encode())
    return _PKG.parent / "build" / "torch_kernels" / f"rollout_{h.hexdigest()[:16]}"


def build_rollouts(sources) -> list[Path]:
    """Compile the library of each generated step (`GeneratedStep.source`)
    unless it exists, one nvcc each, all started together; returns their
    paths. Each directory keeps `rollout.cu` and `nvcc.log`
    (`-Xptxas -v`, the compile's seconds). Raises with nvcc's output if a
    step does not compile."""
    dirs = [rollout_dir(s) for s in sources]
    todo = {d: s for d, s in zip(dirs, sources) if not (d / ROLLOUT_LIB).exists()}
    if todo:
        nvcc = _nvcc()
        tag = f"{os.getpid()}.{threading.get_ident()}.tmp"  # one build a thread
        template = (_PKG / "csrc" / ROLLOUT_TEMPLATE).read_text()
        cmds = []
        for d, source in todo.items():
            d.mkdir(parents=True, exist_ok=True)
            (d / f"rollout.{tag}.cu").write_text(source + "\n" + template)
            cmds.append([nvcc, *_FLAGS, "-shared", str(d / f"rollout.{tag}.cu"),
                         "-o", str(d / f"{ROLLOUT_LIB}.{tag}")])
        results = _run_all(cmds, [d / f"rollout.{tag}.log" for d in todo])
        failed = []
        for d, cmd, (code, out, seconds) in zip(todo, cmds, results):
            text = f"$ {' '.join(cmd)}\n{out}[{seconds:.2f} s]\n"
            (d / "nvcc.log").write_text(text)
            if code != 0:
                (d / f"{ROLLOUT_LIB}.{tag}").unlink(missing_ok=True)
                failed.append(text)
                continue
            os.replace(d / f"rollout.{tag}.cu", d / "rollout.cu")
            os.replace(d / f"{ROLLOUT_LIB}.{tag}", d / ROLLOUT_LIB)
        if failed:
            raise RuntimeError("nvcc failed for a generated rollout step:\n" + "\n".join(failed))
    return [d / ROLLOUT_LIB for d in dirs]


@functools.cache
def load_rollout(source: str) -> ctypes.CDLL:
    """A generated step's library, built if needed and loaded once per
    process."""
    lib = ctypes.CDLL(str(build_rollouts([source])[0]))
    lib.linesearch_rollout_generic_launch.argtypes = [
        _P, _P, _P,  # x0s, u_cands, xs
        _I, _I, _I,  # R (initial states), A (candidates each), N
        _P,  # stream
    ]
    lib.linesearch_rollout_generic_launch.restype = _I
    lib.linesearch_rollout_generic_launch_threads.argtypes = [
        _P, _P, _P, _I, _I, _I,
        _I,  # threads a block (0: the template's choice)
        _P,
    ]
    lib.linesearch_rollout_generic_launch_threads.restype = _I
    # (R, A, N, threads) -> (threads, chunk, shared memory bytes) into an int[3]
    lib.linesearch_rollout_generic_geometry.argtypes = [_I, _I, _I, _I, _P]
    lib.linesearch_rollout_generic_geometry.restype = None
    lib.linesearch_rollout_generic_error_string.argtypes = [_I]
    lib.linesearch_rollout_generic_error_string.restype = ctypes.c_char_p
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
