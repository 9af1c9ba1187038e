"""Build and load the port's CUDA kernels.

The sources under `csrc/` have plain `extern "C"` entry points. At first
use they are compiled with `nvcc` for `sm_90a` into one shared library,
`build/torch_kernels/<hash of sources and flags>/libilqr_admm_torch.so`
under the repository root, and loaded with `ctypes`. Nothing is built
or loaded when the package is imported. A failed build raises with
`nvcc`'s output; there is no fallback.
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
_SOURCES = ("admm_u_only.cu",)
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libilqr_admm_torch.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def build_dir() -> Path:
    """Directory of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_PKG / "csrc" / name).read_bytes())
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

    nvcc's output (with `-Xptxas -v`: registers, shared memory and spills
    of each kernel) is kept beside the library as `nvcc.log`.
    """
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), *(str(_PKG / "csrc" / s) for s in _SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    (out_dir / "nvcc.log").write_text(log + f"\n[{time.perf_counter() - t0:.2f} s]\n")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n{log}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every signature."""
    lib = ctypes.CDLL(str(build()))
    lib.admm_u_only_launch.argtypes = [
        _P, _P, _P, _P, _P, _P,  # u_base, x_base, W_u, W_x, lo, hi
        _P, _P, _P,  # x_out, u_out, zu_out
        _I, _I, _I, _I,  # batch, Nm, Nd, batch_tile
        _I, _I, _I,  # chunk_len, n_chunks, n_tail
        _F, _F, _F,  # alpha, 1 - alpha, stop_tol
        _P,  # stream
    ]
    lib.admm_u_only_launch.restype = _I
    lib.admm_u_only_error_string.argtypes = [_I]
    lib.admm_u_only_error_string.restype = ctypes.c_char_p
    return lib
