"""ctypes bindings of the native C++ runtime `native/kinematics.cpp`
(counterpart of `ilqr_admm_tpu/native.py`).

Host-side batched planar-chain kinematics, the counterpart of the
reference's Pinocchio dependency, and an independent C++ LQT Riccati
backward pass that tests use as a cross-language oracle. The library is
built with g++ at first use, into `build/native/` under the repository
root; importing this module builds and loads nothing. Inputs are numpy
arrays, sequences or tensors (moved to the host), taken as float64.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parents[1]
_SRC = _REPO / "native" / "kinematics.cpp"
_LIB = _REPO / "build" / "native" / "libilqr_native.so"

_lib: Optional[ctypes.CDLL] = None


def _build() -> Path:
    """Compile the library unless it is newer than its source; the build
    writes a temporary file and renames it, so a process never loads a
    half-written library."""
    if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
        _LIB.parent.mkdir(parents=True, exist_ok=True)
        tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                       check=True)
        os.replace(tmp, _LIB)
    return _LIB


def load() -> ctypes.CDLL:
    """Load the native library, building it if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        dp, i = ctypes.POINTER(ctypes.c_double), ctypes.c_int
        for name, args in (("planar_fk", [dp, i, dp, dp]),
                           ("planar_fk_batch", [dp, i, dp, i, dp]),
                           ("planar_jacobian", [dp, i, dp, dp]),
                           ("planar_jacobian_batch", [dp, i, dp, i, dp]),
                           ("lqt_backward_ref", [dp] * 5 + [i] * 3 + [dp, dp])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, None
        _lib = lib
    return _lib


def _f64(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype=np.float64)


def _cptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _chain(lengths, qs):
    lengths, qs = _f64(lengths), _f64(qs)
    if lengths.ndim != 1 or qs.ndim not in (1, 2) or qs.shape[-1] != lengths.shape[0]:
        raise ValueError(f"lengths (n,) and angles (n,) or (batch, n) expected, got "
                         f"{lengths.shape} and {qs.shape}")
    return lengths, qs


def planar_fk(lengths, qs) -> np.ndarray:
    """FK for (n,) or (batch, n) joint angles -> (3,) or (batch, 3)."""
    lib = load()
    lengths, qs = _chain(lengths, qs)
    n = lengths.shape[0]
    if qs.ndim == 1:
        out = np.empty(3)
        lib.planar_fk(_cptr(lengths), n, _cptr(qs), _cptr(out))
        return out
    out = np.empty((qs.shape[0], 3))
    lib.planar_fk_batch(_cptr(lengths), n, _cptr(qs), qs.shape[0], _cptr(out))
    return out


def planar_jacobian(lengths, qs) -> np.ndarray:
    """Jacobian for (n,) or (batch, n) angles -> (3, n) or (batch, 3, n)."""
    lib = load()
    lengths, qs = _chain(lengths, qs)
    n = lengths.shape[0]
    if qs.ndim == 1:
        out = np.empty((3, n))
        lib.planar_jacobian(_cptr(lengths), n, _cptr(qs), _cptr(out))
        return out
    out = np.empty((qs.shape[0], 3, n))
    lib.planar_jacobian_batch(_cptr(lengths), n, _cptr(qs), qs.shape[0], _cptr(out))
    return out


def lqt_backward_ref(A, B, Q, xd, R):
    """Independent C++ LQT Riccati backward pass. A (N, d, d), B (N, d, m),
    Q (N, d, d), xd (N, d), R (N, m, m). Returns (K (N, m, d), k (N, m))."""
    lib = load()
    A, B, Q, xd, R = (_f64(t) for t in (A, B, Q, xd, R))
    N, d, m = A.shape[0], A.shape[-1], B.shape[-1]
    want = {"A": (N, d, d), "B": (N, d, m), "Q": (N, d, d), "xd": (N, d), "R": (N, m, m)}
    for name, t in zip(want, (A, B, Q, xd, R)):
        if t.shape != want[name]:
            raise ValueError(f"{name} has shape {t.shape}, expected {want[name]}")
    K = np.empty((N, m, d))
    k = np.empty((N, m))
    lib.lqt_backward_ref(_cptr(A), _cptr(B), _cptr(Q), _cptr(xd), _cptr(R), N, d, m, _cptr(K),
                         _cptr(k))
    return K, k
