"""NaN and inf guards (counterpart of `ilqr_admm_tpu/utils/debug.py`).

The line-search NaN guard is built into the solvers; this module adds
opt-in detection:

- `checked(fn)`: raise FloatingPointError when fn returns a non-finite
  value, instead of letting it propagate;
- `assert_finite(tree, name)`: host-side finiteness check over a tree
  of tensors, naming the offending leaf;
- `debug_nan_hook()`: a scope with autograd anomaly detection on (a
  backward pass that produces NaN raises with the forward op's trace)
  and a finite check of whatever the scope hands to its `check`.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager
from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree


def assert_finite(tree, name: str = "value"):
    """Raise FloatingPointError naming the first leaf of `tree` (tensors or
    arrays) with a NaN or inf entry. Reads each leaf on the host."""
    for path, leaf in pytree.tree_flatten_with_path(tree)[0]:
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        finite = np.isfinite(arr)
        if not np.all(finite):
            raise FloatingPointError(
                f"{name}{pytree.keystr(path)} contains {np.size(arr) - finite.sum()} "
                "non-finite entries"
            )


def checked(fn: Callable) -> Callable:
    """Wrap fn so that a non-finite entry in its output raises
    FloatingPointError. The check reads the output on the host once a
    call."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_finite(out, getattr(fn, "__name__", "output"))
        return out

    return wrapper


@contextmanager
def debug_nan_hook():
    """Scope with `torch.autograd.set_detect_anomaly(True)`; yields a
    `check(tree, name)` function (`assert_finite`) for forward values.
    Anomaly detection slows every backward pass; use it to debug."""
    with torch.autograd.set_detect_anomaly(True):
        yield assert_finite
