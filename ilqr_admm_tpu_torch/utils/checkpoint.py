"""Solver-state checkpoint and resume (counterpart of
`ilqr_admm_tpu/utils/checkpoint.py`).

Persists any tree of tensors (nominal trajectories, ADMM duals and
slacks, penalties, gains: dicts, lists, tuples and NamedTuples) as a
flat NumPy `.npz` archive, one entry `leaf_i` a leaf, and restores it
onto the template's devices and dtypes. Leaves are numbered in the JAX
package's order (dict keys sorted), so the archive is the one its
`.npz` format writes and reads.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _leaves(tree: Any) -> list:
    """The leaves of a tree of dicts (sorted keys), lists and tuples."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _rebuild(template: Any, leaves) -> Any:
    """template's tree with its leaves taken in order from the iterator."""
    if isinstance(template, dict):
        out = {key: _rebuild(template[key], leaves) for key in sorted(template)}
        return {key: out[key] for key in template}
    if isinstance(template, (list, tuple)):
        items = [_rebuild(item, leaves) for item in template]
        if isinstance(template, list):
            return items
        return type(template)(*items) if hasattr(template, "_fields") else tuple(items)
    return next(leaves)


def save_state(path: str, state: Any) -> str:
    """Persist a tree of tensors (or arrays). Returns the path written."""
    out = _npz(path)
    np.savez(out, **{
        f"leaf_{i}": (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
                      else np.asarray(leaf))
        for i, leaf in enumerate(_leaves(state))
    })
    return out


def restore_state(path: str, template: Any) -> Any:
    """Restore a tree saved by `save_state`.

    `template` gives the tree's structure, and each tensor leaf's device
    and dtype: a restored leaf lands where the template's leaf lives.
    """
    leaves = _leaves(template)
    with np.load(_npz(path)) as data:
        if len(data.files) != len(leaves):
            raise ValueError(
                f"checkpoint holds {len(data.files)} leaves, the template {len(leaves)}")
        restored = []
        for i, leaf in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            if isinstance(leaf, torch.Tensor):
                restored.append(torch.tensor(arr, dtype=leaf.dtype, device=leaf.device))
            else:
                restored.append(torch.as_tensor(arr))
    return _rebuild(template, iter(restored))
