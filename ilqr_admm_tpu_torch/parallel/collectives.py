"""The collectives of the scale-out layer, on `torch.distributed`.

The JAX package's `psum`, `pmax` and `all_gather` over a mesh axis
become `all_reduce(SUM)`, `all_reduce(MAX)` and `all_gather` over the
process group of that axis (`mesh.get_group(axis)`). Every rank calls
each function with tensors of the same shape, in the same order.

Gloo, the backend of CPU worlds and of several ranks sharing one card,
takes CUDA tensors in `all_reduce` and `all_gather` as NCCL does
(checked on an H100 with torch 2.11), so no collective is staged through
host memory here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """The reduction of t over the group's ranks (a new tensor; t is kept).
    op: `dist.ReduceOp.SUM` or `MAX`."""
    out = t.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's t, in rank order; each rank's t has the same shape.
    A bool tensor travels as uint8."""
    src = t.contiguous()
    src = src.view(torch.uint8) if t.dtype == torch.bool else src
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.view(torch.bool) for p in parts] if t.dtype == torch.bool else parts


def all_gather_uneven(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' t concatenated along the leading axis, in rank order,
    where the leading sizes may differ between ranks (the other axes may
    not): the sizes are gathered first, then every piece padded to the
    largest and gathered."""
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    sizes = [int(s) for s in all_gather(n, group)]
    pad = max(sizes) - t.shape[0]
    if pad:
        t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))], dim=0)
    return torch.cat([p[:s] for p, s in zip(all_gather(t, group), sizes)], dim=0)


def gather_packed(tensors, group) -> list[torch.Tensor]:
    """The ranks' tensors, each concatenated along its leading axis in rank
    order, in one all_gather a dtype: each rank's tensors of a dtype are
    flattened into one buffer, gathered, and cut back into (ranks * rows,
    ...) tensors. Every rank passes tensors of the same shapes."""
    out = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        parts = all_gather(torch.cat([tensors[i].reshape(-1) for i in idx]), group)
        offset = 0
        for i in idx:
            t = tensors[i]
            out[i] = torch.cat([p[offset:offset + t.numel()].view(t.shape) for p in parts])
            offset += t.numel()
    return out
