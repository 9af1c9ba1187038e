"""An associative scan over the leading axis (torch has none).

The same recursive odd/even tree as `jax.lax.associative_scan`: combine
adjacent pairs, scan the half-length sequence recursively, then fill in
the even positions. So it applies `fn` to the same operands in the same
order as JAX does, and a flat scan matches JAX's to rounding. O(log n)
depth, O(n) applications of `fn`, each batched over about half the
sequence.
"""

from __future__ import annotations

from typing import Callable

import torch


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[0::2] = a, out[1::2] = b along the leading axis (len(a) - len(b) in {0, 1})."""
    out = a.new_empty((a.shape[0] + b.shape[0],) + tuple(a.shape[1:]))
    out[0::2] = a
    out[1::2] = b
    return out


def associative_scan(fn: Callable, elems, reverse: bool = False):
    """Inclusive scan of `elems` along axis 0 with the associative `fn`.

    elems: a tensor or a tuple of tensors with the same leading length n.
    fn(a, b) takes two values of that structure, batched over a leading
    axis, and returns one (a covers the earlier positions). Returns the
    same structure: out[t] = e_0 o e_1 o ... o e_t. With reverse=True
    the sequence is scanned from its end, as in JAX, so `fn`'s first
    operand covers the LATER positions: out[t] folds e_{n-1}, ..., e_t,
    and a suffix scan of the LQT value elements, whose combine takes
    (earlier, later), passes `lambda a, b: combine(b, a)`.
    """
    single = isinstance(elems, torch.Tensor)
    flat = [elems] if single else list(elems)
    n = flat[0].shape[0]
    if any(e.shape[0] != n for e in flat):
        raise ValueError(
            "associative_scan inputs must share their leading length, got "
            f"{[tuple(e.shape) for e in flat]}"
        )
    if reverse:
        flat = [torch.flip(e, (0,)) for e in flat]

    def combine(a, b):
        if single:
            return [fn(a[0], b[0])]
        return list(fn(tuple(a), tuple(b)))

    def scan(es):
        n = es[0].shape[0]
        if n < 2:
            return es
        reduced = combine([e[0:-1:2] for e in es], [e[1::2] for e in es])
        odd = scan(reduced)
        if n % 2 == 0:
            even = combine([e[:-1] for e in odd], [e[2::2] for e in es])
        else:
            even = combine(odd, [e[2::2] for e in es])
        even = [torch.cat([e[:1], r], dim=0) for e, r in zip(es, even)]
        return [_interleave(a, b) for a, b in zip(even, odd)]

    out = scan(flat)
    if reverse:
        out = [torch.flip(e, (0,)) for e in out]
    return out[0] if single else tuple(out)
