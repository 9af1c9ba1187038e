"""The Riccati recursion with its horizon sharded over a mesh axis
(counterpart of `ilqr_admm_tpu/parallel/time_sharded.py`).

The horizon N is split into P contiguous chunks of L = N / P stages, one
a rank of a ('time',) mesh axis. Each rank builds the conditional value
function elements of its chunk (`ops/parallel_riccati.py`), runs a local
inclusive suffix scan over them, and ONE all_gather exchanges the P
chunk totals (each O(d^2)). Rank i then composes the exclusive suffix of
the later chunks, S_i = total_{i+1} o ... o total_{P-1}, and joins it
with its local suffixes: the two-level blocked scan with the block level
mapped onto the ranks.

Gain extraction at stage t needs the value function of stage t + 1. At a
chunk's last stage that is the first joined element of the next chunk,
total_{i+1} o S_{i+1} = S_i, which rank i already holds: no second
exchange. The gains are gathered once at the end, so every rank returns
the whole (N, ...) result, as the JAX call returns the global array.
Every rank of the axis makes the same call with the same global
arguments; the per-stage prelude and the gains are computed on the
rank's own chunk only.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ilqr_admm_tpu_torch.ops.parallel_riccati import (
    _combine,
    _identity_elems,
    gains_from_scanned,
    ilqr_value_elements,
    value_elements,
)
from ilqr_admm_tpu_torch.ops.riccati import DPGains
from ilqr_admm_tpu_torch.ops.scan import associative_scan
from ilqr_admm_tpu_torch.parallel.collectives import all_gather, gather_packed
from ilqr_admm_tpu_torch.parallel.mesh import axis_group
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


def _check_divisible(N: int, P: int):
    if N % P != 0:
        raise ValueError(f"horizon {N} must be divisible by mesh axis size {P}")


def _local_suffix_scan(combine, identity, chunk, group, index: int, P: int):
    """(the rank's chunk of the global inclusive suffix scan, S_index).

    chunk: tuple of (L, ...) tensors, the rank's elements. One all_gather
    of the chunk totals; S_index is the identity on the last rank.
    """
    scanned = associative_scan(lambda a, b: combine(b, a), chunk, reverse=True)
    total = torch.cat([x[:1].reshape(-1) for x in scanned])
    totals = all_gather(total, group)  # (P,) flat chunk totals, in rank order

    def unpack(flat):  # -> tuple of (1, ...) elements
        out, offset = [], 0
        for x in scanned:
            n = x[:1].numel()
            out.append(flat[offset:offset + n].view((1,) + tuple(x.shape[1:])))
            offset += n
        return tuple(out)

    S = identity((1,))
    for j in reversed(range(index + 1, P)):
        S = combine(unpack(totals[j]), S)  # chunk j is earlier than the chunks after it
    return combine(scanned, S), S


def time_sharded_suffix_scan(combine, identity, elems, mesh, axis: str):
    """Inclusive suffix scan of `elems` (a tuple of (N, ...) tensors) with
    the time axis sharded over mesh axis `axis`.

    combine(earlier, later) broadcasts over a leading batch axis;
    identity(prefix) builds identity elements of leading shape prefix.
    N must be divisible by the axis size. Every rank passes the whole
    elems and takes its chunk; returns the whole scan on every rank.
    """
    group, P, index = axis_group(mesh, axis)
    N = elems[0].shape[0]
    _check_divisible(N, P)
    L = N // P
    chunk = tuple(x[index * L:(index + 1) * L] for x in elems)
    scanned, _ = _local_suffix_scan(combine, identity, chunk, group, index, P)
    return tuple(gather_packed(list(scanned), group))


def _chunk_rows(N: int, P: int, index: int):
    """(first row, rows of the chunk, end of the rows its prelude takes):
    one stage past the chunk where there is one, so that the prelude's
    terminal-stage rule (`value_elements_general` zeroes the last row's
    A, b and C) falls on a row the rank drops, or on the true terminal."""
    L = N // P
    a = index * L
    return a, L, min(a + L + 1, N)


def _scan_and_gains(elems, A_t, B, U, s, drift, L, d, fast_inverse, group, index, P):
    """The rank's scanned chunk and its gains. elems, A_t, B, U, s and
    drift hold the chunk's rows and, except on the last rank, one more."""
    comb = functools.partial(_combine, fast_inverse=fast_inverse)
    identity = functools.partial(_identity_elems, d=d, dtype=A_t.dtype, device=A_t.device)
    chunk = tuple(x[:L] for x in elems)
    scanned, S = _local_suffix_scan(comb, identity, chunk, group, index, P)
    # the value function at the stage after the chunk is S (see the module docstring)
    ext = scanned if A_t.shape[0] == L else tuple(torch.cat([x, y]) for x, y in zip(scanned, S))
    gains = gains_from_scanned(A_t, B, U, s, ext, fast_inverse=fast_inverse, drift=drift)
    return scanned, DPGains(*(g[:L] for g in gains))


def _check_fast_inverse(d: int, fast_inverse: bool):
    if fast_inverse and d > 4:
        raise ValueError(
            f"fast_inverse=True uses the closed-form adjugate inverse, which supports state "
            f"dim <= 4 (got d={d}); use the default LU combine for larger states")


@full_f32_matmul()
def lqt_backward_time_sharded(A: torch.Tensor, B: torch.Tensor, Q: torch.Tensor,
                              xd: torch.Tensor, R: torch.Tensor, Qr: Optional[torch.Tensor] = None,
                              xr: Optional[torch.Tensor] = None, Rr: Optional[torch.Tensor] = None,
                              ur: Optional[torch.Tensor] = None, *, mesh, axis: str = "time",
                              fast_inverse: bool = False) -> DPGains:
    """LQT Riccati with the horizon sharded over `mesh[axis]`.

    Same contract as `ops.riccati.lqt_backward` and
    `ops.parallel_riccati.lqt_backward_parallel`: each rank scans its
    chunk and one all_gather of O(P d^2) joins the chunks, whatever N.
    Every rank returns the whole DPGains.
    """
    _check_fast_inverse(A.shape[-1], fast_inverse)
    group, P, index = axis_group(mesh, axis)
    N, d = A.shape[0], A.shape[-1]
    _check_divisible(N, P)
    a, L, end = _chunk_rows(N, P, index)
    rows = lambda t: None if t is None else t[a:end]  # noqa: E731
    elems, U, s = value_elements(*(rows(t) for t in (A, B, Q, xd, R, Qr, xr, Rr, ur)),
                                 fast_inverse=fast_inverse)
    _, gains = _scan_and_gains(elems, A[a:end], B[a:end], U, s, None, L, d, fast_inverse,
                               group, index, P)
    return DPGains(*gather_packed(list(gains), group))


@full_f32_matmul()
def ilqr_backward_time_sharded(A: torch.Tensor, B: torch.Tensor, Cts: torch.Tensor,
                               cts: torch.Tensor, drift: Optional[torch.Tensor] = None, *, mesh,
                               axis: str = "time", fast_inverse: bool = False,
                               return_value: bool = False):
    """General iLQR Riccati (Cux cross terms, optional affine drift) with
    the horizon sharded over `mesh[axis]`.

    Same (K, k) contract as `ops.parallel_riccati.ilqr_backward_parallel`:
    the completion-of-squares prelude is per stage (each rank does its
    chunk's), each rank scans its chunk, ONE all_gather of O(P d^2) chunk
    totals joins them, and the gains are extracted locally. With `drift`
    it is the backward of the box-constrained active-set iteration
    (`ops/constrained_riccati.py::ilqr_backward_box_parallel(mesh=...)`);
    return_value=True adds the per-stage cost-to-go (J (N, d, d), eta (N,
    d)) its exchange test needs. Every rank returns the whole result.
    """
    _check_fast_inverse(A.shape[-1], fast_inverse)
    group, P, index = axis_group(mesh, axis)
    N, d = A.shape[0], A.shape[-1]
    _check_divisible(N, P)
    a, L, end = _chunk_rows(N, P, index)
    drift_r = None if drift is None else drift[a:end]
    elems, U, s, A_t, Kc = ilqr_value_elements(A[a:end], B[a:end], Cts[a:end], cts[a:end],
                                               fast_inverse=fast_inverse, drift=drift_r)
    scanned, gains = _scan_and_gains(elems, A_t, B[a:end], U, s, drift_r, L, d, fast_inverse,
                                     group, index, P)
    out = [gains.K - Kc[:L], gains.k]
    if return_value:
        out += [scanned[4], scanned[3]]
    return tuple(gather_packed(out, group))
