"""Blocked time-parallel LQT Riccati with the scan on the card.

Counterpart of `ilqr_admm_tpu/ops/pallas_riccati.py`
(`lqt_backward_parallel_pallas` and its kernels `_scan_kernel` and
`_join_kernel`). The elements and the gains are plain torch, as they are
XLA in the JAX package (`fast_inverse=True` throughout); the scan between
them is two hand-written CUDA kernels in `csrc/riccati_scan.cu`:

1. pack the elements (N, d, d) | (N, d), padded with identities to
   nb * L, into (L, rows, nb) slabs: element t = b * L + j sits in lane b
   at step j, so lanes are the fastest axis;
2. `riccati_scan`: the reverse suffix scan inside each of the nb blocks,
   r[j] = e_j o ... o e_{L-1} (replaces `_scan_kernel`), a chunked warp
   scan on the card (one warp a lane, `SCAN_CHUNKS` chunks of its steps);
3. `riccati_join`: the exclusive suffixes S_b of the nb block totals r[0]
   (replaces the XLA scan between the kernels) and (eta, J) of r[j] o S_b
   for every element (replaces `_join_kernel`), in one launch, written
   time-major as (N, d) and (N, d, d); then the gains.

On CPU tensors each wrapper runs its plain torch version
(`riccati_scan_reference`, `riccati_join_reference`) instead; on CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from ilqr_admm_tpu_torch.ops.parallel_riccati import (
    _combine,
    _identity_elems,
    gains_from_scanned,
    value_elements,
)
from ilqr_admm_tpu_torch.ops.riccati import DPGains
from ilqr_admm_tpu_torch.ops.scan import associative_scan
from ilqr_admm_tpu_torch.utils.device import resolve_device
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul

# Number of times each wrapper has launched its CUDA kernel in this process.
scan_launch_count = 0
join_launch_count = 0

_F32 = torch.float32

# Chunks of a lane's L steps in `riccati_scan_kernel`: one a thread of the
# lane's warp. `riccati_scan_reference(..., chunks=SCAN_CHUNKS)` replays
# the kernel's order of combines.
SCAN_CHUNKS = 32
# Lanes a block of `riccati_join_kernel` owns: its level-2 prologue folds
# and trees the later lanes' totals in this many chunks and scans its own
# lanes' totals. `riccati_join_reference(..., order=JOIN_GROUP)` replays it.
JOIN_GROUP = 16
# The most steps a join block takes (its shared memory grows with them)
JOIN_MAX_STEPS = 16


def comp_rows(d: int) -> tuple[int, ...]:
    """Rows of the five component slabs (A, b, C, eta, J)."""
    return (d * d, d, d * d, d, d * d)


def _pack(x, nb, L, rows):
    """(nb*L, rows) -> (L, rows, nb): element t = b*L + j in lane b at step j."""
    return x.reshape(nb, L, rows).permute(1, 2, 0).contiguous()


def _unpack(x, N, rows):
    """(L, rows, nb) -> (nb*L, rows)[:N]."""
    return x.permute(2, 0, 1).reshape(-1, rows)[:N]


def _lanes(slabs, d):
    """Slab step(s) (..., rows, nb) -> element tuple with lanes leading:
    (..., nb, d, d) / (..., nb, d)."""
    shapes = ((d, d), (d,), (d, d), (d,), (d, d))
    return tuple(
        x.transpose(-1, -2).reshape(x.shape[:-2] + (x.shape[-1],) + shp)
        for x, shp in zip(slabs, shapes)
    )


def _check_slabs(name, slabs):
    """(L, d, nb, device): checks five f32 contiguous component slabs."""
    if len(slabs) != 5 or not all(isinstance(t, torch.Tensor) for t in slabs):
        raise TypeError(f"{name} takes the five component slabs (A, b, C, eta, J) as tensors")
    A = slabs[0]
    if A.ndim != 3:
        raise ValueError(f"{name}: slabs must be (L, rows, nb), got A of shape {tuple(A.shape)}")
    L, nb = A.shape[0], A.shape[2]
    d = round(A.shape[1] ** 0.5)
    if d * d != A.shape[1] or not 1 <= d <= 4:
        raise ValueError(f"{name} supports d <= 4 (A slab rows d*d), got {A.shape[1]} rows")
    for comp, t, rows in zip("A b C eta J".split(), slabs, comp_rows(d)):
        if tuple(t.shape) != (L, rows, nb):
            raise ValueError(f"{name}: {comp} has shape {tuple(t.shape)}, expected {(L, rows, nb)}")
        if t.device != A.device:
            raise ValueError(f"{name}: {comp} is on {t.device} but A is on {A.device}")
        if t.dtype != _F32:
            raise TypeError(f"{name} takes float32, got {comp} as {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {comp} must be contiguous")
    return L, d, nb, A.device


def _check_device(name, device):
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {device}")


def _launch(fn_name, *args):
    from ilqr_admm_tpu_torch._build import load_library

    lib = load_library()
    err = getattr(lib, fn_name)(*args)
    if err != 0:
        msg = lib.riccati_error_string(err).decode()
        raise RuntimeError(f"{fn_name} failed: {msg} (cudaError {err})")


def _ptrs(tensors):
    return [t.data_ptr() for t in tensors]


# ---- level 1: csrc/riccati_scan.cu, riccati_scan_kernel ---------------------


def _where(mask, new, old):
    """Element tuples: new where mask (leading dims), else old."""
    return tuple(torch.where(mask.reshape(mask.shape + (1,) * (n.ndim - mask.ndim)), n, o)
                 for n, o in zip(new, old))


def riccati_scan_reference(A, b, C, eta, J, chunks=None):
    """Plain torch version of the level-1 scan. Returns the five
    local-suffix slabs r[j] = e_j o ... o e_{L-1}, shaped as the inputs.

    chunks=None: the reverse loop over the L steps, each one combine
    batched over the nb lanes. chunks=k: the kernel's order (k =
    `SCAN_CHUNKS` a warp): each lane's steps cut into k chunks of
    ceil(L / k), each chunk folded with its latest element innermost,
    an inclusive suffix over the k chunk totals in Hillis-Steele rounds
    (after the round with offset o, total c covers chunks c .. c + 2o -
    1), then each chunk walked backwards from the suffix of the later
    chunks; every step is batched over lanes and chunks.
    """
    slabs = (A, b, C, eta, J)
    L, d, nb = A.shape[0], b.shape[1], A.shape[2]
    out = [torch.empty_like(x) for x in slabs]

    def emit(j, x):
        for o, c in zip(out, x):
            o[j] = c.reshape(x[0].shape[0], -1).T

    with full_f32_matmul():
        if chunks is None:
            carry = _identity_elems((nb,), d, A.dtype, A.device)
            for j in range(L - 1, -1, -1):
                carry = _combine(_lanes(tuple(x[j] for x in slabs), d), carry,
                                 fast_inverse=True)
                emit(j, carry)
            return tuple(out)
        if isinstance(chunks, bool) or not isinstance(chunks, int) or chunks < 1:
            raise ValueError(f"chunks must be None or a positive int, got {chunks!r}")
        size = -(-L // chunks)
        ident = _identity_elems((chunks, nb), d, A.dtype, A.device)
        starts = torch.arange(chunks, device=A.device) * size
        # element k of every chunk, (chunks, nb, ...), and where it exists
        def step(k):
            j = torch.clamp(starts + k, max=L - 1)
            return _lanes(tuple(x[j] for x in slabs), d), starts + k < L

        total = ident
        for k in range(size - 1, -1, -1):
            e, valid = step(k)
            total = _where(valid, _combine(e, total, fast_inverse=True), total)
        o = 1
        while o < chunks:
            later = tuple(torch.cat([x[o:], ix[:o]]) for x, ix in zip(total, ident))
            comb = _combine(total, later, fast_inverse=True)
            total = _where(torch.arange(chunks, device=A.device) + o < chunks, comb, total)
            o *= 2
        x = tuple(torch.cat([t[1:], ix[:1]]) for t, ix in zip(total, ident))
        for k in range(size - 1, -1, -1):
            e, valid = step(k)
            x = _where(valid, _combine(e, x, fast_inverse=True), x)
            for c in range(chunks):
                j = c * size + k
                if j < L:
                    emit(j, tuple(v[c] for v in x))
    return tuple(out)


def riccati_scan(A, b, C, eta, J):
    """Level-1 reverse suffix scan within each lane of (L, rows, nb) f32
    slabs; returns the five local-suffix slabs.

    CUDA tensors go to the kernel in `csrc/riccati_scan.cu`, one warp a
    lane, held to `riccati_scan_reference(..., chunks=SCAN_CHUNKS)`; CPU
    tensors to `riccati_scan_reference` (the sequential loop).
    """
    global scan_launch_count
    slabs = (A, b, C, eta, J)
    L, d, nb, device = _check_slabs("riccati_scan", slabs)
    _check_device("riccati_scan", device)
    if device.type == "cpu":
        return riccati_scan_reference(*slabs)
    out = tuple(torch.empty_like(x) for x in slabs)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _launch("riccati_scan_launch", *_ptrs(slabs), *_ptrs(out), L, nb, d, stream)
    scan_launch_count += 1
    return out


# ---- level 2 and the join: csrc/riccati_scan.cu, riccati_join_kernel ------


def riccati_level2_reference(A, b, C, eta, J):
    """Plain torch version of the level-2 scan, as the JAX package runs it:
    the associative suffix scan over the nb block totals (step 0 of the
    local-suffix slabs), shifted to the exclusive suffix. Returns (S_eta
    (d, nb), S_J (d*d, nb)), the only parts of S the join reads."""
    d, nb = b.shape[1], A.shape[2]
    totals = _lanes(tuple(x[0] for x in (A, b, C, eta, J)), d)
    with full_f32_matmul():
        inc = associative_scan(
            lambda x, y: _combine(y, x, fast_inverse=True), totals, reverse=True
        )
    ident = _identity_elems((1,), d, A.dtype, A.device)
    S_eta, S_J = (torch.cat([x[1:], ix], dim=0) for x, ix in zip(inc[3:], ident[3:]))
    return S_eta.T.contiguous(), S_J.reshape(nb, d * d).T.contiguous()


def _level2_grouped(A, b, C, eta, J, group):
    """The level-2 scan in the join kernel's order for `group` lanes a
    block; returns (S_eta (d, nb), S_J (d*d, nb)).

    For the block of lanes g*group .. g*group + group - 1: the n lanes
    after it in `group` chunks of ceil(n / group), each folded from the
    identity, its latest total innermost; an ordered pairwise tree over
    the chunk totals (after the round with offset o, chunk q = 0 mod 2o
    covers chunks q .. q + 2o - 1) gives the later lanes' total; an
    inclusive Hillis-Steele suffix over the block's own totals, in the
    same rounds, gives each lane the suffix of the lanes after it in the
    block; S_b is that suffix composed with the later lanes' total. Lanes
    past nb hold the identity. Batched over the blocks: a combine with the
    identity is exact, so the shorter chunks of later blocks pad with it.
    """
    d, nb = b.shape[1], A.shape[2]
    dev, G = A.device, group
    groups = -(-nb // G)
    totals = _lanes(tuple(x[0] for x in (A, b, C, eta, J)), d)
    # index nb: the identity
    ext = tuple(torch.cat([t, i]) for t, i in zip(totals, _identity_elems((1,), d, A.dtype, dev)))
    g = torch.arange(groups, device=dev)[:, None, None]
    q = torch.arange(G, device=dev)
    chunk = (torch.clamp(nb - (g + 1) * G, min=0) + G - 1) // G
    size = -(-max(nb - G, 0) // G)  # the longest chunk, block 0's
    k = torch.arange(size, device=dev)[None, None, :]
    lane = (g + 1) * G + q[None, :, None] * chunk + k
    idx = torch.where((k < chunk) & (lane < nb), lane, nb)  # (groups, G, size)

    def combine_where(mask, x, y):
        return _where(mask.expand(groups, G), _combine(x, y, fast_inverse=True), x)

    x = _identity_elems((groups, G), d, A.dtype, dev)
    for kk in range(size - 1, -1, -1):
        x = _combine(tuple(e[idx[..., kk]] for e in ext), x, fast_inverse=True)
    own = torch.arange(groups, device=dev)[:, None] * G + q[None, :]
    t = tuple(e[torch.where(own < nb, own, nb)] for e in ext)  # (groups, G, ...)
    o = 1
    while o < G:
        src = torch.clamp(q + o, max=G - 1)
        x = combine_where(((q % (2 * o) == 0) & (q + o < G))[None, :], x,
                          tuple(v[:, src] for v in x))
        t = combine_where((q + o < G)[None, :], t, tuple(v[:, src] for v in t))
        o *= 2
    ident = _identity_elems((groups, 1), d, A.dtype, dev)
    after = tuple(torch.cat([v[:, 1:], i], dim=1) for v, i in zip(t, ident))
    later = tuple(v[:, :1].expand_as(w) for v, w in zip(x, after))
    S = _combine(after, later, fast_inverse=True)
    S_eta = S[3].reshape(groups * G, d)[:nb]
    S_J = S[4].reshape(groups * G, d * d)[:nb]
    return S_eta.T.contiguous(), S_J.T.contiguous()


def _join_slabs(A, b, C, eta, J, S_eta, S_J):
    """(eta, J) of r[j] o S_b for every step j and lane b at once, as
    (eta (L, d, nb), J (L, d*d, nb)) slabs."""
    L, d, nb = A.shape[0], b.shape[1], A.shape[2]
    r = _lanes((A, b, C, eta, J), d)  # (L, nb, ...)
    # S's A, b and C do not reach (eta, J) of the combine
    S = (*_identity_elems((nb,), d, A.dtype, A.device)[:3],
         S_eta.T, S_J.T.reshape(nb, d, d))
    with full_f32_matmul():
        out = _combine(r, S, fast_inverse=True)
    return (out[3].transpose(-1, -2).contiguous(),
            out[4].reshape(L, nb, d * d).transpose(-1, -2).contiguous())


def riccati_join_reference(A, b, C, eta, J, N, order=None):
    """Plain torch version of the joined kernel: the exclusive suffixes
    S_b of the block totals, then (eta, J) of r[j] o S_b for every element,
    returned time-major as eta (N, d) and J (N, d, d) (rows t = b * L + j
    < N).

    order=None: the level-2 scan in the JAX package's order
    (`riccati_level2_reference`), which the CPU wrapper runs; order=G: the
    kernel's order for G lanes a block (`JOIN_GROUP` on the card).
    """
    slabs = (A, b, C, eta, J)
    d = b.shape[1]
    if order is None:
        S = riccati_level2_reference(*slabs)
    else:
        if isinstance(order, bool) or not isinstance(order, int) or order < 1:
            raise ValueError(f"order must be None or a positive int, got {order!r}")
        with full_f32_matmul():
            S = _level2_grouped(*slabs, order)
    eta_s, J_s = _join_slabs(*slabs, *S)
    return _unpack(eta_s, N, d), _unpack(J_s, N, d * d).reshape(N, d, d)


def join_tile(L: int, nb: int, n_sms: int) -> int:
    """Steps a block of the join kernel takes: the fewest with which the
    blocks (a group of `JOIN_GROUP` lanes by a tile of steps) cover the
    SMs once, so every block's prologue runs at the same time; at most
    `JOIN_MAX_STEPS`."""
    groups = -(-nb // JOIN_GROUP)
    tiles = max(1, min(L, n_sms // groups))
    return min(-(-L // tiles), JOIN_MAX_STEPS)


def riccati_join(A, b, C, eta, J, N):
    """(eta, J) of every local suffix r[j] of `riccati_scan` joined with
    its block's exclusive suffix S_b: returns eta (N, d) and J (N, d, d),
    time-major, the rows t = b * L + j < N.

    CUDA tensors go to the kernel in `csrc/riccati_scan.cu` (level 2 as
    each block's prologue, one launch), held to
    `riccati_join_reference(..., order=JOIN_GROUP)`; CPU tensors to
    `riccati_join_reference` (level 2 in the JAX package's order).
    """
    global join_launch_count
    slabs = (A, b, C, eta, J)
    L, d, nb, device = _check_slabs("riccati_join", slabs)
    _check_device("riccati_join", device)
    if isinstance(N, bool) or not isinstance(N, int) or not (L - 1) * nb < N <= L * nb:
        raise ValueError(f"riccati_join: N must be an int in ({(L - 1) * nb}, {L * nb}] for "
                         f"L = {L} steps of nb = {nb} lanes, got {N!r}")
    if device.type == "cpu":
        return riccati_join_reference(*slabs, N)
    eta_out = torch.empty((N, d), dtype=_F32, device=device)
    J_out = torch.empty((N, d, d), dtype=_F32, device=device)
    jt = join_tile(L, nb, torch.cuda.get_device_properties(device).multi_processor_count)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _launch("riccati_join_launch", *_ptrs(slabs), eta_out.data_ptr(), J_out.data_ptr(),
                L, nb, N, d, jt, JOIN_GROUP, stream)
    join_launch_count += 1
    return eta_out, J_out


# ---- the entry point ---------------------------------------------------------


def pack_elements(elems, N, d, nb):
    """The (L, rows, nb) slabs of the N elements padded with identities to
    nb * L, L = ceil(N / nb)."""
    L = -(-N // nb)
    pad = nb * L - N
    ident = _identity_elems((), d, elems[0].dtype, elems[0].device)
    out = []
    for x, ix, rows in zip(elems, ident, comp_rows(d)):
        if pad:
            x = torch.cat([x, ix.expand((pad,) + tuple(x.shape[1:]))], dim=0)
        out.append(_pack(x.reshape(nb * L, rows), nb, L, rows))
    return tuple(out)


def lqt_backward_parallel_fused(
    A, B, Q, xd, R, Qr=None, xr=None, Rr=None, ur=None, nb: int = 128, *, device=None,
) -> DPGains:
    """Blocked time-parallel LQT Riccati with the scan in CUDA kernels.

    The contract of `lqt_backward_parallel_pallas`: the gains of
    `lqt_backward` for d <= 4 and m <= 4, always in float32. nb blocks ride
    the lanes, L = ceil(N / nb) sequential steps each. device: where to run
    (default the CUDA card; "cpu" runs the plain versions of the kernels).
    """
    device = resolve_device(device)
    _check_device("lqt_backward_parallel_fused", device)
    N, d = A.shape[0], A.shape[-1]
    if d > 4:
        raise ValueError(f"the fused blocked Riccati supports d <= 4, got {d}")
    if isinstance(nb, bool) or not isinstance(nb, int) or nb < 1:
        raise ValueError(f"nb must be a positive int, got {nb!r}")

    def f32(x):
        return None if x is None else torch.as_tensor(x).to(device=device, dtype=_F32)

    A32, B32 = f32(A), f32(B)
    with full_f32_matmul():
        elems, U, s = value_elements(
            A32, B32, f32(Q), f32(xd), f32(R), Qr=f32(Qr), xr=f32(xr), Rr=f32(Rr), ur=f32(ur),
            fast_inverse=True,
        )
        r = riccati_scan(*pack_elements(elems, N, d, nb))
        eta_all, J_all = riccati_join(*r, N)
        return gains_from_scanned(
            A32, B32, U, s, (None, None, None, eta_all, J_all), fast_inverse=True
        )
