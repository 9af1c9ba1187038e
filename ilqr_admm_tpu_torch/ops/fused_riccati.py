"""Blocked time-parallel LQT Riccati with the scan on the card.

Counterpart of `ilqr_admm_tpu/ops/pallas_riccati.py`
(`lqt_backward_parallel_pallas` and its kernels `_scan_kernel` and
`_join_kernel`). The elements and the gains are plain torch, as they are
XLA in the JAX package (`fast_inverse=True` throughout); the scan between
them is three hand-written CUDA kernels in `csrc/riccati_scan.cu`:

1. pack the elements (N, d, d) | (N, d), padded with identities to
   nb * L, into (L, rows, nb) slabs: element t = b * L + j sits in lane b
   at step j, so lanes are the fastest axis;
2. `riccati_scan`: the reverse suffix scan inside each of the nb blocks,
   r[j] = e_j o ... o e_{L-1} (replaces `_scan_kernel`), a chunked warp
   scan on the card (one warp a lane, `SCAN_CHUNKS` chunks of its steps);
3. `riccati_level2`: the exclusive suffixes S_b of the nb block totals
   r[0], as (eta, J) slabs (replaces the XLA scan between the kernels);
4. `riccati_join`: (eta, J) of r[j] o S_b for every element (replaces
   `_join_kernel`), then unpack and extract the gains.

On CPU tensors each wrapper runs its plain torch version
(`riccati_scan_reference`, `riccati_level2_reference`,
`riccati_join_reference`) instead; on CUDA tensors it launches its
kernel or raises.
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
level2_launch_count = 0
join_launch_count = 0

_F32 = torch.float32

# Chunks of a lane's L steps in `riccati_scan_kernel`: one a thread of the
# lane's warp. `riccati_scan_reference(..., chunks=SCAN_CHUNKS)` replays
# the kernel's order of combines.
SCAN_CHUNKS = 32


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


# ---- level 2: csrc/riccati_scan.cu, riccati_level2_kernel -------------------


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


def riccati_level2(A, b, C, eta, J):
    """Exclusive suffixes of the block totals from the local-suffix slabs
    of `riccati_scan`; returns (S_eta (d, nb), S_J (d*d, nb)).

    CUDA tensors go to the kernel in `csrc/riccati_scan.cu`; CPU tensors
    to `riccati_level2_reference`.
    """
    global level2_launch_count
    slabs = (A, b, C, eta, J)
    _, d, nb, device = _check_slabs("riccati_level2", slabs)
    _check_device("riccati_level2", device)
    if device.type == "cpu":
        return riccati_level2_reference(*slabs)
    S_eta = torch.empty((d, nb), dtype=_F32, device=device)
    S_J = torch.empty((d * d, nb), dtype=_F32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _launch("riccati_level2_launch", *_ptrs(slabs), S_eta.data_ptr(), S_J.data_ptr(),
                nb, d, stream)
    level2_launch_count += 1
    return S_eta, S_J


# ---- the join: csrc/riccati_scan.cu, riccati_join_kernel --------------------


def riccati_join_reference(A, b, C, eta, J, S_eta, S_J):
    """Plain torch version of the join: (eta, J) of r[j] o S_b for every
    step j and lane b at once. Returns (eta (L, d, nb), J (L, d*d, nb))."""
    L, d, nb = A.shape[0], b.shape[1], A.shape[2]
    r = _lanes((A, b, C, eta, J), d)  # (L, nb, ...)
    # S's A, b and C do not reach (eta, J) of the combine
    S = (*_identity_elems((nb,), d, A.dtype, A.device)[:3],
         S_eta.T, S_J.T.reshape(nb, d, d))
    with full_f32_matmul():
        out = _combine(r, S, fast_inverse=True)
    return (out[3].transpose(-1, -2).contiguous(),
            out[4].reshape(L, nb, d * d).transpose(-1, -2).contiguous())


def riccati_join(A, b, C, eta, J, S_eta, S_J):
    """(eta, J) of every local suffix joined with its block's exclusive
    suffix: returns (L, d, nb) and (L, d*d, nb) slabs.

    CUDA tensors go to the kernel in `csrc/riccati_scan.cu`; CPU tensors
    to `riccati_join_reference`.
    """
    global join_launch_count
    slabs = (A, b, C, eta, J)
    L, d, nb, device = _check_slabs("riccati_join", slabs)
    _check_device("riccati_join", device)
    for name, t, rows in (("S_eta", S_eta, d), ("S_J", S_J, d * d)):
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != (rows, nb):
            raise ValueError(f"riccati_join: {name} must be a ({rows}, {nb}) tensor")
        if t.device != device or t.dtype != _F32 or not t.is_contiguous():
            raise ValueError(f"riccati_join: {name} must be contiguous float32 on {device}")
    if device.type == "cpu":
        return riccati_join_reference(*slabs, S_eta, S_J)
    eta_out = torch.empty((L, d, nb), dtype=_F32, device=device)
    J_out = torch.empty((L, d * d, nb), dtype=_F32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _launch("riccati_join_launch", *_ptrs(slabs), S_eta.data_ptr(), S_J.data_ptr(),
                eta_out.data_ptr(), J_out.data_ptr(), L, nb, d, stream)
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
        eta_slab, J_slab = riccati_join(*r, *riccati_level2(*r))
        eta_all = _unpack(eta_slab, N, d)
        J_all = _unpack(J_slab, N, d * d).reshape(N, d, d)
        return gains_from_scanned(
            A32, B32, U, s, (None, None, None, eta_all, J_all), fast_inverse=True
        )
