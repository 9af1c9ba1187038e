"""Constrained Riccati backward passes: stagewise control bounds inside
the DP recursion, no ADMM splitting (counterpart of
`ilqr_admm_tpu/ops/constrained_riccati.py`).

`ilqr_backward_box` is the boxDDP backward pass (Tassa, Mansard and
Todorov, ICRA 2014): each stage solves a box QP over the control
increment (`ops/boxqp.py`) and the feedback gain is restricted to the
free subspace. `ilqr_backward_box_parallel` solves the same clamped-
subspace model with an active-set exchange over the whole horizon, each
pass a time-parallel Riccati scan. `box_kkt_residual` certifies a
nominal against the sequential recursion; `rollout_closed_loop_clipped`
is the boxDDP policy's rollout.

Same conventions as `ops/riccati.py::ilqr_backward`: Cts (N, x+u, x+u)
Taylor Hessians, cts (N, x+u) gradients, zero final-step gains. The JAX
package runs each recursion as a `lax.scan`; here it is a Python loop
over the stages with the same per-stage algebra, in full f32, with no
host read.
"""

from __future__ import annotations

import torch

from ilqr_admm_tpu_torch.ops.boxqp import _masked_solve, box_bounds, boxqp, boxqp_enum
from ilqr_admm_tpu_torch.ops.parallel_riccati import _bmm, ilqr_backward_parallel
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


def _sym(M):
    return 0.5 * (M + M.T)


def _stage_q(At, Bt, Ct, ct, V, v, d, reg_eye):
    """The stage's Q-function blocks: (qx, qu, Qxx, Qux, Quu)."""
    qx = ct[:d] + At.T @ v
    qu = ct[d:] + Bt.T @ v
    Qxx = Ct[:d, :d] + At.T @ V @ At
    Qux = Ct[d:, :d] + Bt.T @ V @ At
    Quu = _sym(Ct[d:, d:] + Bt.T @ V @ Bt + reg_eye)
    return qx, qu, Qxx, Qux, Quu


def _stage_value(qx, qu, Qxx, Qux, Quu, Kt, kt):
    V = Qxx + Qux.T @ Kt + Kt.T @ Qux + Kt.T @ Quu @ Kt
    v = qx + Qux.T @ kt + Kt.T @ qu + Kt.T @ Quu @ kt
    return V, v


def _blocks(Cxx, Cxu, Cux, Cuu):
    """The (N, x+u, x+u) Hessians of their four blocks, built out of place:
    an indexed write into a Hessian the fleet shares fails under vmap when
    the blocks are per instance."""
    return torch.cat([torch.cat([Cxx, Cxu], dim=-1), torch.cat([Cux, Cuu], dim=-1)], dim=-2)


def _stack_gains(Ks, ks, m, d, like):
    """Gains collected from t = N-2 down to 0, in time order, with the
    zero final step."""
    K = torch.stack(Ks[::-1] + [torch.zeros((m, d), dtype=like.dtype, device=like.device)])
    k = torch.stack(ks[::-1] + [torch.zeros((m,), dtype=like.dtype, device=like.device)])
    return K, k


@full_f32_matmul()
def ilqr_backward_box(A, B, Cts, cts, u_nom, u_lower, u_upper, reg=0.0, qp_iters: int = 12,
                      qp_method: str = "auto"):
    """boxDDP backward pass: per-stage box-QP feedforward and
    free-subspace feedback.

    u_lower/u_upper: scalars or (m,) absolute control bounds; the QP is
    over the increment, with bounds [u_lower - u_nom_t, u_upper - u_nom_t].
    qp_method: 'enum' (exact, `boxqp_enum`), 'newton' (`qp_iters`
    projected-Newton steps) or 'auto' ('enum' for m <= 3). Returns
    (K (N, u, x), k (N, u)) with zero final-step gains; forward rollouts
    must clip u into the box (`rollout_closed_loop_clipped`).
    """
    if qp_method not in ("auto", "enum", "newton"):
        raise ValueError(f"qp_method must be auto|enum|newton, got {qp_method!r}")
    d, m = A.shape[-1], B.shape[-1]
    lo, hi = box_bounds(u_lower, m, A), box_bounds(u_upper, m, A)
    use_enum = qp_method == "enum" or (qp_method == "auto" and m <= 3)
    reg_eye = reg * torch.eye(m, dtype=A.dtype, device=A.device)

    V, v = Cts[-1][:d, :d], cts[-1][:d]
    Ks, ks = [], []
    for t in range(A.shape[0] - 2, -1, -1):
        qx, qu, Qxx, Qux, Quu = _stage_q(A[t], B[t], Cts[t], cts[t], V, v, d, reg_eye)
        if use_enum:
            kt, free = boxqp_enum(Quu, qu, lo - u_nom[t], hi - u_nom[t])
        else:
            kt, free = boxqp(Quu, qu, lo - u_nom[t], hi - u_nom[t], n_iters=qp_iters)
        Kt = _masked_solve(Quu, free, -Qux)
        V, v = _stage_value(qx, qu, Qxx, Qux, Quu, Kt, kt)
        Ks.append(Kt)
        ks.append(kt)
    return _stack_gains(Ks, ks, m, d, A)


@full_f32_matmul()
def ilqr_backward_box_parallel(A, B, Cts, cts, u_nom, u_lower, u_upper, reg=0.0,
                               mask_iters: int = 3, clamp0=None, return_clamp: bool = False,
                               mesh=None, mesh_axis: str = "time"):
    """Time-parallel boxDDP backward pass: an active-set exchange over the
    whole horizon, each pass a time-parallel Riccati scan.

    1. An unconstrained pass seeds, per stage, which control increments
       cross their box (clamped at the crossed bound), unless `clamp0 =
       (clamp_lo, clamp_hi)` gives the set.
    2. Each clamped dim is frozen at its bound offset c = bound - u_nom;
       the frozen controls become a dynamics drift d_t = B_t c_t
       (`ilqr_backward_parallel(drift=...)`) and linear cost shifts, and
       the free subspace is a plain parallel Riccati pass. Given the set,
       this is the sequential box-QP recursion's clamped-subspace model.
    3. Between passes the set is exchanged primal-dually: clamped dims
       release on a wrong-sign multiplier g_t = qu_t + Quu_t k_t, free
       dims clamp when their step crosses a bound.

    mask_iters passes run unvetted; the gains and set returned are those
    of the pass of least KKT violation (NaN counts as +inf). Returns (K,
    k), and the post-exchange set (clamp_lo, clamp_hi) when return_clamp.

    mesh: a `DeviceMesh` (`parallel/mesh.py`) shards every pass's horizon
    over its `mesh_axis` (`parallel/time_sharded.py::ilqr_backward_time_sharded`:
    one all_gather of O(P d^2) chunk totals a pass); every rank of the
    axis makes the call with the same arguments, and the masked model and
    the exchange, per-stage algebra, run on each rank over the whole
    horizon.
    """
    if mesh is None:
        backward = ilqr_backward_parallel
    else:
        from ilqr_admm_tpu_torch.parallel.time_sharded import ilqr_backward_time_sharded

        def backward(A_, B_, Cts_, cts_, drift=None, **kw):
            return ilqr_backward_time_sharded(A_, B_, Cts_, cts_, drift, mesh=mesh,
                                              axis=mesh_axis, **kw)
    d, m = A.shape[-1], B.shape[-1]
    dtype, device = A.dtype, A.device
    lo, hi = box_bounds(u_lower, m, A), box_bounds(u_upper, m, A)
    eye_m = torch.eye(m, dtype=dtype, device=device)

    Cts = _blocks(Cts[:, :d, :d], Cts[:, :d, d:], Cts[:, d:, :d], Cts[:, d:, d:] + reg * eye_m)
    dlo = lo - u_nom  # (N, m) increment bounds
    dhi = hi - u_nom
    Cuu_full, Cux_full, cu_full = Cts[:, d:, d:], Cts[:, d:, :d], cts[:, d:]
    fast = d <= 4 and m <= 4  # inv_small on the (d, d) combines and (m, m) gains
    zero = torch.zeros((), dtype=dtype, device=device)

    def masked_pass(clamp_lo, clamp_hi):
        F = (~(clamp_lo | clamp_hi)).to(dtype)
        c = torch.where(clamp_lo, dlo, torch.where(clamp_hi, dhi, zero))
        c = torch.cat([c[:-1], torch.zeros_like(c[-1:])])  # terminal controls unused
        drift = torch.einsum("tij,tj->ti", B, c)
        cu_eff = (cu_full + torch.einsum("tij,tj->ti", Cuu_full, c)) * F
        cx_eff = cts[:, :d] + torch.einsum("tji,tj->ti", Cux_full, c)
        B_eff = B * F[:, None, :]
        Cts_eff = _blocks(Cts[:, :d, :d], Cts[:, :d, d:] * F[:, None, :], Cux_full * F[:, :, None],
                          Cuu_full * F[:, :, None] * F[:, None, :] + eye_m * (1.0 - F)[:, :, None])
        K, k, J, eta = backward(
            A, B_eff, Cts_eff, torch.cat([cx_eff, cu_eff], dim=-1), return_value=True,
            drift=drift, fast_inverse=fast)
        return K * F[:, :, None], k * F + c, J, eta

    def exchange(clamp_lo, clamp_hi, k, J, eta):
        """The primal-dual set update at the masked solution, and its KKT
        violation (zero exactly at the set's fixed point)."""
        BT = B[:-1].transpose(-1, -2)
        qu = cu_full[:-1] - torch.sum(BT * eta[1:, None, :], dim=-1)
        Quu = Cuu_full[:-1] + _bmm(_bmm(BT, J[1:]), B[:-1])
        g = qu + torch.sum(Quu * k[:-1, None, :], dim=-1)
        g = torch.cat([g, torch.zeros((1, m), dtype=dtype, device=device)])
        clamp = clamp_lo | clamp_hi
        new_lo = (clamp_lo & (g >= 0)) | (~clamp & (k <= dlo))
        new_hi = (clamp_hi & (g <= 0)) | (~clamp & (k >= dhi))
        viol = torch.sum(torch.where(clamp_lo, torch.clamp(-g, min=0.0), zero))
        viol = viol + torch.sum(torch.where(clamp_hi, torch.clamp(g, min=0.0), zero))
        viol = viol + torch.sum(torch.where(
            ~clamp, torch.clamp(dlo - k, min=0.0) + torch.clamp(k - dhi, min=0.0), zero))
        # a NaN pass must neither win the best-pass comparison nor poison it
        return new_lo, new_hi, torch.where(torch.isnan(viol), float("inf"), viol)

    if clamp0 is None:
        _, k_unc = backward(A, B, Cts, cts, fast_inverse=fast)
        clamp_lo, clamp_hi = k_unc <= dlo, k_unc >= dhi
    else:
        clamp_lo, clamp_hi = clamp0
    K, k, J, eta = masked_pass(clamp_lo, clamp_hi)
    prop_lo, prop_hi, viol = exchange(clamp_lo, clamp_hi, k, J, eta)
    best_K, best_k, best_viol, best_lo, best_hi = K, k, viol, prop_lo, prop_hi
    for _ in range(max(1, mask_iters) - 1):
        K, k, J, eta = masked_pass(prop_lo, prop_hi)
        lo2, hi2, viol = exchange(prop_lo, prop_hi, k, J, eta)
        better = viol < best_viol
        best_K = torch.where(better, K, best_K)
        best_k = torch.where(better, k, best_k)
        best_lo = torch.where(better, lo2, best_lo)
        best_hi = torch.where(better, hi2, best_hi)
        best_viol = torch.where(better, viol, best_viol)
        prop_lo, prop_hi = lo2, hi2
    if return_clamp:
        return best_K, best_k, (best_lo, best_hi)
    return best_K, best_k


@full_f32_matmul()
def box_kkt_residual(A, B, Cts, cts, u_nom, u_lower, u_upper, reg=0.0, eps: float = 1e-6):
    """Sequential-backward KKT residual of a nominal trajectory.

    Runs the exact sequential box-QP recursion (enum) and measures how far
    the nominal (delta_u = 0) is from each stage's box-QP optimality
    conditions given the constrained cost-to-go: |qu_t| on free dims,
    max(0, -qu_t) at the lower bound, max(0, qu_t) at the upper. Returns
    the max over stages and dims (a 0-dim tensor): zero iff the
    trajectory is a stationary point of the control-limited DP model.
    """
    d, m = A.shape[-1], B.shape[-1]
    lo, hi = box_bounds(u_lower, m, A), box_bounds(u_upper, m, A)
    tol = eps * (1.0 + torch.maximum(torch.abs(lo), torch.abs(hi)))
    reg_eye = reg * torch.eye(m, dtype=A.dtype, device=A.device)
    zero = torch.zeros((), dtype=A.dtype, device=A.device)

    V, v = Cts[-1][:d, :d], cts[-1][:d]
    rs = []
    for t in range(A.shape[0] - 2, -1, -1):
        ut = u_nom[t]
        qx, qu, Qxx, Qux, Quu = _stage_q(A[t], B[t], Cts[t], cts[t], V, v, d, reg_eye)
        r = torch.where(ut <= lo + tol, torch.maximum(zero, -qu),
                        torch.where(ut >= hi - tol, torch.maximum(zero, qu), torch.abs(qu)))
        kt, free = boxqp_enum(Quu, qu, lo - ut, hi - ut)
        Kt = _masked_solve(Quu, free, -Qux)
        V, v = _stage_value(qx, qu, Qxx, Qux, Quu, Kt, kt)
        rs.append(torch.amax(r))
    return torch.amax(torch.stack(rs))


@full_f32_matmul()
def rollout_closed_loop_clipped(f, x0, K, k, x_nom, u_nom, u_lower, u_upper):
    """Clipped feedback rollout: u_t = clip(u_nom + k + K (x - x_nom), bounds).

    The clip is part of the boxDDP policy: feedback pushing past a bound
    saturates, matching the backward pass's clamped-subspace model.
    Returns (xs (N, x), us (N, u)).
    """
    m = K.shape[-2]
    lo, hi = box_bounds(u_lower, m, K), box_bounds(u_upper, m, K)
    xs, us = [], []
    x = x0
    for t in range(K.shape[0]):
        # expanded matvec: exact elementwise products, as the JAX package
        u = torch.clamp(u_nom[t] + k[t] + torch.sum(K[t] * (x - x_nom[t])[None, :], dim=-1),
                        lo, hi)
        xs.append(x)
        us.append(u)
        x = f(x, u)
    return torch.stack(xs), torch.stack(us)
