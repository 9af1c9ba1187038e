"""GEMM-formulated batched LQT-ADMM: the plain torch fleet.

Counterpart of `ilqr_admm_tpu/solvers/batched.py`. With the lifted
operators prefactored, every ADMM iteration of a fleet of constrained LQT
instances that share dynamics and cost is two dense products plus the
projections:

    u = (r_base + (z_x - l_x) SuTQr^T + (z_u - l_u) Rr^T) l_inv^T
    x = free + u Su^T

with the batch on the rows. This is the plain torch fleet: no kernel of
its own. Its fused counterpart, for box constraints, is
`ops/fused_admm.py`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ilqr_admm_tpu_torch.ops.lifted import build_Su, build_Sx
from ilqr_admm_tpu_torch.problem import QuadCost, host_f64
from ilqr_admm_tpu_torch.solvers.admm import validate_constraint_blocks
from ilqr_admm_tpu_torch.solvers.lqt import block_diag_stacked, broadcast_rho
from ilqr_admm_tpu_torch.utils.device import resolve_device
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


def _chol_solve_small(M, b):
    """Unrolled batched Cholesky solve for tiny SPD systems.

    M: (..., n, n) SPD (n small: the Anderson gram), b: (..., n). Every
    operation is elementwise over the leading batch axes, as in the JAX
    package, with the same clamp of the pivots at 1e-30.
    """
    n = M.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            acc = M[..., i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(acc, min=1e-30))
            else:
                L[i][j] = acc / L[j][j]
    y = [None] * n
    for i in range(n):
        acc = b[..., i]
        for k in range(i):
            acc = acc - L[i][k] * y[k]
        y[i] = acc / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        for k in range(i + 1, n):
            acc = acc - L[k][i] * x[k]
        x[i] = acc / L[i][i]
    return torch.stack(x, dim=-1)


class BatchedLQTADMM(nn.Module):
    """The plain fleet solver; holds the operators as buffers (SuTQr and
    Rr_l are None when their block is off). `solver(x0s)` -> (x, u)."""

    def __init__(self, ops: dict, project_x, project_u, n_iters: int, alpha: float, tol: float,
                 anderson_m: int, anderson_safeguard: float, anderson_reg: float):
        super().__init__()
        for name, value in ops.items():
            self.register_buffer(name, value)
        self.project_x, self.project_u = project_x, project_u
        self.n_iters, self.alpha, self.tol = n_iters, alpha, tol
        self.anderson_m = anderson_m
        self.anderson_safeguard = anderson_safeguard
        self.anderson_reg = anderson_reg

    def iteration(self, free, r_base, z_x, z_u, l_x, l_u):
        r = r_base
        if self.SuTQr is not None:
            # the regularization target is absolute x; the operator's
            # pullback of the free response is already in r_base
            r = r + (z_x - l_x) @ self.SuTQr.T
        if self.Rr_l is not None:
            r = r + (z_u - l_u) @ self.Rr_l.T
        u_hat = r @ self.l_inv.T
        x_hat = free + u_hat @ self.Su.T

        prim = torch.zeros(u_hat.shape[0], dtype=u_hat.dtype, device=u_hat.device)
        dual = torch.zeros_like(prim)
        if self.project_x is not None:
            z_rel = self.alpha * x_hat + (1.0 - self.alpha) * z_x
            z_x_new = self.project_x(z_rel + l_x)
            l_x = l_x + x_hat - z_x_new
            prim = prim + torch.linalg.vector_norm(x_hat - z_x_new, dim=-1)
            dual = dual + torch.linalg.vector_norm(z_x_new - z_x, dim=-1)
            z_x = z_x_new
        if self.project_u is not None:
            z_rel = self.alpha * u_hat + (1.0 - self.alpha) * z_u
            z_u_new = self.project_u(z_rel + l_u)
            l_u = l_u + u_hat - z_u_new
            prim = prim + torch.linalg.vector_norm(u_hat - z_u_new, dim=-1)
            dual = dual + torch.linalg.vector_norm(z_u_new - z_u, dim=-1)
            z_u = z_u_new
        return z_x, z_u, l_x, l_u, x_hat, u_hat, prim, dual

    @full_f32_matmul()
    def forward(self, x0s):
        """x0s: (batch, d). Returns (x (batch, N*d), u (batch, N*m))."""
        x0s = torch.as_tensor(x0s).to(self.l_inv.device, self.l_inv.dtype)
        free = x0s @ self.Sx.T
        r_base = self.r_const[None] - free @ self.SuTQ.T
        if self.SuTQr is not None:
            r_base = r_base - free @ self.SuTQr.T

        # warm start from the unconstrained optimum (the unregularized inverse)
        u0 = (self.r_const[None] - free @ self.SuTQ.T) @ self.l_inv_unreg.T
        z_u = u0
        z_x = free + u0 @ self.Su.T
        l_x = torch.zeros_like(z_x)
        l_u = torch.zeros_like(z_u)
        step = lambda *s: self.iteration(free, r_base, *s)  # noqa: E731

        if self.tol <= 0.0:
            x, u = z_x, z_u
            for _ in range(self.n_iters):
                z_x, z_u, l_x, l_u, x, u, _, _ = step(z_x, z_u, l_x, l_u)
            return x, u
        if self.anderson_m <= 0:
            return self._early_stop(step, (z_x, z_u, l_x, l_u))
        return self._anderson(step, (z_x, z_u, l_x, l_u))

    def _early_stop(self, step, init):
        """Per-instance freeze: a converged instance keeps its iterates; the
        loop ends when every instance is frozen or at n_iters."""
        state = init + (init[0], init[1])  # (z_x, z_u, l_x, l_u, x, u)
        done = torch.zeros(init[0].shape[0], dtype=torch.bool, device=init[0].device)
        for _ in range(self.n_iters):
            if bool(done.all()):
                break
            *new, prim, dual = step(*state[:4])
            keep = done[:, None]
            state = tuple(torch.where(keep, o, n) for o, n in zip(state, new))
            done = done | ((prim < self.tol) & (dual < self.tol))
        return state[4], state[5]

    def _anderson(self, step, init):
        """Per-instance safeguarded type-II Anderson on top of the freeze
        (mirror of the JAX fleet's, which mirrors `admm_solve`'s): each
        instance keeps its own secant memory, restarts when its fixed-point
        residual grows past `anderson_safeguard` times its best since the
        last restart, and returns its best-scoring plain evaluation."""
        z_x0, z_u0, l_x0, l_u0 = init
        has_x, has_u = self.project_x is not None, self.project_u is not None
        Bn, dtype, device = z_x0.shape[0], z_x0.dtype, z_x0.device
        sxd = z_x0.shape[1] if has_x else 0
        sud = z_u0.shape[1] if has_u else 0
        D = 2 * (sxd + sud)
        m_aa = self.anderson_m
        SAFE, REG = float(self.anderson_safeguard), float(self.anderson_reg)

        def pack(zx, zu, lx, lu):
            parts = ([zx, lx] if has_x else []) + ([zu, lu] if has_u else [])
            return torch.cat(parts, dim=-1)

        def unpack(v):
            zx = v[:, :sxd] if has_x else z_x0
            lx = v[:, sxd:2 * sxd] if has_x else l_x0
            zu = v[:, 2 * sxd:2 * sxd + sud] if has_u else z_u0
            lu = v[:, 2 * sxd + sud:] if has_u else l_u0
            return zx, zu, lx, lu

        eye_aa = torch.eye(m_aa, dtype=dtype, device=device)
        eps = torch.finfo(dtype).eps
        done = torch.zeros(Bn, dtype=torch.bool, device=device)
        v_in = pack(*init)
        x, u = z_x0, z_u0
        mem_dv = torch.zeros((Bn, m_aa, D), dtype=dtype, device=device)
        mem_dg = torch.zeros_like(mem_dv)
        prev_v = torch.zeros((Bn, D), dtype=dtype, device=device)
        prev_g = torch.zeros_like(prev_v)
        has_prev = torch.zeros(Bn, dtype=torch.bool, device=device)
        best = torch.full((Bn,), torch.inf, dtype=dtype, device=device)
        ret_score = torch.full((Bn,), torch.inf, dtype=dtype, device=device)

        for _ in range(self.n_iters):
            if bool(done.all()):
                break
            nz_x, nz_u, nl_x, nl_u, nx, nu, prim, dual = step(*unpack(v_in))
            v_plain = pack(nz_x, nz_u, nl_x, nl_u)
            g = v_plain - v_in
            gnorm = torch.linalg.vector_norm(g, dim=-1)

            restart = has_prev & (gnorm > SAFE * best)
            push = has_prev & ~restart
            mem_dv_p = torch.cat([mem_dv[:, 1:], (v_in - prev_v)[:, None]], dim=1)
            mem_dg_p = torch.cat([mem_dg[:, 1:], (g - prev_g)[:, None]], dim=1)
            sel = push[:, None, None]
            rst = restart[:, None, None]
            mem_dv_new = torch.where(sel, mem_dv_p, torch.where(rst, 0.0, mem_dv))
            mem_dg_new = torch.where(sel, mem_dg_p, torch.where(rst, 0.0, mem_dg))

            gram = torch.einsum("bmd,bnd->bmn", mem_dg_new, mem_dg_new)
            tr = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1)[:, None, None]
            rhs = torch.einsum("bmd,bd->bm", mem_dg_new, g)
            gam = _chol_solve_small(gram + (REG * tr + 1e-30) * eye_aa, rhs)
            v_aa = v_in + g - torch.einsum("bmd,bm->bd", mem_dv_new + mem_dg_new, gam)
            # below a machine-precision-scaled floor the secant pairs are
            # noise: finish with plain steps
            noise_floor = 1e3 * eps * (1.0 + torch.linalg.vector_norm(v_plain, dim=-1))
            use_aa = gnorm > noise_floor
            v_next = torch.where((use_aa & ~restart)[:, None], v_aa, v_plain)

            best = torch.where(restart, torch.inf, torch.minimum(best, gnorm))
            conv = (prim < self.tol) & (dual < self.tol)
            # the returned iterate is the instance's best-scoring plain
            # evaluation; a converging one is always taken
            score = prim + dual
            take = ~done & ((score < ret_score) | conv)
            tk, keep = take[:, None], done[:, None]
            keep3 = keep[:, :, None]
            x = torch.where(tk, nx, x)
            u = torch.where(tk, nu, u)
            mem_dv = torch.where(keep3, mem_dv, mem_dv_new)
            mem_dg = torch.where(keep3, mem_dg, mem_dg_new)
            prev_v = torch.where(keep, prev_v, v_in)
            prev_g = torch.where(keep, prev_g, g)
            has_prev = torch.where(done, has_prev, ~restart)
            ret_score = torch.where(take, score, ret_score)
            v_in = torch.where(keep, v_in, v_next)
            done = done | conv
        return x, u


def make_batched_lqt_admm(
    A,
    B,
    cost: QuadCost,
    project_x: Optional[Callable] = None,
    project_u: Optional[Callable] = None,
    rho_x=None,
    rho_u=None,
    n_iters: int = 100,
    alpha: float = 1.0,
    tol: float = 0.0,
    anderson_m: int = 0,
    anderson_safeguard: float = 10.0,
    anderson_reg: float = 1e-10,
    *,
    device=None,
    dtype: torch.dtype | None = None,
) -> BatchedLQTADMM:
    """Build a batched constrained-LQT ADMM solver (the plain torch fleet).

    The arguments are those of the JAX `make_batched_lqt_admm`, with
    `device` (default: the CUDA card) and `dtype` (default: A's dtype)
    added. project_x /
    project_u map flattened (batch, N*dim) tensors to the constraint
    sets. Returns a module; solver(x0s (batch, d)) -> (x (batch, N*d),
    u (batch, N*m)).

    tol = 0 runs exactly n_iters iterations and returns the last one.
    tol > 0 freezes an instance once its primal residual ||x_hat - z||
    and dual residual ||z - z_prev|| (summed over the enabled blocks) are
    both below tol, and stops when every instance is frozen or at
    n_iters. anderson_m > 0 (requires tol > 0) adds per-instance
    safeguarded Anderson acceleration and returns each instance's
    best-scoring plain evaluation.

    The warm start is the unconstrained optimum, through the inverse of
    the unregularized normal matrix (the fused path's `_admm_kernel`
    setup uses the regularized one: the two follow different iterates
    to the same fixed point). The setup runs in f64 on the host from the
    data rounded to `dtype` and is cast to `dtype` once; the hot
    products run in full f32 (no TF32).
    """
    device = resolve_device(device)
    validate_constraint_blocks(project_x, rho_x, project_u, rho_u)
    if anderson_m > 0 and tol <= 0.0:
        raise ValueError(
            "anderson_m > 0 requires tol > 0: the fixed-count mode returns the "
            "last iterate, which Anderson cannot certify; use the per-instance "
            "early-stopping mode"
        )
    dtype = torch.as_tensor(A).dtype if dtype is None else dtype
    A, B, cost = host_f64(A, B, cost, dtype)
    N, d, m = A.shape[0], A.shape[-1], B.shape[-1]
    f64 = torch.float64

    Su = build_Su(A, B)
    SuTQ = Su.T @ block_diag_stacked(cost.Q)
    l_side = SuTQ @ Su + block_diag_stacked(cost.R)
    ops = dict(
        Su=Su, Sx=build_Sx(A).reshape(N * d, d), SuTQ=SuTQ,
        l_inv_unreg=torch.linalg.inv(l_side), r_const=SuTQ @ cost.lifted_xd(),
        SuTQr=None, Rr_l=None,
    )
    if project_x is not None and rho_x is not None:
        Qr = broadcast_rho(rho_x, d, N, dtype).to(f64)
        ops["SuTQr"] = Su.T @ block_diag_stacked(Qr)
        l_side = l_side + ops["SuTQr"] @ Su
    if project_u is not None and rho_u is not None:
        ops["Rr_l"] = block_diag_stacked(broadcast_rho(rho_u, m, N, dtype).to(f64))
        l_side = l_side + ops["Rr_l"]
    ops["l_inv"] = torch.linalg.inv(l_side)
    ops = {k: None if v is None else v.to(device=device, dtype=dtype).contiguous()
           for k, v in ops.items()}
    return BatchedLQTADMM(ops, project_x, project_u, n_iters, alpha, float(tol),
                          int(anderson_m), anderson_safeguard, anderson_reg)
