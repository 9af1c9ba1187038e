"""Batched robust SLS-ADMM with shared operators: scenario fleets.

Counterpart of `ilqr_admm_tpu/solvers/batched_sls.py`. A fleet of
robust syntheses shares dynamics and cost and differs per instance
(chance-constraint levels, bounds), so the x-update operators are built
once and every ADMM iteration over the fleet is one batched product

    U = l_inv (r + SuTQr (z_x - l_x) + Rr (z_u - l_u))    (batch, Nm, p+1)

plus the projections. This is the plain torch fleet: no kernel of its
own. Its fused counterpart is `ops/fused_sls.py`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn
from torch.utils._pytree import tree_leaves

from ilqr_admm_tpu_torch.ops.lifted import build_Su, build_Sx
from ilqr_admm_tpu_torch.problem import QuadCost, host_f64
from ilqr_admm_tpu_torch.solvers.admm import validate_constraint_blocks
from ilqr_admm_tpu_torch.solvers.lqt import block_diag_stacked, broadcast_rho, lqt_solve_sls
from ilqr_admm_tpu_torch.utils.device import resolve_device
from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


class BatchedSLSADMM(nn.Module):
    """The plain fleet solver; holds the operators as buffers (SuTQr and
    Rr_l are None when their block is off). `solver(params)` -> (du,
    phi_u, U)."""

    def __init__(self, ops: dict, project_x, project_u, p: int, n_iters: int, alpha: float,
                 tol: float):
        super().__init__()
        for name, value in ops.items():
            self.register_buffer(name, value)
        self.project_x, self.project_u = project_x, project_u
        self.p, self.n_iters, self.alpha, self.tol = p, n_iters, alpha, tol

    def x_update(self, z_x, z_u, l_x, l_u):
        r = self.r_base.expand((z_u.shape[0],) + tuple(self.r_base.shape))
        if self.project_x is not None:
            r = r + self.SuTQr @ (z_x - l_x)
        if self.project_u is not None:
            r = r + self.Rr_l @ (z_u - l_u)
        U = self.l_inv @ r
        X = self.Su @ U
        X[:, :, 1:] += self.Sx
        return X, U

    def iteration(self, state, params):
        z_x, z_u, l_x, l_u = state
        X, U = self.x_update(z_x, z_u, l_x, l_u)
        batch = U.shape[0]
        prim = torch.zeros(batch, dtype=U.dtype, device=U.device)
        dual = torch.zeros_like(prim)
        blocks = []
        for proj, P, z, lam in ((self.project_x, X, z_x, l_x), (self.project_u, U, z_u, l_u)):
            if proj is None:
                blocks.append((z, lam))
                continue
            z_rel = self.alpha * P + (1.0 - self.alpha) * z
            z_new = proj(z_rel + lam, params)
            lam = lam + P - z_new
            prim = prim + torch.linalg.vector_norm((P - z_new).reshape(batch, -1), dim=-1)
            dual = dual + torch.linalg.vector_norm((z_new - z).reshape(batch, -1), dim=-1)
            blocks.append((z_new, lam))
        (z_x, l_x), (z_u, l_u) = blocks
        return (z_x, z_u, l_x, l_u), X, U, prim, dual

    @full_f32_matmul()
    def forward(self, params):
        batch = tree_leaves(params)[0].shape[0]
        like = dict(dtype=self.l_inv.dtype, device=self.l_inv.device)
        Nd, Nm, p1 = self.Su.shape[0], self.Su.shape[1], self.p + 1
        z_x = torch.zeros((batch, Nd, p1), **like)
        z_u = torch.zeros((batch, Nm, p1), **like)
        state = (z_x, z_u, torch.zeros_like(z_x), torch.zeros_like(z_u))
        U = z_u
        if self.tol <= 0.0:
            for _ in range(self.n_iters):
                state, _, U, _, _ = self.iteration(state, params)
        else:
            # per-instance early stop: a frozen instance keeps its iterates;
            # the loop ends once every instance is frozen or at n_iters
            done = torch.zeros(batch, dtype=torch.bool, device=like["device"])
            for _ in range(self.n_iters):
                if bool(done.all()):
                    break
                new, _, nU, prim, dual = self.iteration(state, params)
                keep = done[:, None, None]
                state = tuple(torch.where(keep, o, n) for o, n in zip(state, new))
                U = torch.where(keep, U, nU)
                done = done | ((prim < self.tol) & (dual < self.tol))
        du = U[:, :, 0]
        phi_u = torch.cat(
            [U[:, :, 1:p1], self.PHI_unc[:, self.p:].expand(batch, -1, -1)], dim=-1
        )
        return du, phi_u, U


def make_batched_sls_admm(
    A,
    B,
    cost: QuadCost,
    project_x: Optional[Callable] = None,
    project_u: Optional[Callable] = None,
    rho_x=None,
    rho_u=None,
    robust_dim: Optional[int] = None,
    n_iters: int = 100,
    alpha: float = 1.0,
    tol: float = 0.0,
    *,
    device=None,
    dtype: torch.dtype | None = None,
) -> BatchedSLSADMM:
    """Build a batched robust SLS-ADMM solver (the plain torch fleet).

    The arguments are those of the JAX `make_batched_sls_admm`, with
    `device` (default: the CUDA card) and `dtype` (default: A's dtype)
    added. tol = 0 runs exactly
    n_iters iterations; tol > 0 freezes an instance once its Frobenius
    primal residual ||x_iter - z|| and dual residual ||z - z_prev||
    (summed over the enabled blocks) are both below tol, and stops when
    every instance is frozen or at n_iters.

    project_x / project_u map (batch, N*dim, p+1) tensors and the
    per-instance `params` (a tensor, or nested tuples, lists and dicts
    of tensors, with a leading batch axis) to the constraint sets:
    proj(y, params) -> y projected.

    The setup runs in f64 on the host from the data rounded to `dtype`
    and is cast to `dtype` once. Returns solve(params) -> (du (batch,
    Nm), phi_u (batch, Nm, Nd), U (batch, Nm, p+1)).
    """
    device = resolve_device(device)
    validate_constraint_blocks(project_x, rho_x, project_u, rho_u)
    if project_x is None and project_u is None:
        raise ValueError("at least one projection required")
    dtype = torch.as_tensor(A).dtype if dtype is None else dtype
    A, B, cost = host_f64(A, B, cost, dtype)
    N, d, m = A.shape[0], A.shape[-1], B.shape[-1]
    p = d // 2 if robust_dim is None else robust_dim
    f64 = torch.float64

    with full_f32_matmul():
        PHI_unc, _ = lqt_solve_sls(A, B, cost)
        Su = build_Su(A, B)
        Sx = build_Sx(A, p).reshape(-1, p)
        SuTQ = Su.T @ block_diag_stacked(cost.Q)
        l_side = SuTQ @ Su + block_diag_stacked(cost.R)
        r_fb = -SuTQ @ Sx
        ops = dict(SuTQr=None, Rr_l=None)
        if project_x is not None:
            Qr = broadcast_rho(rho_x, d, N, dtype).to(f64)
            ops["SuTQr"] = Su.T @ block_diag_stacked(Qr)
            l_side = l_side + ops["SuTQr"] @ Su
            r_fb = r_fb - ops["SuTQr"] @ Sx
        if project_u is not None:
            ops["Rr_l"] = block_diag_stacked(broadcast_rho(rho_u, m, N, dtype).to(f64))
            l_side = l_side + ops["Rr_l"]
        r_ff = SuTQ @ cost.lifted_xd()
        ops.update(
            PHI_unc=PHI_unc, Su=Su, Sx=Sx, l_inv=torch.linalg.inv(l_side),
            r_base=torch.cat([r_ff[:, None], r_fb], dim=-1),
        )
    ops = {k: None if v is None else v.to(device=device, dtype=dtype).contiguous()
           for k, v in ops.items()}
    return BatchedSLSADMM(ops, project_x, project_u, p, n_iters, alpha, float(tol))
