"""Lifted causal response operators Sw, Su.

Counterpart of `ilqr_admm_tpu/ops/lifted.py`. The JAX scans become
Python loops over t; every product runs in full f32 (or f64).

Conventions: A (N, x, x), B (N, x, u); trajectory x_0..x_{N-1} with
x_{t+1} = A_t x_t + B_t u_t; lifted vectors stack timesteps first.
Block (i, j) of Sw is A_{i-1}···A_j (I on the diagonal); block (i, j) of
Su is A_{i-1}···A_{j+1} B_j for i > j.
"""

from __future__ import annotations

import torch

from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


@full_f32_matmul()
def sw_x0(A: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """Free response Sw[:, :x_dim] @ x0 as a trajectory (N, x_dim)."""
    xs = []
    x = x0
    for At in A:
        xs.append(x)
        x = At @ x
    return torch.stack(xs)


@full_f32_matmul()
def su_apply(A: torch.Tensor, B: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """Su @ u as a trajectory: forced response from zero state.

    us: (N, u_dim) -> (N, x_dim). x_0 = 0; x_{t+1} = A_t x_t + B_t u_t.
    """
    x = torch.zeros(A.shape[-1], dtype=A.dtype, device=A.device)
    xs = []
    for At, Bt, ut in zip(A, B, us):
        xs.append(x)
        x = At @ x + Bt @ ut
    return torch.stack(xs)


@full_f32_matmul()
def su_t_apply(A: torch.Tensor, B: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
    """Adjoint Su^T @ v: (N, x_dim) -> (N, u_dim).

    (Su^T v)_j = B_j^T p_{j+1} with the costate recursion
    p_t = v_t + A_t^T p_{t+1}, p_N = 0.
    """
    N = A.shape[0]
    p = torch.zeros(A.shape[-1], dtype=A.dtype, device=A.device)
    outs = [None] * N
    for t in range(N - 1, -1, -1):
        outs[t] = B[t].T @ p  # p here is p_{t+1}
        p = vs[t] + A[t].T @ p
    return torch.stack(outs)


@full_f32_matmul()
def build_Sx(A: torch.Tensor, p: int | None = None) -> torch.Tensor:
    """First p columns of Sw as stacked blocks: (N, x_dim, p)."""
    d = A.shape[-1]
    p = d if p is None else p
    M = torch.eye(d, dtype=A.dtype, device=A.device)[:, :p]
    Ms = []
    for At in A:
        Ms.append(M)
        M = At @ M
    return torch.stack(Ms)


@full_f32_matmul()
def build_Sw(A: torch.Tensor) -> torch.Tensor:
    """Dense lifted Sw: (N*x, N*x), one row block per step."""
    N, d, _ = A.shape
    eye = torch.eye(d, dtype=A.dtype, device=A.device)
    row = torch.zeros((d, N * d), dtype=A.dtype, device=A.device)
    row[:, :d] = eye
    rows = [row]
    for t in range(1, N):
        row = A[t - 1] @ row
        row[:, t * d : (t + 1) * d] += eye
        rows.append(row)
    return torch.stack(rows).reshape(N * d, N * d)


def _build_Su_seq(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Sequential row-block recursion (N steps)."""
    N, d, _ = A.shape
    m = B.shape[-1]
    row = torch.zeros((d, N * m), dtype=A.dtype, device=A.device)
    rows = [row]
    for t in range(1, N):
        row = A[t - 1] @ row
        row[:, (t - 1) * m : t * m] += B[t - 1]
        rows.append(row)
    return torch.stack(rows).reshape(N * d, N * m)


def _pick_block(N: int) -> int:
    """Largest divisor of N not exceeding ~sqrt-scale (32)."""
    for L in (32, 25, 20, 16, 10, 8, 5, 4):
        if N % L == 0 and L < N:
            return L
    return 0


@full_f32_matmul()
def build_Su(A: torch.Tensor, B: torch.Tensor, block_size: int | None = None) -> torch.Tensor:
    """Dense lifted Su: (N*x, N*u); block (i, j) = A_{i-1}···A_{j+1} B_j.

    Two-level blocked construction, L + N/L sequential steps instead of N:

    - level 1 (L steps, batched over the N/L blocks): per block, the
      within-block local rows, the entry-to-row transitions
      G_i = A_{i-1}···A_{block start}, the block transition Phi, and the
      block-exit input response E;
    - level 2 (N/L steps): propagate the block-entry state response S
      across blocks (S' = Phi S + E) and complete each row as G_i S + local.

    Exact up to fp reassociation. block_size=None picks a divisor of N
    near 32 and keeps the sequential build for N <= 256 (the JAX
    package's cut-over); 0 forces sequential.
    """
    N, d, _ = A.shape
    m = B.shape[-1]
    L = _pick_block(N) if block_size is None else block_size
    if L <= 1 or N % L != 0 or (block_size is None and N <= 256) or N <= 64:
        return _build_Su_seq(A, B)
    P = N // L
    Lm = L * m

    Ab = A.reshape(P, L, d, d)
    Bb = B.reshape(P, L, d, m)

    # level 1, batched over the P blocks
    row = torch.zeros((P, d, Lm), dtype=A.dtype, device=A.device)
    G = torch.eye(d, dtype=A.dtype, device=A.device).expand(P, d, d)
    local, Gs = [row], [G]
    for t in range(1, L):
        row = Ab[:, t - 1] @ row
        row[:, :, (t - 1) * m : t * m] += Bb[:, t - 1]
        G = Ab[:, t - 1] @ G
        local.append(row)
        Gs.append(G)
    local = torch.stack(local, dim=1)  # (P, L, d, Lm)
    Gs = torch.stack(Gs, dim=1)  # (P, L, d, d)
    A_end, B_end = Ab[:, -1], Bb[:, -1]
    E = A_end @ row
    E[:, :, (L - 1) * m :] += B_end  # (P, d, Lm)
    Phi = A_end @ G  # (P, d, d)

    # level 2: N/L sequential block steps
    S = torch.zeros((d, N * m), dtype=A.dtype, device=A.device)
    R = []
    for b in range(P):
        cols = slice(b * Lm, (b + 1) * Lm)
        Rb = torch.einsum("lde,ef->ldf", Gs[b], S)  # (L, d, N*m)
        Rb[:, :, cols] += local[b]
        S = Phi[b] @ S
        S[:, cols] += E[b]
        R.append(Rb)
    return torch.stack(R).reshape(N * d, N * m)
