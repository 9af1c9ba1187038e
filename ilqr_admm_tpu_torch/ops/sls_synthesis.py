"""SLS response-map synthesis via a time-reversed Cholesky factorization.

Counterpart of `ilqr_admm_tpu/ops/sls_synthesis.py`. The trailing
principal submatrices l_side[s:, s:] of the lifted normal matrix are the
leading principal submatrices of the index-reversed l_side[::-1, ::-1],
so one Cholesky factor of the reversed matrix serves all N trailing
systems: each per-timestep solve is a pair of masked triangular solves
with that one factor (`torch.linalg.solve_triangular`, batched over the
right-hand sides).

Masking argument: a forward solve Lr z = b with b supported on rows < s
gives z[:s] from Lr[:s, :s] alone; zeroing z[s:] and back-solving
Lr^T y = z gives y[s:] = 0 and y[:s] the leading-subsystem solution.
"""

from __future__ import annotations

import torch

from ilqr_admm_tpu_torch.utils.precision import full_f32_matmul


@full_f32_matmul()
def causal_cholesky_factors(l_side: torch.Tensor) -> torch.Tensor:
    """Lower-triangular Lr with Lr Lr^T = l_side[::-1, ::-1]."""
    return torch.linalg.cholesky(torch.flip(l_side, dims=(0, 1)))


@full_f32_matmul()
def causal_trailing_solve(Lr: torch.Tensor, rhs: torch.Tensor, starts) -> torch.Tensor:
    """Batched solve of the trailing systems l_side[s_i:, s_i:] y = rhs_i[s_i:].

    Lr: (M, M) from `causal_cholesky_factors`. rhs: (nb, M, c) in the
    original (unreversed) row order; rows < starts[i] of rhs_i are
    ignored. starts: (nb,) row offsets. Returns y (nb, M, c) in the
    original row order with y[i, :starts[i]] = 0.
    """
    M = Lr.shape[0]
    starts = torch.as_tensor(starts, device=rhs.device)
    rows = torch.arange(M, device=rhs.device)
    # reversed rows: the trailing rows [s:] are the leading rows [:M - s]
    mask = (rows[None, :] < (M - starts)[:, None]).to(rhs.dtype)[:, :, None]
    z = torch.linalg.solve_triangular(Lr, torch.flip(rhs, dims=(1,)) * mask, upper=False)
    y_rev = torch.linalg.solve_triangular(Lr.T, z * mask, upper=True)
    return torch.flip(y_rev * mask, dims=(1,))


@full_f32_matmul()
def sls_synthesize(l_side, r_side_ff, r_side_fb, u_dim: int, x_dim: int):
    """Unconstrained SLS synthesis: feedforward du and causal feedback Phi_u.

    l_side: (M, M), M = N*u_dim, Su^T Q Su + R (+ regularizers);
    r_side_ff: (M,), Su^T Q xd; r_side_fb: (M, N*x_dim), -Su^T Q Sw.
    Returns (PHI_U (M, N*x_dim), du (M,)).
    """
    M = l_side.shape[0]
    N = M // u_dim
    Lr = causal_cholesky_factors(l_side)
    du = causal_trailing_solve(Lr, r_side_ff[None, :, None], [0])[0, :, 0]
    # one (M, x_dim) column block per timestep, trailing start i * u_dim
    rhs = r_side_fb.reshape(M, N, x_dim).permute(1, 0, 2)
    starts = torch.arange(N, device=l_side.device) * u_dim
    cols = causal_trailing_solve(Lr, rhs, starts)
    return cols.permute(1, 0, 2).reshape(M, N * x_dim), du
