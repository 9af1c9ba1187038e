"""LQT helpers (counterpart of part of `ilqr_admm_tpu/solvers/lqt.py`).

Only the penalty broadcast and the block-diagonal lift are ported; the
batch, DP and SLS solvers come with a later slice.
"""

from __future__ import annotations

import torch


def broadcast_rho(rho, dim: int, N: int, dtype: torch.dtype | None = None, device=None):
    """Broadcast an ADMM penalty spec to stacked (N, dim, dim) blocks.

    Accepts: None | scalar | (dim, dim) | (N, dim, dim). Returns None or
    an (N, dim, dim) tensor.
    """
    if rho is None:
        return None
    rho = torch.as_tensor(rho, dtype=dtype, device=device)
    if rho.ndim == 0:
        eye = torch.eye(dim, dtype=rho.dtype, device=rho.device)
        return (rho * eye).expand(N, dim, dim)
    if rho.ndim == 2:
        return rho.expand(N, dim, dim)
    return rho


def block_diag_stacked(blocks: torch.Tensor) -> torch.Tensor:
    """Dense block-diagonal (N*d, N*d) from stacked (N, d, d) blocks."""
    return torch.block_diag(*blocks)
