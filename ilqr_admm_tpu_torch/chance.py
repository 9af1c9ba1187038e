"""Joint chance-constraint calibration (counterpart of `ilqr_admm_tpu/chance.py`).

The reference asks for a *per-row* confidence level and hand-built SOC
projection data; the joint (whole-trajectory) success probability is
then an uncalibrated by-product. This module takes the joint level:

    proj_u, cal = make_box_chance_projection(
        var=0.1, robust_dim=3, lower=-6.0, upper=6.0,
        joint_alpha=0.958, n_rows=N * m, shifted=True)

A row phi = [ff, resp_1..resp_p] of the decision matrix [du | Phi_u]
must satisfy P(phi^T [1; delta] <= hi) >= alpha_row with delta ~ N(0,
diag(var)): the SOC ||diag(sqrt(var)) phi|| <= (hi - ff) / psi_inv,
psi_inv = Psi^-1(alpha_row), one `project_soc_unit` preimage a side,
intersected by `project_set_convex`.

The tightening psi_inv comes from the joint level by one of three
corrections:

- chi (default): every row shares the same initial-state deviation, so
  all SOC rows hold at once on the event ||diag(var)^{-1/2} delta|| <=
  psi, whatever the number of rows: psi = chi_p^{-1}(joint_alpha);
- sidak: alpha_row = joint_alpha^(1/k) over the k = n_rows x sides
  one-sided rows (exact for independent row noise);
- bonferroni: the union bound alpha_row = 1 - (1 - joint_alpha) / k.

For sidak and bonferroni, `count_binding_rows` gives a sharper count for
a second pass. The SOC data are tensors on the device and in the dtype
the caller names (the card unless told otherwise); nothing is built at
import.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from scipy.stats import chi, norm

from ilqr_admm_tpu_torch.projections import project_set_convex, project_soc_unit
from ilqr_admm_tpu_torch.utils.device import resolve_device


class ChanceCalibration(NamedTuple):
    """Resolved calibration: the per-row confidence derived from the joint."""

    alpha_row: float  # per-row, per-side confidence level
    psi_inv: float  # Psi^-1(alpha_row), the SOC tightening factor
    n_constraints: int  # one-sided rows the correction covered
    joint_alpha: Optional[float]  # requested joint level (None if direct)


def per_row_confidence(joint_alpha: float, n_constraints: int, method: str = "sidak") -> float:
    """Per-row confidence whose n_constraints-fold intersection holds
    jointly with probability >= joint_alpha (under independence for
    'sidak', unconditionally for 'bonferroni')."""
    if not 0.0 < joint_alpha < 1.0:
        raise ValueError(f"joint_alpha must be in (0,1), got {joint_alpha}")
    if n_constraints < 1:
        raise ValueError(f"n_constraints must be >= 1, got {n_constraints}")
    if method == "sidak":
        return float(joint_alpha ** (1.0 / n_constraints))
    if method == "bonferroni":
        return float(1.0 - (1.0 - joint_alpha) / n_constraints)
    raise ValueError(f"unknown calibration method: {method!r}")


def calibrate(
    joint_alpha: Optional[float] = None,
    alpha_row: Optional[float] = None,
    n_rows: Optional[int] = None,
    sides: int = 2,
    method: str = "chi",
    robust_dim: Optional[int] = None,
) -> ChanceCalibration:
    """Resolve (joint_alpha | alpha_row) into a ChanceCalibration.

    method='chi' (default) is the shared-uncertainty ball certificate
    psi = chi_{robust_dim}^{-1}(joint_alpha), sound for any number of
    rows; 'sidak' and 'bonferroni' correct per-row levels over n_rows x
    sides one-sided constraints.
    """
    if (joint_alpha is None) == (alpha_row is None):
        raise ValueError("pass exactly one of joint_alpha / alpha_row")
    if joint_alpha is None:
        if not 0.5 < alpha_row < 1.0:
            # psi_inv = Psi^-1(alpha_row) must be > 0: soc_box_rows divides
            # by it, so alpha_row <= 0.5 would build sign-flipped or
            # inf/NaN SOC sets
            raise ValueError(f"alpha_row must be in (0.5, 1), got {alpha_row}")
        k = int(n_rows or 0) * int(sides)
        return ChanceCalibration(alpha_row=float(alpha_row), psi_inv=float(norm.ppf(alpha_row)),
                                 n_constraints=k, joint_alpha=None)
    if method == "chi":
        if robust_dim is None:
            raise ValueError("chi calibration requires robust_dim")
        if not 0.0 < joint_alpha < 1.0:
            raise ValueError(f"joint_alpha must be in (0,1), got {joint_alpha}")
        psi_inv = float(chi.ppf(joint_alpha, df=int(robust_dim)))
        return ChanceCalibration(
            alpha_row=float(norm.cdf(psi_inv)),  # the implied per-row level
            psi_inv=psi_inv,
            n_constraints=0,  # the row count does not enter the certificate
            joint_alpha=joint_alpha,
        )
    if n_rows is None:
        raise ValueError(f"{method!r} calibration requires n_rows")
    k = int(n_rows) * int(sides)
    alpha_row = per_row_confidence(joint_alpha, k, method)
    return ChanceCalibration(alpha_row=float(alpha_row), psi_inv=float(norm.ppf(alpha_row)),
                             n_constraints=k, joint_alpha=joint_alpha)


def soc_box_rows(var, robust_dim: int, lower, upper, psi_inv: float, *, device=None,
                 dtype: torch.dtype = torch.float64):
    """SOC data (As, bs, projections) for box chance constraints on rows
    [ff | resp_1..resp_p] under delta ~ N(0, diag(var)).

    var: scalar or (robust_dim,) variances of the robust coordinates.
    lower / upper: the bounds (None disables that side). device: where
    the As and bs live (default the CUDA card).
    """
    kw = dict(dtype=dtype, device=resolve_device(device))
    p = int(robust_dim)
    var = np.broadcast_to(np.asarray(var, np.float64), (p,))
    mu = np.zeros(p + 1)
    mu[0] = 1.0
    Adiag = np.diag(np.sqrt(np.concatenate([[0.0], var])))
    As, bs = [], []
    if upper is not None:
        As.append(torch.tensor(np.concatenate([Adiag, (-mu / psi_inv)[None]], 0), **kw))
        bs.append(torch.tensor(np.append(np.zeros(p + 1), float(upper) / psi_inv), **kw))
    if lower is not None:
        As.append(torch.tensor(np.concatenate([Adiag, (mu / psi_inv)[None]], 0), **kw))
        bs.append(torch.tensor(np.append(np.zeros(p + 1), -float(lower) / psi_inv), **kw))
    if not As:
        raise ValueError("at least one of lower/upper required")
    return As, bs, [project_soc_unit] * len(As)


def make_box_chance_projection(
    var,
    robust_dim: int,
    lower=None,
    upper=None,
    *,
    joint_alpha: Optional[float] = None,
    alpha_row: Optional[float] = None,
    n_rows: Optional[int] = None,
    method: str = "chi",
    shifted: bool = False,
    rho: float = 1e1,
    max_iter: int = 100,
    threshold: float = 1e-4,
    device=None,
    dtype: torch.dtype = torch.float64,
):
    """A chance-constrained box projection for sls_admm / isls_admm.

    Returns (proj, ChanceCalibration). shifted=False gives the `sls_admm`
    form proj(y) over absolute rows; shifted=True the `isls_admm` form
    proj(y, u_nom), which shifts the feedforward column into absolute
    coordinates around the nominal (reference `isls.py:641,649`).

    Pass joint_alpha (with the default method='chi' nothing else is
    needed; 'sidak' and 'bonferroni' also need n_rows, the number of
    decision rows, e.g. N*u_dim for control bounds) or a direct
    alpha_row. device and dtype: those of the rows the projection will
    take (default the CUDA card, float64).
    """
    sides = (lower is not None) + (upper is not None)
    cal = calibrate(joint_alpha, alpha_row, n_rows, sides, method, robust_dim=robust_dim)
    As, bs, projs = soc_box_rows(var, robust_dim, lower, upper, cal.psi_inv, device=device,
                                 dtype=dtype)

    def _project(y):
        return project_set_convex(y, As, bs, projs, rho=rho, max_iter=max_iter,
                                  threshold=threshold)

    if shifted:

        def proj(y, u_nom):
            shift = torch.zeros_like(y)
            shift[:, 0] = u_nom.reshape(-1)
            return _project(y + shift) - shift

    else:

        def proj(y):
            return _project(y)

    return proj, cal


def make_state_box_chance_projection(
    var,
    robust_dim: int,
    N: int,
    x_dim: int,
    bounds: dict,
    *,
    joint_alpha: Optional[float] = None,
    alpha_row: Optional[float] = None,
    n_rows: Optional[int] = None,
    method: str = "chi",
    rho: float = 1e1,
    max_iter: int = 20,
    threshold: float = 1e-2,
    device=None,
    dtype: torch.dtype = torch.float64,
):
    """A chance-constrained STATE box projection for `sls_admm`'s x-block.

    bounds = {(t, i): (lower, upper), ...} maps (timestep,
    state-coordinate) to bounds (lower == upper pins the row, e.g. a
    terminal state). Returns (proj, ChanceCalibration); proj(y) over the
    (N*x_dim, robust_dim+1) x-block projects each constrained row onto
    its SOC intersection and passes the others through. Calibration as
    in `make_box_chance_projection`.
    """
    cal = calibrate(joint_alpha, alpha_row, n_rows or len(bounds), 2, method,
                    robust_dim=robust_dim)
    row_projs = []
    for (t, i), (lower, upper) in sorted(bounds.items()):
        if not (0 <= t < N and 0 <= i < x_dim):
            raise ValueError(f"row ({t}, {i}) outside (N={N}, x_dim={x_dim})")
        As, bs, projs = soc_box_rows(var, robust_dim, lower, upper, cal.psi_inv, device=device,
                                     dtype=dtype)
        row_projs.append((t * x_dim + i, As, bs, projs))

    def proj(y):
        y = y.clone()
        for idx, As, bs, projs in row_projs:
            y[idx : idx + 1] = project_set_convex(y[idx : idx + 1], As, bs, projs, rho=rho,
                                                  max_iter=max_iter, threshold=threshold)
        return y

    return proj, cal


def count_binding_rows(ff_abs, phi, var, lower=None, upper=None, psi_inv: float = 0.0,
                       slack: float = 0.25) -> int:
    """Number of one-sided chance rows binding at a solution, the count for
    a second, sharper Sidak pass: a side binds when its z-score (bound -
    ff) / spread is within (1 + slack) psi_inv; rows with ~zero spread
    never bind. Takes arrays or host tensors."""
    ff_abs = np.asarray(ff_abs, np.float64).reshape(-1)
    phi = np.asarray(phi, np.float64).reshape(len(ff_abs), -1)
    var = np.broadcast_to(np.asarray(var, np.float64), (phi.shape[-1],))
    spread = np.sqrt(np.maximum((phi**2 * var[None]).sum(-1), 1e-24))
    n = 0
    if upper is not None:
        n += int(((float(upper) - ff_abs) / spread <= (1 + slack) * psi_inv).sum())
    if lower is not None:
        n += int(((ff_abs - float(lower)) / spread <= (1 + slack) * psi_inv).sum())
    return max(n, 1)
