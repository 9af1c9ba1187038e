"""Solution certificates of the box-constrained LQT-ADMM fleet.

Counterpart of the certificate section of the repository's `bench.py`
(`_oracle_cost_gap` and the gates after it): feasibility of the
projected iterate, the fraction of instances at the reference primal
tolerance, and the relative cost gap against a float64 L-BFGS-B oracle
on a subsample. Built on the port's own `build_Su` and `sw_x0`.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import minimize

from ilqr_admm_tpu_torch.ops.lifted import build_Su, sw_x0
from ilqr_admm_tpu_torch.problem import QuadCost
from ilqr_admm_tpu_torch.solvers.lqt import block_diag_stacked

# The gates of bench.py: every oracle-checked instance (the first 64)
# within 1e-4 of the optimum, 99% of instances at the 1e-4 primal
# tolerance, no violation.
PRIMAL_TOL = 1e-4
MIN_CONVERGED_FRAC = 0.99
MAX_COST_GAP = 1e-4
N_ORACLE = 64


def _f64(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float64)


def max_violation(z_u, u_lower, u_upper) -> float:
    """Largest bound violation of the projected iterate (0 when feasible)."""
    z = _f64(z_u)
    over = torch.clamp(z - _f64(u_upper), min=0.0)
    under = torch.clamp(_f64(u_lower) - z, min=0.0)
    return float(torch.max(torch.maximum(over, under)))


def converged_frac(u, z_u) -> float:
    """Fraction of instances whose primal residual ||u - z_u|| is below PRIMAL_TOL."""
    prim = torch.linalg.vector_norm(_f64(u) - _f64(z_u), dim=-1)
    return float(torch.mean((prim < PRIMAL_TOL).to(torch.float64)))


def oracle_cost_gap(A, B, cost: QuadCost, x0s, z_u, u_lower, u_upper):
    """Relative cost gap of feasible z-iterates against a float64 oracle.

    The problem data are lifted exactly to f64 and each instance,
    min_u u^T M u - 2 r^T u subject to the box, is solved with L-BFGS-B.
    Returns (median, max) of (J(z) - J(u*)) / |J(u*)|.
    """
    A, B = _f64(A), _f64(B)
    Su = build_Su(A, B).numpy()
    Q = block_diag_stacked(_f64(cost.Q)).numpy()
    R = block_diag_stacked(_f64(cost.R)).numpy()
    xd = _f64(cost.lifted_xd()).numpy()
    M = Su.T @ Q @ Su + R
    dim = M.shape[0]
    lo = np.broadcast_to(_f64(u_lower).numpy(), (dim,))
    hi = np.broadcast_to(_f64(u_upper).numpy(), (dim,))
    bounds = list(zip(lo, hi))

    gaps = []
    for x0, z in zip(_f64(x0s), _f64(z_u).numpy()):
        free = sw_x0(A, x0).reshape(-1).numpy()
        r = Su.T @ (Q @ (xd - free))
        const = (free - xd) @ Q @ (free - xd)

        def f_and_g(v):
            Mv = M @ v
            return v @ Mv - 2.0 * r @ v, 2.0 * (Mv - r)

        res = minimize(
            f_and_g, z, jac=True, method="L-BFGS-B", bounds=bounds,
            options={"ftol": 1e-16, "gtol": 1e-12, "maxiter": 2000},
        )
        j_opt = res.fun + const
        j_z = z @ (M @ z) - 2.0 * r @ z + const
        gaps.append((j_z - j_opt) / max(abs(j_opt), 1e-12))
    gaps = np.asarray(gaps)
    return float(np.median(gaps)), float(np.max(gaps))


def certify(A, B, cost: QuadCost, x0s, u, z_u, u_lower, u_upper) -> dict:
    """All certificates of one fleet solve; the oracle sees the first N_ORACLE."""
    gap_med, gap_max = oracle_cost_gap(
        A, B, cost, x0s[:N_ORACLE], z_u[:N_ORACLE], u_lower, u_upper
    )
    return {
        "max_violation": max_violation(z_u, u_lower, u_upper),
        "converged_frac": converged_frac(u, z_u),
        "cost_gap_median": gap_med,
        "cost_gap_max": gap_max,
    }


def gate_failures(cert: dict) -> list[str]:
    """The bench gates a certificate misses; empty when it passes."""
    failures = []
    if not cert["max_violation"] == 0.0:
        failures.append(f"infeasible z-iterate: max_violation {cert['max_violation']}")
    if not cert["converged_frac"] >= MIN_CONVERGED_FRAC:
        failures.append(f"converged_frac {cert['converged_frac']} < {MIN_CONVERGED_FRAC}")
    for key in ("cost_gap_median", "cost_gap_max"):
        if not cert[key] <= MAX_COST_GAP:
            failures.append(f"{key} {cert[key]} > {MAX_COST_GAP}")
    return failures
