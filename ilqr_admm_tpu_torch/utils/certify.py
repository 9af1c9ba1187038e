"""Solution certificates of the port's fleets.

The box-constrained LQT-ADMM fleet: counterpart of the certificate
section of the repository's `bench.py` (`_oracle_cost_gap` and the gates
after it): feasibility of the projected iterate, the fraction of
instances at the reference primal tolerance, and the relative cost gap
against a float64 L-BFGS-B oracle on a subsample.

The robust SLS fleet: counterpart of `benchmarks/_oracles.py`
(`_project_diamond`, `sls_qp`) and the gates of
`benchmarks/bench_pallas_sls.py`: the distance of each reported U to its
exact f64 diamond projection, and the relative cost gap of that
projection against a float64 trust-constr QP oracle on a subsample
spread over the fleet.

The state-bounded LQT fleet: feasibility of both projected iterates, the
fraction of instances with both primal residuals at the reference
tolerance, and the relative cost gap against a float64 QP oracle with the
state box as linear constraints, on a subsample spread over the fleet.

The time-parallel Riccati: the gates of `tests/test_pallas_riccati.py`
(K, k and Quu against a float64 sequential `lqt_backward` of the same
f32-rounded problem) and the tracking cost of the closed loop the gains
drive, against the f64 optimum's.

The 3DoF arm iLQR-ADMM fleet: counterpart of `benchmarks/_oracles.py`
(`arm_polish`), `benchmarks/_certify.py` (`gaps`) and the gates of
`benchmarks/bench_arm_admm.py`: the fraction of converged instances, the
bound violation, the fraction with an active bound, and the relative gap
of clip(u)'s f64 cost against a bounded L-BFGS-B polish from it (a
local-optimality certificate: the task is nonconvex).

Built on the port's own `build_Su`, `build_Sx` and `sw_x0`; no jax.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from scipy.optimize import LinearConstraint, minimize

from ilqr_admm_tpu_torch.ops.lifted import build_Su, build_Sx, sw_x0
from ilqr_admm_tpu_torch.ops.parallel_riccati import rollout_closed_loop_parallel
from ilqr_admm_tpu_torch.ops.riccati import lqt_backward
from ilqr_admm_tpu_torch.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu_torch.problem import QuadCost, SolveStatus
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
    """Largest bound violation of a projected iterate (0 when feasible);
    bounds are scalars or vectors, +-inf where free."""
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


# The state-bounded LQT fleet: no violation of either projected iterate,
# 99% of instances with both primal residuals below 1e-4, and an oracle
# cost gap of at most 1e-4 (median and max) on 16 instances, as in
# bench.py's gates.
STATE_BOX_N_ORACLE = 16


def state_box_qp(A, B, cost: QuadCost, x0s, z_u, u_lower, u_upper, x_lower, x_upper,
                 maxiter: int = 1000) -> dict:
    """The exact convex oracle of the state-bounded LQT fleet, per instance.

    Minimizes u^T M u - 2 r^T u (M = Su^T Q Su + R, r = Su^T Q (xd - free))
    subject to the box on u and the finite rows of the state box on
    free + Su u, in f64 with scipy's SLSQP (an active-set method, exact on
    a QP). It starts from the unconstrained optimum clipped to the control
    box, which does not depend on the iterate under test. trust-constr
    reaches the same optimum at about 30 times the cost (6-12 s an
    instance at N = 100 on a CPU). SLSQP's own stopping test is kept at
    ftol = 1e-12: tighter, it reports a line-search failure (status 8) at
    the optimum on some instances.

    Returns j_z = J(z_u), j_star = J at the oracle's optimum (J the
    tracking cost, constant included), state_violation = the largest
    excursion of free + Su z_u outside the state box, and success and
    message: scipy's verdict on each instance. An instance whose oracle
    did not succeed certifies nothing.
    """
    A, B = _f64(A), _f64(B)
    Su = build_Su(A, B).numpy()
    Q = block_diag_stacked(_f64(cost.Q)).numpy()
    R = block_diag_stacked(_f64(cost.R)).numpy()
    xd = _f64(cost.lifted_xd()).numpy()
    M = Su.T @ Q @ Su + R
    Nd, Nm = Su.shape
    ulo = np.broadcast_to(_f64(u_lower).numpy(), (Nm,))
    uhi = np.broadcast_to(_f64(u_upper).numpy(), (Nm,))
    xlo = np.broadcast_to(_f64(x_lower).numpy(), (Nd,))
    xhi = np.broadcast_to(_f64(x_upper).numpy(), (Nd,))

    x0s, z_u = _f64(x0s), _f64(z_u).numpy()
    j_z, j_star, viol = (np.zeros(len(z_u)) for _ in range(3))
    success, message = np.zeros(len(z_u), bool), []
    for i, (x0, z) in enumerate(zip(x0s, z_u)):
        free = sw_x0(A, x0).reshape(-1).numpy()
        r = Su.T @ (Q @ (xd - free))
        const = (free - xd) @ Q @ (free - xd)
        x_z = free + Su @ z
        viol[i] = max(float(np.max(np.maximum(x_z - xhi, xlo - x_z))), 0.0)
        # one-sided rows c(v) >= 0 for each finite side of the state box
        cons = []
        for sign, lim in ((1.0, xhi), (-1.0, xlo)):
            k = np.isfinite(lim)
            if not k.any():
                continue
            S, b = sign * Su[k], sign * (lim[k] - free[k])
            cons.append({"type": "ineq", "fun": lambda v, S=S, b=b: b - S @ v,
                         "jac": lambda v, S=S: -S})
        res = minimize(
            lambda v: v @ (M @ v) - 2.0 * r @ v, np.clip(np.linalg.solve(M, r), ulo, uhi),
            jac=lambda v: 2.0 * (M @ v - r), method="SLSQP", bounds=list(zip(ulo, uhi)),
            constraints=cons, options={"ftol": 1e-12, "maxiter": maxiter},
        )
        j_z[i] = z @ (M @ z) - 2.0 * r @ z + const
        j_star[i] = res.fun + const
        success[i] = res.success
        message.append(f"status {res.status}: {res.message}")
    return {"j_z": j_z, "j_star": j_star, "state_violation": viol, "success": success,
            "message": message}


def certify_state_box(A, B, cost: QuadCost, x0s, x, u, z_x, z_u, u_lower, u_upper, x_lower,
                      x_upper, n_oracle: int = STATE_BOX_N_ORACLE) -> dict:
    """All certificates of one state-bounded fleet solve.

    max_violation_x/u (of z_x and z_u against their boxes; 0 by
    construction) and converged_frac (both ||x - z_x|| and ||u - z_u||
    below PRIMAL_TOL) cover every instance. The oracle sees
    `oracle_indices(batch, n_oracle)` and gives |J(z_u) - J*| / |J*|: the
    absolute value because z_u may sit ~1e-6 outside the state box, whose
    excursion is reported beside the gap. oracle_failures lists each
    oracle instance where SLSQP did not succeed, with scipy's message.
    """
    prim_x = torch.linalg.vector_norm(_f64(x) - _f64(z_x), dim=-1)
    prim_u = torch.linalg.vector_norm(_f64(u) - _f64(z_u), dim=-1)
    conv = (prim_x < PRIMAL_TOL) & (prim_u < PRIMAL_TOL)
    idx = oracle_indices(len(conv), n_oracle)
    orc = state_box_qp(A, B, cost, _f64(x0s)[idx], _f64(z_u)[idx], u_lower, u_upper,
                       x_lower, x_upper)
    gaps = np.abs(orc["j_z"] - orc["j_star"]) / np.maximum(np.abs(orc["j_star"]), 1e-12)
    return {
        "max_violation_x": max_violation(z_x, x_lower, x_upper),
        "max_violation_u": max_violation(z_u, u_lower, u_upper),
        "converged_frac": float(torch.mean(conv.to(torch.float64))),
        "prim_x_max": float(prim_x.max()),
        "prim_u_max": float(prim_u.max()),
        "cost_gap_median": float(np.median(gaps)),
        "cost_gap_max": float(np.max(gaps)),
        "state_violation_max": float(orc["state_violation"].max()),
        "oracle_indices": idx.tolist(),
        "oracle_failures": [f"instance {int(i)}: {msg}" for i, ok, msg
                            in zip(idx, orc["success"], orc["message"]) if not ok],
    }


def state_box_gate_failures(cert: dict) -> list[str]:
    """The gates a state-bounded certificate misses; empty when it passes."""
    failures = [f"oracle failed on {f}" for f in cert["oracle_failures"]]
    for key in ("max_violation_x", "max_violation_u"):
        if not cert[key] == 0.0:
            failures.append(f"infeasible projected iterate: {key} {cert[key]}")
    if not cert["converged_frac"] >= MIN_CONVERGED_FRAC:
        failures.append(f"converged_frac {cert['converged_frac']} < {MIN_CONVERGED_FRAC}")
    for key in ("cost_gap_median", "cost_gap_max"):
        if not cert[key] <= MAX_COST_GAP:
            failures.append(f"{key} {cert[key]} > {MAX_COST_GAP}")
    return failures


# The gates of benchmarks/bench_pallas_sls.py:194-197: 99% of instances
# within 5e-3 of their diamond projection, and an oracle cost gap of at
# most 1e-4 (median) and 1e-3 (max) on 8 instances spread over the fleet.
SLS_PRIMAL_TOL = 5e-3
SLS_MAX_GAP_MEDIAN = 1e-4
SLS_MAX_GAP_MAX = 1e-3
SLS_N_ORACLE = 8


def project_diamond(v, c: float, r):
    """Exact projection of rows v = (a, b) onto {|a| + c |b| <= r}, in f64.

    v: (..., 2); r: the radius of each row, broadcastable to v's leading
    axes. Soft-thresholds v_i(l) = sign(v_i) max(|v_i| - l w_i, 0) with
    w = (1, c); the radius sum_i w_i |v_i(l)| is piecewise linear and
    decreasing in l, solved by 64 bisection steps.
    """
    v = np.asarray(v, np.float64)
    rows = v.reshape(-1, 2)
    r = np.broadcast_to(np.asarray(r, np.float64)[..., None], v.shape[:-1] + (1,)).reshape(-1)
    w = np.asarray([1.0, c])
    a = np.abs(rows)
    need = a @ w > r
    out = rows.copy()
    if np.any(need):
        av = a[need]
        lo = np.zeros(av.shape[0])
        hi = np.max(av / w, axis=1)
        for _ in range(64):
            mid = 0.5 * (lo + hi)
            too_big = np.maximum(av - mid[:, None] * w, 0.0) @ w > r[need]
            lo = np.where(too_big, mid, lo)
            hi = np.where(too_big, hi, mid)
        lam = 0.5 * (lo + hi)
        out[need] = np.sign(rows[need]) * np.maximum(av - lam[:, None] * w, 0.0)
    return out.reshape(v.shape)


def sls_primal_residuals(U, bounds, c: float) -> np.ndarray:
    """||U_i - P_diamond(U_i)|| of each instance; U (batch, Nm, 2), bounds (batch,)."""
    U = _f64(U).numpy()
    return np.linalg.norm((U - project_diamond(U, c, _f64(bounds).numpy()[:, None]))
                          .reshape(U.shape[0], -1), axis=-1)


def sls_qp(A, B, cost: QuadCost, bounds, U, c: float) -> dict:
    """The exact convex oracle of the robust SLS fleet, per instance.

    Minimizes J(du, phi) = (Su du - xd)' Q (Su du - xd) + du' R du
    + (Su phi + Sx)' Q (Su phi + Sx) + phi' R phi subject to
    |du_r| + c |phi_r| <= bound on every row, written as 4 linear
    constraints a row, with scipy trust-constr from the exact diamond
    projection z of the reported U (bounds (B,), U (B, Nm, 2)). Returns
    j_z = J(z), j_star = min(J at the oracle's optimum, j_z) and
    prim = ||U - z||.
    """
    A, B = _f64(A), _f64(B)
    Su = build_Su(A, B).numpy()
    Sx = build_Sx(A, 1).reshape(-1, 1)[:, 0].numpy()
    Ql = block_diag_stacked(_f64(cost.Q)).numpy()
    Rl = block_diag_stacked(_f64(cost.R)).numpy()
    xd = _f64(cost.lifted_xd()).numpy()
    bounds, U = _f64(bounds).numpy(), _f64(U).numpy()
    Nm = Su.shape[1]

    H = Su.T @ Ql @ Su + Rl  # shared curvature of both columns
    g_du = -Su.T @ (Ql @ xd)
    g_phi = Su.T @ (Ql @ Sx)
    const_du = xd @ Ql @ xd
    const_phi = Sx @ Ql @ Sx
    eye = np.eye(Nm)
    A_con = np.concatenate(
        [np.concatenate([sa * eye, sb * c * eye], axis=1)
         for sa, sb in ((1, 1), (1, -1), (-1, 1), (-1, -1))]
    )
    Hfull = np.zeros((2 * Nm, 2 * Nm))
    Hfull[:Nm, :Nm] = H
    Hfull[Nm:, Nm:] = H
    gfull = np.concatenate([g_du, g_phi])

    def j_of(du, phi):
        return (du @ H @ du + 2 * g_du @ du + const_du
                + phi @ H @ phi + 2 * g_phi @ phi + const_phi)

    def f(v):
        return v @ Hfull @ v + 2 * gfull @ v + const_du + const_phi

    def jac(v):
        return 2 * (Hfull @ v + gfull)

    j_z, j_star, prim = (np.zeros(len(bounds)) for _ in range(3))
    for i, r in enumerate(bounds):
        z = project_diamond(U[i], c, r)  # exact feasible iterate
        prim[i] = np.linalg.norm(U[i] - z)
        j_z[i] = j_of(z[:, 0], z[:, 1])
        res = minimize(
            f, z.T.reshape(-1),  # [du; phi], a feasible start
            jac=jac, method="trust-constr", hess=lambda v: 2 * Hfull,
            constraints=[LinearConstraint(A_con, -np.inf, float(r))],
            options={"gtol": 1e-12, "xtol": 1e-14, "maxiter": 3000},
        )
        j_star[i] = min(res.fun, j_z[i])
    return {"j_z": j_z, "j_star": j_star, "prim": prim}


def oracle_indices(batch: int, n: int = SLS_N_ORACLE) -> np.ndarray:
    """n instances spread evenly over the fleet (both ends of a sorted one)."""
    return np.linspace(0, batch - 1, n).astype(int)


def certify_sls(A, B, cost: QuadCost, bounds, U, c: float, n_oracle: int = SLS_N_ORACLE) -> dict:
    """All certificates of one robust SLS fleet solve (U (batch, Nm, 2)).

    converged_frac and prim_max cover every instance; the oracle sees
    `oracle_indices(batch, n_oracle)`.
    """
    prim = sls_primal_residuals(U, bounds, c)
    idx = oracle_indices(len(prim), n_oracle)
    orc = sls_qp(A, B, cost, _f64(bounds)[idx], _f64(U)[idx], c)
    gaps = (orc["j_z"] - orc["j_star"]) / np.maximum(np.abs(orc["j_star"]), 1e-12)
    return {
        "converged_frac": float(np.mean(prim < SLS_PRIMAL_TOL)),
        "prim_max": float(prim.max()),
        "cost_gap_median": float(np.median(gaps)),
        "cost_gap_max": float(np.max(gaps)),
        "oracle_indices": idx.tolist(),
    }


def sls_gate_failures(cert: dict) -> list[str]:
    """The SLS bench gates a certificate misses; empty when it passes."""
    failures = []
    if not cert["converged_frac"] >= MIN_CONVERGED_FRAC:
        failures.append(f"converged_frac {cert['converged_frac']} < {MIN_CONVERGED_FRAC}")
    if not cert["cost_gap_median"] <= SLS_MAX_GAP_MEDIAN:
        failures.append(f"cost_gap_median {cert['cost_gap_median']} > {SLS_MAX_GAP_MEDIAN}")
    if not cert["cost_gap_max"] <= SLS_MAX_GAP_MAX:
        failures.append(f"cost_gap_max {cert['cost_gap_max']} > {SLS_MAX_GAP_MAX}")
    return failures


# The gates of tests/test_pallas_riccati.py:46-52 (f32 against the f64
# sequential pass) and a closed-loop tracking cost within 1e-4.
RICCATI_MAX_K_REL = 5e-5
RICCATI_K_TOL = 2e-4  # atol and rtol of k
RICCATI_QUU_TOL = 1e-4  # atol and rtol of Quu
RICCATI_MAX_COST_REL = 1e-4


def tracking_cost(Q, xd, R, xs, us) -> float:
    """sum_t (x_t - xd_t)^T Q_t (x_t - xd_t) + u_t^T R_t u_t in f64."""
    Q, xd, R, xs, us = (_f64(t) for t in (Q, xd, R, xs, us))
    dx = xs - xd
    return float(torch.einsum("ti,tij,tj->", dx, Q, dx) + torch.einsum("ti,tij,tj->", us, R, us))


def certify_riccati(A, B, Q, xd, R, gains, x0) -> dict:
    """Gains of a time-parallel LQT pass against the f64 sequential oracle.

    The oracle runs on the host on the problem rounded to the gains'
    dtype. The closed loop from x0 runs with the gains where they are
    (`rollout_closed_loop_parallel`) and with the oracle's gains in f64
    on the host; the two tracking costs are compared.
    """
    dtype = gains.K.dtype
    A, B, Q, xd, R = (torch.as_tensor(t).to("cpu", dtype).to(torch.float64)
                      for t in (A, B, Q, xd, R))
    star = lqt_backward(A, B, Q, xd, R)
    K, k, Quu = (_f64(t) for t in (gains.K, gains.k, gains.Quu))
    dev = gains.K.device
    xs, us = rollout_closed_loop_parallel(A.to(dev, dtype), B.to(dev, dtype), gains.K, gains.k,
                                          torch.as_tensor(x0).to(dev, dtype))
    x0 = torch.as_tensor(x0).to("cpu", torch.float64)
    # the oracle's closed loop: u_t = K*_t x_t + k*_t on the linear plant, sequentially
    x, us_star, xs_star = x0, [], []
    for t in range(A.shape[0]):
        u = star.K[t] @ x + star.k[t]
        xs_star.append(x)
        us_star.append(u)
        x = A[t] @ x + B[t] @ u
    xs_star, us_star = torch.stack(xs_star), torch.stack(us_star)
    c, c_star = tracking_cost(Q, xd, R, xs, us), tracking_cost(Q, xd, R, xs_star, us_star)
    finite = all(bool(torch.isfinite(t).all()) for t in (gains.K, gains.k, gains.Quu, xs, us))
    return dict(
        finite=finite,
        K_rel=float((K - star.K).abs().max() / star.K.abs().max()),
        k_ratio=float(((k - star.k).abs() / (RICCATI_K_TOL + RICCATI_K_TOL * star.k.abs())).max()),
        Quu_ratio=float(((Quu - star.Quu).abs()
                         / (RICCATI_QUU_TOL + RICCATI_QUU_TOL * star.Quu.abs())).max()),
        k_max_err=float((k - star.k).abs().max()),
        Quu_max_err=float((Quu - star.Quu).abs().max()),
        cost=c, cost_star=c_star, cost_rel=abs(c - c_star) / abs(c_star),
    )


def riccati_gate_failures(cert: dict) -> list[str]:
    failures = []
    if not cert["finite"]:
        failures.append("non-finite gains or closed loop")
    if not cert["K_rel"] <= RICCATI_MAX_K_REL:
        failures.append(f"max|K - K*| / max|K*| = {cert['K_rel']:.3e} > {RICCATI_MAX_K_REL:g}")
    if not cert["k_ratio"] <= 1.0:
        failures.append(f"k outside atol = rtol = {RICCATI_K_TOL:g} (ratio {cert['k_ratio']:.3g})")
    if not cert["Quu_ratio"] <= 1.0:
        failures.append(f"Quu outside atol = rtol = {RICCATI_QUU_TOL:g} "
                        f"(ratio {cert['Quu_ratio']:.3g})")
    if not cert["cost_rel"] <= RICCATI_MAX_COST_REL:
        failures.append(
            f"closed-loop cost off by {cert['cost_rel']:.3e} > {RICCATI_MAX_COST_REL:g}")
    return failures


# The gates of bench_arm_admm.py: 99% of the fleet CONVERGED, the
# reported u within 1e-2 of the bound, and the oracle gap on the first 8
# instances (median, max) at most 1e-3 and 1e-2 in the inner line-search
# mode (:139-142), 2e-3 and 6e-3 in the outer one (:177-178).
ARM_N_ORACLE = 8
ARM_GATES = {
    "inner": dict(converged_frac=0.99, max_violation=1e-2, cost_gap_median=1e-3,
                  cost_gap_max=1e-2),
    "outer": dict(converged_frac=0.99, max_violation=1e-2, cost_gap_median=2e-3,
                  cost_gap_max=6e-3),
}


def arm_polish(arm, cost: QuadCost, q0s, us, u_lower: float, u_upper: float) -> dict:
    """f64 host oracle of the arm fleet (`_oracles.py::arm_polish`).

    For each instance: the cost of clip(u) from x0 = [q0, 0, fk(q0)], its
    gradient by torch autograd of the rollout on the CPU in float64, and
    a bounded L-BFGS-B polish from clip(u) with the reference's options.
    Returns j_ours, j_star = min(polished, j_ours), and the seconds.
    """
    t0 = time.perf_counter()
    q0s, us = _f64(q0s), _f64(us)
    n_inst, N, m = us.shape
    cost = QuadCost(_f64(cost.Q), _f64(cost.xd), _f64(cost.R))

    def j_of(q0, u_flat):
        x0 = torch.cat([q0, torch.zeros_like(q0), arm.fk(q0)])
        u = u_flat.reshape(N, m)
        return cost(rollout_nonlinear(arm.step, x0, u), u)

    j_ours, j_star = np.zeros(n_inst), np.zeros(n_inst)
    for i in range(n_inst):
        u0 = torch.clamp(us[i].reshape(-1), u_lower, u_upper)
        with torch.no_grad():
            j_ours[i] = float(j_of(q0s[i], u0))

        def f_and_g(v, q0=q0s[i]):
            v = torch.tensor(v, requires_grad=True)
            val = j_of(q0, v)
            (g,) = torch.autograd.grad(val, v)
            return float(val.detach()), g.numpy()

        res = minimize(f_and_g, u0.numpy(), jac=True, method="L-BFGS-B",
                       bounds=[(u_lower, u_upper)] * (N * m),
                       options={"ftol": 1e-14, "gtol": 1e-10, "maxiter": 2000})
        j_star[i] = min(res.fun, j_ours[i])
    return {"j_ours": j_ours, "j_star": j_star, "seconds": time.perf_counter() - t0}


def gaps(j_ours, j_star):
    """Relative cost excess of ours over the oracle, (median, max)."""
    j_ours, j_star = np.asarray(j_ours, np.float64), np.asarray(j_star, np.float64)
    g = (j_ours - j_star) / np.maximum(np.abs(j_star), 1e-12)
    return float(np.median(g)), float(np.max(g))


def certify_arm(arm, cost: QuadCost, q0s, res, u_bound: float,
                n_oracle: int = ARM_N_ORACLE) -> dict:
    """The certificates of one arm fleet solve (`res`, an
    `ilqr_admm_fleet` result) as `bench_arm_admm.py` reports them; the
    oracle polishes the first n_oracle instances."""
    u = _f64(res.u_nom)
    u_max = u.abs().amax(dim=(1, 2))
    outer = _f64(res.outer_iters)
    orc = arm_polish(arm, cost, q0s[:n_oracle], u[:n_oracle], -u_bound, u_bound)
    gap_med, gap_max = gaps(orc["j_ours"], orc["j_star"])
    return {
        "converged_frac": float((res.status.cpu() == SolveStatus.CONVERGED).double().mean()),
        "max_violation": max(float(u_max.max()) - u_bound, 0.0),
        "bounds_active_frac": float((u_max > 0.98 * u_bound).double().mean()),
        "mean_cost": float(_f64(res.cost).mean()),
        "mean_outer_iters": float(outer.mean()),
        "max_outer_iters": int(outer.max()),
        "cost_gap_median": gap_med,
        "cost_gap_max": gap_max,
        "oracle_seconds": orc["seconds"],
    }


def arm_gate_failures(cert: dict, mode: str) -> list[str]:
    """The gates of bench_arm_admm.py a certificate misses in line-search
    mode 'inner' or 'outer'; empty when it passes."""
    gates = ARM_GATES[mode]
    failures = []
    if not cert["converged_frac"] >= gates["converged_frac"]:
        failures.append(f"converged_frac {cert['converged_frac']} < {gates['converged_frac']}")
    for key in ("max_violation", "cost_gap_median", "cost_gap_max"):
        if not cert[key] <= gates[key]:
            failures.append(f"{key} {cert[key]} > {gates[key]}")
    return failures
