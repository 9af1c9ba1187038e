"""LQT and robust SLS with control bounds on the double integrator.

Mirrors `Double integrator/LQR and SLS with control bounds.ipynb`:
unconstrained batch solve → LQT-ADMM (batch & DP) with |u| <= 5 →
robust SLS-ADMM with chance constraints → 10k-rollout Monte-Carlo check.
The PyTorch twin of `examples/double_integrator_control_bounds.py`, in
float32 on the CUDA card unless `--device` names another.

Run: python examples_torch/double_integrator_control_bounds.py [--plot] [--device cpu]
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch
from scipy.stats import norm

from ilqr_admm_tpu_torch import SLS, get_double_integrator_AB
from ilqr_admm_tpu_torch.projections import (
    project_bound,
    project_set_convex,
    project_soc_unit,
)
from ilqr_admm_tpu_torch.utils.device import resolve_device


def main(device=None, plot=False):
    device = resolve_device(device)
    like = dict(dtype=torch.get_default_dtype(), device=device)
    x_dim, u_dim, N = 1, 1, 100
    nb_deriv, T = 2, 1.0
    d = x_dim * nb_deriv
    A, B = get_double_integrator_AB(x_dim, nb_deriv, dt=T / N, **like)

    sls = SLS(d, u_dim, N, device=device)
    sls.AB = [A, B]

    zs = np.stack([np.zeros(d), np.array([1.0, 0.0])])
    Qs = np.stack([np.zeros((d, d)), np.eye(d) * 1e6])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    sls.set_quadratic_cost(zs, Qs, seq, u_std=1e-2)

    x0 = np.zeros(d)
    x_opt, u_opt = sls.solve(x0, method="batch")
    out = dict(unconstrained_cost=float(sls.compute_cost(x_opt, u_opt)),
               unconstrained_u_max=float(u_opt.abs().max()))
    print(f"unconstrained: cost {out['unconstrained_cost']:.4e}, "
          f"max|u| {out['unconstrained_u_max']:.3f}")

    lower_u, upper_u = -5.0, 5.0
    x_c, u_c = sls.ADMM_LQT_Batch(
        x0, project_u=lambda u: project_bound(u, lower_u, upper_u),
        max_iter=100, rho_u=1e-2, tol=1e-4, verbose=True,
    )
    out["batch_cost"] = float(sls.compute_cost(x_c, u_c))
    out["batch_u_max"] = float(u_c.abs().max())
    print(f"ADMM batch:    cost {out['batch_cost']:.4e}, "
          f"max|u| {out['batch_u_max']:.6f}")

    x_d, u_d, K_dp, k_dp = sls.ADMM_LQT_DP(
        x0, project_u=lambda u: project_bound(u, lower_u, upper_u),
        max_iter=500, rho_u=1e-1, tol=1e-4,
    )
    out["dp_cost"] = float(sls.compute_cost(x_d, u_d))
    print(f"ADMM DP:       cost {out['dp_cost']:.4e}")

    # --- robust chance-constrained SLS (cells 15-16)
    var_x0 = 0.01
    psi_inv = float(norm.ppf(0.95))
    mu = np.array([1.0, 0.0])
    sigma = np.array([0.0, var_x0])
    Au = np.diag(np.sqrt(sigma))
    A_hi = torch.tensor(np.concatenate([Au, (-mu / psi_inv)[None]], 0), **like)
    b_hi = torch.tensor(np.append(np.zeros(2), upper_u / psi_inv), **like)
    A_lo = torch.tensor(np.concatenate([Au, (mu / psi_inv)[None]], 0), **like)
    b_lo = torch.tensor(np.append(np.zeros(2), -lower_u / psi_inv), **like)

    def project_u_rob(y):
        return project_set_convex(
            y, [A_hi, A_lo], [b_hi, b_lo], [project_soc_unit] * 2,
            rho=1e1, max_iter=100, threshold=1e-3,
        )

    du, PHI_U = sls.ADMM_SLS(
        project_u=project_u_rob, max_iter=50, rho_u=1e2, tol=1e-3,
        robust_dim=1, verbose=True,
    )
    out["sls_cost"] = float(sls.compute_cost(sls.Sw[:, :d] @ torch.zeros(d, **like)
                                             + sls.Su @ du))
    print(f"robust SLS:    cost {out['sls_cost']:.4e}")

    # --- Monte-Carlo validation (cells 19-20)
    n_mc = 10_000
    rng = np.random.default_rng(0)
    x0s = np.zeros((n_mc, d))
    x0s[:, 0] = rng.normal(0, np.sqrt(var_x0), n_mc)

    _, us_dp = sls.get_trajectory_dp(x0s, K_dp, k_dp)
    K_sls, k_sls = sls.controller(PHI_U, du)
    _, us_sls = sls.get_trajectory_sls(x0s, K_sls, k_sls)

    thr = 1e-3
    for name, us in [("DP", us_dp), ("SLS", us_sls)]:
        us = us.cpu().numpy()
        ok = np.all((us >= lower_u - thr) & (us <= upper_u + thr), axis=(1, 2))
        out[f"mc_success_{name}"] = 100 * ok.mean()
        print(f"MC success {name}: {100 * ok.mean():.2f} %")

    if plot:
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(ncols=2, figsize=(8, 4))
        ax[0].plot(x_c.cpu().numpy().reshape(N, -1)[:, 0], label="ADMM")
        ax[0].plot(x_opt.cpu().numpy()[:, 0], "r", label="unconstrained")
        ax[1].plot(u_c.cpu().numpy().reshape(N, -1)[:-1], label="ADMM")
        ax[1].plot(u_opt.cpu().numpy()[:-1], "r", label="unconstrained")
        ax[1].axhline(lower_u, color="k"); ax[1].axhline(upper_u, color="k")
        plt.legend(); plt.savefig("di_control_bounds.png", dpi=120)
        print("saved di_control_bounds.png")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--plot", action="store_true")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(**vars(p.parse_args()))
