"""LQT and robust SLS with state bounds (chance-constrained endpoint).

Mirrors `Double integrator/LQR and SLS with state bounds.ipynb`: final
position pinned to 0.5, final velocity to 0, |u| <= 3, all enforced by
projections; robust SLS version guarantees the endpoint constraints with
probability 0.9 under Gaussian x0 uncertainty; 10k-rollout MC validation
(reference: DP 23.44 % vs SLS 89.59 %). The PyTorch twin of
`examples/double_integrator_state_bounds.py`, in float32 on the CUDA
card unless `--device` names another.

Run: python examples_torch/double_integrator_state_bounds.py [--device cpu]
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


def main(device=None):
    device = resolve_device(device)
    like = dict(dtype=torch.get_default_dtype(), device=device)
    N, d, u_dim = 100, 2, 1
    A, B = get_double_integrator_AB(1, 2, dt=1.0 / N, **like)
    sls = SLS(d, u_dim, N, device=device)
    sls.AB = [A, B]

    zs = np.stack([np.zeros(d), np.array([1.0, 1.0])])
    Qs = np.stack([np.zeros((d, d)), np.zeros((d, d))])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    sls.set_quadratic_cost(zs, Qs, seq, u_std=1e-4)

    x0 = np.zeros(d)
    x_final, lower_u, upper_u = 0.5, -3.0, 3.0

    def project_x(x):
        end = torch.tensor([x_final, 0.0], dtype=x.dtype, device=x.device)
        return torch.cat([x[:-d], end])

    project_u = lambda u: project_bound(u, lower_u, upper_u)

    rho_x = np.zeros((N, d, d))
    rho_x[-1] = np.eye(d) * 1e1
    x_b, u_b = sls.ADMM_LQT_Batch(
        x0, project_x=project_x, project_u=project_u,
        max_iter=500, rho_x=rho_x, rho_u=1e-3, tol=1e-3, verbose=True,
    )
    out = dict(batch_cost=float(sls.compute_cost(x_b, u_b)))
    print(f"batch: cost {out['batch_cost']:.3e} (reference 3.09e-2)")

    x_d, u_d, K_dp, k_dp = sls.ADMM_LQT_DP(
        x0, project_x=project_x, project_u=project_u,
        max_iter=5000, rho_x=rho_x, rho_u=1e-3, tol=1e-4,
    )
    out["dp_cost"] = float(sls.compute_cost(x_d, u_d))
    print(f"DP:    cost {out['dp_cost']:.3e} (reference 3.09e-2)")

    # --- robust version (cells 16-17)
    var_x0, alpha = 0.02, 0.9
    psi_inv = float(norm.ppf(alpha))
    mu = np.array([1.0, 0.0])
    Au = np.diag(np.sqrt([0.0, var_x0]))

    def soc_pair(hi, lo):
        A_hi = torch.tensor(np.concatenate([Au, (-mu / psi_inv)[None]], 0), **like)
        b_hi = torch.tensor(np.append(np.zeros(2), hi / psi_inv), **like)
        A_lo = torch.tensor(np.concatenate([Au, (mu / psi_inv)[None]], 0), **like)
        b_lo = torch.tensor(np.append(np.zeros(2), -lo / psi_inv), **like)
        return [A_hi, A_lo], [b_hi, b_lo]

    As_u, bs_u = soc_pair(upper_u, lower_u)
    As_xf, bs_xf = soc_pair(x_final, x_final)
    As_vf, bs_vf = soc_pair(0.0, 0.0)
    projs = [project_soc_unit] * 2

    def project_u_rob(y):
        return project_set_convex(y, As_u, bs_u, projs, rho=1e1, max_iter=20,
                                  threshold=1e-2)

    def project_x_rob(y):
        pos = project_set_convex(y[-2:-1], As_xf, bs_xf, projs, rho=1e1,
                                 max_iter=20, threshold=1e-2)
        vel = project_set_convex(y[-1:], As_vf, bs_vf, projs, rho=1e1,
                                 max_iter=20, threshold=1e-2)
        return torch.cat([y[:-2], pos, vel])

    rho_x_r = np.zeros((N, d, d))
    rho_x_r[-1] = np.eye(d) * 1e3
    du, PHI_U = sls.ADMM_SLS(
        project_x=project_x_rob, project_u=project_u_rob,
        max_iter=100, rho_x=rho_x_r, rho_u=1e-3, tol=1e-5, robust_dim=1,
        verbose=True,
    )

    # --- Monte-Carlo validation
    n_mc = 10_000
    rng = np.random.default_rng(0)
    x0s = np.zeros((n_mc, d))
    x0s[:, 0] = rng.normal(0, np.sqrt(var_x0), n_mc)
    xs_dp, us_dp = sls.get_trajectory_dp(x0s, K_dp, k_dp)
    K_sls, k_sls = sls.controller(PHI_U, du)
    xs_sls, us_sls = sls.get_trajectory_sls(x0s, K_sls, k_sls)

    thr = 1e-2
    for name, xs, us in [("DP", xs_dp, us_dp), ("SLS", xs_sls, us_sls)]:
        xs, us = xs.cpu().numpy(), us.cpu().numpy()
        sx = (x_final - thr <= xs[:, -1, 0]) & (xs[:, -1, 0] <= x_final + thr)
        sdx = np.abs(xs[:, -1, 1]) <= thr
        su = ((us >= lower_u - thr) & (us <= upper_u + thr)).all(axis=(1, 2))
        out[f"mc_success_{name}"] = 100 * (sx & sdx & su).mean()
        print(f"MC success {name}: {100 * (sx & sdx & su).mean():.2f} % "
              f"(reference: DP 23.44, SLS 89.59)")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(**vars(p.parse_args()))
