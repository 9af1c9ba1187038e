"""LQT-ADMM with spherical obstacle avoidance (2D double integrator).

Mirrors `Double integrator/LQR and SLS with spherical obstacle
avoidance.ipynb`: two circular obstacles handled by the intersection of
quadratic-shell (sphere-complement) projections via consensus ADMM +
Dykstra refinement. The PyTorch twin of
`examples/double_integrator_obstacles.py`, in float32 on the CUDA card
unless `--device` names another.

Run: python examples_torch/double_integrator_obstacles.py [--device cpu]
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from ilqr_admm_tpu_torch import SLS, get_double_integrator_AB
from ilqr_admm_tpu_torch.projections import (
    project_quadratic,
    project_set_convex,
    project_set_convex_dykstra,
)
from ilqr_admm_tpu_torch.utils.device import resolve_device


def main(device=None):
    device = resolve_device(device)
    like = dict(dtype=torch.get_default_dtype(), device=device)
    x_dim, u_dim, N = 2, 2, 100
    d = x_dim * 2
    A, B = get_double_integrator_AB(x_dim, 2, dt=1.0 / N, **like)
    sls = SLS(d, u_dim, N, device=device)
    sls.AB = [A, B]

    x_std, u_std = 1e3, 1e-4
    zs = np.stack([np.zeros(d), np.array([1.0, 1.0, 0.0, 0.0])])
    Qs = np.stack([np.zeros((d, d)), np.eye(d) * x_std])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    sls.set_quadratic_cost(zs, Qs, seq, u_std)

    x0 = np.zeros(d)
    x_opt, u_opt = sls.solve(x0, method="batch")
    out = dict(unconstrained_cost=float(sls.compute_cost(x_opt, u_opt)))
    print(f"unconstrained cost {out['unconstrained_cost']:.4e} "
          f"(reference 2.473e-1)")

    # two circular obstacles (scenario 0 of the notebook)
    radii = np.array([0.1, 0.15]) * 1.1
    centers = [torch.tensor([0.5, 0.5], **like), torch.tensor([0.5, 0.2], **like)]
    lowers = 0.5 * radii**2
    upper = 1e2

    projs = [
        (lambda c, l: (lambda y: project_quadratic(y - c, l, upper) + c))(c, l)
        for c, l in zip(centers, lowers)
    ]
    As = [torch.eye(x_dim, **like)] * 2
    bs = [torch.zeros(x_dim, **like)] * 2

    def project_state(x):
        x_ = x.reshape(N, d)
        pos = x_[:, :x_dim]
        pos = project_set_convex(pos, As, bs, projs, rho=1.0, max_iter=5,
                                 threshold=1e-2)
        pos = project_set_convex_dykstra(pos, projs, max_iter=50, tol=1e-5)
        return torch.cat([pos, x_[:, x_dim:]], 1).reshape(-1)

    rho_x = np.zeros((N, d, d))
    rho_x[:, :x_dim, :x_dim] = np.eye(x_dim)
    x_c, u_c = sls.ADMM_LQT_Batch(
        x0, project_x=project_state, max_iter=500, rho_x=rho_x, tol=1e-3,
        verbose=True,
    )
    out["constrained_cost"] = float(sls.compute_cost(x_c, u_c))
    print(f"constrained cost  {out['constrained_cost']:.4e} "
          f"(reference 2.680e-1)")

    # obstacle-clearance oracle. The x-iterate can hug/penetrate slightly
    # before full convergence; the projected (z) iterate is feasible by
    # construction and is the answer to deploy.
    x_feas = project_state(x_c)
    for name, xv in [("x-iterate", x_c), ("projected", x_feas)]:
        pos = xv.cpu().numpy().reshape(N, d)[:, :x_dim]
        dists = [np.linalg.norm(pos - c.cpu().numpy(), axis=-1).min() for c in centers]
        out[f"clearances_{name}"] = dists
        print(f"{name}: min obstacle clearances {dists[0]:.3f}/{dists[1]:.3f} "
              f"(radii {radii[0] / 1.1:.3f}/{radii[1] / 1.1:.3f})")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(**vars(p.parse_args()))
