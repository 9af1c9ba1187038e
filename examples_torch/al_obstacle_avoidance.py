"""Obstacle avoidance via augmented-Lagrangian iLQR (first-class DP).

The reference's spherical-obstacle task (`Double integrator/LQR and SLS
with spherical obstacle avoidance.ipynb`) keeps trajectories OUT of two
circles via ADMM with quadratic-shell projections. Here the same
geometry is handled directly inside the DP loop: the nonconvex
keep-out constraint r - ||p - c|| <= 0 per obstacle goes through
`solvers/al_ilqr.py` — no penalty tuning, no projection operators, and
a certified max-violation on exit. The PyTorch twin of
`examples/al_obstacle_avoidance.py`, in float32 on the CUDA card unless
`--device` names another.

Run: python examples_torch/al_obstacle_avoidance.py [--device cpu]
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.ops.riccati import quad_cost_model
from ilqr_admm_tpu_torch.problem import ILQRConfig
from ilqr_admm_tpu_torch.solvers.al_ilqr import al_ilqr_solve
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.utils.device import resolve_device


def main(device=None):
    device = resolve_device(device)
    like = dict(dtype=torch.get_default_dtype(), device=device)
    N = 100
    plant = DoubleIntegrator(2, 2, dt=1.0 / N, **like)  # 2D position + velocity
    get_AB = lambda xs, us: plant.AB(xs.shape[0])
    d = plant.x_dim

    # track (1, 1) at the final step (reference obstacle notebook setup)
    zs = torch.stack([torch.zeros(d, **like), torch.tensor([1.0, 1.0, 0.0, 0.0], **like)])
    Qs = torch.stack([torch.zeros((d, d), **like), torch.eye(d, **like) * 1e3])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, plant.u_dim)
    get_Cs = lambda xs, us: quad_cost_model(cost.Q, cost.xd, cost.R, xs, us)

    # centers sit slightly off the start-goal diagonal: an obstacle
    # exactly on it makes the straight-line rollout a symmetric saddle
    centers = torch.tensor([[0.32, 0.28], [0.68, 0.77]], **like)
    radii = torch.tensor([0.18, 0.15], **like)

    def keep_out(x, u):
        del u
        p = x[:2]
        dist = torch.linalg.norm(p[None, :] - centers, dim=-1)
        return radii - dist  # <= 0 means outside every circle

    x0 = torch.zeros(d, **like)
    res = al_ilqr_solve(
        plant.step, get_AB, get_Cs, cost, x0, torch.zeros((N, plant.u_dim), **like),
        ineq=keep_out,
        cfg=ILQRConfig(max_iter=40, tol_fun=1e-10),
        n_al=12, mu0=10.0, mu_factor=5.0, tol_con=1e-7, device=device,
    )

    ps = res.x_nom[:, :2].cpu().numpy()
    c_np, r_np = centers.cpu().numpy(), radii.cpu().numpy()
    dists = np.linalg.norm(ps[:, None, :] - c_np[None], axis=-1)
    margin = (dists - r_np[None]).min()
    out = dict(cost=float(res.cost), max_violation=float(res.max_violation),
               min_clearance=float(margin), final=ps[-1].tolist())
    print(f"AL obstacle avoidance: cost {float(res.cost):.4e}, "
          f"max violation {float(res.max_violation):.2e}, "
          f"min clearance {margin:.4f} (>= 0 means outside), "
          f"final position ({ps[-1, 0]:.3f}, {ps[-1, 1]:.3f})")
    # unconstrained straight line would cut through obstacle 1: show the
    # straight-line incursion for contrast
    line = np.linspace([0, 0], [1, 1], N)
    d_line = np.linalg.norm(line[:, None, :] - c_np[None], axis=-1)
    out["line_violation"] = float(-(d_line - r_np[None]).min())
    print(f"(straight line would violate by "
          f"{-(d_line - r_np[None]).min():.4f})")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(**vars(p.parse_args()))
