"""iLQR-ADMM with rotated-rectangle obstacle avoidance (simple car).

Mirrors `Car/Iterative LQR with state constraints.ipynb`: the simple
kinematic car with analytic Jacobians, quadratic final cost, and two
rotated rectangular obstacles handled with inf-norm-shell projections
composed through consensus ADMM. The PyTorch twin of
`examples/car_state_constraints.py`, in float32 on the CUDA card unless
`--device` names another.

Run: python examples_torch/car_state_constraints.py [--device cpu]
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from ilqr_admm_tpu_torch import iSLS
from ilqr_admm_tpu_torch.models.car import CarSimple
from ilqr_admm_tpu_torch.projections import (
    project_outside_rotated_boxes,
    project_set_convex,
    project_square,
)
from ilqr_admm_tpu_torch.utils.device import resolve_device


def main(device=None):
    device = resolve_device(device)
    like = dict(dtype=torch.get_default_dtype(), device=device)
    x_dim, u_dim, N = 4, 2, 500
    dt = 15.0 / N
    car = CarSimple(dt=dt)
    sls = iSLS(x_dim, u_dim, N, device=device)
    sls.forward_model = car.step

    x_std = 1e2
    target = np.array([-5.0, -5.0, np.pi / 4, 0.0])
    zs = np.stack([np.zeros(x_dim), target])
    Qs = np.stack([np.zeros((x_dim, x_dim)), np.eye(x_dim) * x_std])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    sls.set_quadratic_cost(zs, Qs, seq, u_std=1e-2)

    x0 = np.array([0.0, -2.0, np.pi / 2, 0.0])
    x_nom, u_nom = sls.rollout_batch(x0[None], np.zeros((1, N, u_dim)))
    sls.reset()
    sls.nominal_values = x_nom[0], u_nom[0]

    sls.solve(car.get_AB, method="batch", max_iter=50, max_line_search_iter=40)
    out = dict(unconstrained_cost=sls.cost)
    print(f"unconstrained iLQR (batch) cost {sls.cost:.4f}; final "
          f"{sls.x_nom[-1].cpu().numpy().round(3)}")

    # two rotated rectangular obstacles (notebook cell 18)
    centers = np.stack([np.array([-7.0, -3.0]), np.array([-3.0, -7.0])])
    a_safe = np.array([[2.5, 1.5], [2.5, 1.5]])  # width, length + margin
    Ws, Ws_inv = [], []
    alpha = -np.pi / 4
    R = np.array([[np.cos(alpha), -np.sin(alpha)], [np.sin(alpha), np.cos(alpha)]])
    for i in range(2):
        W = np.diag(a_safe[i, 0] / a_safe[i]) @ R.T
        Ws.append(torch.tensor(W, **like))
        Ws_inv.append(torch.tensor(np.linalg.inv(W), **like))
    lower_sq = a_safe[:, 0] / 2
    upper_sq = 1e5

    def make_proj(i):
        c = torch.tensor(centers[i], **like)

        def proj(y):  # y: (N, x_dim) full states
            z = (y[:, :2] - c) @ Ws[i].T
            z = project_square(z, lower_sq[i], upper_sq)
            return torch.cat([z @ Ws_inv[i].T + c, y[:, 2:]], 1)

        return proj

    projs = [make_proj(0), make_proj(1)]
    As = [torch.eye(x_dim, **like)] * 2
    bs = [torch.zeros(x_dim, **like)] * 2

    def project_state(x):
        x_ = x.reshape(N, x_dim)
        out = project_set_convex(x_, As, bs, projs, rho=1e1, max_iter=15,
                                 threshold=1e-3)
        return out.reshape(-1)

    rho_x = np.zeros((N, x_dim, x_dim))
    rho_x[:, :2, :2] = np.eye(2) * 1e-1

    # exact alternative: normalize each obstacle frame by its radius so
    # every box is the unit inf-norm ball, then use the single-push
    # world-metric projection (certified exact for disjoint obstacles)
    As_box = torch.stack([Ws[i] / lower_sq[i] for i in range(2)])
    bs_box = torch.stack(
        [-(Ws[i] / lower_sq[i]) @ torch.tensor(centers[i], **like) for i in range(2)]
    )

    def project_state_exact(x):
        x_ = x.reshape(N, x_dim)
        p, _ = project_outside_rotated_boxes(x_[:, :2], As_box, bs_box, l=1.0)
        return torch.cat([p, x_[:, 2:]], 1).reshape(-1)

    for name, proj in (("consensus-ADMM", project_state),
                       ("exact single-push", project_state_exact)):
        sls.reset()
        sls.nominal_values = x_nom[0], u_nom[0]
        sls.ilqr_admm(
            car.get_AB, project_x=proj, max_admm_iter=10,
            max_line_search=50, rho_x=rho_x, k_max=10, threshold=1e-1,
            verbose=True,
        )
        out[f"{name} cost"] = sls.cost
        print(f"[{name}] constrained cost {sls.cost:.4f}; final "
              f"{sls.x_nom[-1].cpu().numpy().round(3)}")

        # clearance oracle
        pos = sls.x_nom.cpu().numpy()[:, :2]
        for i in range(2):
            z = (pos - centers[i]) @ Ws[i].cpu().numpy().T
            out[f"{name} clearance {i}"] = float(np.abs(z).max(-1).min())
            print(f"  min inf-norm distance to obstacle {i}: "
                  f"{np.abs(z).max(-1).min():.3f} (bound {lower_sq[i]:.2f})")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(**vars(p.parse_args()))
