"""3DoF arm iLQR-ADMM with state and control bound constraints.

Mirrors `3DoF robot/State and control bound constraints.ipynb` with the
analytic arm replacing Pinocchio: reach the line y=1 with the
end-effector x constrained to [0.5, 1.0] at the final step, joint
velocities within ±1.5, controls within ±6. The PyTorch twin of
`examples/arm_constrained.py`, in float64 on the CUDA card unless
`--device` names another.

Run: python examples_torch/arm_constrained.py [--device cpu]
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from ilqr_admm_tpu_torch import iSLS
from ilqr_admm_tpu_torch.models.arm import PlanarArm
from ilqr_admm_tpu_torch.utils.device import resolve_device
from ilqr_admm_tpu_torch.utils.precision import use_x64


def main(device=None):
    device = resolve_device(device)
    # the notebook's x_std=1e6 / u_std=1e-4 weight ratio (1e10) is past
    # any f32 formulation's conditioning budget (see utils/precision.py)
    use_x64()
    N = 100
    arm = PlanarArm((1.0, 1.0, 1.0), dt=1.0 / N)
    d, m, n = arm.x_dim, arm.u_dim, arm.q_dim

    sls = iSLS(d, m, N, device=device)
    sls.forward_model = arm.step

    x_std, u_std = 1e6, 1e-4
    target = np.array([0.0] * n + [0.0] * n + [1.5, 1.0, 0.0])
    w = np.array([0.0] * n + [x_std] * n + [0.0, x_std, 0.0])
    zs = np.stack([np.zeros(d), target])
    Qs = np.stack([np.zeros((d, d)), np.diag(w)])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    sls.set_cost_variables(zs, Qs, seq, u_std)

    q0 = np.array([np.pi / 3, -np.pi / 2, -np.pi / 4])
    x0 = arm.initial_state(torch.tensor(q0, device=device))
    u0 = np.ones((N, m))
    x_nom, u_nom = sls.get_trajectory_batch(x0, u0)
    sls.reset()
    sls.nominal_values = x_nom, u_nom

    sls.solve_ilqr(arm.get_AB, max_ilqr_iter=30, max_line_search_iter=20, dp=True)
    out = dict(unconstrained_cost=sls.cost)
    print(f"unconstrained iLQR cost {sls.cost:.4f} (reference ≈ 0.118)")

    lower_u, upper_u = -6.0, 6.0
    lower_xf, upper_xf = 0.5, 1.0
    lower_dq, upper_dq = -1.5, 1.5

    def project_u(u):
        return torch.clamp(u, lower_u, upper_u)

    def project_x(x):
        x_ = x.reshape(N, d).clone()
        x_[-1, 2 * n] = torch.clamp(x_[-1, 2 * n], lower_xf, upper_xf)
        x_[:, n : 2 * n] = torch.clamp(x_[:, n : 2 * n], lower_dq, upper_dq)
        return x_.reshape(-1)

    Qr = np.zeros((N, d, d))
    Qr[-1, 2 * n, 2 * n] = 1e1
    Qr[:, n : 2 * n, n : 2 * n] = np.eye(n) * 1e-2

    sls.reset()
    sls.nominal_values = x_nom, u_nom
    sls.ilqr_admm(
        arm.get_AB, project_x=project_x, project_u=project_u,
        max_admm_iter=10, max_line_search=5, rho_x=Qr, rho_u=1e-3,
        threshold=1e-4, verbose=True,
    )
    xs = sls.x_nom.cpu().numpy()
    us = sls.u_nom.cpu().numpy()
    out.update(constrained_cost=sls.cost, final_ee_x=float(xs[-1, 2 * n]),
               dq_max=float(np.abs(xs[:, n:2 * n]).max()), u_max=float(np.abs(us).max()))
    print(f"constrained cost {sls.cost:.4f} (reference ≈ 0.1996)")
    print(f"final ee x {xs[-1, 2 * n]:.3f} in [{lower_xf}, {upper_xf}]; "
          f"max|dq| {np.abs(xs[:, n:2 * n]).max():.3f}; max|u| {np.abs(us).max():.3f}")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(**vars(p.parse_args()))
