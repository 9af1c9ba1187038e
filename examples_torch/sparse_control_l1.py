"""Sparse (l1-regularized) control via prox-ADMM.

Beyond the reference (whose z-updates are all set projections): the
generic ADMM driver accepts any proximal map as the z-update, so adding
a sparsity cost γ‖u‖₁ to the LQT objective is just `prox_l1` (soft
thresholding) in place of a projection — the pattern of "An ADMM
Algorithm for Solving l1 Regularized MPC" (PAPERS.md). The optimizer
turns the actuation *off exactly* for most of the horizon and fires
briefly where it matters (bang-off behavior), instead of the l2
solution's always-on whisper. The PyTorch twin of
`examples/sparse_control_l1.py`, in float32 on the CUDA card unless
`--device` names another.

Run: python examples_torch/sparse_control_l1.py [--device cpu]
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.problem import ADMMConfig
from ilqr_admm_tpu_torch.projections import prox_l1
from ilqr_admm_tpu_torch.solvers.lqt import lqt_solve_batch
from ilqr_admm_tpu_torch.solvers.lqt_admm import lqt_admm_batch
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.utils.device import resolve_device


def main(device=None):
    device = resolve_device(device)
    like = dict(dtype=torch.get_default_dtype(), device=device)
    N = 100
    plant = DoubleIntegrator(1, 2, dt=1.0 / N, **like)
    d, m = plant.x_dim, plant.u_dim
    zs = torch.stack([torch.zeros(d, **like), torch.tensor([1.0, 0.0], **like)])
    Qs = torch.stack([torch.zeros((d, d), **like), torch.eye(d, **like) * 1e4])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)
    x0 = torch.zeros(d, **like)

    # dense l2 optimum for comparison
    xs2, us2 = lqt_solve_batch(A, B, cost, x0)

    gamma, rho = 2.0, 1e-1
    # z-update: min γ||z||_1 + ρ||x̂ - z + λ||²  →  soft(x̂+λ, γ/(2ρ))
    x, u, info = lqt_admm_batch(
        A, B, cost, x0,
        project_u=lambda v: prox_l1(v, gamma / (2.0 * rho)),
        rho_u=rho,
        cfg=ADMMConfig(max_iter=2000, tol=1e-8),
    )
    u = u.cpu().numpy().reshape(N, m)
    us2 = us2.cpu().numpy()
    x = x.cpu().numpy().reshape(N, d)

    # the x-iterate carries tiny residual values on the zeroed support
    # (the z-iterate is exactly sparse); count activity relatively
    thr = 1e-3 * np.max(np.abs(u))
    on = np.sum(np.abs(u) > thr)
    on2 = np.sum(np.abs(us2) > 1e-3 * np.max(np.abs(us2)))
    print(f"l2 solution : {on2}/{N} timesteps active, "
          f"final pos {xs2.cpu().numpy()[-1, 0]:.4f}")
    print(f"l1 solution : {on}/{N} timesteps active (γ={gamma}), "
          f"final pos {x[-1, 0]:.4f}")
    idx = np.nonzero(np.abs(u[:, 0]) > thr)[0]
    print(f"l1 firing windows: steps {idx[:8]} ... {idx[-8:]}")
    assert on < N // 2, "expected sparse actuation"
    assert abs(x[-1, 0] - 1.0) < 0.05, "target still reached"
    return dict(l2_active=int(on2), l1_active=int(on), l2_final=float(xs2[-1, 0]),
                l1_final=float(x[-1, 0]), l1_iters=int(info.iters))


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(**vars(p.parse_args()))
