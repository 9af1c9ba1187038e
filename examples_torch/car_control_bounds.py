"""Iterative LQR with control constraints on the simple car.

Mirror of `Car/Iterative LQR with control constraints.ipynb` (cells
6-20): the kinematic car x=[x,y,theta,v], u=[steer, dv] with closed-form
Jacobians, a quadratic final-state cost (x_std=1e2, u_std=1e-2, target
0), solved unconstrained (reference golden cost 0.68766, cell 13) and
with |u_i| <= 0.5 control bounds via `ilqr_admm` (reference reaches cost
3.04 at its k_max=30 cap, cell 20 — still descending; match or beat).

Includes the analytic-vs-autodiff derivative cross-check the reference
gets from having both paths (`Tutorial.ipynb` cells 8/10): CarSimple
ships the closed-form `get_AB` (notebook cell 6) AND a `torch.func.jacfwd`
twin; they must agree to float precision. The PyTorch twin of
`examples/car_control_bounds.py`, in float32 on the CUDA card unless
`--device` names another.

Run: python examples_torch/car_control_bounds.py [--device cpu]
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from ilqr_admm_tpu_torch.models.car import CarSimple
from ilqr_admm_tpu_torch.ops.rollout import rollout_nonlinear
from ilqr_admm_tpu_torch.problem import ILQRConfig, SolveStatus
from ilqr_admm_tpu_torch.projections import project_bound
from ilqr_admm_tpu_torch.solvers.ilqr import ilqr_init, ilqr_solve
from ilqr_admm_tpu_torch.solvers.ilqr_admm import ilqr_admm
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.utils.device import resolve_device


def main(device=None):
    device = resolve_device(device)
    like = dict(dtype=torch.get_default_dtype(), device=device)
    N = 500
    car = CarSimple(dt=15.0 / N)
    d, m = car.x_dim, car.u_dim

    # task: drive [1, 1, 3pi/2, 0] -> 0 with a final viapoint cost
    x_std, u_std = 1e2, 1e-2
    zs = torch.stack([torch.zeros(d, **like), torch.zeros(d, **like)])
    Qs = torch.stack([torch.zeros((d, d), **like), torch.eye(d, **like) * x_std])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, u_std, m)

    x0 = torch.tensor([1.0, 1.0, 3.0 * np.pi / 2, 0.0], **like)
    u0 = torch.zeros((N, m), **like)
    # the unwrapped dynamics is the differentiable twin the reference's
    # closed-form get_AB differentiates (see CarSimple.step_unwrapped)
    f = car.step_unwrapped
    x_nom0 = rollout_nonlinear(f, x0, u0)

    # --- derivative cross-check: closed-form get_AB vs torch.func.jacfwd
    rng = np.random.default_rng(0)
    xs_t = torch.tensor(rng.normal(size=(N, d)), **like)
    us_t = torch.tensor(rng.normal(size=(N, m)), **like)
    A_an, B_an = car.get_AB(xs_t, us_t)
    A_ad, B_ad = car.get_AB_autodiff(xs_t, us_t)
    dA = float((A_an - A_ad).abs().max())
    dB = float((B_an - B_ad).abs().max())
    print(f"analytic vs autodiff Jacobians: max|dA|={dA:.2e} max|dB|={dB:.2e}")
    assert dA < 1e-6 and dB < 1e-6, (dA, dB)

    # --- unconstrained iLQR (notebook cell 13: cost 0.68766, 26 iters)
    from ilqr_admm_tpu_torch.ops.riccati import quad_cost_model

    get_Cs = lambda xs, us: quad_cost_model(cost.Q, cost.xd, cost.R, xs, us)
    st = ilqr_solve(
        f, car.get_AB, get_Cs, cost,
        ilqr_init(f, cost, x0, u0, device=device),
        cfg=ILQRConfig(max_iter=50, tol_fun=1e-6),
    )
    c_unc = float(st.cost)
    print(f"unconstrained iLQR: cost {c_unc:.5f} (reference 0.68766), "
          f"status {SolveStatus(int(st.status)).name}")
    assert abs(c_unc - 0.68766) < 0.02, c_unc

    # --- constrained: |steer| <= 0.5, |dv| <= 0.5 (notebook cell 20)
    def proj_u(u):
        return project_bound(u, -0.5, 0.5)

    res = ilqr_admm(
        f, car.get_AB, cost, x_nom0, u0,
        quad_cost=cost, project_u=proj_u, rho_u=1e0,
        max_iter=60, max_admm_iter=8,
        alphas=10.0 ** torch.linspace(0.0, -5.0, 50, **like),
        tol=1e-3, outer_tol=1e-5, device=device,
    )
    us = res.u_nom.cpu().numpy()
    c_con = float(res.cost)
    print(f"ilqr_admm |u|<=0.5: cost {c_con:.4f} (reference stops at 3.04 "
          f"when its k_max=30 budget runs out, still descending; the "
          f"converged constrained optimum is ~0.695), "
          f"max|u| {np.abs(us).max():.4f}, outer iters {int(res.outer_iters)}, "
          f"status {SolveStatus(int(res.status)).name}")
    assert np.abs(us).max() <= 0.5 + 1e-3
    assert c_unc < c_con <= 0.72, c_con
    return dict(dA=dA, dB=dB, unconstrained_cost=c_unc,
                unconstrained_status=SolveStatus(int(st.status)).name, constrained_cost=c_con,
                u_max=float(np.abs(us).max()), outer_iters=int(res.outer_iters),
                status=SolveStatus(int(res.status)).name)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(**vars(p.parse_args()))
