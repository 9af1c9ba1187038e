"""One-call JOINT chance-constraint calibration (beyond the reference).

The reference workflow (3DoF robust notebook c24-26) asks you to pick a
*per-row* confidence and hand-build SOC projection matrices; the joint
(whole-trajectory) success probability is whatever it turns out to be —
its reported 95.8 % at psi^-1(0.82)/row is an artifact of an
under-converged iterate. Here the joint level IS the API:

    res = isls_admm(..., joint_alpha=0.958, u_bounds=(-6, 6), x0_var=0.1)

The library derives the SOC tightening with the chi-ball certificate
psi = chi_p^{-1}(joint_alpha) (`ilqr_admm_tpu_torch.chance`): every
constraint row shares the same initial-state deviation delta, so ALL
rows hold simultaneously whenever ||diag(var)^{-1/2} delta|| <= psi — a
joint guarantee that does not degrade with horizon length (a Sidak
correction over the 600 one-sided rows would demand psi = 3.80 and can
push tight problems infeasible; chi_3 needs 2.86). The PyTorch twin of
`examples/robust_joint_calibration.py`, in float64 on the CUDA card
unless `--device` names another.

Run: python examples_torch/robust_joint_calibration.py [--device cpu]
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch
from torch.func import vmap

from ilqr_admm_tpu_torch.chance import calibrate
from ilqr_admm_tpu_torch.models.arm import PlanarArm
from ilqr_admm_tpu_torch.ops.rollout import rollout_nonlinear, rollout_sls_delta
from ilqr_admm_tpu_torch.solvers.isls_admm import isls_admm
from ilqr_admm_tpu_torch.solvers.lqt import sls_controller
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.utils.device import resolve_device
from ilqr_admm_tpu_torch.utils.precision import use_x64


def main(device=None):
    device = resolve_device(device)
    use_x64()
    like = dict(dtype=torch.float64, device=device)
    N, var_q0, u_max, joint_alpha = 100, 0.1, 6.0, 0.958
    arm = PlanarArm((1.0, 1.0, 1.0), dt=1.0 / N)
    d, m, n = arm.x_dim, arm.u_dim, arm.q_dim

    target = torch.tensor([0.0] * n + [0.0] * n + [1.5, 2.0, 0.0], **like)
    w = torch.tensor([0.0] * n + [1e3] * n + [1e3, 1e3, 0.0], **like)
    zs = torch.stack([torch.zeros(d, **like), target])
    Qs = torch.stack([torch.zeros((d, d), **like), torch.diag(w)])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(zs, Qs, seq, 1e-4, m)

    x0 = arm.initial_state(torch.tensor([np.pi / 3, -np.pi / 2, -np.pi / 4], **like))
    u0 = torch.zeros((N, m), **like)
    x_nom0 = rollout_nonlinear(arm.step, x0, u0)

    cal = calibrate(joint_alpha=joint_alpha, robust_dim=n)
    print(f"requested joint alpha {joint_alpha} -> chi_{n} ball psi = "
          f"{cal.psi_inv:.3f} (implied per-row level {cal.alpha_row:.5f})")

    res = isls_admm(
        arm.step, arm.get_AB, quad, x_nom0, u0, robust_dim=n,
        quad_cost=quad, rho_u=1e0,
        joint_alpha=joint_alpha, u_bounds=(-u_max, u_max), x0_var=var_q0,
        k_max=50, max_admm_iter=10,
        alphas=10.0 ** torch.linspace(0.0, -5.0, 50, **like)[:30], outer_tol=1e-4,
        device=device,
    )
    out = dict(psi=cal.psi_inv, alpha_row=cal.alpha_row, outer_iters=int(res.outer_iters),
               cost=float(res.cost), terminal_y=float(res.x_nom[-1, 2 * n + 1]))
    print(f"solved in {int(res.outer_iters)} outer iterations, "
          f"cost {float(res.cost):.3f}, terminal y "
          f"{float(res.x_nom[-1, 2 * n + 1]):.3f} (target 2.0)")

    # certificate: every row's z-score >= psi (the returned controller is
    # the projected, SOC-feasible iterate)
    u_abs = res.u_nom.cpu().numpy().reshape(-1) + res.du.cpu().numpy()
    spread = np.sqrt(var_q0) * np.linalg.norm(res.phi_u.cpu().numpy(), axis=-1)
    z = np.minimum(u_max - u_abs, u_abs + u_max) / np.maximum(spread, 1e-12)
    out["z_min"] = float(z.min())
    print(f"min per-row z-score {z.min():.3f} (certificate needs "
          f">= {cal.psi_inv:.3f})")

    # Monte-Carlo validation (the reference's signature test, c26)
    PHI_U = torch.zeros((m * N, d * N), **like)
    PHI_U[:, :n] = res.phi_u
    A, B = arm.get_AB(res.x_nom, res.u_nom)
    K, k = sls_controller(A, B, PHI_U, res.du)
    rng = np.random.default_rng(11)
    q0s = torch.tensor(rng.normal(res.x_nom[0, :n].cpu().numpy(), np.sqrt(var_q0), (1000, n)),
                       **like)
    x0s = torch.cat([q0s, torch.zeros((1000, n), **like), vmap(arm.fk)(q0s)], dim=-1)
    _, us = vmap(
        lambda a: rollout_sls_delta(arm.step, a, K, k, res.x_nom, res.u_nom)
    )(x0s)
    ok = (us.abs().cpu().numpy() <= u_max + 1e-3).all(axis=(1, 2))
    out["mc_success"] = float(ok.mean())
    print(f"joint MC success over 1000 rollouts: {ok.mean():.3f} "
          f"(requested {joint_alpha}; reference workflow reports 0.958)")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(**vars(p.parse_args()))
