"""ADMM acceleration showdown: plain vs Nesterov vs Anderson.

Beyond the reference (plain ADMM throughout, `admm.py:6-106`): the
driver offers two accelerators — Nesterov momentum with adaptive
restart (`ADMMConfig.accel`, Goldstein et al. 2014 Alg. 8) and
safeguarded type-II Anderson extrapolation (`ADMMConfig.anderson_m`,
Walker & Ni 2011 with SCS-style restart-on-increase). Both reach the
same constrained optimum as plain ADMM; they differ in how much of the
slow linear consensus tail they remove. On the control-bounds LQT with
a deliberately 1000x-too-small penalty (the worst case for plain ADMM's
linear rate) plain, Nesterov and Anderson stop at a 2000-iteration cap
in float32 (under float64 the tail floor drops away), and on the
well-scaled problem Anderson halves the count. The PyTorch twin of
`examples/admm_acceleration.py`, in float32 on the CUDA card unless
`--device` names another.

Run: python examples_torch/admm_acceleration.py [--device cpu]
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.problem import ADMMConfig, SolveStatus
from ilqr_admm_tpu_torch.projections import project_bound
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
    Qs = torch.stack([torch.zeros((d, d), **like), torch.eye(d, **like) * 1e3])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)
    proj_u = lambda u: project_bound(u, -5.0, 5.0)
    x0 = torch.zeros(d, **like)

    variants = {
        "plain": dict(),
        "nesterov": dict(accel=True),
        "anderson(m=5)": dict(anderson_m=5),
    }

    # tol 5e-4: just above the f32 dual-residual floor of this problem
    # (~3e-4 — the x-update's factored solve noise; under float64 the
    # floor drops away and tol can be driven to 1e-6+)
    out = {}
    for rho, label in ((1e-2, "well-scaled rho=1e-2"),
                       (1e-5, "mis-scaled rho=1e-5 (1000x too small)")):
        print(f"\n-- {label} --")
        sols = {}
        for name, kw in variants.items():
            xs, us, info = lqt_admm_batch(
                A, B, cost, x0, project_u=proj_u, rho_u=rho,
                cfg=ADMMConfig(max_iter=2000, tol=5e-4, stall_tol=1e-15, **kw),
            )
            c = float(cost(xs.reshape(N, d), us.reshape(N, m)))
            status = SolveStatus(int(info.status)).name
            sols[name] = (us.cpu().numpy(), status)
            out[(rho, name)] = dict(iters=int(info.iters), status=status, cost=c,
                                    u_max=float(us.abs().max()))
            print(f"  {name:14s}: {int(info.iters):5d} iters  "
                  f"status={status:10s} cost={c:.4f} "
                  f"max|u|={float(us.abs().max()):.5f}")
        # all variants that converged agree on the solution
        conv = [u for u, st in sols.values() if st == "CONVERGED"]
        for u in conv[1:]:
            assert np.max(np.abs(u - conv[0])) < 1e-2
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(**vars(p.parse_args()))
