"""Inverse optimal control through the constrained solver.

Differentiable ADMM (IFT fixed-point VJP, `solvers/implicit.py`) lets
gradients flow through the *constrained* LQT solution. This demo:

1. generates a demonstration trajectory from a control-bounded LQT
   problem with a hidden control bound and a hidden via-point target;
2. recovers both by gradient descent on the squared trajectory mismatch
   — gradients computed through the ADMM fixed point, not by unrolling.

Capability beyond the reference (pure NumPy, no autodiff). The PyTorch
twin of `examples/inverse_lqt_learning.py`, in float64 on the CUDA card
unless `--device` names another; `torch.autograd` takes the gradient
through `lqt_admm_implicit`, and `torch.optim.Adam` takes the steps.

Run: python examples_torch/inverse_lqt_learning.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import argparse

import numpy as np
import torch

from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.projections import project_bound
from ilqr_admm_tpu_torch.solvers.implicit import lqt_admm_implicit
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.utils.device import resolve_device
from ilqr_admm_tpu_torch.utils.precision import use_x64


def main(device=None):
    device = resolve_device(device)
    use_x64()
    like = dict(dtype=torch.float64, device=device)
    N = 40
    di = DoubleIntegrator(1, 2, dt=1.0 / N, **like)
    d, m = di.x_dim, di.u_dim
    zs = torch.stack([torch.zeros(d, **like), torch.tensor([1.0, 0.0], **like)])
    Qs = torch.stack([torch.zeros((d, d), **like), torch.eye(d, **like) * 1e3])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = di.AB(N)
    proj_u = lambda v, p: project_bound(v, -p, p)

    def solve(target, bound):
        xd = torch.cat([quad.xd[:-1], torch.stack([target, quad.xd[-1, 1]])[None]])
        theta = dict(Q=quad.Q, R=quad.R, xd=xd, x0=torch.zeros(d, **like), pu=bound)
        return lqt_admm_implicit(A, B, theta, project_u=proj_u, rho_u=1e-1)

    true_target, true_bound = 0.7, 2.5
    xs_demo, us_demo = solve(torch.tensor(true_target, **like), torch.tensor(true_bound, **like))
    print(f"demonstration: max|u| = {float(us_demo.abs().max()):.4f} "
          f"(hidden bound {true_bound}), final pos = {float(xs_demo[-1, 0]):.4f} "
          f"(hidden target {true_target})")

    def loss(params):
        xs, us = solve(params["target"], params["bound"])
        return torch.sum((xs - xs_demo) ** 2) + torch.sum((us - us_demo) ** 2)

    # note: d(loss)/d(bound) is exactly zero wherever the bound is slack
    # (correct IFT behavior) — initialize inside the active region
    params = dict(target=torch.tensor(0.2, requires_grad=True, **like),
                  bound=torch.tensor(3.0, requires_grad=True, **like))
    opt = torch.optim.Adam(list(params.values()), lr=5e-2)
    for i in range(150):
        opt.zero_grad()
        loss(params).backward()
        opt.step()
        if i % 30 == 0:
            with torch.no_grad():
                print(f"iter {i:3d}: target={float(params['target']):.4f} "
                      f"bound={float(params['bound']):.4f} loss={float(loss(params)):.3e}")

    out = {k: float(v.detach()) for k, v in params.items()}
    print(f"recovered: target={out['target']:.4f} (true {true_target}), "
          f"bound={out['bound']:.4f} (true {true_bound})")
    assert abs(out["target"] - true_target) < 5e-3
    assert abs(out["bound"] - true_bound) < 5e-2
    print("OK")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(**vars(p.parse_args()))
