"""Primal-dual (multiple-shooting) iLQR from an infeasible start.

Beyond the reference: its iLQR is single-shooting — every iterate is a
rollout of the controls, so the only way to initialize is a control
guess. The primal-dual solver (`solvers/pd_ilqr.py`, PAPERS.md arXiv
2403.00748) treats the STATE PATH as a decision variable too: here the
car is initialized with a straight line drawn from start to goal (no
controls at all, dynamics violated everywhere) and the solver closes the
defects while optimizing, landing on the same optimum as single-shooting
iLQR. The PyTorch twin of `examples/pd_ilqr_infeasible_start.py`, in
float32 on the CUDA card unless `--device` names another.

Run: python examples_torch/pd_ilqr_infeasible_start.py [--device cpu]
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from ilqr_admm_tpu_torch.models.car import CarSimple
from ilqr_admm_tpu_torch.ops.riccati import quad_cost_model
from ilqr_admm_tpu_torch.problem import ILQRConfig
from ilqr_admm_tpu_torch.solvers.ilqr import ilqr_init, ilqr_solve
from ilqr_admm_tpu_torch.solvers.pd_ilqr import pd_ilqr_init, pd_ilqr_solve
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.utils.device import resolve_device


def main(device=None):
    device = resolve_device(device)
    like = dict(dtype=torch.get_default_dtype(), device=device)
    N = 60
    car = CarSimple(dt=0.1)
    target = torch.tensor([1.5, 1.0, 0.0, 0.0], **like)
    zs = torch.stack([target, target])
    Qs = torch.stack([
        torch.diag(torch.tensor([1.0, 1.0, 0.0, 0.1], **like)) * 1e-2,
        torch.diag(torch.tensor([20.0, 20.0, 0.0, 1.0], **like)),
    ])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(zs, Qs, seq, 1e-2, 2)
    get_Cs = lambda xs, us: quad_cost_model(quad.Q, quad.xd, quad.R, xs, us)

    def cost_fn(xs, us):
        dx = xs - quad.xd
        return (torch.einsum("ti,tij,tj->", dx, quad.Q, dx)
                + torch.einsum("ti,tij,tj->", us, quad.R, us))

    x0 = torch.tensor([0.0, 0.0, 0.3, 0.0], **like)

    # straight-line state guess, zero controls — infeasible everywhere
    line = torch.linspace(0.0, 1.0, N, **like)[:, None] * (target - x0)[None] + x0[None]
    line[0] = x0
    st0 = pd_ilqr_init(cost_fn, car.step, line, torch.zeros((N, 2), **like), device=device)
    out = dict(init_defect=float(st0.defect), init_cost=float(st0.cost))
    print(f"init: max defect {float(st0.defect):.4f} (dynamics violated), "
          f"cost {float(st0.cost):.4f}")

    st = pd_ilqr_solve(
        car.step, car.get_AB, get_Cs, cost_fn, st0,
        ILQRConfig(max_iter=80, tol_fun=1e-9),
    )
    ref = ilqr_solve(
        car.step, car.get_AB, get_Cs, quad,
        ilqr_init(car.step, cost_fn, x0, torch.zeros((N, 2), **like), device=device),
        ILQRConfig(max_iter=60),
    )
    out.update(cost=float(st.cost), defect=float(st.defect), iterations=int(st.iteration),
               reference_cost=float(ref.cost), final=st.x_nom[-1][:2].tolist())
    print(f"pd-ilqr  : cost {float(st.cost):.5f}, max defect "
          f"{float(st.defect):.1e}, {int(st.iteration)} iterations")
    print(f"reference: cost {float(ref.cost):.5f} (single-shooting iLQR)")
    print(f"final pos {st.x_nom[-1][:2].cpu().numpy().round(3)} "
          f"(target {target[:2].cpu().numpy()})")
    assert float(st.defect) < 1e-5
    assert abs(float(st.cost) - float(ref.cost)) < 2e-2
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(**vars(p.parse_args()))
