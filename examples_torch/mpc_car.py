"""Receding-horizon MPC on the simple car with disturbances.

Demonstrates `solvers/mpc.py`: a shift-and-resolve MPC step (2 iLQR
iterations per tick, no host read) tracking a target pose under process
noise and model mismatch, the closed loop captured as one CUDA graph on
the card (`run_mpc(graph=True)`), plus a vmapped fleet of controllers
(`make_mpc_fleet_step`). The PyTorch twin of `examples/mpc_car.py`, in
float32 on the CUDA card unless `--device` names another.

Run: python examples_torch/mpc_car.py [--device cpu]
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch
from torch.func import vmap

from ilqr_admm_tpu_torch.models.car import CarSimple
from ilqr_admm_tpu_torch.ops.riccati import quad_cost_model
from ilqr_admm_tpu_torch.solvers.mpc import (
    make_mpc_fleet_step,
    make_mpc_step,
    mpc_init,
    run_mpc,
)
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.utils.device import resolve_device


def main(device=None):
    device = resolve_device(device)
    like = dict(dtype=torch.get_default_dtype(), device=device)
    H, n_steps = 40, 80
    model = CarSimple(dt=0.1)           # controller's model
    plant = CarSimple(dt=0.1)           # true plant (add mismatch here)
    d, m = 4, 2

    target = torch.tensor([2.0, 1.0, 0.0, 0.0], **like)
    zs = torch.stack([target, target])
    Qs = torch.stack([
        torch.diag(torch.tensor([1.0, 1.0, 0.0, 0.1], **like)),
        torch.diag(torch.tensor([20.0, 20.0, 0.0, 1.0], **like)),
    ])
    seq = np.zeros(H, dtype=np.int32)
    seq[-1] = 1
    quad = viapoint_cost(zs, Qs, seq, 1e-2, m)

    def get_Cs(xs, us):
        return quad_cost_model(quad.Q, quad.xd, quad.R, xs, us)

    step = make_mpc_step(model.step, model.get_AB, get_Cs, quad, n_ilqr_iters=2)

    x0 = torch.tensor([0.0, 0.0, 0.5, 0.0], **like)
    state = mpc_init(model.step, x0, torch.zeros((H, m), **like), device=device)

    rng = np.random.default_rng(0)
    ws = torch.tensor(rng.normal(0, 2e-3, size=(n_steps, d)), **like)
    # on the card the closed loop is one CUDA graph, replayed n_steps times
    xs, us, _ = run_mpc(plant.step, step, state, x0, n_steps, ws=ws, graph=device.type == "cuda")

    final = xs[-1].cpu().numpy()
    print(f"MPC: after {n_steps} ticks the car is at {final[:2].round(3)} "
          f"(target {target[:2].cpu().numpy()}), |v| {abs(final[3]):.3f}")

    # fleet of controllers from different starts (vmapped step)
    x0s = torch.tensor(rng.normal(0, 0.3, size=(16, d)), **like)
    zeros = torch.zeros((H, m), **like)
    states = vmap(lambda a: mpc_init(model.step, a, zeros, device=device))(x0s)
    fleet_step = make_mpc_fleet_step(model.step, model.get_AB, get_Cs, quad, n_ilqr_iters=2)
    us0, _ = fleet_step(states, x0s)
    print(f"fleet: one vmapped MPC tick for 16 controllers -> controls {tuple(us0.shape)}")
    return dict(final=final.tolist(), fleet_controls=list(us0.shape),
                fleet_finite=bool(torch.isfinite(us0).all()))


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(**vars(p.parse_args()))
