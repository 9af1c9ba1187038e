"""boxDDP vs iLQR-ADMM on the control-limited car-parking task.

The reference reaches Tassa's control-limited DDP benchmark only through
ADMM splitting (`Car/Replicate of control-limited ddp car example.ipynb`);
this example runs the *first-class* DP treatment — the box-QP backward
pass (`solvers/boxddp.py`) — against the ADMM path on the same problem,
and a barrier interior-point solve with a per-stage SOC on the controls
(an input cone the reference cannot express at all). The PyTorch twin
of `examples/boxddp_car_parking.py`, in float32 on the CUDA card unless
`--device` names another.

Run: python examples_torch/boxddp_car_parking.py [--animate [out.gif]] [--device cpu]
--animate renders the boxDDP parking maneuver to a GIF (reference
parity: DDP-replicate notebook cell 22's animation).
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from ilqr_admm_tpu_torch.models.car import CarFrontWheel, CarParkingCost
from ilqr_admm_tpu_torch.problem import ILQRConfig
from ilqr_admm_tpu_torch.solvers.barrier_ilqr import barrier_ilqr_solve, make_barrier
from ilqr_admm_tpu_torch.solvers.boxddp import boxddp_init, boxddp_solve
from ilqr_admm_tpu_torch.solvers.ilqr import ilqr_init, ilqr_solve
from ilqr_admm_tpu_torch.problem import SolveStatus
from ilqr_admm_tpu_torch.utils.device import resolve_device


def main(device=None):
    device = resolve_device(device)
    like = dict(dtype=torch.get_default_dtype(), device=device)
    N = 500
    car = CarFrontWheel(dt=15.0 / N)
    cost = CarParkingCost(**like)
    rng = np.random.default_rng(0)
    u0 = torch.tensor(rng.normal(size=(N, 2)) * 0.1, **like)
    x0 = torch.tensor([1.0, 1.0, 3.0 * np.pi / 2, 0.0], **like)
    lo = torch.tensor([-0.5, -2.0], **like)
    hi = torch.tensor([0.5, 2.0], **like)
    cfg = ILQRConfig(max_iter=100, tol_fun=1e-7)

    st_u = ilqr_solve(
        car.step, car.get_AB, cost.get_Cs, cost,
        ilqr_init(car.step, cost, x0, u0, device=device), cfg=cfg,
    )
    out = dict(ilqr_cost=float(st_u.cost), ilqr_status=SolveStatus(int(st_u.status)).name)
    print(f"unconstrained iLQR: cost {float(st_u.cost):.4f} "
          f"(reference ~0.93), status {SolveStatus(int(st_u.status)).name}")

    st_b = boxddp_solve(
        car.step, car.get_AB, cost.get_Cs, cost,
        boxddp_init(car.step, cost, x0, u0, lo, hi, device=device),
        u_lower=lo, u_upper=hi, cfg=cfg,
    )
    us = st_b.u_nom.cpu().numpy()
    u_rel = np.abs(us / np.asarray([0.5, 2.0])).max()
    out.update(boxddp_cost=float(st_b.cost), boxddp_u_rel=float(u_rel),
               boxddp_status=SolveStatus(int(st_b.status)).name)
    print(f"boxDDP |u1|<=0.5 |u2|<=2: cost {float(st_b.cost):.4f} "
          f"(reference ADMM path 1.903), max|u| {u_rel:.6f} "
          f"of bound, status {SolveStatus(int(st_b.status)).name}")

    # r4: the exactness-certified time-parallel backward — same optimum,
    # O(log N) backward depth
    st_p = boxddp_solve(
        car.step, car.get_AB, cost.get_Cs, cost,
        boxddp_init(car.step, cost, x0, u0, lo, hi, device=device),
        u_lower=lo, u_upper=hi,
        cfg=ILQRConfig(max_iter=250, tol_fun=1e-7),  # each iteration is
        # O(log N) deep, so a larger cap still wins the wall clock
        riccati="parallel",
    )
    out.update(parallel_cost=float(st_p.cost),
               parallel_status=SolveStatus(int(st_p.status)).name)
    print(f"boxDDP parallel backward: cost {float(st_p.cost):.4f} "
          f"(sequential optimum 1.9053), "
          f"status {SolveStatus(int(st_p.status)).name}")

    # input cone: ||W u_t|| <= 1 with W = diag(1/0.5, 1/2.0) — a smooth
    # coupling of steering and acceleration authority
    W = torch.tensor([2.0, 0.5], **like)
    barrier = make_barrier(
        soc=lambda x, u: [(torch.tensor(1.0, dtype=u.dtype, device=u.device), W * u)]
    )
    st_c = barrier_ilqr_solve(
        car.step, car.get_AB, cost.get_Cs, cost, x0, 0.0 * u0, barrier,
        cfg=ILQRConfig(max_iter=60, tol_fun=1e-9),
        mu0=1.0, mu_factor=6.0, n_barrier=8, device=device,
    )
    nrm = np.linalg.norm(st_c.u_nom.cpu().numpy() * W.cpu().numpy(), axis=-1)
    out.update(barrier_cost=float(st_c.cost), barrier_norm=float(nrm.max()),
               barrier_status=SolveStatus(int(st_c.status)).name)
    print(f"barrier SOC ||W u||<=1: cost {float(st_c.cost):.4f}, "
          f"max||W u|| {nrm.max():.6f}, status {SolveStatus(int(st_c.status)).name}")
    out["state"] = st_b  # for --animate
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--animate", nargs="?", const="car_parking.gif", default=None,
                   metavar="OUT.gif")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args()
    st = main(args.device)["state"]
    if args.animate is not None:
        from ilqr_admm_tpu_torch.viz import animate_car

        path = animate_car(
            st.x_nom.cpu().numpy(), st.u_nom.cpu().numpy(), args.animate,
            xlim=(-3, 3), ylim=(-3, 3), stride=10, fps=12,
        )
        print(f"animation written to {path}")
