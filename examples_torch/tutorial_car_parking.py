"""Tutorial: iLQR car parking with autodiff derivatives + control bounds.

Mirrors `Tutorial.ipynb` / `Car/Replicate of control-limited ddp car
example.ipynb`: the Tassa/Todorov control-limited DDP car-parking task
with pseudo-Huber costs, solved by iLQR (DP) and then by iLQR-ADMM with
front-wheel-angle/acceleration bounds. The PyTorch twin of
`examples/tutorial_car_parking.py`, in float32 on the CUDA card unless
`--device` names another.

Run: python examples_torch/tutorial_car_parking.py [--plot] [--device cpu]
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from ilqr_admm_tpu_torch import iSLS
from ilqr_admm_tpu_torch.models.car import CarFrontWheel, CarParkingCost
from ilqr_admm_tpu_torch.utils.device import resolve_device


def main(device=None, plot=False):
    device = resolve_device(device)
    like = dict(dtype=torch.get_default_dtype(), device=device)
    x_dim, u_dim, N = 4, 2, 500
    T = 15.0
    car = CarFrontWheel(dt=T / N)
    cost = CarParkingCost(**like)

    sls = iSLS(x_dim=x_dim, u_dim=u_dim, N=N, device=device)
    sls.forward_model = car.step  # plain torch; derivatives come from torch.func.jacfwd
    sls.cost_function = cost

    rng = np.random.default_rng(0)
    u0 = rng.normal(size=(N, u_dim)) * 0.1
    x0 = np.array([1.0, 1.0, 3 * np.pi / 2, 0.0])
    x_nom, u_nom = sls.get_trajectory_batch(x0, u0)
    sls.reset()
    sls.nominal_values = x_nom, u_nom
    out = dict(initial_cost=sls.cost)
    print(f"initial cost {sls.cost:.4f}")

    sls.solve(car.get_AB, cost.get_Cs, max_iter=100, max_line_search_iter=40,
              method="dp")
    out.update(ilqr_cost=sls.cost, ilqr_evals=len(sls.cost_log))
    print(f"iLQR final cost {sls.cost:.4f} after {len(sls.cost_log)} evals "
          f"(reference ≈ 0.9283)")
    print("final state:", sls.x_nom[-1].cpu().numpy().round(4))

    # --- control-limited variant (cells 19-21)
    lower = torch.tensor([-0.5, -2.0], **like)
    upper = torch.tensor([0.5, 2.0], **like)

    def project_u(u):
        return torch.clamp(u.reshape(N, u_dim), lower, upper).reshape(-1)

    sls.reset()
    sls.nominal_values = x_nom, u_nom
    sls.ilqr_admm(
        get_AB=car.get_AB, get_Cs=cost.get_Cs, project_u=project_u,
        max_iter=50, max_admm_iter=5, max_line_search_iter=40,
        rho_u=np.diag([1e-1, 1e-2]), tol=1e-3, verbose=True,
    )
    us = sls.u_nom.cpu().numpy()
    out.update(ilqr_admm_cost=sls.cost, steer_max=float(np.abs(us[:, 0]).max()),
               accel_max=float(np.abs(us[:, 1]).max()))
    print(f"iLQR-ADMM final cost {sls.cost:.4f} (reference ≈ 1.903); "
          f"max|steer| {np.abs(us[:, 0]).max():.3f}, max|accel| {np.abs(us[:, 1]).max():.3f}")

    if plot:
        import matplotlib.pyplot as plt
        from ilqr_admm_tpu_torch.viz import plot_convergence
        fig, ax = plt.subplots(ncols=2, figsize=(9, 4))
        xs = sls.x_nom.cpu().numpy()
        ax[0].plot(xs[:, 0], xs[:, 1])
        ax[0].plot(0, 0, "rx"); ax[0].set_aspect("equal")
        plot_convergence(sls.cost_log, ax=ax[1])
        plt.savefig("car_parking.png", dpi=120)
        print("saved car_parking.png")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--plot", action="store_true")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(**vars(p.parse_args()))
