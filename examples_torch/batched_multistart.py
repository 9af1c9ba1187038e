"""Batched multi-start / scenario solves sharded over a device mesh.

The scale-out demo (no reference counterpart — the reference is single
process): thousands of independent constrained LQT-ADMM instances solved
in parallel, sharded over the mesh's 'data' axis, with an all-reduced
success-rate metric. The PyTorch twin of `examples/batched_multistart.py`,
in float32 on the CUDA card unless `--device` names another. The mesh
needs a process group, so the script starts a world of one process
itself (NCCL on the card, gloo on the CPU) and ends it when done.

Run: python examples_torch/batched_multistart.py [--batch 4096] [--device cpu]
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.parallel import (
    batched_lqt_admm_dp,
    make_mesh,
    mc_success_rate,
    sharded_instance_solve,
)
from ilqr_admm_tpu_torch.parallel import distributed
from ilqr_admm_tpu_torch.problem import ADMMConfig
from ilqr_admm_tpu_torch.projections import project_bound
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.utils.device import resolve_device


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(device=None, batch=4096):
    device = resolve_device(device)
    distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device=device)
    try:
        return _run(device, batch)
    finally:
        dist.destroy_process_group()


def _run(device, batch):
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

    mesh = make_mesh(device=device)
    n_dev = mesh.size()
    batch = (batch // n_dev) * n_dev
    print(f"mesh: {n_dev} devices, axis 'data'; batch {batch} instances")

    proj_u = lambda u: project_bound(u, -5.0, 5.0)
    cfg = ADMMConfig(max_iter=100, tol=1e-4)

    def solve_batch(x0s):
        return batched_lqt_admm_dp(A, B, cost, x0s, project_u=proj_u,
                                   rho_u=1e-2, cfg=cfg, device=device)

    rng = np.random.default_rng(0)
    x0s = torch.tensor(rng.normal(0, 0.2, size=(batch, d)), **like)

    # warmup, then timed run
    xs, us, iters = sharded_instance_solve(solve_batch, mesh, x0s)
    _sync(device)
    t0 = time.perf_counter()
    xs, us, iters = sharded_instance_solve(solve_batch, mesh, x0s)
    _sync(device)
    dt = time.perf_counter() - t0
    out = dict(batch=batch, n_dev=n_dev, seconds=dt, iterations=int(iters.sum()))
    print(f"{batch} instances solved in {dt * 1e3:.1f} ms "
          f"→ {batch / dt:.0f} solves/s, "
          f"{float(iters.sum()) / dt:.0f} ADMM iterations/s")

    def success(us_):
        return (us_.abs().amax(dim=1) <= 5.0 + 1e-2).to(torch.float32)

    rate = mc_success_rate(lambda u: success(u), mesh, us)
    out["rate"] = 100 * float(rate)
    print(f"global constraint-satisfaction rate (psum-reduced): {100 * float(rate):.2f} %")
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(**vars(p.parse_args()))
