"""Scenario fleet of chance-constrained robust syntheses, two ways.

Beyond-reference demo: the chance-constrained control-bound rows
|du_t| + psi*sigma*|phi_t| <= bound form a weighted-l1 "diamond" — the
same set as the reference's intersection-of-two-SOCs construction
(`SLS_ADMM.ipynb` c10-c12) but projectable EXACTLY in closed form
(`projections.project_weighted_l1`). A fleet of robust syntheses that
share dynamics/cost but differ in the per-scenario bound is solved with

1. the reference-style consensus-ADMM SOC intersection projection, and
2. the exact diamond projection,

through the same batched solver (`solvers/batched_sls.py`); both must
agree, and the diamond path needs no inner projection loop at all. The
fused fleet of the same synthesis is `make_fused_sls_admm`, whose loop
is the `sls_admm` CUDA kernel (z_update='diamond'). The PyTorch twin of
`examples/robust_fleet_diamond.py`, in float32 on the CUDA card unless
`--device` names another; the consensus projection runs the 64
scenarios as one batch (`batch_dims=1`, each scenario stopping on its
own, as under `jax.vmap`).

Run: python examples_torch/robust_fleet_diamond.py [--device cpu]
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch
from scipy.stats import norm

from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.projections import (
    project_set_convex,
    project_soc_unit,
    project_weighted_l1,
)
from ilqr_admm_tpu_torch.solvers.batched_sls import make_batched_sls_admm
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.utils.device import resolve_device


def main(device=None):
    device = resolve_device(device)
    f32 = torch.float32
    like = dict(dtype=f32, device=device)
    N, batch = 40, 64
    plant = DoubleIntegrator(1, 2, dt=1.0 / N, **like)
    d, m = plant.x_dim, plant.u_dim
    zs = torch.stack([torch.zeros(d, **like), torch.tensor([1.0, 0.0], **like)])
    Qs = torch.stack([torch.zeros((d, d), **like), torch.eye(d, **like) * 1e3])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)

    # 95% one-sided chance level, disturbance std 0.1 on the phi channel
    psi = float(norm.ppf(0.95))
    c = psi * 0.1

    # reference-style: rows constrained via two SOCs + consensus ADMM
    mu = np.array([1.0, 0.0])
    Au = np.diag([0.0, 0.1])
    A_hi = torch.tensor(np.concatenate([Au, (-mu / psi)[None]], 0), **like)
    A_lo = torch.tensor(np.concatenate([Au, (mu / psi)[None]], 0), **like)

    def soc_proj(y, bounds):  # y (batch, Nm, 2), one bound a scenario
        b = torch.zeros((y.shape[0], 1, 3), dtype=y.dtype, device=y.device)
        b[:, 0, 2] = bounds / psi
        return project_set_convex(y, [A_hi, A_lo], [b, b],
                                  [project_soc_unit] * 2, rho=1e1,
                                  max_iter=30, threshold=0.0, batch_dims=1)

    solve_soc = make_batched_sls_admm(
        A, B, cost, project_u=soc_proj,
        rho_u=1.0, robust_dim=1, n_iters=300, device=device,
    )

    # exact: one closed-form weighted-l1 projection per row
    def diamond_proj(y, bounds):
        return project_weighted_l1(y, torch.tensor([1.0, c], **like), bounds[:, None])

    solve_diamond = make_batched_sls_admm(
        A, B, cost, project_u=diamond_proj,
        rho_u=1.0, robust_dim=1, n_iters=300, device=device,
    )

    rng = np.random.default_rng(0)
    bounds = torch.tensor(rng.uniform(1.5, 3.0, batch), **like)

    du_s, phi_s, _ = solve_soc(bounds)
    du_d, phi_d, _ = solve_diamond(bounds)

    # pointwise agreement is limited by the CONSENSUS path's inner-loop
    # approximation error (~1e-2 on these du magnitudes), so the exact
    # path is the tighter of the two
    dev = float((du_s - du_d).abs().max())
    print(f"fleet of {batch} scenarios, N={N}: "
          f"max |du| deviation SOC-consensus vs exact diamond {dev:.2e}")

    margin = du_d.abs() + c * phi_d[:, :, 0].abs()
    worst = float((margin - bounds[:, None]).max())
    active = float((margin.amax(dim=1) > bounds * 0.98).to(f32).mean()) * 100
    print(f"diamond path: worst chance margin {worst:+.5f} "
          f"(<=0 feasible), bounds active for {active:.0f}% of fleet")
    assert dev < 5e-2 and worst < 1e-3
    print("OK")
    return dict(deviation=dev, worst_margin=worst, active=active)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    main(**vars(p.parse_args()))
