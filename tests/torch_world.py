"""Worlds of gloo ranks on the CPU for the tests of the port's scale-out
layer (`ilqr_admm_tpu_torch/parallel/`).

A world is `nproc` processes of this file, each one rank: it joins the
world through `distributed.initialize(coordinator_address=...)`, reads
its inputs from `inputs.npz` in a directory, runs every case of one
group (`GROUPS`) and writes what each case returned, or the error it
raised, to `rank<r>.pt` there. A rank imports torch, numpy and the port,
never jax. The problems the cases solve are built here too, so that the
tests run the same ones unsharded in their own process.

    python tests/torch_world.py <group> <rank> <nproc> <port> <directory>
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator  # noqa: E402
from ilqr_admm_tpu_torch.ops.constrained_riccati import ilqr_backward_box_parallel  # noqa: E402
from ilqr_admm_tpu_torch.ops.fused_admm import make_fused_lqt_admm  # noqa: E402
from ilqr_admm_tpu_torch.ops.parallel_riccati import (  # noqa: E402
    _combine,
    _identity_elems,
    value_elements,
)
from ilqr_admm_tpu_torch.ops.riccati import quad_cost_model  # noqa: E402
from ilqr_admm_tpu_torch.parallel import (  # noqa: E402
    batched_al_solve,
    batched_boxddp_solve,
    batched_ilqr_solve,
    batched_lqt_admm_dp,
    distributed,
    instance_sharding,
    lqt_backward_time_sharded,
    make_mesh,
    mc_success_rate,
    project_set_convex_sharded,
    sharded_instance_solve,
    time_sharded_suffix_scan,
)
from ilqr_admm_tpu_torch.parallel.mesh import axis_group, replicated  # noqa: E402
from ilqr_admm_tpu_torch.parallel.time_sharded import (  # noqa: E402
    _local_suffix_scan,
    ilqr_backward_time_sharded,
)
from ilqr_admm_tpu_torch.problem import ADMMConfig, ILQRConfig  # noqa: E402
from ilqr_admm_tpu_torch.projections import project_bound, project_soc_unit  # noqa: E402
from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost  # noqa: E402

F64 = torch.float64
RANK_TIMEOUT = 120  # seconds a world may take


# ---------------------------------------------------------------- problems

def di_problem(N: int, weight: float, dtype=F64):
    """`tests/test_parallel.py::_problem` (N = 50, weight 1e4) and the
    fleet of `tests/test_distributed.py` (N = 16, weight 1e3): the 1-D
    double integrator to (1, 0) at the last step, u_std 1e-2. Returns
    (A, B, cost, (f, get_AB, get_Cs, cost))."""
    plant = DoubleIntegrator(1, 2, dt=1.0 / N, device="cpu", dtype=dtype)
    A, B = plant.AB(N)
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    zs = torch.tensor(np.stack([np.zeros(2), [1.0, 0.0]]), dtype=dtype)
    Qs = torch.tensor(np.stack([np.zeros((2, 2)), np.eye(2) * weight]), dtype=dtype)
    cost = viapoint_cost(zs, Qs, seq, 1e-2, 1)
    fns = (lambda x, u: plant.A @ x + plant.B @ u, lambda xs, us: (A, B),
           lambda xs, us: quad_cost_model(cost.Q, cost.xd, cost.R, xs, us), cost)
    return A, B, cost, fns


def project_u5(u):
    return project_bound(u, -5.0, 5.0)


def lqt_admm_fleet(x0s):
    """`test_sharded_matches_unsharded`'s fleet: |u| <= 5, rho_u 1e-2, 50
    iterations at tol 1e-4. Returns (x, u, iters)."""
    A, B, cost, _ = di_problem(50, 1e4)
    return batched_lqt_admm_dp(A, B, cost, x0s, project_u=project_u5, rho_u=1e-2,
                               cfg=ADMMConfig(max_iter=50, tol=1e-4), device="cpu")


def fused_fleet():
    """The u-only fused fleet of `tests/test_torch_fused_admm.py` (N = 40,
    f32, |u| <= 5, rho_u 1e-2, 50 iterations, tiles of 8): on CPU tensors
    its plain version."""
    A, B, cost, _ = di_problem(40, 1e3, torch.float32)
    return make_fused_lqt_admm(A, B, cost, u_lower=-5.0, u_upper=5.0, rho_u=1e-2, n_iters=50,
                               batch_tile=8, refresh_every=1, device="cpu")


def ilqr_fleet(x0s, u0s):
    st = batched_ilqr_solve(*di_problem(50, 1e4)[3], x0s, u0s,
                            ILQRConfig(max_iter=10, max_line_search_iter=10), device="cpu")
    return st._asdict()


def boxddp_fleet(x0s, u0s):
    st = batched_boxddp_solve(*di_problem(50, 1e4)[3], x0s, u0s, -5.0, 5.0,
                              cfg=ILQRConfig(max_iter=15), device="cpu")
    return st._asdict()


def al_fleet(x0s, u0s):
    res = batched_al_solve(*di_problem(50, 1e4)[3], x0s, u0s,
                           ineq=lambda x, u: torch.cat([u - 5.0, -u - 5.0]),
                           cfg=ILQRConfig(max_iter=30), n_al=10, tol_con=1e-8, device="cpu")
    return res._asdict()


def box_success(v):
    return (v.abs().amax(dim=-1) < 1.5).to(torch.float32)


def fleet_costs(x0s):
    """Per-instance costs of `tests/test_distributed.py`'s fleet (N = 16,
    |u| <= 5, rho_u 1e-2, 10 iterations at tol 1e-4), in float64."""
    A, B, cost, _ = di_problem(16, 1e3)
    x, u, _ = batched_lqt_admm_dp(A, B, cost, x0s, project_u=project_u5, rho_u=1e-2,
                                  cfg=ADMMConfig(max_iter=10, tol=1e-4), device="cpu")
    return cost(x.reshape(-1, 16, 2), u.reshape(-1, 16, 1))


def hetero_projection(y, idx):
    """SOC blocks below index 2, the box |y| <= 0.8 from index 2 on."""
    soc = project_soc_unit(y)
    box = project_bound(y, -0.8, 0.8)
    return torch.where((idx < 2).reshape((-1,) + (1,) * (y.ndim - 1)), soc, box)


def lqt_elements(A, B, Q, xd, R):
    """The LQT value elements and the suffix scan's combine and identity."""
    elems, _, _ = value_elements(A, B, Q, xd, R)
    d = A.shape[-1]
    return elems, _combine, lambda p: _identity_elems(p, d, A.dtype, A.device)


# ---------------------------------------------------------------- cases

def _t(inputs, key):
    return torch.tensor(inputs[key])


def _errors(fn):
    """What fn raised, as 'Type: message' (the case must raise)."""
    try:
        fn()
    except (ValueError, TypeError, RuntimeError) as exc:
        return {"error": f"{type(exc).__name__}: {exc}"}
    return {"error": ""}


def _parallel_cases(inputs):
    mesh = make_mesh(device="cpu")
    x0s_i, u0s_i = _t(inputs, "ilqr_x0s"), torch.zeros((32, 50, 1), dtype=F64)
    x0s_b, u0s_b = _t(inputs, "box_x0s"), torch.zeros((16, 50, 1), dtype=F64)
    x0s_a = _t(inputs, "al_x0s")
    vals = _t(inputs, "mc_vals")

    def placements():
        dt = distribute_tensor(vals, mesh, instance_sharding(mesh))
        dr = distribute_tensor(vals, mesh, replicated(mesh))
        return {"local": dt.to_local(), "full": dt.full_tensor(), "replicated": dr.to_local()}

    return {
        "lqt_admm": lambda: dict(zip(("x", "u", "iters"), sharded_instance_solve(
            lqt_admm_fleet, mesh, _t(inputs, "lqt_x0s")))),
        "fused": lambda: dict(zip(("x", "u", "z_x", "z_u"), sharded_instance_solve(
            fused_fleet(), mesh, _t(inputs, "fused_x0s")))),
        "ilqr": lambda: sharded_instance_solve(ilqr_fleet, mesh, x0s_i, u0s_i),
        "boxddp": lambda: sharded_instance_solve(boxddp_fleet, mesh, x0s_b, u0s_b),
        "al": lambda: sharded_instance_solve(al_fleet, mesh, x0s_a, torch.zeros_like(u0s_b)),
        "mc_rate": lambda: {"rate": mc_success_rate(box_success, mesh, vals)},
        "placements": placements,
        "indivisible": lambda: _errors(
            lambda: sharded_instance_solve(lambda x: x, mesh, torch.zeros((5, 2)))),
        "scalar_output": lambda: _errors(
            lambda: sharded_instance_solve(lambda x: x.sum(), mesh, torch.zeros((4, 2)))),
    }


def _consensus_cases(inputs):
    mesh = make_mesh(axis_names=("consensus",), device="cpu")
    kw = dict(mesh=mesh)

    def run(prefix, proj=project_soc_unit, **opts):
        return {"x": project_set_convex_sharded(
            _t(inputs, f"{prefix}_y"), _t(inputs, f"{prefix}_As"), _t(inputs, f"{prefix}_bs"),
            proj, **opts, **kw)}

    def mesh2d():
        m2 = make_mesh((2, 2), ("data", "consensus"), device="cpu")
        x = project_set_convex_sharded(_t(inputs, "wide_y"), _t(inputs, "wide_As"),
                                       _t(inputs, "wide_bs"), project_soc_unit, rho=2.0,
                                       max_iter=80, threshold=1e-8, mesh=m2)
        return {"x": x, "consensus_size": axis_group(m2, "consensus")[1]}

    return {
        "padding": lambda: run("chance", rho=1e1, max_iter=50, threshold=1e-6),
        "full_axis": lambda: run("full", rho=2.0, max_iter=80, threshold=1e-8),
        "mesh2d": mesh2d,
        "hetero": lambda: run("hetero", hetero_projection, rho=1.5, max_iter=100,
                              threshold=1e-8),
        "unbatched": lambda: run("point", rho=1e1, max_iter=50, threshold=1e-8),
        "empty": lambda: _errors(lambda: project_set_convex_sharded(
            torch.zeros(2, dtype=F64), torch.zeros((0, 3, 2), dtype=F64),
            torch.zeros((0, 3), dtype=F64), project_soc_unit, mesh=mesh)),
    }


def _time_cases(inputs):
    mesh = make_mesh(axis_names=("time",), device="cpu")
    lqt = [_t(inputs, f"lqt_{k}") for k in ("A", "B", "Q", "xd", "R")]
    reg = [_t(inputs, f"reg_{k}") for k in ("A", "B", "Q", "xd", "R", "Qr", "xr", "Rr", "ur")]
    il = [_t(inputs, f"ilqr_{k}") for k in ("A", "B", "Cts", "cts", "drift")]
    bx = [_t(inputs, f"box_{k}") for k in ("A", "B", "Cts", "cts", "u_nom", "lo", "hi")]

    def scan():
        elems, comb, ident = lqt_elements(*lqt)
        group, P, i = axis_group(mesh, "time")
        L = lqt[0].shape[0] // P
        _, S = _local_suffix_scan(comb, ident, tuple(x[i * L:(i + 1) * L] for x in elems),
                                  group, i, P)
        whole = time_sharded_suffix_scan(comb, ident, elems, mesh, "time")
        return {"scan": list(whole), "S": list(S), "rank": i, "L": L}

    def ilqr():
        K, k = ilqr_backward_time_sharded(*il, mesh=mesh)
        Kv, kv, J, eta = ilqr_backward_time_sharded(*il, mesh=mesh, return_value=True)
        return {"K": K, "k": k, "Kv": Kv, "kv": kv, "J": J, "eta": eta}

    return {
        "lqt": lambda: lqt_backward_time_sharded(*lqt, mesh=mesh)._asdict(),
        "lqt_reg_fast": lambda: lqt_backward_time_sharded(*reg, mesh=mesh,
                                                          fast_inverse=True)._asdict(),
        "indivisible": lambda: _errors(lambda: lqt_backward_time_sharded(
            *(x[:30] for x in lqt), mesh=mesh)),
        "scan": scan,
        "ilqr": ilqr,
        "box": lambda: dict(zip(("K", "k"), ilqr_backward_box_parallel(*bx, mesh=mesh))),
    }


def _distributed_cases(inputs, initialized):
    mesh = make_mesh(device="cpu")
    x0s = inputs["fleet_x0s"]

    def host_shard():
        ids = distributed.host_shard(np.arange(100))
        ragged = distributed.host_shard(inputs["ragged"])
        return {"first": int(ids[0]), "last": int(ids[-1]), "ragged_local": torch.tensor(ragged),
                "ragged_global": distributed.make_global_batch(ragged, mesh)}

    def fleet():
        garr = distributed.make_global_batch(distributed.host_shard(x0s), mesh)
        return {"mean_cost": mc_success_rate(fleet_costs, mesh, garr), "global": garr}

    return {
        "initialize": lambda: {"returned": initialized, "world": torch.distributed.get_world_size(),
                               "backend": torch.distributed.get_backend(),
                               "again": distributed.initialize("localhost:1", 2, 0,
                                                               device="cpu")},
        "host_shard": host_shard,
        "fleet": fleet,
    }


GROUPS = {"parallel": _parallel_cases, "consensus": _consensus_cases, "time": _time_cases,
          "distributed": _distributed_cases}


def _rank_main(group: str, rank: int, nproc: int, port: int, directory: str):
    torch.set_num_threads(1)
    initialized = distributed.initialize(f"localhost:{port}", nproc, rank, device="cpu")
    inputs = dict(np.load(Path(directory) / "inputs.npz"))
    make = GROUPS[group]
    cases = make(inputs, initialized) if group == "distributed" else make(inputs)
    out = {}
    for name, case in cases.items():
        try:
            out[name] = case()
        except Exception as exc:  # recorded for the test of this case
            out[name] = {"error": f"{type(exc).__name__}: {exc}", "failed": True}
    torch.save(out, Path(directory) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------- the parent side

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(group: str, nproc: int, inputs: dict, directory: Path) -> list[dict]:
    """Run `group`'s cases on a world of nproc gloo ranks; returns each
    rank's {case: outputs}. Fails if a rank exits non-zero or the world
    outlasts RANK_TIMEOUT."""
    directory = Path(directory)
    np.savez(directory / "inputs.npz", **inputs)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(key, None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, group, str(r), str(nproc), str(port), str(directory)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        for r in range(nproc)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of the {group!r} world exited {p.returncode}:\n{log}"
    return [torch.load(directory / f"rank{r}.pt") for r in range(nproc)]


def case(world: list[dict], name: str) -> list:
    """The case's outputs on every rank; fails with a rank's error if it raised."""
    outs = [rank[name] for rank in world]
    for r, out in enumerate(outs):
        assert not (isinstance(out, dict) and out.get("failed")), f"rank {r}: {out['error']}"
    return outs


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
