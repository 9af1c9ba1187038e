"""Port vs JAX package: instance-sharded fleets (`parallel/batch.py`).

The counterpart of `tests/test_parallel.py`. A world of 2 gloo ranks
(`tests/torch_world.py`, importing only the port) runs every fleet of
that file through `sharded_instance_solve`: the LQT-ADMM fleet with the
DP x-update, the fused LQT-ADMM fleet (its plain version on the CPU),
the multi-start iLQR, the boxDDP fleet and the AL fleet. Each rank's
gathered result must equal the unsharded port's to 1e-12 and the JAX
package's `jax.vmap` result to the tolerances of
`tests/test_torch_batch.py` (cost 1e-10 relative, trajectories 1e-8) and,
for the fused fleet, of `tests/test_torch_fused_admm.py` (5e-2 against
the interpret-mode Pallas kernel, which rounds through bf16x3). Inputs
are numpy from seeds, float64 except the fused fleet's float32.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torch_world
from ilqr_admm_tpu.ops.pallas_admm import make_pallas_lqt_admm
from ilqr_admm_tpu.parallel import batch as jb
from ilqr_admm_tpu.problem import ADMMConfig as JADMM, ILQRConfig as JConfig
from ilqr_admm_tpu.projections import project_bound as j_project_bound
from ilqr_admm_tpu_torch.parallel import mc_success_rate
from ilqr_admm_tpu_torch.solvers.al_ilqr import ALResult
from ilqr_admm_tpu_torch.solvers.ilqr import ILQRState
from test_torch_batch import COST_TOL, TRAJ_TOL, _assert_fleet, _problem, _rel, _same_stops
from test_torch_fused_admm import _problem as _fused_problem
from test_torch_fused_admm import _x0s

torch.set_num_threads(2)

SHARD_TOL = 1e-12
NPROC = 2
FUSED_TOL = 5e-2


def _inputs():
    rng = np.random.default_rng
    return {"lqt_x0s": rng(0).normal(0, 0.1, size=(24, 2)), "fused_x0s": _x0s(0, 16),
            "ilqr_x0s": rng(1).normal(0, 0.2, size=(32, 2)),
            "box_x0s": rng(0).normal(0, 0.1, size=(16, 2)),
            "al_x0s": rng(1).normal(0, 0.1, size=(16, 2)),
            "mc_vals": rng(2).normal(size=(800, 4))}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return torch_world.run_world("parallel", NPROC, _inputs(), tmp_path_factory.mktemp("world"))


def _max_diff(got, want):
    return float((torch.as_tensor(got, dtype=torch.float64)
                  - torch.as_tensor(want, dtype=torch.float64)).abs().max())


def _assert_sharded(outs, want: dict, keys):
    """Every rank's gathered outputs against the unsharded port's."""
    for r, out in enumerate(outs):
        for k in keys:
            assert out[k].shape == want[k].shape, (r, k)
            assert _max_diff(out[k], want[k]) <= SHARD_TOL, (r, k, _max_diff(out[k], want[k]))


def test_lqt_admm_dp_fleet_sharded(world):
    """`test_sharded_matches_unsharded`: 24 instances, 12 a rank."""
    x0s = _inputs()["lqt_x0s"]
    want = dict(zip(("x", "u", "iters"), torch_world.lqt_admm_fleet(torch.tensor(x0s))))
    _assert_sharded(torch_world.case(world, "lqt_admm"), want, ("x", "u", "iters"))
    (A, B, jc), _, _, _ = _problem()
    x_j, u_j, it_j = jb.batched_lqt_admm_dp(
        A, B, jc, jnp.asarray(x0s), project_u=lambda u: j_project_bound(u, -5.0, 5.0),
        rho_u=1e-2, cfg=JADMM(max_iter=50, tol=1e-4))
    got = torch_world.case(world, "lqt_admm")[0]
    assert got["iters"].tolist() == np.asarray(it_j).tolist()
    assert _rel(got["x"], x_j) < TRAJ_TOL and _rel(got["u"], u_j) < TRAJ_TOL


def test_fused_fleet_sharded(world):
    """The fused u-only fleet, 16 instances: one tile of 8 a rank."""
    x0s = _inputs()["fused_x0s"]
    keys = ("x", "u", "z_x", "z_u")
    want = dict(zip(keys, torch_world.fused_fleet()(torch.tensor(x0s))))
    _assert_sharded(torch_world.case(world, "fused"), want, keys)
    A, B, cost = _fused_problem()
    x_p, u_p, _, zu_p = make_pallas_lqt_admm(
        A, B, cost, interpret=True, u_lower=-5.0, u_upper=5.0, rho_u=1e-2, n_iters=50,
        batch_tile=8, refresh_every=1)(jnp.asarray(x0s))
    got = torch_world.case(world, "fused")[0]
    for k, ref in (("x", x_p), ("u", u_p), ("z_u", zu_p)):
        assert np.abs(got[k].numpy() - np.asarray(ref)).max() < FUSED_TOL, k
    assert float(got["z_u"].abs().max()) <= 5.0 + 1e-5


FLEET_KEYS = ("x_nom", "u_nom", "cost", "prev_cost", "iteration", "status")


def _fleet_inputs(key, n):
    return _inputs()[key], np.zeros((n, 50, 1))


def test_ilqr_multistart_sharded(world):
    """`test_batched_ilqr_multistart_sharded`: 32 starts, 10 iterations."""
    x0s, u0s = _fleet_inputs("ilqr_x0s", 32)
    want = torch_world.ilqr_fleet(torch.tensor(x0s), torch.tensor(u0s))
    outs = torch_world.case(world, "ilqr")
    _assert_sharded(outs, want, FLEET_KEYS)
    _, _, jfns, _ = _problem()
    jwant = jb.batched_ilqr_solve(*jfns, jnp.asarray(x0s), jnp.asarray(u0s),
                                  JConfig(max_iter=10, max_line_search_iter=10))
    _assert_fleet(ILQRState(**outs[0]), jwant)


def test_boxddp_fleet_sharded(world):
    """`test_boxddp_fleet_sharded`: 16 instances, |u| <= 5, 15 iterations."""
    x0s, u0s = _fleet_inputs("box_x0s", 16)
    want = torch_world.boxddp_fleet(torch.tensor(x0s), torch.tensor(u0s))
    outs = torch_world.case(world, "boxddp")
    _assert_sharded(outs, want, FLEET_KEYS)
    _, _, jfns, _ = _problem()
    jwant = jb.batched_boxddp_solve(*jfns, jnp.asarray(x0s), jnp.asarray(u0s), -5.0, 5.0,
                                    cfg=JConfig(max_iter=15))
    _assert_fleet(ILQRState(**outs[0]), jwant)
    assert float(outs[0]["u_nom"].abs().max()) <= 5.0 + 1e-12


def test_al_fleet_sharded(world):
    """`test_al_fleet_sharded`: 16 instances, |u| <= 5 as AL inequalities;
    all feasible."""
    x0s, u0s = _fleet_inputs("al_x0s", 16)
    want = torch_world.al_fleet(torch.tensor(x0s), torch.tensor(u0s))
    outs = torch_world.case(world, "al")
    _assert_sharded(outs, want, ("x_nom", "u_nom", "cost", "max_violation", "lam_ineq",
                                 "status"))
    assert all(out["lam_eq"] is None for out in outs)
    _, _, jfns, _ = _problem()
    jwant = jb.batched_al_solve(*jfns, jnp.asarray(x0s), jnp.asarray(u0s),
                                ineq=lambda x, u: jnp.concatenate([u - 5.0, -u - 5.0]),
                                cfg=JConfig(max_iter=30), n_al=10, tol_con=1e-8)
    got = ALResult(**outs[0])
    tol = _same_stops(got.status, jwant.status)
    assert _rel(got.cost, jwant.cost) < COST_TOL
    assert _rel(got.u_nom, jwant.u_nom) < tol and _rel(got.x_nom, jwant.x_nom) < tol
    assert float(got.max_violation.max()) < 1e-6


def test_mc_success_rate_reduced_over_the_mesh(world):
    """`test_mc_success_rate_psum`: 800 draws, 400 a rank; the all-reduced
    rate equals the host mean on every rank, and mesh=None gives it in
    one process, as the JAX package's."""
    vals = _inputs()["mc_vals"]
    host = float(np.mean(np.abs(vals).max(-1) < 1.5))
    for out in torch_world.case(world, "mc_rate"):
        assert abs(float(out["rate"]) - host) < 1e-12
    local = mc_success_rate(torch_world.box_success, None, torch.tensor(vals))
    assert abs(float(local) - host) < 1e-12
    jrate = jb.mc_success_rate(lambda v: (jnp.abs(v).max(axis=-1) < 1.5).astype(jnp.float32),
                               None, jnp.asarray(vals))
    assert abs(float(local) - float(jrate)) < 1e-6


def test_placements_shard_the_instance_axis(world):
    """`instance_sharding` and `replicated` as `torch.distributed.tensor`
    placements: rank r holds rows [400 r, 400 (r + 1)), and the tensor
    gathers back whole."""
    vals = torch.tensor(_inputs()["mc_vals"])
    for r, out in enumerate(torch_world.case(world, "placements")):
        assert torch.equal(out["local"], vals[400 * r:400 * (r + 1)])
        assert torch.equal(out["full"], vals) and torch.equal(out["replicated"], vals)


@pytest.mark.parametrize("name, error", [
    ("indivisible", "ValueError: batched argument 0 has 5 instances"),
    ("scalar_output", "TypeError: every result of a sharded solve must be a tensor"),
])
def test_sharded_solve_refuses(world, name, error):
    """A leading axis the mesh does not divide (as `shard_map`), and a
    result with no instance axis."""
    for out in torch_world.case(world, name):
        assert out["error"].startswith(error), out["error"]
