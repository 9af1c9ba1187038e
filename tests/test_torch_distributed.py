"""Port vs JAX package: the multi-process runtime (`parallel/distributed.py`).

The counterpart of `tests/test_distributed.py`: 2 real OS processes
(`tests/torch_world.py`, importing only the port) join one gloo world
through `distributed.initialize(coordinator_address="localhost:<port>",
...)`. Each takes its `host_shard` of instance batches every process
holds (the ragged split too), assembles the global batch with
`make_global_batch`, and solves the constrained LQT-ADMM fleet of the
JAX file (N = 16, |u| <= 5, 10 iterations) over the ('data',) mesh with
the mean cost all-reduced (`mc_success_rate` of the per-instance cost).
Every process's mean must equal the single-process truth of the port
(1e-12) and of the JAX package (1e-8), both in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_world
from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu.problem import ADMMConfig
from ilqr_admm_tpu.projections import project_bound
from ilqr_admm_tpu.solvers.lqt_admm import lqt_admm_dp
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.parallel import distributed, make_mesh

torch.set_num_threads(2)

NPROC = 2
N = 16


def _inputs():
    return {"fleet_x0s": np.random.default_rng(0).normal(0, 0.1, (4 * NPROC, 2)),
            "ragged": np.arange(2 * (2 * NPROC + 1)).reshape(2 * NPROC + 1, 2)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return torch_world.run_world("distributed", NPROC, _inputs(),
                                 tmp_path_factory.mktemp("world"))


def _jax_mean_cost(x0s) -> float:
    """`tests/test_distributed.py::_single_process_truth` in float64."""
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    zs = jnp.stack([jnp.zeros(2), jnp.asarray([1.0, 0.0])])
    Qs = jnp.stack([jnp.zeros((2, 2)), jnp.eye(2) * 1e3])
    seq = np.zeros(N, np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, 1)
    A, B = plant.AB(N)

    def one(x0):
        x, u, _, _ = lqt_admm_dp(A, B, cost, x0, project_u=lambda u: project_bound(u, -5.0, 5.0),
                                 rho_u=1e-2, cfg=ADMMConfig(max_iter=10, tol=1e-4))
        return x, u

    xs, us = jax.jit(jax.vmap(one))(jnp.asarray(x0s))
    return float(jnp.mean(cost(xs.reshape(-1, N, 2), us.reshape(-1, N, 1))))


def test_two_processes_initialize_one_world(world):
    """initialize(coordinator_address=...) returns True in each of the 2
    processes, over gloo on the CPU; called again in an initialized world
    it returns False, as the JAX function's "already initialized" case."""
    for out in torch_world.case(world, "initialize"):
        assert out["returned"] is True and out["world"] == NPROC
        assert out["backend"] == "gloo" and out["again"] is False


def test_host_shard_partitions_and_make_global_batch_assembles(world):
    """host_shard gives each process a contiguous range of 0..99, every id
    once; a ragged batch (5 rows on 2 processes: 3 and 2) comes back whole
    from make_global_batch on every process."""
    outs = torch_world.case(world, "host_shard")
    ranges = [(out["first"], out["last"]) for out in outs]
    assert ranges[0][0] == 0 and ranges[-1][1] == 99
    assert all(b[0] == a[1] + 1 for a, b in zip(ranges, ranges[1:]))
    ragged = torch.tensor(_inputs()["ragged"])
    assert [len(out["ragged_local"]) for out in outs] == [3, 2]
    for out in outs:
        assert torch.equal(out["ragged_global"], ragged)


def test_sharded_fleet_mean_cost_matches_single_process(world):
    x0s = _inputs()["fleet_x0s"]
    truth = float(torch.mean(torch_world.fleet_costs(torch.tensor(x0s))))
    jtruth = _jax_mean_cost(x0s)
    assert abs(truth - jtruth) < 1e-8 * max(1.0, abs(jtruth))
    for out in torch_world.case(world, "fleet"):
        assert torch.equal(out["global"], torch.tensor(x0s))
        assert abs(float(out["mean_cost"]) - truth) < 1e-12 * max(1.0, abs(truth))


def test_initialize_is_a_no_op_in_one_process(monkeypatch):
    """No coordinator and no torchrun environment: False, and no world."""
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert distributed.initialize() is False
    assert not dist.is_initialized()
    assert distributed.host_shard(np.arange(7)).tolist() == list(range(7))


def test_make_mesh_needs_a_world():
    with pytest.raises(RuntimeError, match="distributed.initialize"):
        make_mesh(device="cpu")


def test_initialize_needs_the_whole_world_description(monkeypatch):
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="process_id"):
        distributed.initialize("localhost:1", num_processes=2, device="cpu")
