"""Port vs JAX package: the consensus-ADMM projection with its constraint
blocks stacked and sharded (`parallel/consensus.py`).

The counterpart of `tests/test_consensus_parallel.py`, with the same
inputs (numpy from `default_rng(0)` in each case). The oracle chain is
the JAX file's: the list form `project_set_convex` == the stacked form
== the sharded form, here over a ('consensus',) mesh of 4 gloo ranks
(`tests/torch_world.py`, importing only the port), and the port's
stacked form == the JAX package's stacked form. float64; sharded against
stacked to 1e-12 (only the order of the sums differs), the port against
JAX to 1e-9 (the tolerance of the JAX file's sharded cases).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world
from ilqr_admm_tpu.parallel.consensus import project_set_convex_stacked as j_stacked
from ilqr_admm_tpu.projections import project_bound as j_bound
from ilqr_admm_tpu.projections import project_soc_unit as j_soc
from ilqr_admm_tpu_torch.parallel import project_set_convex_sharded, project_set_convex_stacked
from ilqr_admm_tpu_torch.projections import project_set_convex, project_soc_unit

torch.set_num_threads(2)

NPROC = 4
SHARD_TOL = 1e-12
JAX_TOL = 1e-9


def _random_soc_blocks(rng, nb, m, dim):
    As = 0.3 * rng.standard_normal((nb, m, dim))
    bs = rng.standard_normal((nb, m)) * 0.2 + np.array([0.0] * (m - 1) + [1.0])
    return As, bs


def _chance_soc_blocks():
    """`tests/test_consensus_parallel.py::_chance_soc_blocks`: the
    state-bounds chance-constraint pair, two SOCs per decision row."""
    psi_inv = 1.2815515655446004  # norm.ppf(0.9)
    mu = np.array([0.0, 0.3])
    sig = np.diag(np.sqrt([0.0, 0.02]))
    A_hi = np.concatenate([sig, (-mu / psi_inv)[None]], axis=0)
    A_lo = np.concatenate([sig, (mu / psi_inv)[None]], axis=0)
    b = np.array([0.0, 0.0, 5.0 / psi_inv])
    return np.stack([A_hi, A_lo]), np.stack([b, b])


def _hetero_blocks(rng):
    As, bs = _random_soc_blocks(rng, nb=4, m=3, dim=3)
    As[2:] = np.eye(3)
    bs[2:] = 0.0
    return As, bs


def _cases():
    """(y, As, bs) of each case, drawn in the JAX file's order."""
    cases = {}
    rng = np.random.default_rng(0)
    cases["chance"] = (rng.standard_normal((16, 2)) * 3.0,) + _chance_soc_blocks()
    rng = np.random.default_rng(0)
    As, bs = _random_soc_blocks(rng, nb=NPROC, m=3, dim=4)
    cases["full"] = (rng.standard_normal((5, 4)), As, bs)
    rng = np.random.default_rng(0)
    As, bs = _random_soc_blocks(rng, nb=8, m=3, dim=4)
    cases["wide"] = (rng.standard_normal((5, 4)), As, bs)
    rng = np.random.default_rng(0)
    As, bs = _hetero_blocks(rng)
    cases["hetero"] = (rng.standard_normal((6, 3)) * 2.0, As, bs)
    rng = np.random.default_rng(0)
    cases["point"] = (rng.standard_normal(2) * 4.0,) + _chance_soc_blocks()
    return cases


def _inputs():
    return {f"{name}_{k}": v for name, case in _cases().items()
            for k, v in zip(("y", "As", "bs"), case)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return torch_world.run_world("consensus", NPROC, _inputs(), tmp_path_factory.mktemp("world"))


def _j_hetero(y, idx):
    def one(y_i, i):
        return jax.lax.switch(jnp.where(i < 2, 0, 1), [j_soc, lambda v: j_bound(v, -0.8, 0.8)],
                              y_i)

    return jax.vmap(one)(y, idx)


# (world case, input case, options, port projection, JAX projection)
SHARDED = {
    "padding": ("chance", dict(rho=1e1, max_iter=50, threshold=1e-6), project_soc_unit, j_soc),
    "full_axis": ("full", dict(rho=2.0, max_iter=80, threshold=1e-8), project_soc_unit, j_soc),
    "mesh2d": ("wide", dict(rho=2.0, max_iter=80, threshold=1e-8), project_soc_unit, j_soc),
    "hetero": ("hetero", dict(rho=1.5, max_iter=100, threshold=1e-8),
               torch_world.hetero_projection, _j_hetero),
    "unbatched": ("point", dict(rho=1e1, max_iter=50, threshold=1e-8), project_soc_unit, j_soc),
}


def test_stacked_matches_list_form_and_jax():
    """The stacked form against the reference-shaped list form on the
    chance-constraint SOC intersection (40 points), and against the JAX
    package's stacked form."""
    As, bs = _chance_soc_blocks()
    y = np.random.default_rng(0).standard_normal((40, 2)) * 3.0
    opts = dict(rho=1e1, max_iter=50, threshold=1e-6)
    ref = project_set_convex(torch.tensor(y), [torch.tensor(a) for a in As],
                             [torch.tensor(b) for b in bs], [project_soc_unit] * 2, **opts)
    got = project_set_convex_stacked(torch.tensor(y), torch.tensor(As), torch.tensor(bs),
                                     project_soc_unit, **opts)
    assert float((got - ref).abs().max()) < 1e-10
    want = j_stacked(jnp.asarray(y), jnp.asarray(As), jnp.asarray(bs), j_soc, **opts)
    assert np.abs(got.numpy() - np.asarray(want)).max() < JAX_TOL


@pytest.mark.parametrize("name", list(SHARDED))
def test_sharded_matches_stacked(world, name):
    """padding: nb = 2 blocks on 4 ranks (two ranks hold only padding);
    full_axis: one block a rank; mesh2d: 8 blocks over the 'consensus'
    axis of a (2, 2) ('data', 'consensus') mesh; hetero: SOC and box
    blocks through projection(y, idx) with the global block index;
    unbatched: a single point. Every rank returns the stacked form's x,
    which matches the JAX package's."""
    key, opts, proj, j_proj = SHARDED[name]
    y, As, bs = _cases()[key]
    want = project_set_convex_stacked(torch.tensor(y), torch.tensor(As), torch.tensor(bs),
                                      proj, **opts)
    outs = torch_world.case(world, name)
    for out in outs:
        assert out["x"].shape == want.shape == y.shape
        assert float((out["x"] - want).abs().max()) <= SHARD_TOL
    jwant = j_stacked(jnp.asarray(y), jnp.asarray(As), jnp.asarray(bs), j_proj, **opts)
    assert np.abs(want.numpy() - np.asarray(jwant)).max() < JAX_TOL
    if name == "mesh2d":
        assert all(out["consensus_size"] == 2 for out in outs)
    if name == "hetero":
        assert float(want.abs().max()) <= 0.8 + 1e-3  # the box blocks bind
    if name == "full_axis":  # the moved points satisfy the SOCs
        fr = torch.einsum("smj,bj->sbm", torch.tensor(As), want) + torch.tensor(bs)[:, None]
        assert float((torch.linalg.vector_norm(fr[..., :-1], dim=-1) - fr[..., -1]).max()) < 1e-3


def test_sharded_without_a_mesh_is_the_stacked_form():
    y, As, bs = _cases()["chance"]
    args = (torch.tensor(y), torch.tensor(As), torch.tensor(bs), project_soc_unit)
    assert torch.equal(project_set_convex_sharded(*args, rho=1e1, mesh=None),
                       project_set_convex_stacked(*args, rho=1e1))


def test_empty_block_list_raises(world):
    with pytest.raises(ValueError, match="at least one"):
        project_set_convex_stacked(torch.zeros(2, dtype=torch.float64),
                                   torch.zeros((0, 3, 2), dtype=torch.float64),
                                   torch.zeros((0, 3), dtype=torch.float64), project_soc_unit)
    for out in torch_world.case(world, "empty"):
        assert out["error"].startswith("ValueError: project_set_convex_sharded needs at least")
