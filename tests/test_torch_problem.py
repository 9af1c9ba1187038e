"""Port vs JAX package: cost assembly, QuadCost, the double integrator.

The same numpy inputs go through both packages in float64; the port is
held to the JAX results at rtol 1e-12 (the same arithmetic, at most
reassociated).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator as JDoubleIntegrator
from ilqr_admm_tpu.problem import QuadCost as JQuadCost
from ilqr_admm_tpu.problem import broadcast_AB as j_broadcast_AB
from ilqr_admm_tpu.utils import cost_assembly as jca
from ilqr_admm_tpu_torch.convert import dynamics_from_numpy, quadcost_from_numpy
from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.problem import broadcast_AB
from ilqr_admm_tpu_torch.utils import cost_assembly as tca

torch.set_num_threads(2)

F64 = torch.float64
RTOL = 1e-12


def close(got, want, rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1.0))


def _psd(rng, n, d):
    M = rng.normal(size=(n, d, d))
    return M @ np.swapaxes(M, -1, -2) + 0.1 * np.eye(d)


@pytest.mark.parametrize("nb_dim,nb_deriv,dt", [(1, 2, 0.01), (2, 3, 0.05), (3, 2, 1.0 / 100)])
def test_double_integrator_AB_matches_jax(nb_dim, nb_deriv, dt):
    A, B = tca.get_double_integrator_AB(nb_dim, nb_deriv, dt, dtype=F64)
    jA, jB = jca.get_double_integrator_AB(nb_dim, nb_deriv, dt)
    close(A, jA)
    close(B, jB)
    assert A.dtype == F64 and A.device.type == "cpu"


def test_find_mus_and_precs_match_jax():
    rng = np.random.default_rng(0)
    zs = rng.normal(size=(3, 4))
    Qs = _psd(rng, 3, 4)
    seq = rng.integers(0, 3, size=25)
    close(tca.find_mus(zs, seq), jca.find_mus(zs, seq))
    close(tca.find_precs(Qs, seq), jca.find_precs(Qs, seq))
    precs, roots = tca.find_precs(Qs, seq, sqrt=True)
    j_precs, j_roots = jca.find_precs(Qs, seq, sqrt=True)
    close(precs, j_precs)
    close(roots, j_roots, rtol=1e-10)  # two eigensolvers agree to ~1e-13 here
    close(roots @ roots, precs, rtol=1e-10)


def test_viapoint_cost_matches_jax():
    rng = np.random.default_rng(1)
    N, d, m = 30, 4, 2
    zs = rng.normal(size=(2, d))
    Qs = _psd(rng, 2, d)
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = tca.viapoint_cost(zs, Qs, seq, 1e-2, m, dtype=F64)
    jcost = jca.viapoint_cost(zs, Qs, seq, 1e-2, m)
    for name in ("Q", "xd", "R"):
        close(getattr(cost, name), getattr(jcost, name))
    assert (cost.N, cost.x_dim, cost.u_dim) == (N, d, m)


def test_quadcost_matches_jax():
    rng = np.random.default_rng(2)
    N, d, m = 20, 3, 2
    Q, R = _psd(rng, N, d), _psd(rng, N, m)
    xd = rng.normal(size=(N, d))
    xs = rng.normal(size=(5, 2, N, d))
    us = rng.normal(size=(5, 2, N, m))
    cost = quadcost_from_numpy(Q, xd, R, device="cpu", dtype=F64)
    jcost = JQuadCost(Q=jnp.asarray(Q), xd=jnp.asarray(xd), R=jnp.asarray(R))
    close(cost(torch.tensor(xs), torch.tensor(us)), jcost(jnp.asarray(xs), jnp.asarray(us)))
    close(cost(torch.tensor(xs[0, 0]), torch.tensor(us[0, 0])), jcost(xs[0, 0], us[0, 0]))
    close(cost.lifted_Q(), jcost.lifted_Q())
    close(cost.lifted_R(), jcost.lifted_R())
    close(cost.lifted_xd(), jcost.lifted_xd())


def test_quadcost_moves_as_a_module():
    rng = np.random.default_rng(3)
    cost = quadcost_from_numpy(_psd(rng, 4, 2), rng.normal(size=(4, 2)), _psd(rng, 4, 1),
                               device="cpu", dtype=F64)
    c32 = cost.to(torch.float32)
    assert {b.dtype for b in c32.buffers()} == {torch.float32}
    assert [name for name, _ in cost.named_buffers()] == ["Q", "xd", "R"]


def test_double_integrator_matches_jax():
    rng = np.random.default_rng(4)
    plant = DoubleIntegrator(2, 2, dt=0.05, dtype=F64)
    jplant = JDoubleIntegrator(2, 2, dt=0.05)
    A, B = plant.AB(17)
    jA, jB = jplant.AB(17)
    close(A, jA)
    close(B, jB)
    x, u = rng.normal(size=4), rng.normal(size=2)
    close(plant(torch.tensor(x), torch.tensor(u)), jplant.step(jnp.asarray(x), jnp.asarray(u)))
    assert (plant.x_dim, plant.u_dim) == (jplant.x_dim, jplant.u_dim)


@pytest.mark.parametrize("stacked", [False, True])
def test_broadcast_AB_and_convert_match_jax(stacked):
    rng = np.random.default_rng(5)
    N = 6
    A = rng.normal(size=(N, 3, 3) if stacked else (3, 3))
    B = rng.normal(size=(N, 3, 2) if stacked else (3, 2))
    tA, tB = broadcast_AB(torch.tensor(A), torch.tensor(B), N)
    jA, jB = j_broadcast_AB(A, B, N)
    close(tA, jA)
    close(tB, jB)
    cA, cB = dynamics_from_numpy(np.asarray(jA), np.asarray(jB), device="cpu", dtype=F64)
    close(cA, jA)
    close(cB, jB)
