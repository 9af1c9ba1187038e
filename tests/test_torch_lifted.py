"""Port vs JAX package: lifted operators and the small solver helpers.

Random time-varying dynamics from a seeded numpy generator go through
both packages in float64; lifted operators agree to 1e-10 (the port's
loops reassociate the JAX scans' sums at most).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.ops import lifted as jl
from ilqr_admm_tpu.projections import project_bound as j_project_bound
from ilqr_admm_tpu.solvers.admm import validate_constraint_blocks as j_validate
from ilqr_admm_tpu.solvers.lqt import block_diag_stacked as j_block_diag
from ilqr_admm_tpu.solvers.lqt import broadcast_rho as j_broadcast_rho
from ilqr_admm_tpu_torch.convert import dynamics_from_numpy
from ilqr_admm_tpu_torch.ops import lifted as tl
from ilqr_admm_tpu_torch.projections.primitives import project_bound
from ilqr_admm_tpu_torch.solvers.admm import validate_constraint_blocks
from ilqr_admm_tpu_torch.solvers.lqt import block_diag_stacked, broadcast_rho

torch.set_num_threads(2)

F64 = torch.float64
TOL = 1e-10


def close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1.0))


def _dynamics(N, d=3, m=2, seed=0):
    rng = np.random.default_rng(seed)
    A = np.eye(d) + 0.02 * rng.normal(size=(N, d, d))
    B = rng.normal(size=(N, d, m))
    tA, tB = dynamics_from_numpy(A, B, device="cpu", dtype=F64)
    return A, B, tA, tB


@pytest.mark.parametrize(
    "N,block_size",
    [(100, None), (512, None), (128, 16), (100, 20), (100, 0), (60, 10)],
    ids=["seq-N100", "blocked-auto-N512", "blocked-L16-N128", "blocked-L20-N100",
         "forced-seq", "short-horizon-seq"],
)
def test_build_Su_matches_jax(N, block_size):
    A, B, tA, tB = _dynamics(N)
    close(tl.build_Su(tA, tB, block_size=block_size), jl.build_Su(A, B, block_size=block_size))


def test_build_Su_blocked_equals_sequential():
    _, _, tA, tB = _dynamics(512, seed=1)
    close(tl.build_Su(tA, tB), tl._build_Su_seq(tA, tB))


def test_pick_block_matches_jax():
    for N in (7, 64, 100, 128, 257, 300, 512, 1000):
        assert tl._pick_block(N) == jl._pick_block(N)


@pytest.mark.parametrize("p", [None, 1, 2])
def test_build_Sx_matches_jax(p):
    A, _, tA, _ = _dynamics(40)
    close(tl.build_Sx(tA, p), jl.build_Sx(A, p))


def test_build_Sw_matches_jax():
    A, _, tA, _ = _dynamics(30)
    close(tl.build_Sw(tA), jl.build_Sw(A))


def test_matrix_free_operators_match_jax():
    N, d, m = 50, 3, 2
    A, B, tA, tB = _dynamics(N, d, m, seed=2)
    rng = np.random.default_rng(3)
    x0, us, vs = rng.normal(size=d), rng.normal(size=(N, m)), rng.normal(size=(N, d))
    close(tl.sw_x0(tA, torch.tensor(x0)), jl.sw_x0(A, x0))
    close(tl.su_apply(tA, tB, torch.tensor(us)), jl.su_apply(A, B, us))
    close(tl.su_t_apply(tA, tB, torch.tensor(vs)), jl.su_t_apply(A, B, vs))
    # and they are the dense operators applied
    Su = tl.build_Su(tA, tB)
    close(tl.su_apply(tA, tB, torch.tensor(us)).reshape(-1), Su @ torch.tensor(us).reshape(-1))
    close(tl.su_t_apply(tA, tB, torch.tensor(vs)).reshape(-1), Su.T @ torch.tensor(vs).reshape(-1))


def test_block_diag_stacked_matches_jax():
    blocks = np.random.default_rng(4).normal(size=(7, 3, 3))
    close(block_diag_stacked(torch.tensor(blocks)), j_block_diag(jnp.asarray(blocks)))


@pytest.mark.parametrize("form", ["none", "scalar", "matrix", "stacked"])
def test_broadcast_rho_matches_jax(form):
    rng = np.random.default_rng(5)
    N, d = 6, 3
    rho = {
        "none": None,
        "scalar": 0.25,
        "matrix": rng.normal(size=(d, d)),
        "stacked": rng.normal(size=(N, d, d)),
    }[form]
    got = broadcast_rho(rho, d, N, F64)
    want = j_broadcast_rho(rho, d, N, jnp.float64)
    if form == "none":
        assert got is None and want is None
    else:
        close(got, want)


@pytest.mark.parametrize("bounds", [(-1.0, 1.0), "arrays", (None, 0.5)], ids=["scalar", "arrays", "open-below"])
def test_project_bound_matches_jax(bounds):
    rng = np.random.default_rng(6)
    x = 2.0 * rng.normal(size=(5, 8))
    if bounds == "arrays":
        lo = -rng.uniform(0.1, 1.0, size=8)
        hi = rng.uniform(0.1, 1.0, size=8)
        got = project_bound(torch.tensor(x), torch.tensor(lo), torch.tensor(hi))
    else:
        lo, hi = bounds
        got = project_bound(torch.tensor(x), lo, hi)
    close(got, j_project_bound(jnp.asarray(x), lo, hi))


_PROJ = object()


@pytest.mark.parametrize(
    "px,rx,pu,ru",
    [
        (None, None, _PROJ, None),
        (None, None, _PROJ, 0.0),
        (None, None, _PROJ, np.zeros((3, 1, 1))),
        (None, None, None, 0.1),
        (_PROJ, None, None, None),
        (None, 0.5, _PROJ, 0.1),
        (None, None, _PROJ, 0.1),
        (None, 0.0, None, 0.0),
        (_PROJ, np.eye(2), _PROJ, 1e-2),
    ],
)
def test_validate_constraint_blocks_matches_jax(px, rx, pu, ru):
    def outcome(fn, rho_x, rho_u):
        try:
            fn(px, rho_x, pu, rho_u)
        except ValueError as exc:
            return str(exc)
        return None

    want = outcome(j_validate, rx, ru)
    assert outcome(validate_constraint_blocks, rx, ru) == want
    # penalties given as tensors are judged the same way
    as_t = lambda r: None if r is None else torch.as_tensor(r)
    got_t = outcome(validate_constraint_blocks, as_t(rx), as_t(ru))
    assert (got_t is None) == (want is None)
