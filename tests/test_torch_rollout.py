"""Port vs JAX package: the rollouts of `ops/rollout.py` in float64.

One plant, written once for each package: x+ = A0 x + B0 u + 0.05 sin(x),
so the nonlinear rollouts see a nonlinear step. Gains, nominals and
process noise are made with numpy from a seed; results must agree to
1e-12 relative.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.ops import rollout as jro
from ilqr_admm_tpu_torch.ops import rollout as tro

N, D, M = 12, 3, 2
TOL = 1e-12


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        A=np.tile(np.eye(D), (N, 1, 1)) + 0.1 * rng.normal(size=(N, D, D)),
        B=0.3 * rng.normal(size=(N, D, M)),
        A0=np.eye(D) + 0.1 * rng.normal(size=(D, D)), B0=0.3 * rng.normal(size=(D, M)),
        x0=rng.normal(size=D), us=rng.normal(size=(N, M)), ws=0.01 * rng.normal(size=(N, D)),
        K=0.2 * rng.normal(size=(N, M, D)), k=rng.normal(size=(N, M)),
        x_nom=rng.normal(size=(N, D)), u_nom=rng.normal(size=(N, M)),
        K_lift=np.tril(0.05 * rng.normal(size=(N * M, N * D))), k_lift=rng.normal(size=N * M),
    )


def _fs(data):
    A0j, B0j = jnp.asarray(data["A0"]), jnp.asarray(data["B0"])
    A0t, B0t = torch.tensor(data["A0"]), torch.tensor(data["B0"])
    return ((lambda x, u: A0j @ x + B0j @ u + 0.05 * jnp.sin(x)),
            (lambda x, u: A0t @ x + B0t @ u + 0.05 * torch.sin(x)))


def _close(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() / max(1.0, np.abs(w).max()) < TOL


def _call(pkg, fn, name, data, ws, nominals):
    """Run rollout `name` of one package on the shared data."""
    arr = jnp.asarray if pkg is jro else torch.tensor
    w = arr(data["ws"]) if ws else None
    nom = dict(x_nom=arr(data["x_nom"]), u_nom=arr(data["u_nom"])) if nominals else {}
    if name == "linear":
        return pkg.rollout_linear(arr(data["A"]), arr(data["B"]), arr(data["x0"]), arr(data["us"]),
                                  ws=w, unroll=4)
    if name == "nonlinear":
        return pkg.rollout_nonlinear(fn, arr(data["x0"]), arr(data["us"]), ws=w, unroll=4)
    if name == "closed_loop":
        return pkg.rollout_closed_loop(fn, arr(data["x0"]), arr(data["K"]), arr(data["k"]),
                                       ws=w, **nom)
    if name == "sls":
        return pkg.rollout_sls(fn, arr(data["x0"]), arr(data["K_lift"]), arr(data["k_lift"]),
                               D, M, ws=w)
    return pkg.rollout_sls_delta(fn, arr(data["x0"]), arr(data["K_lift"]), arr(data["k_lift"]),
                                 arr(data["x_nom"]), arr(data["u_nom"]), ws=w)


CASES = [(name, False) for name in ("linear", "nonlinear", "closed_loop", "sls", "sls_delta")]
CASES.insert(3, ("closed_loop", True))


@pytest.mark.parametrize("ws", [False, True], ids=["no noise", "noise"])
@pytest.mark.parametrize("name,nominals", CASES)
def test_rollout_matches_jax(name, nominals, ws):
    data = _data()
    f_jax, f_torch = _fs(data)
    want = _call(jro, f_jax, name, data, ws, nominals)
    got = _call(tro, f_torch, name, data, ws, nominals)
    _close(got, want)


def test_closed_loop_on_the_linear_plant_is_the_linear_rollout():
    data = _data(1)
    A, B = torch.tensor(data["A"]), torch.tensor(data["B"])
    t = iter(range(N))

    def f(x, u):
        i = next(t)
        return A[i] @ x + B[i] @ u

    xs, us = tro.rollout_closed_loop(f, torch.tensor(data["x0"]), torch.tensor(data["K"]),
                                     torch.tensor(data["k"]))
    assert torch.allclose(tro.rollout_linear(A, B, torch.tensor(data["x0"]), us), xs, atol=1e-12)
