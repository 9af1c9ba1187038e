"""Port vs JAX package: the sequential Riccati passes of `ops/riccati.py`.

The same problems, made with numpy from a seed, go through
`ilqr_admm_tpu.ops.riccati` and `ilqr_admm_tpu_torch.ops.riccati` in
float64; the two must agree to 1e-10 (only the order of f64 sums and the
Cholesky factor's side differ).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.ops import riccati as jr
from ilqr_admm_tpu_torch.convert import dpgains_from_numpy
from ilqr_admm_tpu_torch.ops import riccati as tr

torch.set_num_threads(2)

TOL = 1e-10


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _lqt_problem(seed, N=24, d=4, m=2, regularized=False):
    """Random stable-ish LQT data (and regularizers), as numpy f64."""
    rng = np.random.default_rng(seed)
    A = np.tile(np.eye(d), (N, 1, 1)) + 0.05 * rng.normal(size=(N, d, d))
    B = 0.2 * rng.normal(size=(N, d, m))
    Q = np.stack([np.diag(q) for q in rng.uniform(0.1, 10.0, size=(N, d))])
    xd = rng.normal(size=(N, d))
    R = np.tile(np.eye(m) * 0.1, (N, 1, 1))
    reg = {}
    if regularized:
        reg = dict(
            Qr=np.tile(np.eye(d) * 0.4, (N, 1, 1)), xr=rng.normal(size=(N, d)),
            Rr=np.tile(np.eye(m) * 0.2, (N, 1, 1)), ur=rng.normal(size=(N, m)),
        )
    return (A, B, Q, xd, R), reg


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(arrays):
    return [torch.tensor(a) for a in arrays]


REGS = {
    "plain": lambda reg: {},
    "regularized": lambda reg: reg,
    "weights without targets": lambda reg: dict(Qr=reg["Qr"], Rr=reg["Rr"]),
}


@pytest.mark.parametrize("regs", list(REGS))
def test_lqt_backward_matches_jax(regs):
    data, reg = _lqt_problem(0, regularized=True)
    reg = REGS[regs](reg)
    want = jr.lqt_backward(*_j(data), **{k: jnp.asarray(v) for k, v in reg.items()})
    got = tr.lqt_backward(*_t(data), **{k: torch.tensor(v) for k, v in reg.items()})
    assert isinstance(got, tr.DPGains)
    for name, g, w in zip(tr.DPGains._fields, got, want):
        assert g.shape == w.shape, name
        assert _rel(g.numpy(), w) < TOL, name
    assert float(got.K[-1].abs().max()) == 0.0 and float(got.k[-1].abs().max()) == 0.0


@pytest.mark.parametrize("regs", ["plain", "regularized"])
def test_lqt_backward_ff_matches_jax_on_jax_gains(regs):
    """The ff sweep re-run with new linear terms, fed the JAX package's gains."""
    data, reg = _lqt_problem(1, regularized=True)
    reg = REGS[regs](reg)
    gains = jr.lqt_backward(*_j(data), **{k: jnp.asarray(v) for k, v in reg.items()})
    A, B, Q, xd, _ = data
    rng = np.random.default_rng(2)
    xd_new = xd + 0.3 * rng.normal(size=xd.shape)
    reg_new = {k: v + 0.3 * rng.normal(size=v.shape) if k in ("xr", "ur") else v
               for k, v in reg.items()}
    want = jr.lqt_backward_ff(gains, *_j((A, B, Q, xd_new)),
                              **{k: jnp.asarray(v) for k, v in reg_new.items()})
    tgains = dpgains_from_numpy(*(np.asarray(g) for g in gains), device="cpu",
                                dtype=torch.float64)
    got = tr.lqt_backward_ff(tgains, *_t((A, B, Q, xd_new)),
                             **{k: torch.tensor(v) for k, v in reg_new.items()})
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < TOL
    # with unchanged targets the ff sweep reproduces the full pass's k
    same = tr.lqt_backward_ff(tgains, *_t((A, B, Q, xd)),
                              **{k: torch.tensor(v) for k, v in reg.items()})
    assert _rel(same.numpy(), gains.k) < TOL


def _ilqr_model(seed, N=20, d=3, m=2):
    rng = np.random.default_rng(seed)
    A = np.tile(np.eye(d), (N, 1, 1)) + 0.05 * rng.normal(size=(N, d, d))
    B = 0.2 * rng.normal(size=(N, d, m))
    G = rng.normal(size=(N, d + m, d + m))
    Cts = np.einsum("tij,tkj->tik", G, G) + np.eye(d + m)  # SPD, nonzero Cux
    cts = rng.normal(size=(N, d + m))
    fzz = 0.05 * rng.normal(size=(N, d, d + m, d + m))
    fzz = 0.5 * (fzz + np.swapaxes(fzz, -1, -2))
    return A, B, Cts, cts, fzz


@pytest.mark.parametrize("case", ["gauss-newton", "reg", "ddp fzz", "ddp fzz with reg"])
def test_ilqr_backward_matches_jax(case):
    A, B, Cts, cts, fzz = _ilqr_model(3)
    reg = 0.5 if "reg" in case else 0.0
    use_fzz = "fzz" in case
    want = jr.ilqr_backward(*_j((A, B, Cts, cts)), reg=reg,
                            fzz=jnp.asarray(fzz) if use_fzz else None)
    got = tr.ilqr_backward(*_t((A, B, Cts, cts)), reg=reg,
                           fzz=torch.tensor(fzz) if use_fzz else None)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) < TOL


def test_quad_cost_model_matches_jax_and_feeds_ilqr():
    (A, B, Q, xd, R), _ = _lqt_problem(4, N=16)
    rng = np.random.default_rng(5)
    x_nom, u_nom = rng.normal(size=xd.shape), rng.normal(size=(16, 2))
    cts_j, Cts_j = jr.quad_cost_model(*_j((Q, xd, R, x_nom, u_nom)))
    cts_t, Cts_t = tr.quad_cost_model(*_t((Q, xd, R, x_nom, u_nom)))
    assert _rel(cts_t.numpy(), cts_j) < TOL and _rel(Cts_t.numpy(), Cts_j) < TOL
    # the LQT pass is the iLQR pass on this model about the zero nominal
    cts0, Cts0 = tr.quad_cost_model(*_t((Q, xd, R, 0 * x_nom, 0 * u_nom)))
    K, k = tr.ilqr_backward(*_t((A, B)), Cts0, cts0)
    g = tr.lqt_backward(*_t((A, B, Q, xd, R)))
    assert _rel(K.numpy(), g.K.numpy()) < TOL and _rel(k.numpy(), g.k.numpy()) < TOL
