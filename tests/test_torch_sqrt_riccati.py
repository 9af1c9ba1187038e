"""Port vs JAX package: the square-root Riccati backward pass of
`ops/sqrt_riccati.py` and its helpers.

The problem is the car linearized along a trajectory (made with numpy
from a seed), with the parking cost's Taylor blocks plus a cross term
Cux != 0, in float64. The gains must agree with the JAX package to 1e-9
relative (only the order of f64 operations and the QR routine differ);
they must also equal the plain Cholesky pass `ilqr_backward`, which
solves the same recursion.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.models.car import CarFrontWheel as JCar, CarParkingCost as JCost
from ilqr_admm_tpu.ops import sqrt_riccati as js
from ilqr_admm_tpu_torch.ops import sqrt_riccati as ts
from ilqr_admm_tpu_torch.ops.riccati import ilqr_backward

torch.set_num_threads(2)

TOL = 1e-9


def _rel(got, want):
    got, want = got.numpy(), np.asarray(want)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _problem(N, seed, cross):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(N, 4)) * 0.3 + np.array([1.0, 1.0, 4.7, 0.5])
    us = rng.normal(size=(N, 2)) * 0.2
    A, B = JCar(dt=15.0 / N).get_AB(jnp.asarray(xs), jnp.asarray(us))
    cts, Cts = JCost().get_Cs(jnp.asarray(xs), jnp.asarray(us))
    Cts = np.array(Cts)
    # weights up, so that the Schur complement Cxx - Cux' Cuu^-1 Cux stays
    # PSD (the square-root pass clamps what is not)
    Cts[:, 4:, 4:] += 0.05 * np.eye(2)
    Cts[:, :4, :4] += 0.1 * np.eye(4)
    Cux = cross * rng.normal(size=(N, 2, 4))
    Cts[:, 4:, :4] = Cux
    Cts[:, :4, 4:] = np.swapaxes(Cux, 1, 2)
    cts = np.array(cts) + rng.normal(size=(N, 6)) * 0.1
    return np.asarray(A), np.asarray(B), Cts, cts


@pytest.mark.parametrize("N,seed,cross", [(40, 0, 0.01), (25, 1, 0.0), (60, 2, 0.015)])
def test_backward_sqrt_matches_jax(N, seed, cross):
    A, B, Cts, cts = _problem(N, seed, cross)
    jK, jk = js.ilqr_backward_sqrt(*(jnp.asarray(a) for a in (A, B, Cts, cts)))
    tK, tk = ts.ilqr_backward_sqrt(*(torch.tensor(a) for a in (A, B, Cts, cts)))
    assert tK.shape == (N, 2, 4) and tk.shape == (N, 2)
    assert _rel(tK, jK) < TOL and _rel(tk, jk) < TOL
    assert not bool(tK[-1].any()) and not bool(tk[-1].any())
    # the same recursion as the Cholesky pass
    cK, ck = ilqr_backward(*(torch.tensor(a) for a in (A, B, Cts, cts)))
    assert float((tK - cK).abs().max()) < 1e-8 * max(1.0, float(cK.abs().max()))
    assert float((tk - ck).abs().max()) < 1e-8 * max(1.0, float(ck.abs().max()))


def test_backward_sqrt_in_f32_stays_near_f64():
    A, B, Cts, cts = _problem(40, 0, 0.01)
    K64, k64 = ts.ilqr_backward_sqrt(*(torch.tensor(a) for a in (A, B, Cts, cts)))
    K32, k32 = ts.ilqr_backward_sqrt(*(torch.tensor(a, dtype=torch.float32) for a in (A, B, Cts, cts)))
    assert K32.dtype == torch.float32
    assert float((K32.double() - K64).abs().max()) < 1e-4 * float(K64.abs().max())
    assert float((k32.double() - k64).abs().max()) < 1e-4 * float(k64.abs().max())


def test_helpers_match_jax():
    rng = np.random.default_rng(3)
    pres = rng.normal(size=(5, 10, 6))
    pres[2, :, 1] = 0.0  # a zero column: the guarded reflector
    want = np.stack([np.asarray(js._qr_r(jnp.asarray(p))) for p in pres])
    got = ts._qr_r(torch.tensor(pres))
    assert float(np.abs(got.numpy() - want).max()) < 1e-12
    R = got[0, :2, :2]
    rhs = torch.tensor(rng.normal(size=(2, 3)))
    up = ts._solve_upper(R, rhs)
    assert float((R @ up - rhs).abs().max()) < 1e-12
    assert float(np.abs(up.numpy() - np.asarray(js._solve_upper(jnp.asarray(R.numpy()),
                                                               jnp.asarray(rhs.numpy())))).max()) < 1e-12
    lo = ts._solve_lower(R.T, rhs)
    assert float((R.T @ lo - rhs).abs().max()) < 1e-12
    M = rng.normal(size=(4, 4))
    M = M @ M.T
    M[:, 0] = M[0, :] = 0.0  # PSD with a zero block
    got = ts._sqrt_psd(torch.tensor(M))
    assert float(np.abs(got.numpy() - np.asarray(js._sqrt_psd(jnp.asarray(M)))).max()) < 1e-12
    assert float((got @ got - torch.tensor(M)).abs().max()) < 1e-12


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_eigh_rayleigh_matches_eigh(dtype):
    """The eigenvalues as Rayleigh quotients of the eigenvectors (the
    card's batched f32 eigh leaves a zero block's unwritten) agree with
    numpy's eigenvalues, zero and diagonal blocks included."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(12, 3, 3))
    M = X @ X.transpose(0, 2, 1)
    M[::4] = 0.0
    M[1::4] = np.eye(3) * rng.uniform(0.5, 2.0, size=(3, 1, 1))
    w, V = ts.eigh_rayleigh(torch.tensor(M, dtype=dtype))
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert float(np.abs(np.sort(w.double().numpy(), -1) - np.linalg.eigvalsh(M)).max()) < tol * 10
    recon = (V * w[:, None, :]) @ V.transpose(-1, -2)
    assert float(np.abs(recon.double().numpy() - M).max()) < tol * 10
