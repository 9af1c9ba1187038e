"""Port vs JAX package: joint chance-constraint calibration (`chance.py`).

The cases of `tests/test_chance.py` run on the port, each held against
the JAX function on the same inputs (made with numpy from a seed):
calibration values to 1e-12, projections to 1e-10 in float64 (both run
the same consensus ADMM; only the order of f64 sums differs), the error
cases alike.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.stats import chi, norm

from ilqr_admm_tpu import chance as jc
from ilqr_admm_tpu_torch import chance as tc

torch.set_num_threads(2)

CAL_TOL, PROJ_TOL = 1e-12, 1e-10
CPU = dict(device="cpu")

CALIBRATIONS = [
    dict(joint_alpha=0.95, robust_dim=1),
    dict(joint_alpha=0.958, robust_dim=3),
    dict(joint_alpha=0.95, n_rows=100, sides=2, method="sidak"),
    dict(joint_alpha=0.9, n_rows=37, sides=1, method="bonferroni"),
    dict(alpha_row=0.82, n_rows=300),
    dict(alpha_row=0.99),
]


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(got - np.asarray(want)).max()) < tol


@pytest.mark.parametrize("kw", CALIBRATIONS)
def test_calibrate_matches_jax(kw):
    got, want = tc.calibrate(**kw), jc.calibrate(**kw)
    assert got.n_constraints == want.n_constraints and got.joint_alpha == want.joint_alpha
    assert abs(got.alpha_row - want.alpha_row) < CAL_TOL
    assert abs(got.psi_inv - want.psi_inv) < CAL_TOL


@pytest.mark.parametrize("method", ["sidak", "bonferroni"])
def test_per_row_confidence_matches_jax(method):
    for joint, k in ((0.95, 200), (0.9, 1), (0.5, 7)):
        assert abs(tc.per_row_confidence(joint, k, method)
                   - jc.per_row_confidence(joint, k, method)) < CAL_TOL
    a = tc.per_row_confidence(0.95, 200, method)
    assert 0.95 < a < 1.0


def test_chi_certificate_values_and_ordering():
    """chi: psi = chi_p^{-1}(alpha), row-count free, smaller than Sidak's."""
    cal = tc.calibrate(joint_alpha=0.95, robust_dim=1)
    assert abs(cal.psi_inv - chi.ppf(0.95, 1)) < CAL_TOL and abs(cal.psi_inv - 1.96) < 0.01
    cal3 = tc.calibrate(joint_alpha=0.958, robust_dim=3)
    assert abs(cal3.psi_inv - chi.ppf(0.958, 3)) < CAL_TOL and cal3.psi_inv > cal.psi_inv
    a_s = tc.per_row_confidence(0.95, 200, "sidak")
    assert abs(a_s**200 - 0.95) < CAL_TOL
    assert 0.95 < a_s < tc.per_row_confidence(0.95, 200, "bonferroni") < 1.0
    sidak = tc.calibrate(joint_alpha=0.95, n_rows=100, sides=2, method="sidak")
    assert sidak.n_constraints == 200 and abs(sidak.psi_inv - norm.ppf(a_s)) < CAL_TOL
    assert cal.psi_inv < 2.0 < 3.4 < sidak.psi_inv


ERRORS = [
    lambda m: m.per_row_confidence(1.5, 10),
    lambda m: m.per_row_confidence(0.9, 0),
    lambda m: m.per_row_confidence(0.9, 10, "wat"),
    lambda m: m.calibrate(),
    lambda m: m.calibrate(joint_alpha=0.9, alpha_row=0.9, robust_dim=1),
    lambda m: m.calibrate(joint_alpha=0.9),
    lambda m: m.calibrate(joint_alpha=0.9, method="sidak"),
    lambda m: m.calibrate(joint_alpha=1.2, robust_dim=2),
    lambda m: m.soc_box_rows(0.1, 2, None, None, 1.0, **({} if m is jc else CPU)),
]


@pytest.mark.parametrize("case", range(len(ERRORS)))
def test_errors_match_jax(case):
    for module in (jc, tc):
        with pytest.raises(ValueError):
            ERRORS[case](module)


def test_direct_alpha_row_must_exceed_half():
    """alpha_row <= 0.5 would give psi_inv <= 0 and sign-flipped or NaN
    SOC sets; both packages refuse it alike."""
    for bad in (0.5, 0.3, 0.0, -1.0):
        for module, kw in ((jc, {}), (tc, CPU)):
            with pytest.raises(ValueError, match="alpha_row"):
                module.calibrate(alpha_row=bad, n_rows=10)
            with pytest.raises(ValueError, match="alpha_row"):
                module.make_box_chance_projection(0.1, 2, -1.0, 1.0, alpha_row=bad, **kw)
    cal = tc.calibrate(alpha_row=0.9, n_rows=10)
    assert cal.psi_inv > 0 and abs(cal.psi_inv - jc.calibrate(alpha_row=0.9, n_rows=10).psi_inv) < CAL_TOL


@pytest.mark.parametrize("var,p,lower,upper", [(0.1, 3, -6.0, 6.0), ((0.02, 0.05), 2, None, 1.0),
                                               (0.3, 1, -2.0, None)])
def test_soc_box_rows_match_jax(var, p, lower, upper):
    As_t, bs_t, projs = tc.soc_box_rows(var, p, lower, upper, 1.7, **CPU)
    As_j, bs_j, _ = jc.soc_box_rows(var, p, lower, upper, 1.7)
    assert len(As_t) == len(As_j) == len(projs)
    for got, want in zip(As_t + bs_t, As_j + bs_j):
        assert got.dtype == torch.float64 and _close(got, want, CAL_TOL)
    As32, _, _ = tc.soc_box_rows(var, p, lower, upper, 1.7, device="cpu", dtype=torch.float32)
    assert As32[0].dtype == torch.float32


PROJECTIONS = [
    # the first two are the cases whose z-scores tests/test_chance.py checks
    dict(var=0.1, robust_dim=3, lower=-6.0, upper=6.0, alpha_row=0.99),
    dict(var=0.1, robust_dim=3, lower=-6.0, upper=6.0, joint_alpha=0.958),
    dict(var=0.05, robust_dim=2, lower=-2.0, upper=2.0, joint_alpha=0.9, n_rows=40,
         method="sidak"),
    dict(var=0.04, robust_dim=1, lower=None, upper=1.0, alpha_row=0.9),
]


@pytest.mark.parametrize("case", range(len(PROJECTIONS)))
def test_box_projection_matches_jax(case):
    """The projection of random rows; for the first two cases also its
    z-scores, as tests/test_chance.py checks them (the others leave rows
    near the cone's apex within the projection's 100 iterations, in both
    packages alike)."""
    kw = PROJECTIONS[case]
    rng = np.random.default_rng(3)
    p = kw["robust_dim"]
    rows = rng.normal(size=(40, p + 1)) * 2.0
    proj_t, cal_t = tc.make_box_chance_projection(**kw, **CPU)
    proj_j, cal_j = jc.make_box_chance_projection(**kw)
    assert cal_t.n_constraints == cal_j.n_constraints and abs(cal_t.psi_inv - cal_j.psi_inv) < CAL_TOL
    out = proj_t(torch.tensor(rows))
    assert _close(out, proj_j(jnp.asarray(rows)), PROJ_TOL)
    if case < 2:
        out = out.numpy()
        spread = np.maximum(np.sqrt(kw["var"]) * np.linalg.norm(out[:, 1:], axis=-1), 1e-12)
        assert ((kw["upper"] - out[:, 0]) / spread).min() >= cal_t.psi_inv - 5e-2
        assert ((out[:, 0] - kw["lower"]) / spread).min() >= cal_t.psi_inv - 5e-2


def test_feasible_rows_are_fixed_points():
    proj, _ = tc.make_box_chance_projection(0.1, 3, -6.0, 6.0, alpha_row=0.99, **CPU)
    feas = torch.tensor([[0.0, 0.1, 0.1, 0.1], [1.0, 0.0, 0.0, 0.0]], dtype=torch.float64)
    assert float((proj(feas) - feas).abs().max()) < 1e-6


def test_shifted_projection_matches_jax():
    """proj(y, u_nom) projects the absolute feedforward y[:, 0] + u_nom;
    at a zero nominal it is the unshifted projection."""
    rng = np.random.default_rng(4)
    var, p = 0.05, 2
    kw = dict(joint_alpha=0.9, method="chi")
    proj_a, cal_a = tc.make_box_chance_projection(var, p, -2.0, 2.0, **kw, **CPU)
    proj_s, cal_s = tc.make_box_chance_projection(var, p, -2.0, 2.0, shifted=True, **kw, **CPU)
    jproj_s, _ = jc.make_box_chance_projection(var, p, -2.0, 2.0, shifted=True, **kw)
    assert cal_a == cal_s
    rows = rng.normal(size=(10, p + 1))
    zero = torch.zeros((10, 1), dtype=torch.float64)
    assert _close(proj_s(torch.tensor(rows), zero), proj_a(torch.tensor(rows)).numpy(), 1e-12)
    u_nom = rng.normal(size=(5, 2))
    assert _close(proj_s(torch.tensor(rows), torch.tensor(u_nom)),
                  jproj_s(jnp.asarray(rows), jnp.asarray(u_nom)), PROJ_TOL)
    # a nominal of 2.0 against |u| <= 1 pulls the absolute feedforward in
    proj_1, cal = tc.make_box_chance_projection(0.04, 1, -1.0, 1.0, alpha_row=0.9, shifted=True,
                                                **CPU)
    y = torch.tensor([[0.0, 0.5]], dtype=torch.float64)
    out = proj_1(y, torch.full((1, 1), 2.0, dtype=torch.float64)).numpy()
    assert out[0, 0] + 2.0 <= 1.0 - cal.psi_inv * 0.2 * abs(out[0, 1]) + 5e-2


def test_state_box_projection_matches_jax():
    rng = np.random.default_rng(5)
    N, d, p, var = 10, 2, 1, 0.02
    spec = {(N - 1, 0): (0.5, 0.5), (N - 1, 1): (0.0, 0.0), (3, 0): (-1.0, 1.0)}
    kw = dict(joint_alpha=0.9, max_iter=100, threshold=1e-4)
    proj_t, cal_t = tc.make_state_box_chance_projection(var, p, N, d, spec, **kw, **CPU)
    proj_j, cal_j = jc.make_state_box_chance_projection(var, p, N, d, spec, **kw)
    assert abs(cal_t.psi_inv - cal_j.psi_inv) < CAL_TOL
    y = rng.normal(size=(N * d, p + 1)) * 2.0
    out = proj_t(torch.tensor(y))
    assert _close(out, proj_j(jnp.asarray(y)), PROJ_TOL)
    out = out.numpy()
    mask = np.ones(N * d, bool)
    mask[[(N - 1) * d, (N - 1) * d + 1, 3 * d]] = False
    assert np.array_equal(out[mask], y[mask])
    assert np.abs(out[(N - 1) * d] - [0.5, 0.0]).max() < 2e-2
    for module, extra in ((tc, CPU), (jc, {})):
        with pytest.raises(ValueError):
            module.make_state_box_chance_projection(var, p, N, d, {(N, 0): (0.0, 1.0)},
                                                    joint_alpha=0.9, **extra)


def test_count_binding_rows_matches_jax():
    ff = np.asarray([0.0, 5.9, -5.9, 3.0])
    phi = np.asarray([[1.0], [0.05], [0.05], [0.0]])
    for scale in (1.0, 20.0):
        args = (ff, phi * scale, 0.1, -6.0, 6.0)
        got = tc.count_binding_rows(*args, psi_inv=2.0)
        assert got == jc.count_binding_rows(*args, psi_inv=2.0)
        assert got == tc.count_binding_rows(torch.tensor(ff), torch.tensor(phi * scale), 0.1,
                                            -6.0, 6.0, psi_inv=2.0)
    assert tc.count_binding_rows(ff, phi, 0.1, -6.0, 6.0, psi_inv=2.0) == 1
    assert tc.count_binding_rows(ff, phi * 20.0, 0.1, -6.0, 6.0, psi_inv=2.0) >= 3


def test_soc_data_default_to_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tc.soc_box_rows(0.1, 2, -1.0, 1.0, 1.5)
