"""Port vs JAX package: the line-search rollout of `ops/fused_rollout.py`
against `ops/pallas_rollout.py`.

On CPU tensors the wrapper runs its plain version, so these tests hold
that plain version (the kernel's arithmetic) to the JAX package: in f64
against `linesearch_rollout_xla` to 1e-12 (the same elementwise ops), and
in f32 at the JAX test's shape (N = 60, A = 20) against the Pallas kernel
in interpret mode with `asin_newton` and against `linesearch_rollout_xla`
to 1e-5, the JAX file's own bound (`tests/test_pallas_rollout.py:81-83`).
The fleet form (F initial states, each with its own A candidates, one
launch on the card) is held in f32 to `jax.vmap` of the Pallas kernel and
of `linesearch_rollout_xla` at the same 1e-5, and on CPU tensors it is
its F single calls exactly, NaN positions included. The CUDA kernel
itself is held to the plain version on the card by `chip_smoke.py`.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.models.car import CarFrontWheel as JCar
from ilqr_admm_tpu.ops.pallas_rollout import (
    asin_newton,
    linesearch_rollout_xla,
    make_pallas_linesearch_rollout,
)
from ilqr_admm_tpu_torch.models.car import CarFrontWheel, CarSimple
from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.ops import fused_rollout as fr

torch.set_num_threads(2)

X0 = np.array([1.0, 1.0, 3.0 * np.pi / 2, 0.0])


def _cands(N, A, scale=0.2, seed=2):
    delta = np.random.default_rng(seed).normal(size=(N, 2)) * scale
    alphas = 10.0 ** np.linspace(0.0, -5.0, max(50, A))[:A]
    return alphas[:, None, None] * delta[None]


@pytest.mark.parametrize("N,A", [(60, 20), (37, 1), (25, 128)])
def test_plain_version_matches_xla_in_f64(N, A):
    u = _cands(N, A)
    want = linesearch_rollout_xla(JCar(dt=15.0 / N).step, jnp.asarray(X0), jnp.asarray(u))
    car = CarFrontWheel(dt=15.0 / N)
    got = fr.linesearch_rollout_reference(car.step_cols, torch.tensor(X0), torch.tensor(u))
    assert got.shape == (A, N, 4)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 1e-12
    # the vmapped twin of linesearch_rollout_xla too
    twin = fr.linesearch_rollout_torch(car.step, torch.tensor(X0), torch.tensor(u))
    assert float((twin - got).abs().max()) < 1e-12


@pytest.fixture(scope="module")
def f32_case():
    N, A = 60, 20
    u = _cands(N, A).astype(np.float32)
    x0 = X0.astype(np.float32)
    jcar = JCar(dt=15.0 / N)
    roll = make_pallas_linesearch_rollout(
        lambda s, v: jcar.step_cols(s, v, _asin=asin_newton), N, 4, 2, A, interpret=True
    )
    pallas = np.asarray(roll(jnp.asarray(x0), jnp.asarray(u)))
    xla = np.asarray(linesearch_rollout_xla(jcar.step, jnp.asarray(x0), jnp.asarray(u)))
    return N, A, x0, u, pallas, xla


def test_wrapper_on_cpu_matches_pallas_and_xla_in_f32(f32_case):
    N, A, x0, u, pallas, xla = f32_case
    before = fr.launch_count
    roll = fr.make_fused_linesearch_rollout(CarFrontWheel(dt=15.0 / N), N, 4, 2, A, device="cpu")
    xs = roll(torch.tensor(x0), torch.tensor(u))
    assert fr.launch_count == before  # CPU tensors: the plain version, no launch
    assert xs.shape == (A, N, 4) and xs.dtype == torch.float32
    assert np.abs(xs.numpy() - pallas).max() < 1e-5
    assert np.abs(xs.numpy() - xla).max() < 1e-5
    # the first state is x0 for every candidate
    assert torch.equal(xs[:, 0], torch.tensor(x0).expand(A, 4))


def _fleet_case(F, N, A, nan=False):
    """x0s around X0 (N(0, 0.05^2)) and each instance's own candidates
    (alphas x its own step), float32; nan: instance 1's first three
    candidates leave the asin's domain."""
    rng = np.random.default_rng(5)
    x0s = (X0 + rng.normal(0, 0.05, (F, 4))).astype(np.float32)
    u = np.stack([_cands(N, A, seed=10 + f) for f in range(F)]).astype(np.float32)
    if nan:
        u[1, :3, :, 0], u[1, :3, :, 1] = 1.5, 40.0
    return x0s, u


def test_fleet_plain_version_matches_vmapped_pallas_and_xla_in_f32():
    F, N, A = 3, 60, 20
    x0s, u = _fleet_case(F, N, A)
    jcar = JCar(dt=15.0 / N)
    roll = make_pallas_linesearch_rollout(
        lambda s, v: jcar.step_cols(s, v, _asin=asin_newton), N, 4, 2, A, interpret=True
    )
    pallas = np.asarray(jax.vmap(roll)(jnp.asarray(x0s), jnp.asarray(u)))
    xla = np.asarray(jax.vmap(lambda x0, c: linesearch_rollout_xla(jcar.step, x0, c))(
        jnp.asarray(x0s), jnp.asarray(u)))
    car = CarFrontWheel(dt=15.0 / N)
    got = fr.linesearch_rollout_reference(car.step_cols, torch.tensor(x0s), torch.tensor(u))
    assert got.shape == (F, A, N, 4) and got.dtype == torch.float32
    assert np.abs(got.numpy() - pallas).max() < 1e-5
    assert np.abs(got.numpy() - xla).max() < 1e-5
    # each instance's candidates start from its own x0
    assert torch.equal(got[:, :, 0], torch.tensor(x0s)[:, None].expand(F, A, 4))


@pytest.mark.parametrize("F,N,A,nan", [(4, 37, 13, True), (2, 25, 128, False), (1, 60, 20, False)])
def test_fleet_wrapper_is_its_single_calls(F, N, A, nan):
    car = CarFrontWheel(dt=15.0 / N)
    x0s, u = (torch.tensor(a) for a in _fleet_case(F, N, A, nan))
    before = fr.launch_count
    roll = fr.make_fused_linesearch_rollout(car, N, 4, 2, A, device="cpu")
    xs = roll(x0s, u)
    assert fr.launch_count == before  # CPU tensors: the plain version, no launch
    assert xs.shape == (F, A, N, 4)
    assert bool(torch.isnan(xs).any()) == nan
    for f in range(F):
        one = fr.linesearch_rollout(car, x0s[f], u[f])
        assert torch.equal(torch.isnan(xs[f]), torch.isnan(one))
        assert torch.equal(torch.nan_to_num(xs[f], nan=7.0), torch.nan_to_num(one, nan=7.0))


def test_fleet_errors():
    car = CarFrontWheel()
    x0s = torch.zeros(3, 4)
    with pytest.raises(ValueError, match=r"u_cands must be \(3, A, N, 2\)"):
        fr.linesearch_rollout(car, x0s, torch.zeros(2, 8, 10, 2))
    with pytest.raises(ValueError, match="u_cands must be"):
        fr.linesearch_rollout(car, x0s, torch.zeros(8, 10, 2))
    with pytest.raises(ValueError, match="at most 128 candidates an instance"):
        fr.linesearch_rollout(car, x0s, torch.zeros(3, 129, 10, 2))
    with pytest.raises(TypeError, match="float32"):
        fr.linesearch_rollout(car, x0s.double(), torch.zeros(3, 8, 10, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="x0 must be"):
        fr.linesearch_rollout(car, torch.zeros(3, 5), torch.zeros(3, 8, 10, 2))
    with pytest.raises(ValueError, match="x0 must be"):
        fr.linesearch_rollout(car, torch.zeros(0, 4), torch.zeros(0, 8, 10, 2))
    roll = fr.make_fused_linesearch_rollout(car, 10, 4, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="u_cands must be"):
        roll(x0s, torch.zeros(3, 7, 10, 2))
    with pytest.raises(ValueError, match="u_cands must be"):
        roll(torch.zeros(4), torch.zeros(3, 8, 10, 2))


def test_nan_candidates_stay_nan():
    """A candidate whose asin argument leaves [-1, 1] gives NaN states
    from the step after it on, as the JAX rollout does."""
    N, A = 12, 4
    u = _cands(N, A).astype(np.float32)
    u[1, :, 0], u[1, :, 1] = 1.5, 40.0
    car = CarFrontWheel(dt=0.5)
    xs = fr.linesearch_rollout(car, torch.tensor(X0, dtype=torch.float32), torch.tensor(u))
    want = np.asarray(linesearch_rollout_xla(JCar(dt=0.5).step, jnp.asarray(X0, jnp.float32),
                                             jnp.asarray(u)))
    assert np.array_equal(torch.isnan(xs).numpy(), np.isnan(want))
    assert bool(torch.isnan(xs[1, -1, :3]).all()) and not bool(torch.isnan(xs[0]).any())


# csrc/linesearch_rollout.cu stages the horizon in chunks of kChunk steps
CHUNK = 1024


def _staged(car, x0, u, chunk=CHUNK):
    """The CUDA kernel's order of operations, in torch: for each chunk of
    the horizon, the v chain, then b and do for every step at once, the o
    chain, the two products for every step at once, and the x and y
    chains, with (x, y, o, v) carried into the next chunk. The step's
    operations are those of `CarFrontWheel.step`, in its order."""
    n_cands, N, _ = u.shape
    dt, dist = car.dt, car.dist

    def chain(c, d):
        out = []
        for t in range(d.shape[1]):
            out.append(c)
            c = c + d[:, t]
        return torch.stack(out, 1), c

    x, y, o, v = (x0[i].expand(n_cands) for i in range(4))
    rows = []
    for c0 in range(0, N, chunk):
        w, a = u[:, c0:c0 + chunk, 0], u[:, c0:c0 + chunk, 1]
        V, v = chain(v, a * dt)
        f = dt * V
        ins = dist**2 - (torch.sin(w) * f) ** 2
        b = f * torch.cos(w) + dist - torch.sqrt(ins)
        O, o = chain(o, torch.asin(torch.sin(w) * f / dist))
        X, x = chain(x, b * torch.cos(O))
        Y, y = chain(y, b * torch.sin(O))
        rows.append(torch.stack([X, Y, O, V], dim=2))
    return torch.cat(rows, dim=1)


@pytest.mark.parametrize("N,A,nan", [(60, 20, False), (500, 20, False), (500, 20, True),
                                     (37, 1, False), (5000, 8, False)])
def test_staged_order_replays_the_plain_version(N, A, nan):
    """The kernel's staged order equals the plain version in f64 (to
    1e-12: the CPU's vectorised sin and cos may take another path over a
    row than over a column), NaN positions exactly, also over a horizon
    of five chunks."""
    u = _cands(N, A, scale=0.05 if N > 1000 else 0.2)
    if nan:
        u[:3, :, 0], u[:3, :, 1] = 1.5, 40.0
    car = CarFrontWheel(dt=15.0 / N)
    x0, u = torch.tensor(X0), torch.tensor(u)
    want = fr.linesearch_rollout_reference(car.step_cols, x0, u)
    got = _staged(car, x0, u)
    assert got.shape == want.shape == (A, N, 4)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(want).any()) == nan
    fin = torch.isfinite(want)
    assert float((got - want)[fin].abs().max()) <= 1e-12
    assert torch.equal(got[:, 0], x0.expand(A, 4))


def test_errors():
    car = CarFrontWheel()
    # any step or callable plant is taken (the generated route; CarSimple
    # through its __call__), but not an object that is neither, nor a step
    # outside the emitter's table: the double integrator's A @ x
    assert fr.make_fused_linesearch_rollout(CarSimple(), 10, 4, 2, 8,
                                            device="cpu").route.generated is not None
    with pytest.raises(TypeError, match="step_cols callable, a callable plant"):
        fr.make_fused_linesearch_rollout(object(), 10, 4, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="matmul"):
        fr.make_fused_linesearch_rollout(DoubleIntegrator(1, 2, dt=0.1).step, 10, 2, 1, 8,
                                         device="cpu")
    with pytest.raises(ValueError, match="d=4, m=2"):
        fr.make_fused_linesearch_rollout(car, 10, 5, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="d=4, m=2"):
        fr.make_fused_linesearch_rollout(car, 10, 4, 3, 8, device="cpu")
    with pytest.raises(ValueError, match="n_alphas=129"):
        fr.make_fused_linesearch_rollout(car, 10, 4, 2, 129, device="cpu")
    roll = fr.make_fused_linesearch_rollout(car, 10, 4, 2, 8, device="cpu")
    x0 = torch.zeros(4)
    with pytest.raises(ValueError, match="u_cands must be"):
        roll(x0, torch.zeros(8, 11, 2))
    with pytest.raises(TypeError, match="float32"):
        fr.linesearch_rollout(car, x0.double(), torch.zeros(8, 10, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        fr.linesearch_rollout(car, x0, torch.zeros(10, 8, 2).transpose(0, 1))
    with pytest.raises(ValueError, match="at most 128"):
        fr.linesearch_rollout(car, x0, torch.zeros(129, 10, 2))
    with pytest.raises(ValueError, match="x0 must be"):
        fr.linesearch_rollout(car, torch.zeros(5), torch.zeros(8, 10, 2))
    with pytest.raises(ValueError, match=r"dims 1\.\.8"):
        fr.linesearch_rollout(CarSimple().step_unwrapped, torch.zeros(9), torch.zeros(8, 10, 2))


def test_no_vmem_horizon_limit():
    """The TPU kernel refused N = 3000 (12 MiB of VMEM); this one takes it."""
    N, A = 3000, 8
    roll = fr.make_fused_linesearch_rollout(CarFrontWheel(dt=15.0 / N), N, 4, 2, A, device="cpu")
    xs = roll(torch.tensor(X0, dtype=torch.float32),
              torch.tensor(_cands(N, A, scale=0.05).astype(np.float32)))
    assert xs.shape == (A, N, 4) and bool(torch.isfinite(xs).all())
    with pytest.raises(ValueError, match="VMEM"):
        make_pallas_linesearch_rollout(JCar().step_cols, N, 4, 2, A)


def test_no_device_means_the_card():
    car = CarFrontWheel()
    if torch.cuda.is_available():
        roll = fr.make_fused_linesearch_rollout(car, 10, 4, 2, 8)
        xs = roll(torch.zeros(4, device="cuda"), torch.zeros(8, 10, 2, device="cuda"))
        assert xs.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fr.make_fused_linesearch_rollout(car, 10, 4, 2, 8)
    roll = fr.make_fused_linesearch_rollout(car, 10, 4, 2, 8, device="cpu")
    with pytest.raises(ValueError, match="runs on cpu"):
        roll(torch.zeros(4, device="meta"), torch.zeros(8, 10, 2, device="meta"))
