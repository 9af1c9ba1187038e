"""Port vs JAX package: the state-bounded path of `make_fused_lqt_admm`.

Twins of the general path of `make_pallas_lqt_admm` (`_admm_kernel`) at
small N. The JAX side runs the Pallas kernel in interpret mode (bf16x3
products), its f64 setup recomputed from the JAX package's own helpers,
or the XLA fleet `make_batched_lqt_admm`; the port runs on CPU tensors,
where `admm_box` takes its plain version `admm_box_reference`. Problem
data, rho_x arrays and bound vectors cross over through `convert.py`.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu.ops.lifted import build_Su, build_Sx
from ilqr_admm_tpu.ops.pallas_admm import make_pallas_lqt_admm
from ilqr_admm_tpu.projections import project_bound
from ilqr_admm_tpu.solvers.batched import make_batched_lqt_admm
from ilqr_admm_tpu.solvers.lqt import block_diag_stacked, broadcast_rho
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.convert import array_from_numpy, dynamics_from_numpy, quadcost_from_numpy
from ilqr_admm_tpu_torch.ops import fused_admm
from ilqr_admm_tpu_torch.ops.fused_admm import (
    admm_box,
    admm_box_reference,
    box_launch_geometry,
    make_fused_lqt_admm,
    pack_box_operators,
    profile_pack,
)

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64


def _problem(N):
    """The bench problem (bench.py:107-120) at horizon N, in f32."""
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])]).astype(jnp.float32)
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3]).astype(jnp.float32)
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)
    return A.astype(jnp.float32), B.astype(jnp.float32), cost


def _port(A, B, cost, dtype=F32):
    tA, tB = dynamics_from_numpy(np.asarray(A), np.asarray(B), device="cpu", dtype=dtype)
    tcost = quadcost_from_numpy(
        np.asarray(cost.Q), np.asarray(cost.xd), np.asarray(cost.R), device="cpu", dtype=dtype
    )
    return tA, tB, tcost


def _vbox(N, v_max):
    """Velocity box as (N*2,) vectors: position free (+-inf)."""
    v = np.broadcast_to(np.asarray(v_max, np.float64), (N,))
    inf = np.full(N, np.inf)
    return np.stack([-inf, -v], 1).reshape(-1), np.stack([inf, v], 1).reshape(-1)


def _x0s(seed, batch):
    return np.random.default_rng(seed).normal(0, 0.1, size=(batch, 2)).astype(np.float32)


def _np(t):
    return t.detach().cpu().numpy()


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("rho_x_kind", ["scalar", "blocks"])
def test_general_setup_matches_jax_f64(rho_x_kind):
    """SuTQr, l_inv with the Qr term, r_base, the warm start through the
    regularized l_inv and the folded operators, against a JAX f64
    recomputation with the JAX package's helpers, at 1e-10."""
    N = 30
    A, B, cost = _problem(N)
    rho_x = 10.0 if rho_x_kind == "scalar" else np.float32(0.1) * np.stack(
        [np.eye(2) * (1 + t % 3) for t in range(N)]).astype(np.float32)
    rho_u = 0.1
    A64, B64 = A.astype(jnp.float64), B.astype(jnp.float64)
    Su = build_Su(A64, B64)
    Sx = build_Sx(A64).reshape(N * 2, 2)
    SuTQ = Su.T @ block_diag_stacked(cost.Q.astype(jnp.float64))
    Qr = broadcast_rho(jnp.asarray(rho_x, jnp.float32), 2, N).astype(jnp.float64)
    Rr = broadcast_rho(jnp.float64(rho_u), 1, N)
    SuTQr = Su.T @ block_diag_stacked(Qr)
    Rr_l = block_diag_stacked(Rr)
    l_inv = jnp.linalg.inv(SuTQ @ Su + block_diag_stacked(cost.R.astype(jnp.float64))
                           + SuTQr @ Su + Rr_l)
    r_const = SuTQ @ cost.lifted_xd().astype(jnp.float64)
    x0s = _x0s(0, 16)
    free = x0s.astype(np.float64) @ Sx.T
    r_base = r_const[None] - free @ SuTQ.T - free @ SuTQr.T
    u0 = (r_const[None] - free @ SuTQ.T) @ l_inv.T

    x_lower, x_upper = _vbox(N, 1.3)
    tA, tB, tcost = _port(A, B, cost, F64)
    rho_x_t = rho_x if rho_x_kind == "scalar" else array_from_numpy(rho_x, device="cpu",
                                                                    dtype=F64)
    kw = dict(u_lower=-5.0, u_upper=5.0, x_lower=x_lower, x_upper=x_upper, rho_x=rho_x_t,
              rho_u=rho_u, batch_tile=8)
    s64 = make_fused_lqt_admm(tA, tB, tcost, dtype=F64, **kw, device="cpu")
    assert _rel_err(_np(s64.SuTQrT), SuTQr.T) < 1e-10
    assert _rel_err(_np(s64.l_invT), l_inv.T) < 1e-10
    assert _rel_err(_np(s64.W_s), np.concatenate([(l_inv @ SuTQr).T, (l_inv @ Rr_l).T])) < 1e-10
    free_t, r_base_t, u0_t = s64.bases(torch.tensor(x0s))
    assert _rel_err(_np(free_t), free) < 1e-10
    assert _rel_err(_np(r_base_t), r_base) < 1e-10
    assert _rel_err(_np(u0_t), u0) < 1e-10
    u_base_t = s64.kernel_inputs(torch.tensor(x0s))[1]
    assert _rel_err(_np(u_base_t), r_base @ l_inv.T) < 1e-10
    np.testing.assert_array_equal(_np(s64.xb), np.stack([x_lower, x_upper]))
    np.testing.assert_array_equal(_np(s64.ub), np.stack([np.full(N, -5.0), np.full(N, 5.0)]))

    # the f32 solver holds the f64 setup of the f32-rounded data (rho
    # included), rounded once
    s32 = make_fused_lqt_admm(*_port(A, B, cost), **kw, device="cpu")
    s64 = make_fused_lqt_admm(tA, tB, tcost, dtype=F64, **dict(kw, rho_u=float(np.float32(rho_u))),
                              device="cpu")
    for name in ("Sx", "SuTQ", "r_const", "SuTQrT", "l_invT", "W_s", "SuT", "xb", "ub"):
        got = getattr(s32, name)
        assert got.dtype == F32 and got.is_contiguous()
        assert torch.equal(got, getattr(s64, name).to(F32)), name


def test_folded_iteration_is_the_tpu_kernels_iteration():
    """admm_box_reference, with l_inv folded into u_base and W_s, follows
    the four-product iteration of `_admm_kernel` (pallas_admm.py:252-272)
    to round-off in f64."""
    N = 24
    A, B, cost = _problem(N)
    x_lower, x_upper = _vbox(N, 1.3)
    solver = make_fused_lqt_admm(*_port(A, B, cost, F64), u_lower=-5.0, u_upper=5.0,
                                 x_lower=x_lower, x_upper=x_upper, rho_x=10.0, rho_u=0.1,
                                 n_iters=40, alpha=1.3, batch_tile=8, dtype=F64, device="cpu")
    x0s = torch.tensor(_x0s(1, 8), dtype=F64)
    free, r_base, u0 = solver.bases(x0s)
    SuTQrT, l_invT, SuT, xb, ub = solver.SuTQrT, solver.l_invT, solver.SuT, solver.xb, solver.ub
    RrT = 0.1 * torch.eye(N, dtype=F64)
    z_u, z_x = u0, free + u0 @ SuT
    l_x, l_u = torch.zeros_like(z_x), torch.zeros_like(z_u)
    for _ in range(40):
        r = r_base + (z_x - l_x) @ SuTQrT + (z_u - l_u) @ RrT
        u = r @ l_invT
        x = free + u @ SuT
        z_x, l_x = fused_admm._box_update(x, z_x, l_x, xb, 1.3)
        z_u, l_u = fused_admm._box_update(u, z_u, l_u, ub, 1.3)
    got = solver(x0s)
    for g, w in zip(got, (x, u, z_x, z_u)):
        assert float((g - w).abs().max()) < 1e-9 * max(1.0, float(w.abs().max()))


@pytest.mark.parametrize("n_iters", [200, 400])
def test_unfolded_f32_iteration_stalls_above_the_certificate(n_iters):
    """Why l_inv is folded into the loop's operators: run in f32 as
    `_admm_kernel` writes it (r = r_base + ..., u_hat = r l_inv^T), the
    full-width velocity-box fleet (batch 256) keeps fewer than 99% of its
    instances below 1e-4 in both residuals, at 200 iterations and at 400
    (|r| reaches ~33 while |u_hat| <= 5, and r's rounding sets a floor
    near 1.2e-4); the folded form, `admm_box_reference`, converges them
    all at 200."""
    N, batch = 100, 256
    A, B, cost = _problem(N)
    x_lower, x_upper = _vbox(N, 1.3)
    solver = make_fused_lqt_admm(*_port(A, B, cost), u_lower=-5.0, u_upper=5.0,
                                 x_lower=x_lower, x_upper=x_upper, rho_x=10.0, rho_u=0.1,
                                 n_iters=200, batch_tile=32, device="cpu")
    x0s = torch.tensor(_x0s(0, batch))

    def frac(x, u, z_x, z_u):
        prim_x = torch.linalg.vector_norm(x - z_x, dim=1)
        prim_u = torch.linalg.vector_norm(u - z_u, dim=1)
        return float(((prim_x < 1e-4) & (prim_u < 1e-4)).double().mean())

    free, r_base, u0 = solver.bases(x0s)
    RrT = torch.eye(N, dtype=F32) * np.float32(0.1)
    z_u, z_x = u0, free + u0 @ solver.SuT
    l_x, l_u = torch.zeros_like(z_x), torch.zeros_like(z_u)
    for _ in range(n_iters):
        r = r_base + (z_x - l_x) @ solver.SuTQrT + (z_u - l_u) @ RrT
        u = r @ solver.l_invT
        x = free + u @ solver.SuT
        z_x, l_x = fused_admm._box_update(x, z_x, l_x, solver.xb, 1.0)
        z_u, l_u = fused_admm._box_update(u, z_u, l_u, solver.ub, 1.0)
    assert frac(x, u, z_x, z_u) < 0.99
    assert frac(*solver(x0s)) == 1.0


@pytest.mark.parametrize("case", ["velocity box", "position cap"])
def test_box_reference_matches_interpret_pallas(case):
    """f32 plain version against the interpret-mode Pallas kernel, at the
    5e-2 of tests/test_pallas_admm.py:122-123 (that side rounds through
    bf16x3; this one is plain f32 with l_inv folded)."""
    N = 20
    A, B, cost = _problem(N)
    if case == "velocity box":
        x_lower, x_upper = _vbox(N, 1.3)
        kw = dict(u_lower=-5.0, u_upper=5.0, rho_x=10.0, rho_u=0.1)
    else:  # the configuration of test_pallas_xu_matches_xla
        x_lower, x_upper = -10.0, 0.9
        rho_x = np.zeros((N, 2, 2), np.float32)
        rho_x[:] = np.eye(2) * 1e-1
        kw = dict(u_lower=-4.0, u_upper=4.0, rho_x=rho_x, rho_u=1e-2)
    kw.update(x_lower=x_lower, x_upper=x_upper, n_iters=30, batch_tile=8)
    x0s = _x0s(2, 8)
    jax_kw = dict(kw, rho_x=jnp.asarray(kw["rho_x"]))
    want = make_pallas_lqt_admm(A, B, cost, interpret=True, **jax_kw)(jnp.asarray(x0s))
    got = make_fused_lqt_admm(*_port(A, B, cost), **kw, device="cpu")(torch.tensor(x0s))
    for name, g, w in zip(("x", "u", "z_x", "z_u"), got, want):
        assert np.abs(_np(g) - np.asarray(w)).max() < 5e-2, name


def test_fixed_point_matches_long_jax_fleet():
    """The port's general path in f64 reaches the fixed point of a
    4000-iteration JAX fleet within the 5e-3 of tests/test_pallas_admm.py
    (the two warm-start differently: regularized and unregularized l_inv)."""
    N = 30
    A, B, cost = _problem(N)
    A64, B64 = A.astype(jnp.float64), B.astype(jnp.float64)
    x_lower, x_upper = _vbox(N, 1.3)
    x0s = _x0s(3, 8)
    star = make_batched_lqt_admm(
        A64, B64, cost, project_x=lambda x: jnp.clip(x, x_lower, x_upper),
        project_u=lambda u: project_bound(u, -5.0, 5.0), rho_x=10.0, rho_u=0.1, n_iters=4000,
    )
    x_s, u_s = star(jnp.asarray(x0s, jnp.float64))
    solver = make_fused_lqt_admm(*_port(A, B, cost, F64), u_lower=-5.0, u_upper=5.0,
                                 x_lower=x_lower, x_upper=x_upper, rho_x=10.0, rho_u=0.1,
                                 n_iters=600, batch_tile=8, dtype=F64, device="cpu")
    x, u, z_x, z_u = solver(torch.tensor(x0s, dtype=F64))
    assert np.abs(_np(u) - np.asarray(u_s)).max() < 5e-3
    assert np.abs(_np(x) - np.asarray(x_s)).max() < 5e-3
    assert float(z_u.abs().max()) <= 5.0
    assert float(z_x[:, 1::2].abs().max()) <= 1.3


def test_state_only_box_with_over_relaxation():
    """No control bounds, alpha = 1.3 and a velocity limit that varies
    along the horizon (position +-inf): the f64 port reaches the JAX fleet's
    fixed point within 5e-3, and z_u stays the warm start. (At alpha = 1.6
    the JAX package's relaxed step diverges on a state box; see
    tests/test_torch_batched.py.)"""
    N = 30
    A, B, cost = _problem(N)
    A64, B64 = A.astype(jnp.float64), B.astype(jnp.float64)
    x_lower, x_upper = _vbox(N, 1.1 + 0.4 * np.cos(np.linspace(0.0, 3.0, N)))
    x0s = _x0s(4, 8)
    star = make_batched_lqt_admm(A64, B64, cost, project_x=lambda x: jnp.clip(x, x_lower, x_upper),
                                 rho_x=10.0, n_iters=4000, alpha=1.3)
    x_s, u_s = star(jnp.asarray(x0s, jnp.float64))
    solver = make_fused_lqt_admm(*_port(A, B, cost, F64), x_lower=x_lower, x_upper=x_upper,
                                 rho_x=10.0, n_iters=1500, alpha=1.3, batch_tile=8, dtype=F64,
                                 device="cpu")
    assert solver.kernel_options["has_u"] is False
    x0 = torch.tensor(x0s, dtype=F64)
    x, u, z_x, z_u = solver(x0)
    assert np.abs(_np(u) - np.asarray(u_s)).max() < 5e-3
    assert np.abs(_np(x) - np.asarray(x_s)).max() < 5e-3
    assert torch.equal(z_u, solver.bases(x0)[2])
    assert bool((z_x[:, 1::2].abs() <= torch.tensor(x_upper[1::2]) + 1e-12).all())


def test_ignored_knobs_leave_the_output_bit_identical():
    """refresh_every, polish_iters, stop_tol and check_every reach only the
    u-only kernel (pallas_admm.py:400-402); the general path ignores them."""
    N = 20
    A, B, cost = _problem(N)
    x_lower, x_upper = _vbox(N, 1.3)
    base = dict(u_lower=-5.0, u_upper=5.0, x_lower=x_lower, x_upper=x_upper, rho_x=10.0,
                rho_u=0.1, n_iters=40, batch_tile=8)
    tA, tB, tcost = _port(A, B, cost)
    x0s = torch.tensor(_x0s(5, 16))
    want = make_fused_lqt_admm(tA, tB, tcost, **base, device="cpu")(x0s)
    got = make_fused_lqt_admm(tA, tB, tcost, refresh_every=8, polish_iters=0, stop_tol=1e-3,
                              check_every=2, **base, device="cpu")(x0s)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_zero_iterations_return_the_warm_start():
    N = 16
    A, B, cost = _problem(N)
    x_lower, x_upper = _vbox(N, 1.3)
    solver = make_fused_lqt_admm(*_port(A, B, cost), u_lower=-5.0, u_upper=5.0, x_lower=x_lower,
                                 x_upper=x_upper, rho_x=10.0, rho_u=0.1, n_iters=0, batch_tile=8,
                                 device="cpu")
    x0s = torch.tensor(_x0s(6, 8))
    free, _, u0 = solver.bases(x0s)
    x, u, z_x, z_u = solver(x0s)
    assert torch.equal(u, u0) and torch.equal(z_u, u0)
    assert torch.equal(x, z_x)
    torch.testing.assert_close(x, free + u0 @ solver.SuT, rtol=0, atol=0)


def test_state_bounds_without_rho_x_raise():
    tA, tB, tcost = _port(*_problem(16))
    with pytest.raises(ValueError, match="rho_x"):
        make_fused_lqt_admm(tA, tB, tcost, x_lower=-1.0, x_upper=1.0, device="cpu")
    with pytest.raises(ValueError, match="rho_x"):
        make_fused_lqt_admm(tA, tB, tcost, u_lower=-1.0, u_upper=1.0, rho_u=0.1, rho_x=1.0,
                            device="cpu")
    with pytest.raises(ValueError, match="n_iters"):
        make_fused_lqt_admm(tA, tB, tcost, x_lower=-1.0, x_upper=1.0, rho_x=1.0, n_iters=-1,
                            device="cpu")


def _emulate_kernel_product(s, packed, base, start, stop, width, halves):
    """The kernel's product s W over a profile-packed (K, width) W, in f64
    with numpy: each column group j0 reads rows [klo, khi) as `row_range`
    finds them, split into `halves` contiguous parts as phase 1 splits them."""
    Cp = -(-width // 4) * 4
    out = np.zeros((s.shape[0], Cp))
    for j0 in range(0, Cp, 4):
        khi = int((start <= j0).sum())
        klo = int((stop <= j0).sum())
        bounds = [klo, khi] if halves == 1 else [klo, klo + max(khi - klo, 0) // 2, max(khi, klo)]
        for a, b in zip(bounds[:-1], bounds[1:]):
            for k in range(a, b):
                out[:, j0:j0 + 4] += s[:, k:k + 1] * packed[base[k] + j0:base[k] + j0 + 4]
    return out


@pytest.mark.parametrize("kind", ["SuT", "W_s", "diagonal", "banded", "zeros", "ragged"])
def test_profile_pack_matches_the_dense_product(kind):
    """profile_pack's storage, read by the kernel's row-range rule (and the
    phase-1 half split), gives the dense product exactly; Su^T packs to
    about half."""
    N = 30
    rng = np.random.default_rng(0)
    if kind in ("SuT", "W_s"):
        A, B, cost = _problem(N)
        x_lower, x_upper = _vbox(N, 1.3)
        solver = make_fused_lqt_admm(*_port(A, B, cost, F64), u_lower=-5.0, u_upper=5.0,
                                     x_lower=x_lower, x_upper=x_upper, rho_x=10.0, rho_u=0.1,
                                     batch_tile=8, dtype=F64, device="cpu")
        W = getattr(solver, kind)
    elif kind == "diagonal":
        W = torch.diag(torch.tensor(rng.normal(size=N)))
    elif kind == "banded":
        W = torch.tensor(np.triu(np.tril(rng.normal(size=(40, 40)), 3), -5))
    elif kind == "zeros":
        W = torch.zeros(12, 10, dtype=F64)
    else:  # a width that is not a multiple of 4, zero rows inside
        W = torch.tensor(rng.normal(size=(17, 98)) * (rng.random((17, 1)) > 0.3))
    packed, base, start, stop = (t.numpy() for t in profile_pack(W))
    assert base.dtype == start.dtype == stop.dtype == np.int32
    assert np.all(np.diff(start) >= 0) and np.all(np.diff(stop) >= 0)
    assert np.all(start % 4 == 0) and np.all(stop % 4 == 0)
    s = rng.normal(size=(5, W.shape[0]))
    want = s @ W.numpy()
    for halves in (1, 2):
        got = _emulate_kernel_product(s, packed, base, start, stop, W.shape[1], halves)
        np.testing.assert_allclose(got[:, :W.shape[1]], want, rtol=0, atol=1e-12)
    if kind == "SuT":
        assert packed.size < 0.55 * W.numel()
    if kind == "zeros":
        assert packed.size == 0


def test_box_launch_geometry_limits():
    # the full-width configuration: Nm = 100, Nd = 200, 39,704 packed floats
    assert box_launch_geometry(32, 100, 200, 39704) == (400, 226816)
    assert box_launch_geometry(8, 98, 196, 30000)[0] == 100
    with pytest.raises(ValueError, match="multiple of 4"):
        box_launch_geometry(6, 100, 200, 39704)
    with pytest.raises(ValueError, match="batch_tile <= 40"):
        box_launch_geometry(64, 100, 200, 39704)
    with pytest.raises(ValueError, match="shared memory"):
        box_launch_geometry(40, 100, 200, 39704)


def _box_inputs(batch=16, Nm=12, Nd=24, dtype=F32):
    g = torch.Generator().manual_seed(0)
    free = torch.randn(batch, Nd, generator=g, dtype=dtype)
    u_base = torch.randn(batch, Nm, generator=g, dtype=dtype)
    u0 = torch.randn(batch, Nm, generator=g, dtype=dtype)
    W_s = 0.05 * torch.randn(Nd + Nm, Nm, generator=g, dtype=dtype)
    SuT = 0.1 * torch.randn(Nm, Nd, generator=g, dtype=dtype)
    xb = torch.stack([-torch.ones(Nd, dtype=dtype), torch.ones(Nd, dtype=dtype)])
    ub = torch.stack([-torch.ones(Nm, dtype=dtype), torch.full((Nm,), torch.inf, dtype=dtype)])
    return free, u_base, u0, W_s, SuT, xb, ub


def test_box_wrapper_checks_its_inputs():
    inputs = _box_inputs()
    free, u_base, u0, W_s, SuT, xb, ub = inputs
    packed = pack_box_operators(W_s, SuT)
    kw = dict(n_iters=5, batch_tile=8)
    got = admm_box(*inputs, packed, **kw)
    want = admm_box_reference(*inputs, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="multiple of batch_tile"):
        admm_box(*inputs, packed, n_iters=5, batch_tile=6)
    with pytest.raises(ValueError, match="contiguous"):
        admm_box(free, u_base, u0, W_s, SuT.T.contiguous().T, xb, ub, packed, **kw)
    with pytest.raises(TypeError, match="float64"):
        admm_box(free, u_base, u0, W_s.double(), SuT, xb, ub, packed, **kw)
    with pytest.raises(ValueError, match="shape"):
        admm_box(free, u_base, u0, W_s[1:].contiguous(), SuT, xb, ub, packed, **kw)
    with pytest.raises(ValueError, match="n_iters"):
        admm_box(*inputs, packed, n_iters=-1, batch_tile=8)
    # the packed operators are required, and must fit W_s and SuT
    with pytest.raises(TypeError, match="pack_box_operators"):
        admm_box(*inputs, None, **kw)
    with pytest.raises(TypeError, match="int32"):
        admm_box(*inputs, (packed[0], packed[1].long()), **kw)
    with pytest.raises(ValueError, match="shapes of pack_box_operators"):
        admm_box(*inputs, (packed[0], packed[1][1:].contiguous()), **kw)
    meta = [t.to("meta") for t in inputs]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        admm_box(*meta, tuple(t.to("meta") for t in packed), **kw)


def test_cpu_tensors_do_not_launch_the_kernel():
    N = 20
    A, B, cost = _problem(N)
    x_lower, x_upper = _vbox(N, 1.3)
    solver = make_fused_lqt_admm(*_port(A, B, cost), u_lower=-5.0, u_upper=5.0, x_lower=x_lower,
                                 x_upper=x_upper, rho_x=10.0, rho_u=0.1, n_iters=10, batch_tile=8,
                                 device="cpu")
    before = (fused_admm.box_launch_count, fused_admm.launch_count)
    solver(torch.tensor(_x0s(7, 16)))
    assert (fused_admm.box_launch_count, fused_admm.launch_count) == before == (0, 0)
