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

import chip_smoke

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
    box_schedule,
    make_fused_lqt_admm,
    pack_box_operators,
    pair_pack,
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


def _block(ops, off, nb, n):
    """B_n (8 x 8, (k, n)) of the nb interleaved blocks at float offset
    off: lane 4 g + t holds (t + 4 h, g) of each n-tile."""
    lanes = ops[off:off + 64 * nb].reshape(8, 4, nb, 2)  # g, t, n, h
    B = np.zeros((8, 8))
    for h in range(2):
        B[np.arange(4)[:, None] + 4 * h, np.arange(8)[None]] = lanes[:, :, n, h].T
    return B


def _emulate_kernel_product(ops, sched, s, C, phase):
    """The kernel's product s @ W (C columns) as its warps compute it from
    `pair_pack` storage and a `box_schedule`, in f64 with numpy: each warp
    takes its k-steps of its n-tiles; in phase 1 each n-tile's owner adds
    the partial sums handed to it (through the u_hat buffer and the
    slots it lists), each exactly once."""
    K = s.shape[1]
    sp = np.zeros((s.shape[0], -(-K // 8) * 8))
    sp[:, :K] = s
    owned, handed = {}, {}
    for w in sched:
        off, klo, khi, nb, n0 = w[0:5] if phase == 1 else w[11:16]
        acc = [np.zeros((s.shape[0], 8)) for _ in range(2)]
        for kk in range(klo, khi):
            for n in range(nb):
                acc[n] += sp[:, 8 * kk:8 * kk + 8] @ _block(ops, off + (kk - klo) * 64 * nb, nb, n)
        if phase == 2:
            for n in range(nb):
                assert n0 + n not in owned
                owned[n0 + n] = acc[n]
            continue
        give, give_to, own, own_uh, slo, shi = w[5:11]
        if give >= 0:
            assert give_to not in handed.setdefault(n0 + give, {})
            handed[n0 + give][give_to] = acc[give]
        if own >= 0:
            assert n0 + own not in owned
            owned[n0 + own] = (acc[own], own_uh, slo, shi)
    nn = -(-C // 8)
    assert sorted(owned) == list(range(nn))
    out = np.zeros((s.shape[0], nn * 8))
    for j, a in owned.items():
        if phase == 1:
            a, own_uh, slo, shi = a
            parts = handed.get(j, {})
            assert set(parts) == ({-1} if own_uh else set()) | set(range(slo, shi))
            a = a + sum(parts.values())
        out[:, 8 * j:8 * j + 8] = a
    return out[:, :C]


@pytest.mark.parametrize("kind", ["SuT", "W_s", "diagonal", "banded", "zeros", "ragged"])
def test_pair_pack_matches_the_dense_product(kind):
    """pair_pack's storage, read by the kernel's warp schedule in either
    phase (k-split pairs and the shared last single n-tile in phase 1,
    whole pairs in phase 2), gives the dense product exactly; Su^T keeps
    its nonzero blocks only, and an all-zero operator packs to nothing."""
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
    else:  # a width that is not a multiple of 8, zero rows inside
        W = torch.tensor(rng.normal(size=(17, 98)) * (rng.random((17, 1)) > 0.3))
    packed, table = pair_pack(W)
    assert table.dtype == torch.int32 and table.shape == (-(-W.shape[1] // 16), 4)
    sched = box_schedule(table, table).numpy()
    assert sched.dtype == np.int32 and sched.shape[1] == 16
    s = rng.normal(size=(5, W.shape[0]))
    for phase in (1, 2):
        got = _emulate_kernel_product(packed.numpy(), sched, s, W.shape[1], phase)
        np.testing.assert_allclose(got, s @ W.numpy(), rtol=0, atol=1e-12)
    if kind == "SuT":  # 20 of the 32 blocks of the padded 32 x 64 at N = 30
        assert packed.numel() == 20 * 64
    if kind == "zeros":
        assert packed.numel() == 0


def test_box_schedule_balances_the_sub_partitions():
    """At the full width, 16 warps: 12 take half a pair of W_s's n-tiles,
    4 share the last single one (two through slots), and each of the four
    sub-partitions (warp % 4) carries a near-equal share of either phase;
    odd widths pad s_x and W_s to whole 8-row tiles."""
    (_, _, _), box = chip_smoke.box_solver("cpu")
    ops, sched = box.packed
    assert ops.numel() == 663 * 64 and tuple(sched.shape) == (16, 16)
    sched = sched.numpy()
    for phase, cols in ((1, slice(1, 4)), (2, slice(12, 15))):
        load = np.zeros(4)
        for w, row in enumerate(sched):
            klo, khi, nb = row[cols]
            load[w % 4] += (khi - klo) * nb
        assert load.max() - load.min() <= (2 if phase == 1 else 3), (phase, load)
    assert sorted(sched[:, 6].tolist()) == [-1] * 14 + [0, 1]  # two slot handovers
    rng = np.random.default_rng(1)
    s = rng.normal(size=(3, 300))
    W_s = box.W_s.double().numpy()
    np.testing.assert_allclose(_emulate_kernel_product(ops.double().numpy(), sched, s, 100, 1),
                               s @ W_s, rtol=0, atol=1e-9)
    # Nd = 196: W_s gains 4 zero rows between its x and u parts
    W_s, SuT = torch.randn(294, 98, dtype=F64), torch.randn(98, 196, dtype=F64)
    ops, sched = pack_box_operators(W_s, SuT)
    s = rng.normal(size=(3, 294))
    s_pad = np.concatenate([s[:, :196], np.zeros((3, 4)), s[:, 196:]], axis=1)
    np.testing.assert_allclose(_emulate_kernel_product(ops.numpy(), sched.numpy(), s_pad, 98, 1),
                               s @ W_s.numpy(), rtol=0, atol=1e-9)


def test_box_launch_geometry_limits():
    # the full-width configuration: Nm = 100, Nd = 200, 663 blocks, 16 warps
    assert box_launch_geometry(32, 100, 200, 663) == (512, 227456)
    assert box_launch_geometry(16, 98, 196, 600)[0] == 512
    # 2 warps; blocks, s and u_hat (2 n1 + n2 tiles) and two slots, bounds, schedule
    assert box_launch_geometry(32, 12, 24, 10) == (
        64, 4 * (640 + 8 * 32 * (4 + 3 + 2) + 16 * 5 + 16 * 2))
    with pytest.raises(ValueError, match="16 or 32"):
        box_launch_geometry(8, 100, 200, 663)
    with pytest.raises(ValueError, match="warps per block"):
        box_launch_geometry(32, 140, 280, 663)
    with pytest.raises(ValueError, match="shared memory"):
        box_launch_geometry(32, 104, 208, 700)


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
