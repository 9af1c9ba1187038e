"""Port vs JAX package: the fused u-only LQT-ADMM fleet (`ops/fused_admm.py`).

Twins of `tests/test_pallas_admm.py` at N=40, batch 16, tile 8. The JAX
side runs the Pallas kernel in interpret mode (bf16x3 products) or the
XLA fleet `make_batched_lqt_admm`; the port runs on CPU tensors, where
`admm_u_only` takes its plain torch version. Problem data cross over
through `convert.py`.
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
from ilqr_admm_tpu.solvers.lqt import block_diag_stacked
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.convert import dynamics_from_numpy, quadcost_from_numpy
from ilqr_admm_tpu_torch.ops import fused_admm
from ilqr_admm_tpu_torch.ops.fused_admm import (
    _schedule,
    admm_u_only,
    admm_u_only_reference,
    launch_geometry,
    make_fused_lqt_admm,
    pack_u_only_operators,
    u_only_pieces,
)
from ilqr_admm_tpu_torch.utils.certify import certify, gate_failures
from test_torch_fused_admm_box import _block

torch.set_num_threads(2)

F32 = torch.float32


def _problem(N=40):
    """The JAX problem of test_pallas_admm.py and its port twin."""
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])]).astype(jnp.float32)
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3]).astype(jnp.float32)
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)
    A, B = A.astype(jnp.float32), B.astype(jnp.float32)
    return A, B, cost


def _port(A, B, cost, dtype=F32):
    tA, tB = dynamics_from_numpy(np.asarray(A), np.asarray(B), device="cpu", dtype=dtype)
    tcost = quadcost_from_numpy(
        np.asarray(cost.Q), np.asarray(cost.xd), np.asarray(cost.R), device="cpu", dtype=dtype
    )
    return tA, tB, tcost


def _x0s(seed, batch, d=2):
    return np.random.default_rng(seed).normal(0, 0.1, size=(batch, d)).astype(np.float32)


def _np(t):
    return t.detach().cpu().numpy()


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_setup_operators_match_jax_f64():
    """W_u, W_x and the per-solve bases against a JAX f64 recomputation."""
    N = 40
    A, B, cost = _problem(N)
    rho_u = 1e-2
    A64, B64 = A.astype(jnp.float64), B.astype(jnp.float64)
    Su = build_Su(A64, B64)
    Sx = build_Sx(A64).reshape(N * 2, 2)
    SuTQ = Su.T @ block_diag_stacked(cost.Q.astype(jnp.float64))
    Rr_l = rho_u * jnp.eye(N)
    l_inv = jnp.linalg.inv(SuTQ @ Su + block_diag_stacked(cost.R.astype(jnp.float64)) + Rr_l)
    r_const = SuTQ @ cost.lifted_xd().astype(jnp.float64)
    W_u = Rr_l.T @ l_inv.T
    W_x = W_u @ Su.T
    x0s = _x0s(0, 16)
    free = x0s.astype(np.float64) @ Sx.T
    u_base = (r_const[None] - free @ SuTQ.T) @ l_inv.T
    x_base = free + u_base @ Su.T

    tA, tB, tcost = _port(A, B, cost)
    kw = dict(u_lower=-5.0, u_upper=5.0, rho_u=rho_u, batch_tile=8)
    s64 = make_fused_lqt_admm(tA, tB, tcost, dtype=torch.float64, **kw, device="cpu")
    assert _rel_err(_np(s64.W_u), W_u) < 1e-9
    assert _rel_err(_np(s64.W_x), W_x) < 1e-9
    ub64, xb64 = s64.bases(torch.tensor(x0s))
    assert _rel_err(_np(ub64), u_base) < 1e-9
    assert _rel_err(_np(xb64), x_base) < 1e-9

    # the f32 solver holds the f64 setup of the f32-rounded data (rho
    # included), rounded once to f32
    s32 = make_fused_lqt_admm(tA, tB, tcost, **kw, device="cpu")
    s64 = make_fused_lqt_admm(
        tA, tB, tcost, dtype=torch.float64, **dict(kw, rho_u=float(np.float32(rho_u))), device="cpu"
    )
    for name in ("Su", "Sx", "SuTQ", "l_side", "l_inv", "r_const", "W_u", "W_x"):
        got = getattr(s32, name)
        assert got.dtype == F32
        assert torch.equal(got, getattr(s64, name).to(F32)), name
    # f32 bases: r_const - free SuTQ^T cancels terms of ~25 before the
    # product with l_inv (entries ~50), so ~1e-5 relative is f32's floor
    ub32, xb32 = s32.bases(torch.tensor(x0s))
    assert _rel_err(_np(ub32), u_base) < 1e-4
    assert _rel_err(_np(xb32), x_base) < 1e-4


def test_fused_u_only_matches_interpret_pallas():
    """refresh_every=1: iterate match against the interpret-mode Pallas
    kernel, at the 5e-2 of test_pallas_admm.py (that side rounds through
    bf16x3; this one is plain f32)."""
    A, B, cost = _problem()
    kw = dict(u_lower=-5.0, u_upper=5.0, rho_u=1e-2, n_iters=50, batch_tile=8, refresh_every=1)
    x0s = _x0s(0, 16)
    x_p, u_p, _, zu_p = make_pallas_lqt_admm(A, B, cost, interpret=True, **kw)(jnp.asarray(x0s))
    x_t, u_t, zx_t, zu_t = make_fused_lqt_admm(*_port(A, B, cost), **kw,
                                               device="cpu")(torch.tensor(x0s))
    assert np.abs(_np(u_t) - np.asarray(u_p)).max() < 5e-2
    assert np.abs(_np(x_t) - np.asarray(x_p)).max() < 5e-2
    assert np.abs(_np(zu_t) - np.asarray(zu_p)).max() < 5e-2
    assert float(zu_t.abs().max()) <= 5.0 + 1e-5
    assert zx_t is x_t  # z_x is x on the u-only path, as in the JAX solve


def test_fused_delta_mode_converges_to_fixed_point():
    """refresh_every=8 reaches the fixed point of the 4000-iteration XLA
    fleet within the 5e-3 of test_pallas_admm.py."""
    A, B, cost = _problem()
    x0s = _x0s(0, 16)
    star = make_batched_lqt_admm(
        A, B, cost, project_u=lambda u: project_bound(u, -5.0, 5.0), rho_u=1e-2, n_iters=4000,
    )
    _, u_s = star(jnp.asarray(x0s))
    solve = make_fused_lqt_admm(
        *_port(A, B, cost), u_lower=-5.0, u_upper=5.0, rho_u=1e-2,
        n_iters=1000, batch_tile=8, refresh_every=8, device="cpu",
    )
    _, u_t, _, zu_t = solve(torch.tensor(x0s))
    assert np.abs(_np(u_t) - np.asarray(u_s)).max() < 5e-3
    assert float(zu_t.abs().max()) <= 5.0 + 1e-5


def test_fused_polish_reaches_primal_tolerance():
    """The polish count: with exact f32 products the final primal
    residual is below 1e-4 with or without polish, and polish changes
    only how the same 100 iterations are labelled."""
    A, B, cost = _problem()
    x0s = torch.tensor(_x0s(0, 16))

    def prim(polish):
        solve = make_fused_lqt_admm(
            *_port(A, B, cost), u_lower=-5.0, u_upper=5.0, rho_u=1e-1,
            n_iters=100, batch_tile=8, polish_iters=polish, device="cpu",
        )
        _, u, _, zu = solve(x0s)
        return float(torch.linalg.vector_norm(u - zu, dim=-1).max())

    p0, p12 = prim(0), prim(12)
    assert p12 < 1e-4, (p0, p12)
    assert p12 <= p0
    assert p12 == p0


def test_fused_early_exit_matches_full_schedule():
    """stop_tol > 0 returns the full schedule's solution within the 2e-4
    of test_pallas_admm.py, and no worse a primal residual."""
    A, B, cost = _problem()
    kw = dict(u_lower=-5.0, u_upper=5.0, rho_u=1e-2, n_iters=120, batch_tile=8, refresh_every=1)
    tA, tB, tcost = _port(A, B, cost)
    x0s = torch.tensor(_x0s(1, 16))
    x_f, u_f, _, zu_f = make_fused_lqt_admm(tA, tB, tcost, **kw, device="cpu")(x0s)
    x_e, u_e, _, zu_e = make_fused_lqt_admm(tA, tB, tcost, stop_tol=1e-5, **kw, device="cpu")(x0s)
    np.testing.assert_allclose(_np(u_e), _np(u_f), atol=2e-4)
    np.testing.assert_allclose(_np(x_e), _np(x_f), atol=2e-4)
    assert float(zu_e.abs().max()) <= 5.0 + 1e-5
    r_f = (u_f - zu_f).abs().amax(dim=1)
    r_e = (u_e - zu_e).abs().amax(dim=1)
    np.testing.assert_allclose(_np(r_e), _np(r_f), atol=2e-4)


def test_fused_early_exit_with_delta_mode():
    """stop_tol with refresh_every=8 and check_every=4, as in
    test_pallas_admm.py: converged output matches, exited tiles are at
    least as converged as the fixed schedule."""
    A, B, cost = _problem()
    kw = dict(u_lower=-5.0, u_upper=5.0, rho_u=1e-1, n_iters=96, batch_tile=8, refresh_every=8)
    tA, tB, tcost = _port(A, B, cost)
    x0s = torch.tensor(_x0s(2, 8))
    _, u_f, _, zu_f = make_fused_lqt_admm(tA, tB, tcost, **kw, device="cpu")(x0s)
    _, u_e, _, zu_e = make_fused_lqt_admm(tA, tB, tcost, stop_tol=1e-5, check_every=4, **kw,
                                          device="cpu")(x0s)
    np.testing.assert_allclose(_np(u_e), _np(u_f), atol=5e-4)
    r_e = torch.linalg.vector_norm(u_e - zu_e, dim=-1)
    r_f = torch.linalg.vector_norm(u_f - zu_f, dim=-1)
    assert float(r_e.max()) <= float(r_f.max()) + 5e-4


def test_early_exit_is_per_tile():
    """A tile that meets stop_tol stops while a harder tile runs on: the
    easy tile's result equals a solve of that tile alone."""
    A, B, cost = _problem()
    tA, tB, tcost = _port(A, B, cost)
    kw = dict(u_lower=-5.0, u_upper=5.0, rho_u=1e-1, n_iters=200, batch_tile=8,
              stop_tol=1e-4, check_every=2, polish_iters=0)
    easy = np.zeros((8, 2), np.float32)
    hard = _x0s(3, 8) * 30.0
    solve = make_fused_lqt_admm(tA, tB, tcost, **kw, device="cpu")
    _, u_both, _, _ = solve(torch.tensor(np.concatenate([easy, hard])))
    _, u_easy, _, _ = solve(torch.tensor(easy))
    _, u_hard, _, _ = solve(torch.tensor(hard))
    assert torch.equal(u_both[:8], u_easy)
    assert torch.equal(u_both[8:], u_hard)


@pytest.mark.parametrize(
    "args,want",
    [
        ((100, 1, 8, 0.0, 8), (92, 1, 8)),  # n_main 92 at refresh 1
        ((100, 8, 8, 0.0, 8), (96, 1, 8)),  # ceil(92 / 8) = 12 blocks of 8
        ((100, 1, 8, 1e-5, 4), (4, 23, 8)),  # chunks of 3 refresh blocks + 1
        ((96, 8, 8, 1e-5, 4), (25, 4, 8)),  # 3 * 8 + 1 = 25, ceil(88 / 25)
        ((5, 1, 8, 0.0, 8), (0, 1, 5)),  # polish capped at n_iters
    ],
)
def test_schedule_matches_pallas_accounting(args, want):
    assert _schedule(*args) == want


def test_bounds_without_rho_raise():
    A, B, cost = _problem(16)
    tA, tB, tcost = _port(A, B, cost)
    with pytest.raises(ValueError, match="rho_u"):
        make_fused_lqt_admm(tA, tB, tcost, u_lower=-1.0, u_upper=1.0, device="cpu")
    with pytest.raises(ValueError, match="rho_u"):
        make_fused_lqt_admm(tA, tB, tcost, u_lower=-1.0, u_upper=1.0, rho_u=0.0, device="cpu")
    with pytest.raises(ValueError, match="at least one box"):
        make_fused_lqt_admm(tA, tB, tcost, device="cpu")


def test_cpu_tensors_do_not_launch_the_kernel():
    A, B, cost = _problem()
    solve = make_fused_lqt_admm(*_port(A, B, cost), u_lower=-5.0, u_upper=5.0, rho_u=1e-1,
                                n_iters=20, batch_tile=8, device="cpu")
    before = fused_admm.launch_count
    solve(torch.tensor(_x0s(0, 16)))
    assert fused_admm.launch_count == before == 0


def test_f32_plain_path_agrees_with_f64():
    """The f32 plain path against the same solve in f64. The f32 bases
    come from r_const - free SuTQ^T, which cancels terms of ~25 (the 1e3
    via-point weight), so u_base carries ~1e-5 of f32 rounding (bound
    1e-4); the box-constrained fixed point amplifies that about tenfold
    (bound 1e-3 on the iterates). The cost-gap certificate in
    test_torch_slice.py is the accuracy gate of the f32 solve."""
    A, B, cost = _problem()
    kw = dict(u_lower=-5.0, u_upper=5.0, rho_u=1e-1, n_iters=100, batch_tile=8)
    x0s = torch.tensor(_x0s(4, 16))
    s32 = make_fused_lqt_admm(*_port(A, B, cost), **kw, device="cpu")
    s64 = make_fused_lqt_admm(*_port(A, B, cost, torch.float64), dtype=torch.float64, **kw,
                              device="cpu")
    assert float((s32.bases(x0s)[0].double() - s64.bases(x0s)[0]).abs().max()) < 1e-4
    out32, out64 = s32(x0s), s64(x0s)
    assert out64[1].dtype == torch.float64
    for got, want in zip(out32, out64):
        assert float((got.double() - want).abs().max()) < 1e-3


def test_alpha_over_relaxation_matches_batched_fixed_point():
    """alpha != 1 (over-relaxation) reaches the same fixed point as the
    XLA fleet with the same alpha."""
    A, B, cost = _problem()
    x0s = _x0s(5, 8)
    star = make_batched_lqt_admm(
        A, B, cost, project_u=lambda u: project_bound(u, -5.0, 5.0), rho_u=1e-1,
        n_iters=2000, alpha=1.6,
    )
    _, u_s = star(jnp.asarray(x0s))
    solve = make_fused_lqt_admm(*_port(A, B, cost), u_lower=-5.0, u_upper=5.0, rho_u=1e-1,
                                n_iters=600, batch_tile=8, alpha=1.6, device="cpu")
    _, u_t, _, zu_t = solve(torch.tensor(x0s))
    assert np.abs(_np(u_t) - np.asarray(u_s)).max() < 5e-3
    assert float(zu_t.abs().max()) <= 5.0 + 1e-5


def _kernel_inputs(batch=16, Nm=12, Nd=24, dtype=F32):
    g = torch.Generator().manual_seed(0)
    u_base = torch.randn(batch, Nm, generator=g, dtype=dtype)
    x_base = torch.randn(batch, Nd, generator=g, dtype=dtype)
    W_u = 0.1 * torch.randn(Nm, Nm, generator=g, dtype=dtype)
    W_x = torch.randn(Nm, Nd, generator=g, dtype=dtype)
    lo = -torch.ones(Nm, dtype=dtype)
    hi = torch.ones(Nm, dtype=dtype)
    return u_base, x_base, W_u, W_x, lo, hi


def test_wrapper_checks_its_inputs():
    u_base, x_base, W_u, W_x, lo, hi = _kernel_inputs()
    packed = pack_u_only_operators(W_u, W_x)
    kw = dict(n_iters=5, batch_tile=8)
    x, u, z = admm_u_only(u_base, x_base, W_u, W_x, lo, hi, packed, **kw)
    rx, ru, rz = admm_u_only_reference(u_base, x_base, W_u, W_x, lo, hi, **kw)
    assert torch.equal(x, rx) and torch.equal(u, ru) and torch.equal(z, rz)
    with pytest.raises(ValueError, match="multiple of batch_tile"):
        admm_u_only(u_base, x_base, W_u, W_x, lo, hi, packed, n_iters=5, batch_tile=6)
    with pytest.raises(ValueError, match="contiguous"):
        admm_u_only(u_base, x_base, W_u.T, W_x, lo, hi, packed, **kw)
    with pytest.raises(TypeError, match="float64"):
        admm_u_only(u_base, x_base, W_u.double(), W_x, lo, hi, packed, **kw)
    with pytest.raises(ValueError, match="shape"):
        admm_u_only(u_base, x_base, W_u, W_x[:, :-1].contiguous(), lo, hi, packed, **kw)
    with pytest.raises(ValueError, match="refresh_every"):
        admm_u_only(u_base, x_base, W_u, W_x, lo, hi, packed, n_iters=5, batch_tile=8,
                    refresh_every=0)
    with pytest.raises(TypeError, match="pack_u_only_operators"):
        admm_u_only(u_base, x_base, W_u, W_x, lo, hi, packed[0], **kw)
    with pytest.raises(ValueError, match="shapes of pack_u_only_operators"):
        admm_u_only(u_base, x_base, W_u, W_x, lo, hi, (packed[0], packed[1][:-1]), **kw)
    with pytest.raises(ValueError, match="products"):
        admm_u_only_reference(u_base, x_base, W_u, W_x, lo, hi, **kw, products="tf32")
    with pytest.raises(TypeError, match="float32"):
        admm_u_only_reference(*(t.double() for t in (u_base, x_base, W_u, W_x, lo, hi)), **kw,
                              products="tf32x3")
    meta = [t.to("meta") for t in (u_base, x_base, W_u, W_x, lo, hi, *packed)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        admm_u_only(*meta[:6], tuple(meta[6:]), **kw)


def test_launch_geometry_limits():
    assert launch_geometry(64, 100) == (512, 4 * (64 * 13 * 13 + 2 * 8 * 64 * 13 + 16 * 13))
    assert launch_geometry(16, 40)[0] == 96
    with pytest.raises(ValueError, match="16, 32 or 64"):
        launch_geometry(8, 100)
    with pytest.raises(ValueError, match="batch_tile <= 32"):
        launch_geometry(64, 120)
    with pytest.raises(ValueError, match="shared memory"):
        launch_geometry(16, 240)


@pytest.mark.parametrize("batch_tile,Nm", [(64, 100), (32, 98), (16, 40)])
def test_pieces_cover_the_products(batch_tile, Nm):
    """The kernel's two products replayed in f64 from `pack_u_only_operators`'
    storage, piece by piece as its warps take them (`u_only_pieces` for
    s W_u, W_x's pairs over m-groups for x), cover every output once and
    give s W_u and s W_x."""
    rng = np.random.default_rng(Nm)
    Nd = 2 * Nm
    W_u, W_x = rng.normal(size=(Nm, Nm)), rng.normal(size=(Nm, Nd))
    ops, table = (t.numpy() for t in pack_u_only_operators(torch.tensor(W_u), torch.tensor(W_x)))
    s = np.zeros((batch_tile, -(-Nm // 8) * 8))
    s[:, :Nm] = rng.normal(size=(batch_tile, Nm))
    n_pairs_u = -(-Nm // 16)
    mx = min(batch_tile // 16, 2)
    x_pieces = [(n_pairs_u + px, m0, mx) for px in range(-(-Nd // 16))
                for m0 in range(0, batch_tile // 16, mx)]
    pieces = u_only_pieces(batch_tile, Nm)
    assert len(pieces) == launch_geometry(batch_tile, Nm)[0] // 32
    for cols, W, plan in ((Nm, W_u, pieces), (Nd, W_x, x_pieces)):
        out = np.zeros((batch_tile, -(-cols // 8) * 8))
        seen = np.zeros(out.shape, dtype=int)
        for row, m0, mw in plan:
            off, klo, khi, nb = table[row]
            rows = slice(16 * m0, 16 * (m0 + mw))
            n0 = 2 * (row - (n_pairs_u if W is W_x else 0))
            for kk in range(klo, khi):
                for n in range(nb):
                    block = _block(ops, off + (kk - klo) * 64 * nb, nb, n)
                    out[rows, 8 * (n0 + n):8 * (n0 + n + 1)] += s[rows, 8 * kk:8 * kk + 8] @ block
            for n in range(nb):
                seen[rows, 8 * (n0 + n):8 * (n0 + n + 1)] += 1
        assert (seen == 1).all()
        np.testing.assert_allclose(out[:, :cols], s[:, :Nm] @ W, rtol=0, atol=1e-12)


def _bench_fleet(batch=256, **overrides):
    """chip_smoke's u-only bench solver on the CPU and its kernel inputs."""
    A, B, cost, x0s = chip_smoke.bench_problem("cpu", batch=batch)
    kw = dict(u_lower=-chip_smoke.U_MAX, u_upper=chip_smoke.U_MAX, rho_u=chip_smoke.RHO_U,
              n_iters=chip_smoke.ADMM_ITERS, batch_tile=chip_smoke.BATCH_TILE, device="cpu")
    solver = make_fused_lqt_admm(A, B, cost, **dict(kw, **overrides))
    return (A, B, cost, x0s), solver, solver.kernel_inputs(x0s)


def test_tf32x3_schedule_passes_the_bench_gates():
    """The plain version with the kernel's tensor-core products (3xTF32
    main iterations, 6xTF32 tail and x from 3xTF32) passes the bench
    certificates at batch 256 and stays within the kernel tolerance of
    the f32 plain version."""
    (A, B, cost, x0s), solver, inputs = _bench_fleet()
    x, u, z_u = admm_u_only_reference(*inputs, **solver.kernel_options, products="tf32x3")
    cert = certify(A, B, cost, x0s, u, z_u, -chip_smoke.U_MAX, chip_smoke.U_MAX)
    assert gate_failures(cert) == []
    assert cert["converged_frac"] == 1.0
    want = admm_u_only_reference(*inputs, **solver.kernel_options)
    err = max(float((g - w).abs().max()) for g, w in zip((x, u, z_u), want))
    assert 0.0 < err <= chip_smoke.KERNEL_TOL


def test_tf32x3_schedule_matches_interpret_pallas():
    """As test_fused_u_only_matches_interpret_pallas runs it: the 3xTF32
    plain version stays within 1e-4 of the f32 one, and so sits where the
    f32 one sits against the interpret-mode Pallas kernel (8.4e-4 on u:
    the f32 setup of the JAX factory moves the fixed point, not the
    products)."""
    A, B, cost = _problem()
    kw = dict(u_lower=-5.0, u_upper=5.0, rho_u=1e-2, n_iters=50, batch_tile=8, refresh_every=1)
    x0s = _x0s(0, 16)
    pallas = make_pallas_lqt_admm(A, B, cost, interpret=True, **kw)(jnp.asarray(x0s))
    solver = make_fused_lqt_admm(*_port(A, B, cost), **kw, device="cpu")
    inputs = solver.kernel_inputs(torch.tensor(x0s))
    f32 = admm_u_only_reference(*inputs, **solver.kernel_options)
    tf32 = admm_u_only_reference(*inputs, **solver.kernel_options, products="tf32x3")
    for got, plain, want in zip(tf32, f32, (pallas[0], pallas[1], pallas[3])):
        assert float((got - plain).abs().max()) <= 1e-4
        assert np.abs(_np(got) - np.asarray(want)).max() < 2e-3


def test_tf32x3_early_exit_leaves_before_the_fixed_schedule():
    """chip_smoke's early-exit mode (stop_tol 1e-5, check_every 4) with
    the kernel's products, the exit tested on the 6xTF32 chunk end: the
    tiles leave the main phase after as many chunks as with f32 products
    (convergence sets them, not the products' error), some before the
    fixed schedule's 23, and the result passes the bench gates."""
    mode = chip_smoke.MODES["stop_tol=1e-5, check_every=4"]
    (A, B, cost, x0s), solver, inputs = _bench_fleet(**mode)
    kw = solver.kernel_options
    chunk_len, n_chunks, n_tail = _schedule(kw["n_iters"], kw["refresh_every"],
                                            kw["polish_iters"], kw["stop_tol"], kw["check_every"])
    assert (chunk_len, n_chunks, n_tail) == (4, 23, 8)
    iters = {products: chip_smoke.u_only_tile_iterations(
        lambda **o: admm_u_only_reference(*inputs, **o, products=products), kw, x0s.shape[0])
        for products in ("tf32x3", "f32")}
    assert iters["tf32x3"].shape == (x0s.shape[0] // kw["batch_tile"],)
    assert torch.equal(iters["tf32x3"], iters["f32"])
    assert int(iters["tf32x3"].min()) < chunk_len * n_chunks + n_tail
    _, u, z_u = admm_u_only_reference(*inputs, **kw, products="tf32x3")
    assert gate_failures(certify(A, B, cost, x0s, u, z_u, -5.0, 5.0)) == []
