"""Port vs JAX package: the fused robust SLS fleet (`ops/fused_sls.py`).

Twins of `tests/test_pallas_sls.py` at N=20, batch 8. The JAX side runs
`make_pallas_sls_admm` in interpret mode (f32 products at HIGHEST, its
setup in f32); the port runs on CPU tensors, where `sls_admm` takes its
plain torch version `sls_admm_reference`, with its setup in f64 cast to
f32. Problem data cross over through `convert.py`.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.stats import norm
from threadpoolctl import threadpool_limits

import chip_smoke
from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu.ops.lifted import build_Su, build_Sx
from ilqr_admm_tpu.ops.pallas_sls import make_pallas_sls_admm
from ilqr_admm_tpu.solvers.lqt import block_diag_stacked, lqt_solve_sls
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.convert import dynamics_from_numpy, quadcost_from_numpy
from ilqr_admm_tpu_torch.ops import fused_sls
from ilqr_admm_tpu_torch.ops.fused_sls import (
    _schedule,
    kernel_z_update,
    k_split,
    launch_geometry,
    make_fused_sls_admm,
    sls_admm,
    sls_admm_reference,
    sls_pieces,
    sls_row,
)
from ilqr_admm_tpu_torch.ops.fused_admm import pair_pack
from ilqr_admm_tpu_torch.utils.certify import certify_sls, sls_gate_failures

torch.set_num_threads(2)

F32 = torch.float32
PSI = float(norm.ppf(0.95))
C_COEF = PSI * 0.1
DIAMOND = dict(z_update="diamond", diamond_w=(1.0, C_COEF))


def _problem(N=20):
    """The JAX problem of test_pallas_sls.py (f32) and its port twin."""
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


def _soc():
    """The two-SOC chance constraint |du| + psi sigma |phi| <= bound."""
    mu = np.array([1.0, 0.0])
    Au = np.diag(np.sqrt([0.0, 0.01]))
    A_hi = np.concatenate([Au, (-mu / PSI)[None]], 0)
    A_lo = np.concatenate([Au, (mu / PSI)[None]], 0)
    b_fixed = np.zeros(3)
    b_bound = np.array([0.0, 0.0, 1.0 / PSI])
    return [A_hi, A_lo], [b_fixed, b_fixed], [b_bound, b_bound]


NO_SOC = ((), (), ())


def _bounds(seed, batch=8, lo=2.0, hi=4.0, sort=False):
    b = np.random.default_rng(seed).uniform(lo, hi, batch).astype(np.float32)
    return np.sort(b) if sort else b


def _np(t):
    return t.detach().cpu().numpy()


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_setup_operators_match_jax_f64():
    """PHI_unc, U_base and W against a JAX f64 recomputation of
    pallas_sls.py:367-388, to 1e-10 relative (same systems, other order
    of sums); the f32 solver holds that f64 setup rounded once."""
    N, rho_u = 20, 1.0
    A, B, cost = _problem(N)
    A64, B64 = A.astype(jnp.float64), B.astype(jnp.float64)
    PHI_unc, _ = lqt_solve_sls(A64, B64, cost)
    Su = build_Su(A64, B64)
    Sx = build_Sx(A64, 1).reshape(-1, 1)
    SuTQ = Su.T @ block_diag_stacked(cost.Q.astype(jnp.float64))
    Rr_l = rho_u * jnp.eye(N)
    l_inv = jnp.linalg.inv(SuTQ @ Su + block_diag_stacked(cost.R.astype(jnp.float64)) + Rr_l)
    r_base = jnp.concatenate([(SuTQ @ cost.lifted_xd().astype(jnp.float64))[:, None],
                              -SuTQ @ Sx], axis=-1)
    want = dict(PHI_unc=PHI_unc, U_base=(l_inv @ r_base).T, W=(l_inv @ Rr_l).T)

    tA, tB, tcost = _port(A, B, cost)
    s64 = make_fused_sls_admm(tA, tB, tcost, *NO_SOC, rho_u=rho_u, dtype=torch.float64, **DIAMOND,
                              device="cpu")
    s32 = make_fused_sls_admm(tA, tB, tcost, *NO_SOC, rho_u=rho_u, **DIAMOND, device="cpu")
    for name, value in want.items():
        assert _rel_err(_np(getattr(s64, name)), value) < 1e-10, name
        got = getattr(s32, name)
        assert got.dtype == F32 and torch.equal(got, getattr(s64, name).to(F32)), name


# (z_update options, n_iters, bound range, tolerance on max|dU| / max|U|).
# The two sides differ by the f32 setup on the JAX side: its l_inv and
# PHI_unc carry ~1e-4 relative error at N=20 (the f64 port's carry
# ~1e-7), which the converged iterate keeps (about 1.3e-4 measured);
# 1e-3 leaves room for that and no more.
CASES = {
    "diamond": (DIAMOND, dict(n_iters=200), (2.0, 4.0), 1e-3),
    "diamond-early-exit": (DIAMOND, dict(n_iters=200, stop_tol=3e-3, check_every=16),
                           (2.0, 4.0), 1e-3),
    "consensus": ({}, dict(n_iters=60, n_cons_iters=20), (2.0, 4.0), 1e-3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_sls_matches_interpret_pallas(case):
    z_kw, it_kw, (lo, hi), tol = CASES[case]
    soc = NO_SOC if z_kw else _soc()
    kw = dict(rho_u=1.0, robust_dim=1, batch_tile=4, **z_kw, **it_kw)
    A, B, cost = _problem()
    bounds = _bounds(0, lo=lo, hi=hi, sort="early" in case)
    du_p, phi_p, U_p = make_pallas_sls_admm(A, B, cost, *soc, interpret=True, **kw)(
        jnp.asarray(bounds))
    du_t, phi_t, U_t = make_fused_sls_admm(*_port(A, B, cost), *soc, **kw,
                                           device="cpu")(torch.tensor(bounds))
    assert U_t.shape == (8, 20, 2) and phi_t.shape == (8, 20, 40) and du_t.shape == (8, 20)
    assert _rel_err(_np(U_t), U_p) < tol
    assert _rel_err(_np(du_t), du_p) < tol
    # phi_u beyond the robust column is PHI_unc: f32 setup vs f64 setup
    assert _rel_err(_np(phi_t), phi_p) < 1e-2
    assert torch.equal(phi_t[:, :, 0], U_t[:, :, 1]) and torch.equal(du_t, U_t[:, :, 0])


def test_diamond_iterate_is_feasible_and_early_exit_agrees():
    """The serving configuration: the early-exit iterate sits within the
    2e-3 of test_pallas_sls.py:211-212 of the fixed schedule's, and both
    are within 5e-3 of the diamond."""
    A, B, cost = _problem()
    tA, tB, tcost = _port(A, B, cost)
    kw = dict(rho_u=1.0, robust_dim=1, n_iters=300, batch_tile=4, **DIAMOND)
    bounds = torch.tensor(_bounds(2))
    _, _, U_f = make_fused_sls_admm(tA, tB, tcost, *NO_SOC, **kw, device="cpu")(bounds)
    _, _, U_e = make_fused_sls_admm(tA, tB, tcost, *NO_SOC, stop_tol=1e-4, check_every=16,
                                    **kw, device="cpu")(bounds)
    np.testing.assert_allclose(_np(U_e), _np(U_f), atol=2e-3)
    margin = U_f[:, :, 0].abs() + C_COEF * U_f[:, :, 1].abs() - bounds[:, None]
    assert float(margin.max()) < 5e-3


@pytest.mark.parametrize(
    "args,want",
    [
        ((200, 0.0, 16), (200, 1)),  # fixed: exactly n_iters
        ((200, 3e-3, 16), (16, 13)),  # ceil(200 / 16) = 13 chunks: up to 208 iterations
        ((120, 1e-5, 8), (8, 15)),  # a multiple: no overrun
        ((0, 1e-5, 8), (8, 0)),
    ],
)
def test_schedule_matches_pallas_accounting(args, want):
    assert _schedule(*args) == want


@pytest.mark.parametrize("z_update", ["diamond", "consensus"])
def test_early_exit_overruns_to_whole_chunks(z_update):
    """A tile that never meets stop_tol runs ceil(n_iters / check_every)
    whole chunks: 24 iterations for n_iters=20, check_every=8, in the
    port as in the Pallas kernel."""
    A, B, cost = _problem()
    soc, z_kw = (NO_SOC, DIAMOND) if z_update == "diamond" else (_soc(), {})
    kw = dict(rho_u=1.0, robust_dim=1, batch_tile=4, n_cons_iters=10, **z_kw)
    bounds = _bounds(3)
    tA, tB, tcost = _port(A, B, cost)
    never = dict(stop_tol=1e-30, check_every=8)
    _, _, U_e = make_fused_sls_admm(tA, tB, tcost, *soc, n_iters=20, **never, **kw, device="cpu")(
        torch.tensor(bounds))
    _, _, U_24 = make_fused_sls_admm(tA, tB, tcost, *soc, n_iters=24, **kw,
                                     device="cpu")(torch.tensor(bounds))
    _, _, U_20 = make_fused_sls_admm(tA, tB, tcost, *soc, n_iters=20, **kw,
                                     device="cpu")(torch.tensor(bounds))
    assert torch.equal(U_e, U_24)
    assert not torch.equal(U_e, U_20)
    if z_update == "diamond":
        _, _, U_pe = make_pallas_sls_admm(A, B, cost, *soc, n_iters=20, interpret=True,
                                          **never, **kw)(jnp.asarray(bounds))
        _, _, U_p24 = make_pallas_sls_admm(A, B, cost, *soc, n_iters=24, interpret=True,
                                           **kw)(jnp.asarray(bounds))
        np.testing.assert_array_equal(np.asarray(U_pe), np.asarray(U_p24))


def test_early_exit_is_per_tile():
    """A tile that meets stop_tol stops while a harder tile runs on: the
    easy tile's result equals a solve of that tile alone."""
    A, B, cost = _problem()
    solve = make_fused_sls_admm(*_port(A, B, cost), *NO_SOC, rho_u=1.0, n_iters=400,
                                batch_tile=4, stop_tol=1e-4, check_every=4, **DIAMOND, device="cpu")
    easy = np.full(4, 40.0, np.float32)  # the bound is slack: converges at once
    hard = _bounds(4, batch=4, lo=1.0, hi=1.5)
    _, _, U_both = solve(torch.tensor(np.concatenate([easy, hard])))
    _, _, U_easy = solve(torch.tensor(easy))
    _, _, U_hard = solve(torch.tensor(hard))
    assert torch.equal(U_both[:4], U_easy)
    assert torch.equal(U_both[4:], U_hard)
    _, _, U_full = make_fused_sls_admm(*_port(A, B, cost), *NO_SOC, rho_u=1.0, n_iters=400,
                                       batch_tile=4, **DIAMOND, device="cpu")(torch.tensor(easy))
    assert not torch.equal(U_easy, U_full)  # the easy tile did leave early


def test_nonconvergent_early_exit_stops_on_nan():
    """A NaN residual stops a tile, as the Pallas while_loop test does."""
    p1, Nm = 2, 6
    U_base = torch.ones(p1, Nm)
    W = torch.eye(Nm) * float("nan")
    kw = dict(n_iters=64, stop_tol=1e-3, check_every=4, batch_tile=2, **DIAMOND)
    U = sls_admm_reference(torch.full((4,), 2.0), U_base, W, **kw)
    assert bool(torch.isnan(U).all())


def test_zero_iterations_return_u_base():
    U_base = torch.arange(12.0).reshape(2, 6)
    U = sls_admm(torch.full((4,), 2.0), U_base, torch.eye(6), pair_pack(torch.eye(6)), n_iters=0,
                 batch_tile=2, **DIAMOND)
    assert torch.equal(U, U_base.T.expand(4, 6, 2))


@pytest.mark.parametrize(
    "kwargs,err",
    [
        (dict(soc=([np.zeros((3, 2)), np.zeros((5, 2))], [np.zeros(3), np.zeros(5)],
                   [np.zeros(3), np.zeros(5)])), "same number of rows"),
        (dict(soc=([np.zeros((3, 3))], [np.zeros(3)], [np.zeros(3)])), r"\(q, 2\)"),
        (dict(z_update="diamond", diamond_w=(1.0, 0.0)), "strictly positive"),
        (dict(z_update="diamond"), "diamond_w"),
        (dict(z_update="diamond", diamond_w=(1.0, 0.3), robust_dim=2), "robust_dim == 1"),
        (dict(z_update="nope"), "z_update"),
        (dict(gemm_precision="bf16x3"), "not carried"),
        (dict(gemm_precision="f16"), "gemm_precision"),
        (dict(check_every=0, stop_tol=1e-3), "check_every"),
    ],
    ids=["ragged-soc-rows", "soc-width", "zero-diamond-weight", "diamond-without-weights",
         "diamond-robust-dim", "bad-z-update", "bf16x3", "bad-gemm-precision",
         "bad-check-every"],
)
def test_factory_validation(kwargs, err):
    tA, tB, tcost = _port(*_problem(8))
    kwargs = dict(kwargs)
    soc = kwargs.pop("soc", NO_SOC)
    with pytest.raises(ValueError, match=err):
        make_fused_sls_admm(tA, tB, tcost, *soc, rho_u=1.0, n_iters=10, **kwargs, device="cpu")


def test_batch_not_a_multiple_of_the_tile_raises():
    solve = make_fused_sls_admm(*_port(*_problem(8)), *NO_SOC, rho_u=1.0, n_iters=10,
                                batch_tile=4, **DIAMOND, device="cpu")
    with pytest.raises(ValueError, match="multiple of batch_tile"):
        solve(torch.full((6,), 2.0))


def test_kernel_z_update_packing():
    """The constants the CUDA kernels take, and the shapes they are built for."""
    soc_A, b_fixed, b_bound = _soc()
    lc = np.eye(2) + 10.0 * sum(a.T @ a for a in soc_A)
    mode, coeffs, n_sets, q = kernel_z_update(2, "consensus", None, soc_A, b_fixed, b_bound,
                                              np.linalg.inv(lc), 10.0)
    assert (mode, n_sets, q) == (1, 2, 3) and coeffs.dtype == np.float32
    assert coeffs.size == 2 * 3 * 2 * 2 + 2 * 3 * 2 + 4
    np.testing.assert_array_equal(coeffs[:12], np.stack(soc_A).ravel().astype(np.float32))
    np.testing.assert_array_equal(coeffs[12:24], (10.0 * np.stack(soc_A)).ravel().astype(np.float32))
    mode, coeffs, _, _ = kernel_z_update(2, "diamond", (1.0, C_COEF), (), (), (), None, 10.0)
    assert mode == 0
    np.testing.assert_array_equal(coeffs, np.float32([1.0, C_COEF, 1.0 + C_COEF**2]))
    # one set: the general build's shape (2, 1, 3), packed the same way;
    # five sets are past CONSENSUS_MAX
    mode, coeffs, n_sets, q = kernel_z_update(2, "consensus", None, soc_A[:1], b_fixed[:1],
                                              b_bound[:1], np.eye(2), 10.0)
    assert (mode, n_sets, q) == (1, 1, 3) and coeffs.size == 3 * 2 * 2 + 3 * 2 + 4
    with pytest.raises(ValueError, match=r"not built for \(p1, n_sets, q\) = \(2, 5, 3\)"):
        kernel_z_update(2, "consensus", None, 2 * soc_A + soc_A[:1], 2 * b_fixed + b_fixed[:1],
                        2 * b_bound + b_bound[:1], np.eye(2), 10.0)
    with pytest.raises(ValueError, match="p1 = 2"):
        kernel_z_update(3, "diamond", (1.0, 1.0), (), (), (), None, 10.0)


def test_wrapper_checks_its_inputs():
    bounds, U_base, W = torch.full((4,), 2.0), torch.ones(2, 6), torch.eye(6)
    packed = pair_pack(W)
    kw = dict(n_iters=5, batch_tile=2, **DIAMOND)
    assert torch.equal(sls_admm(bounds, U_base, W, packed, **kw),
                       sls_admm_reference(bounds, U_base, W, **kw))
    with pytest.raises(ValueError, match="contiguous"):
        sls_admm(bounds, U_base, torch.eye(6)[:, ::1].T.contiguous().T, packed, **kw)
    with pytest.raises(TypeError, match="float64"):
        sls_admm(bounds, U_base.double(), W, packed, **kw)
    with pytest.raises(ValueError, match="shape"):
        sls_admm(bounds, U_base, torch.eye(5), packed, **kw)
    with pytest.raises(ValueError, match="pair_pack"):
        sls_admm(bounds, U_base, W, (packed[0], packed[1][:, :3]), **kw)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sls_admm(*(t.to("meta") for t in (bounds, U_base, W)),
                 tuple(t.to("meta") for t in packed), **kw)


def test_cpu_tensors_do_not_launch_the_kernel():
    A, B, cost = _problem(8)
    solve = make_fused_sls_admm(*_port(A, B, cost), *NO_SOC, rho_u=1.0, n_iters=10,
                                batch_tile=4, **DIAMOND, device="cpu")
    before = fused_sls.launch_count
    solve(torch.tensor(_bounds(5)))
    assert fused_sls.launch_count == before == 0


def test_launch_geometry_limits():
    """Seven warps (six pairs of n-tiles and the single) at the bench's
    tile of 8, fourteen at 16 or with the k range split; W's 13 x 13
    blocks, two s buffers of 2 batch_tile rows and, with the split, a
    slot of 4 floats a thread, in shared memory."""
    assert launch_geometry(8, 100, 2) == (224, 4 * (64 * 13 * 13 + 2 * 16 * 8 * 13))
    assert launch_geometry(16, 100, 2)[0] == 448
    assert launch_geometry(8, 100, 2, k_split=2) == (
        448, 4 * (64 * 13 * 13 + 2 * 16 * 8 * 13 + 4 * 448))
    with pytest.raises(ValueError, match="8-instance tiles only"):
        launch_geometry(16, 100, 2, k_split=2)
    with pytest.raises(ValueError, match="8 or 16"):
        launch_geometry(4, 100, 2)
    # p1 = 3: two m-tiles a group of 8 instances (the second half zero),
    # the same warps, twice the s buffers; the k split stays at p1 = 2
    assert launch_geometry(8, 100, 3) == (224, 4 * (64 * 13 * 13 + 2 * 32 * 8 * 13))
    with pytest.raises(ValueError, match="at p1 = 2"):
        launch_geometry(8, 100, 3, k_split=2)
    with pytest.raises(ValueError, match="p1 >= 2"):
        launch_geometry(8, 100, 1)
    with pytest.raises(ValueError, match="17 warps"):
        launch_geometry(8, 264, 2)
    with pytest.raises(ValueError, match="shared memory"):
        launch_geometry(8, 240, 2)


@pytest.mark.parametrize("batch_tile", [8, 16])
def test_kernel_rows_pair_both_slabs_in_a_thread(batch_tile):
    """The kernel's tile layout: `sls_row` puts the 2 batch_tile (instance,
    slab) rows slab-major in each 16-row m-tile, once each, and in the
    m16n8k8 accumulator layout (element i of m-tile mt at row 16 mt + g +
    8 (i // 2), column 2 t + i % 2, tf32x3.cuh's frag_row) every lane
    holds both slabs of each instance and column it holds; the warps'
    pieces (`sls_pieces`) cover every (m-tile, n-tile) once."""
    rows = {sls_row(b, p): (b, p) for b in range(batch_tile) for p in range(2)}
    assert sorted(rows) == list(range(2 * batch_tile))
    for mt in range(batch_tile // 8):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            held = {}
            for i in range(4):
                b, p = rows[16 * mt + g + 8 * (i // 2)]
                held.setdefault((b, 2 * t + i % 2), set()).add(p)
            assert all(slabs == {0, 1} for slabs in held.values())
            assert {b for b, _ in held} == {8 * mt + g}
    Nm = 100
    seen = np.zeros((batch_tile // 8, -(-Nm // 8)), dtype=int)
    for pr, m0, mw in sls_pieces(batch_tile, Nm):
        n_tiles = min(2, seen.shape[1] - 2 * pr)
        seen[m0:m0 + mw, 2 * pr:2 * pr + n_tiles] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("batch,batch_tile,Nm,want", [
    (1024, 8, 100, 2),  # the bench: 128 blocks on 132 SMs, 14 warps
    (1056, 8, 100, 2),  # one block an SM
    (1064, 8, 100, 1),  # more blocks than SMs
    (16384, 8, 100, 1),
    (64, 16, 100, 1),  # 16-instance tiles are not split
    (64, 8, 136, 1),  # 18 warps would not fit in 16
])
def test_k_split_takes_two_warps_a_piece_at_one_block_an_sm(batch, batch_tile, Nm, want):
    """The wrapper's choice of warps a piece: the k split where the fleet
    leaves at most one block on each of an H100's 132 SMs and the doubled
    block fits; the launch geometry then takes it."""
    assert k_split(batch, batch_tile, Nm, 132) == want
    threads, _ = launch_geometry(batch_tile, Nm, 2, want)
    assert threads == 32 * want * len(sls_pieces(batch_tile, Nm))


def _serving_solver(mode, batch=16):
    """chip_smoke's SLS solver on the CPU in one of its modes, at the
    bench's width, and its sorted fleet of `batch` bounds."""
    (A, B, cost), solver = chip_smoke.sls_solver("cpu", mode)
    return (A, B, cost), solver, chip_smoke.sls_bounds("cpu", batch=batch, sort=True)


@pytest.mark.parametrize("mode", chip_smoke.SLS_MODES)
def test_tf32x3_products_pass_the_sls_certificates(mode):
    """The plain version with the kernel's 3xTF32 products at the bench's
    width (N = 100, 16 instances, 2 oracle instances): the diamond modes
    pass the gates of bench_pallas_sls.py:194-197, and the iterate stays
    within the kernel's tolerance of the f32 plain version. The bench
    gates only the diamond paths: the consensus iterate's 30-iteration
    inner projection holds its median oracle gap at 3.0e-4 in f32 and f64
    too, so there it must meet the other two gates. The oracle runs on
    one BLAS thread: the workers of a parallel test run share the cores."""
    (A, B, cost), solver, bounds = _serving_solver(mode)
    kw = solver.kernel_options
    U3 = sls_admm_reference(bounds, solver.U_base, solver.W, **kw, products="tf32x3")
    U = sls_admm_reference(bounds, solver.U_base, solver.W, **kw)
    err = float((U3 - U).abs().max())
    assert 0.0 < err <= chip_smoke.SLS_FIXED_TOL * max(1.0, float(U.abs().max()))
    with threadpool_limits(1):
        cert = certify_sls(A, B, cost, bounds, U3, C_COEF, n_oracle=2)
    assert cert["converged_frac"] == 1.0
    failures = sls_gate_failures(cert)
    if mode == "consensus":
        assert [f.split()[0] for f in failures] == ["cost_gap_median"]
        assert cert["cost_gap_max"] <= 1e-3
    else:
        assert failures == []


@pytest.mark.parametrize("case", list(CASES))
def test_tf32x3_products_match_interpret_pallas(case):
    """As test_fused_sls_matches_interpret_pallas runs it: the plain
    version with the kernel's 3xTF32 products stays within 1e-4 x
    max(1, max|U|) of the f32 one, and within CASES' tolerance of the
    interpret-mode Pallas kernel, as the f32 one is held."""
    z_kw, it_kw, (lo, hi), tol = CASES[case]
    soc = NO_SOC if z_kw else _soc()
    kw = dict(rho_u=1.0, robust_dim=1, batch_tile=4, **z_kw, **it_kw)
    A, B, cost = _problem()
    bounds = _bounds(0, lo=lo, hi=hi, sort="early" in case)
    _, _, U_p = make_pallas_sls_admm(A, B, cost, *soc, interpret=True, **kw)(jnp.asarray(bounds))
    solver = make_fused_sls_admm(*_port(A, B, cost), *soc, **kw, device="cpu")
    ops = (torch.tensor(bounds), solver.U_base, solver.W)
    U3 = sls_admm_reference(*ops, **solver.kernel_options, products="tf32x3")
    U = sls_admm_reference(*ops, **solver.kernel_options)
    assert float((U3 - U).abs().max()) <= 1e-4 * max(1.0, float(U.abs().max()))
    assert _rel_err(_np(U3), U_p) < tol


def test_tf32x3_early_exit_leaves_before_the_fixed_schedule():
    """The serving configuration (early exit at 3e-3 every 16 iterations,
    sorted fleet) with the kernel's products: some tiles leave before the
    fixed schedule's 208 iterations, after as many iterations as with f32
    products or one chunk apart."""
    _, solver, bounds = _serving_solver("diamond_ee", batch=32)
    kw = solver.kernel_options
    ops = (bounds, solver.U_base, solver.W)
    iters = {products: chip_smoke.sls_tile_iterations(
        lambda **o: sls_admm_reference(*ops, **o, products=products), kw, bounds.shape[0])
        for products in ("tf32x3", "f32")}
    assert iters["tf32x3"].shape == (4,)
    assert int(iters["tf32x3"].min()) < 208
    assert int((iters["tf32x3"] - iters["f32"]).abs().max()) <= kw["check_every"]
