"""Port vs JAX package: the u-only LQT-ADMM fleet at the width of
`benchmarks/bench_wide_certified.py` (d = 8, m = 4, N = 128: Nm = 512),
and the delta products of `_admm_kernel_u_only` (`refresh_every > 1`).

The JAX side runs the Pallas kernel in interpret mode (bf16x3 refreshes,
one-pass bf16 deltas, f32 setup); the port runs on CPU tensors, where
`admm_u_only` takes its plain torch version. Also: the one-pass TF32
helper and the 3xTF32 delta schedule against numpy replays, the wide
route's pieces and k-chunks replayed in numpy, its geometry, and
`refresh_every = 1` against the loop as it was before delta products.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ilqr_admm_tpu.ops.pallas_admm import make_pallas_lqt_admm
from ilqr_admm_tpu_torch.convert import dynamics_from_numpy, quadcost_from_numpy
from ilqr_admm_tpu_torch.ops import fused_admm
from ilqr_admm_tpu_torch.ops.fused_admm import (
    WIDE_K_CHUNK,
    _schedule,
    admm_u_only,
    admm_u_only_reference,
    default_u_tile,
    launch_geometry,
    make_fused_lqt_admm,
    pack_u_only_operators,
    u_only_route,
    wide_launch_geometry,
    wide_pieces,
)
from ilqr_admm_tpu_torch.utils.certify import converged_frac, max_violation, oracle_cost_gap
from ilqr_admm_tpu_torch.utils.precision import (
    full_f32_matmul,
    tf32x1_matmul,
    tf32x3_matmul,
    tf32x6_matmul,
)
from test_torch_fused_admm_box import _block

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64


def _np_tf32_round(x):
    """TF32 round-to-nearest, ties away from zero, on float32 bits."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _np_tf32_trunc(x):
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _np_split(x, parts):
    out, rest = [], np.asarray(x, np.float32)
    for _ in range(parts - 1):
        out.append(_np_tf32_round(rest))
        rest = (rest - out[-1]).astype(np.float32)
    return [p.astype(np.float64) for p in out + [_np_tf32_trunc(rest)]]


def _mm(a, b):
    """A product of TF32 parts, summed in f64 and rounded to f32."""
    return (a @ b).astype(np.float32)


def _np_x3(a, b):
    (a0, a1), (b0, b1) = _np_split(a, 2), _np_split(b, 2)
    return (_mm(a1, b0) + _mm(a0, b1)) + _mm(a0, b0)


def _np_x6(a, b):
    (a0, a1, a2), (b0, b1, b2) = _np_split(a, 3), _np_split(b, 3)
    return (((_mm(a2, b0) + _mm(a1, b1)) + _mm(a0, b2)) + (_mm(a1, b0) + _mm(a0, b1))
            + _mm(a0, b0))


def _np_x1(a, b):
    return _mm(_np_tf32_round(a).astype(np.float64), _np_tf32_round(b).astype(np.float64))


def _wide_jax(batch=8):
    """bench_wide_certified.py's problem in JAX (f32) and its port twin (f64)."""
    from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
    from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost

    N = chip_smoke.WIDE_N
    plant = DoubleIntegrator(4, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    zs = jnp.stack([jnp.zeros(d, jnp.float32), jnp.asarray(chip_smoke.WIDE_TARGET, jnp.float32)])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3]).astype(jnp.float32)
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)
    A, B = A.astype(jnp.float32), B.astype(jnp.float32)
    tA, tB = dynamics_from_numpy(np.asarray(A), np.asarray(B), device="cpu", dtype=F64)
    tcost = quadcost_from_numpy(np.asarray(cost.Q), np.asarray(cost.xd), np.asarray(cost.R),
                                device="cpu", dtype=F64)
    x0s = np.random.default_rng(0).normal(0.0, 0.1, size=(batch, d)).astype(np.float32)
    return (A, B, cost), (tA, tB, tcost), x0s


def test_wide_fleet_f64_matches_interpret_pallas_and_passes_the_bench_gates():
    """The bench's options (|u| <= 5, rho_u 0.1, 100 iterations,
    refresh_every 8, polish 8) on its first 8 instances: the port's plain
    version in f64 and the interpret-mode Pallas kernel both pass the
    bench's gates (violation 0, converged at 1e-4, oracle gap <= 1e-4),
    and their z_u agree within 2e-3 (3.4e-4 measured: the JAX side's f32
    setup and bf16 products)."""
    (A, B, cost), port, x0s = _wide_jax()
    kw = dict(u_lower=-5.0, u_upper=5.0, rho_u=chip_smoke.RHO_U, n_iters=chip_smoke.WIDE_ITERS,
              refresh_every=chip_smoke.WIDE_REFRESH, batch_tile=8)
    x_p, u_p, _, zu_p = make_pallas_lqt_admm(A, B, cost, interpret=True, **kw)(jnp.asarray(x0s))
    solver = make_fused_lqt_admm(*port, **kw, dtype=F64, device="cpu")
    x_t, u_t, _, zu_t = solver(torch.tensor(x0s, dtype=F64))
    assert u_t.shape == (8, 512) and x_t.shape == (8, 1024)
    for u, z in ((u_t, zu_t), (torch.tensor(np.asarray(u_p)), torch.tensor(np.asarray(zu_p)))):
        assert max_violation(z, -5.0, 5.0) == 0.0
        assert converged_frac(u, z) >= 0.99
        med, worst = oracle_cost_gap(*port, torch.tensor(x0s), z, -5.0, 5.0)
        assert med <= 1e-4 and worst <= 1e-4
    assert np.abs(zu_t.numpy() - np.asarray(zu_p)).max() < 2e-3
    assert np.abs(x_t.numpy() - np.asarray(x_p)).max() < 2e-3


def test_tf32x1_matmul_is_one_pass_of_the_rounded_operands():
    """`tf32x1_matmul` is tf32_round(a) @ tf32_round(b) summed in f32: exact
    where each output is one product, within f32 summation of the f64 sum
    otherwise; it differs from the f32 product at the TF32 level."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(16, 40)).astype(np.float32)
    b = rng.normal(size=(40, 24)).astype(np.float32)
    got = tf32x1_matmul(torch.tensor(a), torch.tensor(b)).numpy()
    want = _np_x1(a, b)
    np.testing.assert_allclose(got, want, rtol=0, atol=40 * 2.0**-23 * np.abs(want).max())
    one = np.zeros_like(a)
    one[np.arange(16), rng.integers(0, 40, 16)] = a[np.arange(16), 0]
    assert np.array_equal(tf32x1_matmul(torch.tensor(one), torch.tensor(b)).numpy(),
                          _np_x1(one, b).astype(np.float32))
    with full_f32_matmul():
        full = (torch.tensor(a) @ torch.tensor(b)).numpy()
    assert 1e-5 < np.abs(got - full).max() / np.abs(full).max() < 2.0**-9


def _replay(u_base, x_base, W_u, W_x, lo, hi, *, n_iters, refresh_every, polish_iters,
            stop_tol, check_every, batch_tile):
    """The kernels' schedule of 3xTF32 refreshes, one-pass deltas and 6xTF32
    tail and chunk ends (alpha = 1), in numpy: f32 iterates, each product
    of TF32 parts summed in f64 and rounded to f32."""
    chunk_len, n_chunks, n_tail = _schedule(n_iters, refresh_every, polish_iters, stop_tol,
                                            check_every)
    tiles = u_base.shape[0] // batch_tile
    ub = u_base.reshape(tiles, batch_tile, -1)
    z, lam, s, c, u = ub.copy(), np.zeros_like(ub), ub.copy(), np.zeros_like(ub), ub.copy()
    active = np.ones(tiles, bool)

    def step(t, kind):
        s_new = z[t] - lam[t]
        if kind == "delta":
            c_new = c[t] + _np_x1(s_new - s[t], W_u)
        else:
            c_new = (_np_x6 if kind == "six" else _np_x3)(s_new, W_u)
        u_new = ub[t] + c_new
        v = u_new + lam[t]
        z_new = np.minimum(np.maximum(v, lo), hi)
        return z_new, v - z_new, s_new, c_new, u_new

    for _ in range(n_chunks):
        for i in range(chunk_len):
            kind = ("six" if stop_tol > 0.0 and i == chunk_len - 1
                    else "delta" if i % refresh_every else "main")
            for t in np.flatnonzero(active):
                z[t], lam[t], s[t], c[t], u[t] = step(t, kind)
        if stop_tol > 0.0:
            active &= np.abs(u - z).max(axis=(1, 2)) >= stop_tol
            if not active.any():
                break
    for _ in range(n_tail):
        for t in range(tiles):
            z[t], lam[t], s[t], c[t], u[t] = step(t, "six")
    x = x_base.reshape(tiles, batch_tile, -1) + _np_x3(s, W_x)
    return x.reshape(x_base.shape), u.reshape(u_base.shape), z.reshape(u_base.shape)


def _small_wide(N=6):
    """bench_wide_certified.py's plant and cost at horizon N (Nm = 4 N), f32."""
    from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
    from ilqr_admm_tpu_torch.utils.cost_assembly import viapoint_cost

    plant = DoubleIntegrator(4, 2, dt=1.0 / N, dtype=F32)
    d, m = plant.x_dim, plant.u_dim
    zs = np.stack([np.zeros(d), chip_smoke.WIDE_TARGET]).astype(np.float32)
    Qs = np.stack([np.zeros((d, d)), np.eye(d) * 1e3]).astype(np.float32)
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    return (*plant.AB(N), viapoint_cost(zs, Qs, seq, 1e-2, m, dtype=F32))


@pytest.mark.parametrize("options,tol", [
    (dict(refresh_every=4, polish_iters=0, stop_tol=0.0, check_every=8), 2e-3),
    (dict(refresh_every=4, polish_iters=3, stop_tol=1e-5, check_every=2), 1e-4),
])
def test_tf32x3_delta_schedule_matches_a_numpy_replay(options, tol):
    """`admm_u_only_reference(products="tf32x3")` with refresh_every 4 on
    the wide bench's plant at N = 6 (Nm = 24; 30 iterations, |u| <= 5,
    x0 ~ N(0, 0.1^2); unconverged, so f32 rounding grows through W_u)
    against the replay of the same schedule in numpy, within tol (6.8e-4
    and 9.8e-6 measured: f32 against f64 sums of the TF32 parts; the
    fixed schedule without a tail ends on a delta iteration); the same
    loop with every iteration a refresh is more than 10 tol from it (5.8e-2
    and 5.7e-2), so the deltas are what was compared."""
    A, B, cost = _small_wide()
    solver = make_fused_lqt_admm(A, B, cost, u_lower=-5.0, u_upper=5.0, rho_u=0.1, n_iters=30,
                                 batch_tile=8, device="cpu", **options)
    x0s = torch.tensor(np.random.default_rng(1).normal(0.0, 0.1, size=(16, 8)), dtype=F32)
    inputs = solver.kernel_inputs(x0s)
    kw = solver.kernel_options
    got = admm_u_only_reference(*inputs, **kw, products="tf32x3")
    want = _replay(*(t.numpy() for t in inputs), **{k: v for k, v in kw.items() if k != "alpha"})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol)
    refreshed = admm_u_only_reference(*inputs, **dict(kw, refresh_every=1), products="tf32x3")
    assert max(float(np.abs(r.numpy() - w).max()) for r, w in zip(refreshed, want)) > 10 * tol


def _previous_loop(u_base, x_base, W_u, W_x, lo, hi, *, n_iters, refresh_every=1, alpha=1.0,
                   polish_iters=8, stop_tol=0.0, check_every=8, batch_tile=64, products="f32"):
    """`admm_u_only_reference` as it was before delta products, kept here to
    hold refresh_every = 1 to it bit for bit."""
    main, six = ((torch.matmul, torch.matmul) if products == "f32"
                 else (tf32x3_matmul, tf32x6_matmul))
    chunk_len, n_chunks, n_tail = _schedule(n_iters, refresh_every, polish_iters, stop_tol,
                                            check_every)
    batch, Nm = u_base.shape
    n_tiles = batch // batch_tile
    ub = u_base.reshape(n_tiles, batch_tile, Nm)
    one_minus_alpha = 1.0 - alpha

    def step(z, lam, matmul):
        s = z - lam
        u = ub + matmul(s, W_u)
        if alpha == 1.0:
            v = u + lam
            z_new = torch.minimum(torch.maximum(v, lo), hi)
            return z_new, v - z_new, s, u
        z_rel = alpha * u + one_minus_alpha * z
        z_new = torch.minimum(torch.maximum(z_rel + lam, lo), hi)
        return z_new, lam + u - z_new, s, u

    with full_f32_matmul():
        z, lam, s, u = ub, torch.zeros_like(ub), ub, ub
        active = None
        for _ in range(n_chunks):
            for i in range(chunk_len):
                test = stop_tol > 0.0 and i == chunk_len - 1
                new = step(z, lam, six if test else main)
                if active is None:
                    z, lam, s, u = new
                else:
                    keep = active[:, None, None]
                    z, lam, s, u = (torch.where(keep, a, b) for a, b in zip(new, (z, lam, s, u)))
            if stop_tol > 0.0:
                running = torch.amax(torch.abs(u - z), dim=(1, 2)) >= stop_tol
                active = running if active is None else active & running
                if not bool(active.any()):
                    break
        for _ in range(n_tail):
            z, lam, s, u = step(z, lam, six)
        x = x_base.reshape(n_tiles, batch_tile, -1) + main(s, W_x)
    return x.reshape(batch, -1), u.reshape(batch, Nm), z.reshape(batch, Nm)


@pytest.mark.parametrize("products", ["f32", "tf32x3"])
@pytest.mark.parametrize("extra", [{}, dict(alpha=1.6), dict(stop_tol=1e-5, check_every=4)])
def test_refresh_every_1_is_the_previous_loop_bit_for_bit(products, extra):
    A, B, cost, x0s = chip_smoke.bench_problem("cpu", horizon=40, batch=64)
    solver = make_fused_lqt_admm(A, B, cost, u_lower=-4.0, u_upper=4.0, rho_u=0.1, n_iters=60,
                                 batch_tile=16, device="cpu", **extra)
    inputs = solver.kernel_inputs(x0s)
    got = admm_u_only_reference(*inputs, **solver.kernel_options, products=products)
    want = _previous_loop(*inputs, **solver.kernel_options, products=products)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("batch_tile,Nm", [(32, 512), (16, 520), (32, 98), (16, 1024)])
def test_wide_pieces_and_k_chunks_cover_the_products(batch_tile, Nm):
    """The wide route's two products replayed in f64 from
    `pack_u_only_operators`' storage as its warps take them: warp w's pairs
    of W_u's n-tiles (`wide_pieces`) over all the tile's rows, each k range
    in chunks of WIDE_K_CHUNK k-steps added to the total; then W_x's pairs
    dealt to the warps in turn. Every output is covered once and the sums
    are s W_u and s W_x."""
    rng = np.random.default_rng(Nm)
    Nd = 2 * Nm
    W_u, W_x = rng.normal(size=(Nm, Nm)), rng.normal(size=(Nm, Nd))
    W_u[:, :8] = 0.0  # an all-zero pair's columns keep klo = khi = 0
    W_u[:16, 8:24] = 0.0  # a pair whose k range starts late
    ops, table = (t.numpy() for t in pack_u_only_operators(torch.tensor(W_u), torch.tensor(W_x)))
    s = np.zeros((batch_tile, -(-Nm // 8) * 8))
    s[:, :Nm] = rng.normal(size=(batch_tile, Nm))
    pieces = wide_pieces(batch_tile, Nm)
    warps = len(pieces)
    assert 32 * warps == wide_launch_geometry(batch_tile, Nm)[0]
    n_pairs_u = -(-Nm // 16)
    x_plan = [[n_pairs_u + px for px in range(w, -(-Nd // 16), warps)] for w in range(warps)]
    for cols, W, plan in ((Nm, W_u, pieces), (Nd, W_x, x_plan)):
        out = np.zeros((batch_tile, -(-cols // 8) * 8))
        seen = np.zeros(out.shape, dtype=int)
        for rows in plan:
            for row in rows:
                off, klo, khi, nb = table[row]
                n0 = 2 * (row - (n_pairs_u if W is W_x else 0))
                for k0 in range(klo, khi, WIDE_K_CHUNK):
                    part = np.zeros((batch_tile, 8 * nb))
                    for kk in range(k0, min(k0 + WIDE_K_CHUNK, khi)):
                        for n in range(nb):
                            block = _block(ops, off + (kk - klo) * 64 * nb, nb, n)
                            part[:, 8 * n:8 * n + 8] += s[:, 8 * kk:8 * kk + 8] @ block
                    out[:, 8 * n0:8 * (n0 + nb)] += part
                seen[:, 8 * n0:8 * (n0 + nb)] += 1
        assert (seen == 1).all()
        np.testing.assert_allclose(out[:, :cols], s[:, :Nm] @ W, rtol=0, atol=1e-10)


def test_wide_geometry_and_route_choice():
    """The wide route takes 32 instances a block up to Nm = 512 and 16 up to
    1,024: two s buffers, lambda and the bounds in shared memory (200,704
    bytes at the bench's width); `u_only_route` sends a launch to the
    narrow kernel where W_u fits, to the wide one where it does not, and
    raises where neither takes it; `default_u_tile` picks the tile."""
    assert wide_launch_geometry(32, 512) == (512, 200704)
    assert wide_launch_geometry(16, 1024) == (512, 4 * (2 * 8 * 16 * 128 + 16 * 16 * 64 + 16 * 128))
    assert wide_launch_geometry(32, 100)[0] == 32 * 4
    with pytest.raises(ValueError, match="Nm <= 512"):
        wide_launch_geometry(32, 520)
    with pytest.raises(ValueError, match="16 or 32"):
        wide_launch_geometry(64, 512)
    n1 = 13
    assert launch_geometry(64, 100, delta=True)[1] == 4 * (64 * n1 * n1 + 3 * 8 * 64 * n1 + 16 * n1)
    assert u_only_route(64, 100) == u_only_route(64, 100, refresh_every=8) == "narrow"
    assert u_only_route(32, 512) == u_only_route(16, 512, refresh_every=8) == "wide"
    assert u_only_route(16, 224) == "narrow" and u_only_route(16, 224, refresh_every=8) == "wide"
    with pytest.raises(ValueError, match="no u-only kernel"):
        u_only_route(64, 512)
    assert default_u_tile(100) == default_u_tile(100, refresh_every=8) == 64
    assert default_u_tile(200) == 32 and default_u_tile(200, refresh_every=8) == 16
    assert default_u_tile(512, refresh_every=8) == 32 and default_u_tile(1024) == 16
    with pytest.raises(ValueError, match="no u-only kernel"):
        default_u_tile(1040)


@pytest.mark.parametrize("Nm,routes,tiles", [
    (100, ("narrow", "narrow", "narrow"), (64, 64)),
    (224, ("narrow", "wide", None), (16, 32)),
    (225, ("wide", "wide", None), (32, 32)),
    (512, ("wide", "wide", None), (32, 32)),
    (516, ("wide", None, None), (16, 16)),
    (1024, ("wide", None, None), (16, 16)),
    (1025, (None, None, None), None),
])
def test_route_choice_at_the_edges_of_each_route(Nm, routes, tiles):
    """`u_only_route` for tiles 16, 32 and 64 (None where it raises) and
    `default_u_tile` with refresh_every 1 and 8, at the narrow kernel's
    last width, the wide route's first, the bench's, a padded width and
    the wide route's last and first refused."""
    for tile, want in zip((16, 32, 64), routes):
        if want is None:
            with pytest.raises(ValueError, match="no u-only kernel"):
                u_only_route(tile, Nm)
        else:
            assert u_only_route(tile, Nm) == want
    if tiles is None:
        with pytest.raises(ValueError, match="no u-only kernel"):
            default_u_tile(Nm)
    else:
        assert (default_u_tile(Nm), default_u_tile(Nm, refresh_every=8)) == tiles


@pytest.mark.parametrize("batch_tile", [16, 32])
def test_wide_geometry_fits_at_every_width_it_takes(batch_tile):
    """At every Nm from 1 to 1,024 the wide route either raises or gives
    whole warps, at most 16, and shared memory within a block's limit that
    grows with Nm; it takes every Nm up to 512 at tile 32 and up to 1,024
    at tile 16, and none past."""
    last, taken = 0, []
    for Nm in range(1, 1025):
        try:
            threads, smem = wide_launch_geometry(batch_tile, Nm)
        except ValueError:
            continue
        taken.append(Nm)
        assert threads % 32 == 0 and 32 <= threads <= 32 * 16
        assert threads == 32 * len(wide_pieces(batch_tile, Nm))
        assert last <= smem <= fused_admm._MAX_SMEM and smem % 16 == 0
        last = smem
    assert taken == list(range(1, {16: 1024, 32: 512}[batch_tile] + 1))


def test_wide_ptxas_reads_each_builds_registers_and_spills():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z23admm_u_only_wide_kernelILi2ELb0ELb1EEv7Problem'"
        " for 'sm_90a'",
        "ptxas info    : Function properties for _Z23admm_u_only_wide_kernelILi2ELb0ELb1EEv7Problem",
        "    72 bytes stack frame, 72 bytes spill stores, 72 bytes spill loads",
        "ptxas info    : Used 128 registers, used 0 barriers, 72 bytes cumulative stack size",
        "ptxas info    : Compiling entry function '_Z23admm_u_only_wide_kernelILi1ELb1ELb0EEv7Problem'"
        " for 'sm_90a'",
        "ptxas info    : Function properties for _Z23admm_u_only_wide_kernelILi1ELb1ELb0EEv7Problem",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 104 registers, used 1 barriers",
    ])
    got = chip_smoke.wide_ptxas(log)
    assert set(got) == {(32, 0, 1), (16, 1, 0)}
    assert got[(32, 0, 1)] == ("72 bytes stack frame, 72 bytes spill stores, 72 bytes spill loads; "
                               "Used 128 registers, used 0 barriers, 72 bytes cumulative stack size")
    assert got[(16, 1, 0)].endswith("Used 104 registers, used 1 barriers")


def test_wide_solver_defaults_to_the_wide_tile_and_runs_plain_on_cpu():
    problem = chip_smoke.wide_problem("cpu", batch=64)
    solver = chip_smoke.wide_solver("cpu", problem)
    kw = solver.kernel_options
    assert kw["batch_tile"] == 32 and kw["refresh_every"] == chip_smoke.WIDE_REFRESH
    inputs = solver.kernel_inputs(problem[3])
    before = (fused_admm.launch_count, fused_admm.wide_launch_count)
    got = admm_u_only(*inputs, solver.packed, **kw)
    assert (fused_admm.launch_count, fused_admm.wide_launch_count) == before
    want = admm_u_only_reference(*inputs, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    x, u, z_x, z_u = solver(problem[3])
    assert z_x is x and max_violation(z_u, -5.0, 5.0) == 0.0 and converged_frac(u, z_u) == 1.0
