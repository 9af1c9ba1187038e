"""Port vs JAX package: the robust SLS kernel at every width and consensus
shape its Pallas kernel takes (`ops/fused_sls.py`).

Two routes carry `_sls_admm_kernel`'s loop on the card: `csrc/sls_admm.cu`
stages W in shared memory (to Nm = 224 at p1 = 2), `csrc/sls_admm_wide.cu`
streams it from L2 past that (`sls_route`, chosen at build). Both take the
consensus z-update at any shape to CONSENSUS_MAX (a general build beside
the two compiled ones). Here, on the CPU:

- the port's plain version `sls_admm_reference` past the narrow edge (N =
  240) and at the general consensus shapes, fed the JAX package's own f32
  operators, against `make_pallas_sls_admm(interpret=True)`, so that only
  the loop is compared;
- the wide kernel's layout (`pack_sls_wide`'s A fragments, the B columns
  of `sls_wide_column`, the m64nNk8 accumulator layout) replayed in numpy
  against the dense product, at every tile's edges;
- the routes' limits, and the refusals at build on CUDA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu.ops.lifted import build_Su, build_Sx
from ilqr_admm_tpu.ops.pallas_sls import make_pallas_sls_admm
from ilqr_admm_tpu.solvers.lqt import block_diag_stacked, broadcast_rho
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.ops import fused_sls
from ilqr_admm_tpu_torch.ops.fused_admm import pair_pack
from ilqr_admm_tpu_torch.ops.fused_sls import (
    CONSENSUS_MAX,
    CONSENSUS_SHAPES,
    general_z_update,
    kernel_z_update,
    launch_geometry,
    make_fused_sls_admm,
    pack_sls_wide,
    sls_admm,
    sls_admm_reference,
    sls_route,
    sls_wide_column,
    sls_wide_columns,
    sls_wide_edge,
    sls_wide_k_steps,
    sls_wide_launch_geometry,
    sls_wide_smem,
    sls_wide_tiles,
)

torch.set_num_threads(2)

F32 = torch.float32
C_COEF = chip_smoke.C_COEF
DIAMOND = dict(z_update="diamond", diamond_w=(1.0, C_COEF))
CONSENSUS = dict(n_cons_iters=chip_smoke.SLS_CONS_ITERS, cons_rho=chip_smoke.SLS_CONS_RHO)


def _jax_problem(N, nb_dim=1):
    """chip_smoke.via_point_problem's plant and cost in the JAX package, f32."""
    plant = DoubleIntegrator(nb_dim, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray(chip_smoke.TARGETS[nb_dim])]).astype(jnp.float32)
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3]).astype(jnp.float32)
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)
    return A.astype(jnp.float32), B.astype(jnp.float32), cost


def _jax_operators(A, B, cost, p, rho_u):
    """(U_base (p1, Nm), W (Nm, Nm)) as `make_pallas_sls_admm` forms them
    (pallas_sls.py:367-388): the same f32 ops at matmul precision highest."""
    N, m = A.shape[0], B.shape[-1]
    with jax.default_matmul_precision("highest"):
        Su = build_Su(A, B)
        Sx = build_Sx(A, p).reshape(-1, p)
        Rr_l = block_diag_stacked(broadcast_rho(rho_u, m, N, jnp.float32))
        SuTQ = Su.T @ block_diag_stacked(cost.Q).astype(jnp.float32)
        l_side = SuTQ @ Su + block_diag_stacked(cost.R).astype(jnp.float32) + Rr_l
        l_inv = jnp.linalg.inv(l_side)
        r_base = jnp.concatenate([(SuTQ @ cost.lifted_xd().astype(jnp.float32))[:, None],
                                  -SuTQ @ Sx], axis=-1)
        return np.asarray((l_inv @ r_base).T), np.asarray((l_inv @ Rr_l).T)


def _loop_against_pallas(N, nb_dim, sets, kw, batch=8, seed=0, sort=False):
    """(U of the port's f32 plain loop on JAX's operators, U of the
    interpret-mode Pallas kernel), both (batch, Nm, p1)."""
    A, B, cost = _jax_problem(N, nb_dim)
    p1 = kw["robust_dim"] + 1
    bounds = np.random.default_rng(seed).uniform(2.0, 4.0, batch).astype(np.float32)
    if sort:
        bounds = np.sort(bounds)
    _, _, U_p = make_pallas_sls_admm(A, B, cost, *sets, rho_u=1.0, interpret=True, **kw)(
        jnp.asarray(bounds))
    U_base, W = _jax_operators(A, B, cost, kw["robust_dim"], 1.0)
    opts = {k: v for k, v in kw.items() if k != "robust_dim"}
    if kw.get("z_update") != "diamond":
        soc_A = tuple(np.asarray(a, np.float64) for a in sets[0])
        lc = np.eye(p1) + opts["cons_rho"] * sum(a.T @ a for a in soc_A)
        opts.update(soc_A=soc_A, soc_b_fixed=tuple(np.asarray(b, np.float64) for b in sets[1]),
                    soc_b_bound=tuple(np.asarray(b, np.float64) for b in sets[2]),
                    l_inv_cons=np.linalg.inv(lc))
    U_t = sls_admm_reference(torch.tensor(bounds), torch.tensor(U_base), torch.tensor(W), **opts)
    return U_t.numpy(), np.asarray(U_p)


def _err(U_t, U_p):
    """max |dU| over max(1, max |U|): both loops in f32 on the same
    operators, apart only by their products' order of sums."""
    return np.abs(U_t - U_p).max() / max(1.0, np.abs(U_p).max())


# Past the narrow kernel's edge (N = 240: Nm = 240 at p1 = 2), 60
# iterations, the bench's options. Tolerance 1e-4 x max(1, max|U|): the
# same f32 loop on the same operators, apart only by the products' order
# of sums through 60 iterations of an operator with entries to ~1 (the
# three cases read 1.4e-6-4.4e-6).
WIDE_CASES = {
    "diamond": (((), (), ()), dict(DIAMOND, n_iters=60)),
    "diamond-early-exit": (((), (), ()), dict(DIAMOND, n_iters=60, stop_tol=3e-3,
                                              check_every=8)),
    "consensus": (chip_smoke.soc_sets(), dict(CONSENSUS, n_iters=60)),
}


@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_loop_past_the_narrow_edge_matches_interpret_pallas(case):
    sets, kw = WIDE_CASES[case]
    N = 240
    assert sls_route(8, N, 2) == "wide"
    U_t, U_p = _loop_against_pallas(N, 1, sets, dict(kw, robust_dim=1, batch_tile=8),
                                    sort="early" in case)
    assert U_t.shape == U_p.shape == (8, N, 2)
    assert _err(U_t, U_p) <= 1e-4


# The general consensus shapes (p1, n_sets, q) at N = 20, the chance sets
# of chip_smoke.chance_sets (p1 = 4: the planar double integrator, d = 4),
# 60 iterations, 1e-4 x max(1, max|U|) as above. The Pallas kernel takes
# no robust_dim = 0 (its setup divides by p), so p1 >= 2.
GENERAL_SHAPES = [(2, 1, 3), (4, 2, 5), (3, 3, 4), (2, 4, 9)]


@pytest.mark.parametrize("shape", GENERAL_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_general_consensus_shapes_match_interpret_pallas(shape):
    p1, n_sets, q = shape
    assert shape not in CONSENSUS_SHAPES
    sets = chip_smoke.chance_sets(*shape)
    assert general_z_update(p1, "consensus", sets[0])
    assert kernel_z_update(p1, "consensus", None, *sets, np.eye(p1), 10.0)[2:] == (n_sets, q)
    kw = dict(CONSENSUS, n_iters=60, robust_dim=p1 - 1, batch_tile=4)
    U_t, U_p = _loop_against_pallas(20, 1 if p1 <= 3 else 2, sets, kw, seed=p1 + n_sets)
    assert np.isfinite(U_t).all() and U_t.shape == U_p.shape
    assert _err(U_t, U_p) <= 1e-4
    # the sets bind: instances with other bounds end apart
    assert np.ptp(U_p, axis=0).max() > 1e-3


def test_general_shape_fleet_matches_interpret_pallas():
    """The factory at a general shape on the CPU (its f64 setup cast to
    f32) against the Pallas kernel's own f32 setup: the 1e-3 relative of
    test_torch_fused_sls.py::CASES, which covers the two setups' gap."""
    A, B, cost = _jax_problem(20)
    sets = chip_smoke.chance_sets(*chip_smoke.SLS_GENERAL_SHAPE)
    kw = dict(CONSENSUS, n_iters=60, robust_dim=2, batch_tile=4, rho_u=1.0)
    bounds = np.random.default_rng(5).uniform(2.0, 4.0, 8).astype(np.float32)
    _, _, U_p = make_pallas_sls_admm(A, B, cost, *sets, interpret=True, **kw)(jnp.asarray(bounds))
    (tA, tB, tcost), solver = chip_smoke.sls_general_solver(
        "cpu", horizon=20, n_iters=60, batch_tile=4, n_cons_iters=kw["n_cons_iters"])
    assert solver.route is None and solver.kernel_options["soc_A"][0].shape == (4, 3)
    _, _, U_t = solver(torch.tensor(bounds))
    U_p = np.asarray(U_p)
    assert np.abs(U_t.numpy() - U_p).max() / np.abs(U_p).max() < 1e-3


# ---- the wide kernel's layout, replayed ----------------------------------


def _accumulator_element(e, w, g, t):
    """(row of the M tile, B column) of accumulator element e of thread 32 w
    + 4 g + t in a warpgroup (`acc_row`, `acc_col` of csrc/sls_admm_wide.cu)."""
    return 16 * w + g + 8 * ((e >> 1) & 1), 8 * (e >> 2) + 2 * t + (e & 1)


def _b_index(k, n, N):
    """Float offset of B's (k, n) in shared memory (`b_index<N>`)."""
    return (((k >> 2) * (N // 8) + (n >> 3)) << 5) + ((n & 7) << 2) + (k & 3)


def _replay(W, s, batch_tile, p1):
    """s (batch_tile, p1, Nm) times W as csrc/sls_admm_wide.cu computes it,
    in f64: A fragments from `pack_sls_wide`, B laid out by
    `sls_wide_column` and `b_index`, read back by k-step as the descriptor
    strides (LBO 16 N bytes, SBO 128) walk it, the products tile by tile
    and k-step by k-step, and each accumulator element written back to the
    (instance, slab, column) the kernel's epilogue reads it as."""
    Nm = W.shape[0]
    H, N = -(-p1 // 2), sls_wide_columns(batch_tile, p1)
    n_tiles, nk = sls_wide_tiles(Nm), sls_wide_k_steps(Nm)
    ops_f, ops_i = pack_sls_wide(W)
    assert ops_i.tolist() == [n_tiles, nk]
    frags = ops_f.numpy().reshape(n_tiles, nk, 4, 8, 4, 4)  # tile, step, w, g, t, value
    # B in shared memory, one k-step at a time through the descriptor
    smem = np.zeros(N * 8 * nk)
    for b in range(batch_tile):
        for k in range(p1):
            for c in range(Nm):
                smem[_b_index(c, sls_wide_column(b, k, p1), N)] = s[b, k, c]
    out = np.full((batch_tile, p1, Nm), np.nan)
    for tile in range(n_tiles):
        acc = np.zeros((64, N))
        for step in range(nk):
            a = np.zeros((64, 8))
            for w in range(4):
                for g in range(8):
                    for t in range(4):
                        v = frags[tile, step, w, g, t]
                        r = 16 * w + g
                        a[r, t], a[r + 8, t], a[r, t + 4], a[r + 8, t + 4] = v
            base = 8 * N * step  # the k-step's offset in floats: 32 N bytes a k-step
            bk = np.zeros((8, N))
            for kk in range(8):
                for n in range(N):
                    # core matrix (kk // 4, n // 8): LBO 16 N bytes, SBO 128
                    off = base + (kk // 4) * 4 * N + (n // 8) * 32 + (n % 8) * 4 + kk % 4
                    bk[kk, n] = smem[off]
            acc += a @ bk
        for w in range(4):
            for g in range(8):
                for t in range(4):
                    for e in range(N // 2):
                        row, col = _accumulator_element(e, w, g, t)
                        i, pair = divmod(e >> 2, H)
                        k = 2 * pair + (e & 1)
                        assert col == sls_wide_column(4 * i + t, k, p1)
                        c = 64 * tile + row
                        if c < Nm and k < p1:
                            out[4 * i + t, k, c] = acc[row, col]
                        elif k >= p1:
                            assert acc[row, col] == 0.0  # the zero slab
    return out


@pytest.mark.parametrize("Nm,batch_tile,p1", [(72, 8, 2), (136, 16, 2), (100, 8, 3),
                                              (40, 8, 5), (24, 8, 8)])
def test_wide_layout_replays_the_dense_product(Nm, batch_tile, p1):
    """The replay equals s W to 1e-12 in f64 at widths that cut M tiles and
    k-steps short (Nm = 72: a second tile of 8 rows, K padded from 72 to 80;
    136: three tiles, tile 16; 100 at p1 = 3: a zero slab; p1 = 5 and 8:
    three and four slab pairs, N = 48 and 64), every element once."""
    rng = np.random.default_rng(Nm)
    W = torch.tensor(rng.normal(size=(Nm, Nm)))
    s = rng.normal(size=(batch_tile, p1, Nm))
    out = _replay(W, s, batch_tile, p1)
    want = np.einsum("bkc,cd->bkd", s, W.numpy())
    assert not np.isnan(out).any()
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("p1", [2, 3, 4, 7, 8])
@pytest.mark.parametrize("batch_tile", [8, 16])
def test_wide_columns_hold_every_slab_of_an_instance_in_a_thread(batch_tile, p1):
    """`sls_wide_column` is a one-to-one map of (instance, slab) into N =
    2 batch_tile ceil(p1 / 2) columns, and in the m64nNk8 accumulator layout
    (a thread of quad lane t holds columns 8 j + 2 t, 8 j + 2 t + 1) every
    slab of an instance sits in one thread; the columns it leaves free are
    an odd p1's zero slab."""
    N = sls_wide_columns(batch_tile, p1)
    cols = {sls_wide_column(b, k, p1): (b, k) for b in range(batch_tile) for k in range(p1)}
    assert len(cols) == batch_tile * p1 and max(cols) < N
    assert N - len(cols) == (batch_tile if p1 % 2 else 0)
    for t in range(4):
        held = {cols[c] for c in range(N) if c % 8 // 2 == t and c in cols}
        assert {b for b, _ in held} == set(range(t, batch_tile, 4))
        for b in range(t, batch_tile, 4):
            assert {k for bb, k in held if bb == b} == set(range(p1))


def test_pack_sls_wide_holds_w_transposed():
    """The packed fragments are W^T, zero-padded to whole 64-row tiles and
    16-column k-step pairs; the CPU wrapper takes them on route="wide" and
    runs the plain version, bit for bit the narrow route's."""
    Nm = 90
    W = torch.randn(Nm, Nm, generator=torch.Generator().manual_seed(0))
    ops_f, ops_i = pack_sls_wide(W)
    assert ops_i.dtype == torch.int32 and ops_i.tolist() == [2, 12]
    assert ops_f.numel() == 2 * 12 * 512 and ops_f.dtype == W.dtype
    frags = ops_f.reshape(2, 12, 4, 8, 4, 4)
    # thread (w, g, t)'s first value is W^T[16 w + g, t] of the k-step
    assert float(frags[1, 3, 1, 2, 3, 0]) == float(W.T[64 + 18, 8 * 3 + 3])
    assert float(frags[1, 11, 3, 7, 3, 3]) == 0.0  # row 127, column 95: padding
    U_base, bounds = torch.randn(2, Nm), torch.full((8,), 2.0)
    kw = dict(n_iters=7, batch_tile=8, **DIAMOND)
    want = sls_admm(bounds, U_base, W.float(), pair_pack(W.float()), **kw)
    got = sls_admm(bounds, U_base, W.float(), pack_sls_wide(W.float()), **kw, route="wide")
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="pack_sls_wide"):
        sls_admm(bounds, U_base, W.float(), pair_pack(W.float()), **kw, route="wide")
    with pytest.raises(ValueError, match="route"):
        sls_admm(bounds, U_base, W.float(), pair_pack(W.float()), **kw, route="middle")


# ---- the routes' limits ----------------------------------------------------


@pytest.mark.parametrize("batch_tile,Nm,p1,general,want", [
    (8, 100, 2, False, "narrow"),  # the bench
    (8, 224, 2, False, "narrow"),  # the narrow edge: W 200,704 B + s
    (8, 232, 2, False, "wide"),
    (16, 100, 2, False, "narrow"),
    (16, 136, 2, False, "wide"),  # 18 warps of pieces: 16 at most
    (8, 208, 3, False, "narrow"),
    (8, 216, 3, False, "wide"),
    (8, 400, 2, False, "wide"),  # the wide fleet
    (8, 1024, 2, False, "wide"),  # the edge the route was asked for
    (8, 1552, 2, False, "wide"),  # where shared memory ends
    (8, 1553, 2, False, None),
    (8, 1536, 2, True, "wide"),  # the general z-update's constants take 2,848 B
    (8, 1537, 2, True, None),
    (8, 768, 3, False, "wide"),
    (8, 769, 3, False, None),
    (16, 768, 2, False, "wide"),
    (16, 769, 2, False, None),
    (16, 400, 5, True, None),  # tile 16 takes p1 <= 4 (N <= 64)
    (16, 100, 3, True, None),  # the general build takes tile 8 only
    (16, 300, 2, True, None),
    (8, 384, 8, True, "wide"),
    (8, 385, 8, True, None),
    (4, 100, 2, False, None),
])
def test_route_at_the_edges_of_both_kernels(batch_tile, Nm, p1, general, want):
    """`sls_route` at the edges of the narrow kernel (`launch_geometry`) and
    of the wide one (`sls_wide_launch_geometry`, `sls_wide_edge`); a launch
    neither takes raises with both kernels' reasons."""
    if want is None:
        with pytest.raises(ValueError, match="no SLS kernel takes this launch.*wide kernel"):
            sls_route(batch_tile, Nm, p1, general)
        return
    assert sls_route(batch_tile, Nm, p1, general) == want
    if want == "wide":
        threads, smem = sls_wide_launch_geometry(batch_tile, Nm, p1, general)
        assert threads == 512 and smem == sls_wide_smem(batch_tile, Nm, p1)
        assert Nm <= sls_wide_edge(batch_tile, p1, general)


def test_wide_geometry_counts_its_shared_memory():
    """s hi and lo (2 N K floats, K = Nm padded to 16) and four rings of 4
    k-steps of 2 KB: 111,360 B at the wide fleet (Nm = 400, tile 8)."""
    assert sls_wide_launch_geometry(8, 400, 2) == (512, 4 * 2 * 16 * 400 + 32768)
    assert sls_wide_smem(8, 1024, 2) == 4 * 2 * 16 * 1024 + 32768
    assert sls_wide_smem(8, 401, 3) == 4 * 2 * 32 * 416 + 32768
    assert [sls_wide_edge(8, p1) for p1 in (2, 3, 4, 5, 6, 7, 8)] == [1552, 768, 768, 512, 512,
                                                                       384, 384]
    for kw, msg in ((dict(batch_tile=32, Nm=400, p1=2), "8 or 16"),
                    (dict(batch_tile=8, Nm=400, p1=1), "2 <= p1 <= 8"),
                    (dict(batch_tile=8, Nm=400, p1=9), "2 <= p1 <= 8"),
                    (dict(batch_tile=16, Nm=100, p1=6), "at most 64")):
        with pytest.raises(ValueError, match=msg):
            sls_wide_launch_geometry(**kw)


def test_narrow_fleets_keep_their_route_and_geometry():
    """Every fleet the narrow kernel took before the wide route existed
    stays with it, with the same block (chip_smoke's SLS cases: the bench
    at tiles 8 and 16, Nm = 98, p1 = 3), and a compiled consensus shape
    runs no general build (its shared memory unchanged)."""
    for tile, Nm, p1 in ((8, 100, 2), (16, 100, 2), (8, 98, 2), (16, 98, 2), (8, 100, 3)):
        assert sls_route(tile, Nm, p1) == "narrow"
        assert launch_geometry(tile, Nm, p1) == launch_geometry(tile, Nm, p1, general=False)
    assert launch_geometry(8, 100, 2) == (224, 4 * (64 * 13 * 13 + 2 * 16 * 8 * 13))
    for shape in CONSENSUS_SHAPES:
        p1, n_sets, q = shape
        assert not general_z_update(p1, "consensus", [np.zeros((q, p1))] * n_sets)
    assert not general_z_update(2, "diamond", ())
    _, solver = chip_smoke.sls_solver("cpu", "diamond_ee")
    assert solver.route is None and torch.equal(solver.packed[0], pair_pack(solver.W)[0])


def test_plain_version_counts_each_tiles_iterations():
    """`sls_admm_reference(stats=...)` counts the iterations each tile ran,
    as `chip_smoke.sls_tile_iterations` finds them by cutting the schedule:
    slack tiles (bounds past the unconstrained |du|) leave at an early
    test, bound ones run on; the fixed schedule runs n_iters everywhere."""
    _, solver = chip_smoke.sls_solver("cpu", "diamond_ee", horizon=40, n_iters=96,
                                      check_every=8)
    bounds = chip_smoke.sls_bounds("cpu", batch=32, seed=6, sort=True, hi=40.0)
    kw = solver.kernel_options
    ops = (bounds, solver.U_base, solver.W)
    stats = {}
    sls_admm_reference(*ops, **kw, stats=stats)
    want = chip_smoke.sls_tile_iterations(lambda **o: sls_admm_reference(*ops, **o), kw, 32)
    assert torch.equal(stats["tile_iterations"], want)
    assert int(want.min()) < 96 and int(want.max()) == 96
    sls_admm_reference(*ops, **dict(kw, stop_tol=0.0), stats=stats)
    assert stats["tile_iterations"].tolist() == [96] * 4


def test_consensus_limits():
    """Every shape to CONSENSUS_MAX packs for the kernels; past it, or a
    cone of one row, raises."""
    max_p1, max_sets, max_q = CONSENSUS_MAX
    assert CONSENSUS_MAX == (8, 4, 9)
    sets = chip_smoke.chance_sets(max_p1, max_sets, max_q)
    mode, coeffs, n_sets, q = kernel_z_update(max_p1, "consensus", None, *sets, np.eye(max_p1),
                                              10.0)
    assert (mode, n_sets, q) == (1, max_sets, max_q)
    assert coeffs.size == fused_sls._MAX_COEFFS
    for shape in ((9, 1, 3), (2, 5, 3), (2, 1, 10), (2, 1, 1)):
        sets = chip_smoke.chance_sets(*shape) if shape[2] > 1 else (
            [np.zeros((1, 2))], [np.zeros(1)], [np.zeros(1)])
        with pytest.raises(ValueError, match="not built for"):
            kernel_z_update(shape[0], "consensus", None, *sets, np.eye(shape[0]), 10.0)


# ---- refusals at build on CUDA ---------------------------------------------


def _raise_without_a_card(monkeypatch):
    """Let the factory take a CUDA device on a host without a card, so that
    a refusal at build shows before anything reaches CUDA."""
    monkeypatch.setattr(fused_sls, "resolve_device", lambda device=None: torch.device("cuda"))


# (plant's nb_dim, horizon, z-update options, the message): the 1-D bench
# fleet past the wide edge (Nm = 1,560; its setup on the CPU takes minutes,
# so only the refusal is checked there), robust_dim 2 past its edge at p1
# = 3 (768), a tile of 32, a consensus shape of five sets
REFUSED = {
    "past-the-wide-edge": (1, 1560, dict(DIAMOND), r"no SLS kernel.*Nm <= 1552"),
    "p1-3-past-its-edge": (1, 776, dict(CONSENSUS, robust_dim=2, sets=(3, 2, 4)),
                           r"no SLS kernel.*Nm <= 768 at this tile"),
    "tile-32": (1, 400, dict(DIAMOND, batch_tile=32), r"no SLS kernel takes this launch"),
    "five-sets": (1, 20, dict(CONSENSUS, robust_dim=2, sets=(3, 5, 4)),
                  r"not built for \(p1, n_sets, q\) = \(3, 5, 4\)"),
}


def _refused_fleet(device, case):
    nb_dim, horizon, kw, _ = REFUSED[case]
    kw = dict(kw)
    sets = chip_smoke.chance_sets(*kw.pop("sets")) if "sets" in kw else ((), (), ())
    A, B, cost, _ = chip_smoke.via_point_problem("cpu", nb_dim, horizon, batch=1)
    return make_fused_sls_admm(A, B, cost, *sets, rho_u=1.0, n_iters=2, device=device, **kw)


@pytest.mark.parametrize("case", list(REFUSED))
def test_a_fleet_no_kernel_takes_raises_at_build_on_cuda(monkeypatch, case):
    """A fleet past every edge raises ValueError when it is built for the
    card, not at its first call; on the CPU the same fleet builds, with
    route None, and runs the plain version (but at Nm = 1,560)."""
    if case != "past-the-wide-edge":
        solver = _refused_fleet("cpu", case)
        assert solver.route is None
        _, _, U = solver(chip_smoke.sls_bounds("cpu", batch=solver.kernel_options["batch_tile"]))
        assert bool(torch.isfinite(U).all())
    _raise_without_a_card(monkeypatch)
    with pytest.raises(ValueError, match=REFUSED[case][3]):
        _refused_fleet("cuda", case)


def test_robust_dim_zero_is_refused():
    """The JAX kernel's setup takes no robust_dim = 0; nor does the port."""
    A, B, cost, _ = chip_smoke.bench_problem("cpu", horizon=10, batch=1)
    with pytest.raises(ValueError, match="robust_dim must be >= 1"):
        make_fused_sls_admm(A, B, cost, [np.zeros((2, 1))], [np.zeros(2)], [np.zeros(2)],
                            rho_u=1.0, robust_dim=0, device="cpu")
    with pytest.raises(ZeroDivisionError):
        make_pallas_sls_admm(*_jax_problem(10), [np.zeros((2, 1))], [np.zeros(2)],
                             [np.zeros(2)], rho_u=1.0, robust_dim=0, interpret=True)
