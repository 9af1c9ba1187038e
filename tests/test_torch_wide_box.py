"""Port vs JAX package: the state-bounded path of `make_fused_lqt_admm` past
the narrow kernel's Nm = 128, on the wide route `csrc/admm_box_wide.cu`.

The planar double integrator of the examples (`DoubleIntegrator(2, 2,
dt=1/N)`, N = 100: Nm = 200, Nd = 400) with the bench's cost to (1, 1),
|u| <= 5 and |v_x|, |v_y| <= 1.3. The JAX side runs the Pallas kernel
`_admm_kernel` in interpret mode (bf16x3 products) or the XLA fleet
`make_batched_lqt_admm`; the port runs on CPU tensors, where `admm_box`
takes its plain version `admm_box_reference` on either route. Also: the
route and geometry at the edges of both kernels, the wide route's packed
tables and warp pieces replayed in numpy, the build-time refusal on a
CUDA device, and the narrow route's fleets unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu.ops.pallas_admm import make_pallas_lqt_admm
from ilqr_admm_tpu.projections import project_bound
from ilqr_admm_tpu.solvers.batched import make_batched_lqt_admm
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.convert import dynamics_from_numpy, quadcost_from_numpy
from ilqr_admm_tpu_torch.ops import fused_admm
from ilqr_admm_tpu_torch.ops.fused_admm import (
    admm_box,
    admm_box_reference,
    box_launch_geometry,
    box_route,
    box_schedule,
    box_wide_launch_geometry,
    default_box_tile,
    make_fused_lqt_admm,
    pack_box_operators,
    pair_pack,
)
from ilqr_admm_tpu_torch.utils.certify import certify_state_box, state_box_gate_failures
from test_torch_fused_admm_box import _block

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64
N = 100


def _planar(N=N, nb_dim=2, target=chip_smoke.PLANAR_TARGET):
    """The planar fleet's problem in JAX (f32 data) and its port twin in
    `dtype`: (A, B, cost), port(dtype) -> (tA, tB, tcost)."""
    plant = DoubleIntegrator(nb_dim, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray(target)]).astype(jnp.float32)
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3]).astype(jnp.float32)
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)
    A, B = A.astype(jnp.float32), B.astype(jnp.float32)

    def port(dtype=F32):
        tA, tB = dynamics_from_numpy(np.asarray(A), np.asarray(B), device="cpu", dtype=dtype)
        tcost = quadcost_from_numpy(np.asarray(cost.Q), np.asarray(cost.xd),
                                    np.asarray(cost.R), device="cpu", dtype=dtype)
        return tA, tB, tcost

    return (A, B, cost), port


def _x0s(seed, batch, d=4):
    return np.random.default_rng(seed).normal(0, 0.1, size=(batch, d)).astype(np.float32)


def _np(t):
    return t.detach().cpu().numpy()


_OPTIONS = dict(u_lower=-5.0, u_upper=5.0, rho_x=10.0, rho_u=0.1)


def box_wide_pieces(Nm, Nd):
    """Each warp's pairs of 8-column n-tiles in `csrc/admm_box_wide.cu`, in
    warp order: (W_s's pairs, whose u columns it owns, Su^T's pairs, whose
    x columns it owns): warp w takes pairs w, w + 16, ... of each, over the
    whole k range."""
    n_pairs = (-(-Nm // 16), -(-Nd // 16))
    return [tuple(tuple(range(w, n, 16)) for n in n_pairs) for w in range(16)]


# ---- (a) the route and the geometry at the edges ---------------------------


def _dense_blocks(Nm, Nd):
    """8 x 8 blocks of W_s ((8 n2 + Nm) x Nm) and Su^T with none skipped."""
    n1, n2 = -(-Nm // 8), -(-Nd // 8)
    return (n2 + n1) * n1 + n1 * n2


@pytest.mark.parametrize("Nm,Nd,n_blocks,routes", [
    # the narrow kernel's widest: 16 warps; few blocks, so its shared memory fits
    (128, 256, 0, ("narrow", "narrow")),
    # the 1-D bench fleet's 663 blocks at Nm = 100 (227,456 B at tile 32)
    (100, 200, 663, ("narrow", "narrow")),
    # past 16 narrow warps
    (136, 272, 0, ("wide", "wide")),
    # the planar fleet, with its 2,525 blocks and with none skipped
    (200, 400, 2525, ("wide", "wide")),
    (200, 400, None, ("wide", "wide")),
    # the narrow kernel's 16 warps but its operators past shared memory
    (120, 240, 800, ("wide", "wide")),
    # the wide route's edge at tile 32 and at 16
    (256, 512, None, ("wide", "wide")),
    (264, 512, None, ("wide", None)),
    (256, 520, None, ("wide", None)),
    (512, 1024, None, ("wide", None)),
    # past both kernels
    (520, 1024, None, (None, None)),
    (512, 1032, None, (None, None)),
])
def test_route_at_the_edges_of_each_kernel(Nm, Nd, n_blocks, routes):
    """`box_route` for tiles 16 and 32 (None where it raises, naming both
    kernels' limits): the narrow kernel wherever `box_launch_geometry`
    takes the launch, the wide one to Nm = 512, Nd = 1,024 (Nm = 256, Nd =
    512 at tile 32), neither beyond; `default_box_tile` follows. n_blocks
    None: every block, none skipped."""
    if n_blocks is None:
        n_blocks = _dense_blocks(Nm, Nd)
    for tile, want in zip((16, 32), routes):
        if want is None:
            with pytest.raises(ValueError, match="Nm <= 128, Nd <= 256.*Nm <= 512, Nd <= 1024"):
                box_route(tile, Nm, Nd, n_blocks)
        else:
            assert box_route(tile, Nm, Nd, n_blocks) == want
    if routes == (None, None):
        with pytest.raises(ValueError, match="no state-bounded kernel"):
            default_box_tile(Nm, Nd, n_blocks)
    else:
        narrow = [t for t, r in zip((16, 32), routes) if r == "narrow"]
        assert default_box_tile(Nm, Nd, n_blocks) == max(
            narrow or [t for t, r in zip((16, 32), routes) if r is not None])


def test_narrow_geometry_agrees_with_box_route():
    """Where `box_launch_geometry` takes a launch, `box_route` says
    narrow; the narrow kernel's own limits stand as they were."""
    for Nm, Nd, n_blocks in ((100, 200, 663), (98, 196, 600), (12, 24, 10), (128, 256, 0)):
        for tile in (16, 32):
            box_launch_geometry(tile, Nm, Nd, n_blocks)
            assert box_route(tile, Nm, Nd, n_blocks) == "narrow"
    with pytest.raises(ValueError, match="warps per block"):
        box_launch_geometry(32, 136, 272, 0)


def test_wide_geometry_limits_and_messages():
    """Two A operands, l_x and the bounds in shared memory: 158,400 B at
    the planar fleet (tile 32), 208,896 B at the edge (tile 16), 202,752 B
    at tile 32's (Nm = 256, Nd = 512)."""
    assert box_wide_launch_geometry(32, 200, 400) == (512, 158400)
    assert box_wide_launch_geometry(16, 512, 1024) == (512, 208896)
    assert box_wide_launch_geometry(32, 256, 512) == (512, 202752)
    assert box_wide_launch_geometry(16, 200, 400) == (512, 4 * (8 * 16 * 100 + 16 * 16 * 25
                                                                + 16 * 75))
    with pytest.raises(ValueError, match="16 or 32"):
        box_wide_launch_geometry(64, 200, 400)
    with pytest.raises(ValueError, match="Nm <= 256, Nd <= 512"):
        box_wide_launch_geometry(32, 512, 1024)
    with pytest.raises(ValueError, match="Nm <= 512, Nd <= 1024"):
        box_wide_launch_geometry(16, 520, 400)


@pytest.mark.parametrize("batch_tile", [16, 32])
def test_wide_geometry_fits_at_every_width_it_takes(batch_tile):
    """At every (Nm, Nd) on a grid that crosses the route's limits, the wide
    geometry either raises or gives 16 whole warps and shared memory within
    a block's limit, growing with both widths; it takes exactly the widths
    up to its limits."""
    max_m, max_d = {16: (512, 1024), 32: (256, 512)}[batch_tile]
    Nms = sorted({*range(4, 530, 12), max_m, max_m + 1})
    Nds = sorted({*range(4, 1050, 20), max_d, max_d + 1})
    for Nm in Nms:
        last = 0
        for Nd in Nds:
            try:
                threads, smem = box_wide_launch_geometry(batch_tile, Nm, Nd)
            except ValueError:
                assert Nm > max_m or Nd > max_d
                continue
            assert Nm <= max_m and Nd <= max_d
            assert threads == 512 and smem % 16 == 0
            assert last <= smem <= fused_admm._MAX_SMEM
            last = smem


@pytest.mark.parametrize("batch_tile,Nm,Nd", [(32, 200, 400), (16, 512, 1024), (32, 198, 396),
                                              (16, 136, 1000), (32, 8, 8)])
def test_wide_pieces_cover_every_pair_once(batch_tile, Nm, Nd):
    """Warp w takes W_s's pairs w, w + 16, ... and Su^T's likewise: each
    pair once, and at every width the geometry takes, at most the
    kernel's one and two pairs a warp (tile 32) or two and four (16)."""
    box_wide_launch_geometry(batch_tile, Nm, Nd)
    pieces = box_wide_pieces(Nm, Nd)
    assert len(pieces) == 16
    p1, p2 = fused_admm._BOX_WIDE_PAIRS[batch_tile]
    for phase, (n_pairs, cap) in enumerate(((-(-Nm // 16), p1), (-(-Nd // 16), p2))):
        owned = sorted(p for w in pieces for p in w[phase])
        assert owned == list(range(n_pairs))
        assert max(len(w[phase]) for w in pieces) <= cap


def _emulate_wide_product(ops, table, s, cols, pieces, phase):
    """The wide kernel's product s @ W (cols columns) in numpy from
    `pack_box_operators(..., "wide")` storage, as its warps take it: each
    warp's pairs over their whole k range, in chunks of 8 k-steps added to
    the total; each output column written once."""
    K = s.shape[1]
    sp = np.zeros((s.shape[0], -(-K // 8) * 8))
    sp[:, :K] = s
    nn = -(-cols // 8)
    out = np.zeros((s.shape[0], nn * 8))
    seen = np.zeros(nn, dtype=int)
    first = 0 if phase == 0 else -(-(ops["n1"]) // 2)
    for warp in pieces:
        for p in warp[phase]:
            off, klo, khi, nb = table[first + p]
            for k0 in range(klo, khi, 8):
                part = np.zeros((s.shape[0], 8 * nb))
                for kk in range(k0, min(k0 + 8, khi)):
                    for n in range(nb):
                        block = _block(ops["f"], off + (kk - klo) * 64 * nb, nb, n)
                        part[:, 8 * n:8 * n + 8] += sp[:, 8 * kk:8 * kk + 8] @ block
                out[:, 16 * p:16 * p + 8 * nb] += part
            seen[2 * p:2 * p + nb] += 1
    assert (seen == 1).all()
    return out[:, :cols]


@pytest.mark.parametrize("case", ["planar", "odd", "random"])
def test_wide_tables_replay_the_dense_products(case):
    """`pack_box_operators(W_s, Su^T, "wide")`: the same blocks as the
    narrow form, then W_s's pair table and Su^T's (offsets from the start
    of the blocks); the wide kernel's two products replayed from them give
    s W_s (s_x padded to whole tiles) and u_hat Su^T exactly."""
    rng = np.random.default_rng(0)
    if case == "random":
        Nm, Nd = 136, 276
        W_s = torch.tensor(rng.normal(size=(Nd + Nm, Nm)) * (rng.random((Nd + Nm, 1)) > 0.2))
        SuT = torch.tensor(np.triu(rng.normal(size=(Nm, Nd))))
    else:
        horizon = N if case == "planar" else 99
        x_lower, x_upper = chip_smoke.velocity_box(horizon, nb_dim=2)
        solver = make_fused_lqt_admm(*_planar(horizon)[1](F64), **_OPTIONS, x_lower=x_lower,
                                     x_upper=x_upper, batch_tile=8, dtype=F64, device="cpu")
        W_s, SuT = solver.W_s, solver.SuT
        Nm, Nd = SuT.shape
    ops_f, table = pack_box_operators(W_s, SuT, "wide")
    narrow_f, sched = pack_box_operators(W_s, SuT)
    assert torch.equal(ops_f, narrow_f) and table.dtype == torch.int32
    n1, n2 = -(-Nm // 8), -(-Nd // 8)
    assert tuple(table.shape) == (-(-n1 // 2) + -(-n2 // 2), 4)
    if case == "planar":  # 2,525 blocks: W_s dense (75 x 25), Su^T's nonzero 650
        assert ops_f.numel() == 2525 * 64 and tuple(sched.shape) == (26, 16)
    ops = {"f": ops_f.numpy(), "n1": n1}
    table = table.numpy()
    pieces = box_wide_pieces(Nm, Nd)
    s = rng.normal(size=(5, Nd + Nm))
    s_pad = np.concatenate([s[:, :Nd], np.zeros((5, 8 * n2 - Nd)), s[:, Nd:]], axis=1)
    np.testing.assert_allclose(_emulate_wide_product(ops, table, s_pad, Nm, pieces, 0),
                               s @ W_s.numpy(), rtol=0, atol=1e-9)
    u = rng.normal(size=(5, Nm))
    np.testing.assert_allclose(_emulate_wide_product(ops, table, u, Nd, pieces, 1),
                               u @ SuT.numpy(), rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match="route"):
        pack_box_operators(W_s, SuT, "medium")


def _raise_without_a_card(monkeypatch):
    """Let the factory take a CUDA device string on a host without a card,
    so that a refusal at build time shows before anything reaches CUDA."""
    monkeypatch.setattr(fused_admm, "resolve_device", lambda device=None: torch.device("cuda"))


@pytest.mark.parametrize("nb_dim,horizon,batch_tile", [(4, 129, None), (2, 129, 32),
                                                       (2, 260, None), (1, 520, 16)])
def test_a_fleet_no_kernel_takes_raises_at_build_on_cuda(monkeypatch, nb_dim, horizon,
                                                          batch_tile):
    """A state-bounded fleet past both kernels (Nm = 516; Nm = 258 at tile
    32; Nd = 1,040; Nm = 520) raises ValueError when it is built for the
    card, naming both kernels' limits, and not at its first call; on the
    CPU the same fleet builds unpacked, with route None, and runs the plain
    version."""
    A, B, cost, _ = chip_smoke.via_point_problem("cpu", nb_dim, horizon, batch=1)
    x_lower, x_upper = chip_smoke.velocity_box(horizon, nb_dim=nb_dim)
    kw = dict(_OPTIONS, x_lower=x_lower, x_upper=x_upper, n_iters=3, batch_tile=batch_tile)
    x0s = chip_smoke.via_point_problem("cpu", nb_dim, horizon, batch=32)[3]
    solver = make_fused_lqt_admm(A, B, cost, **kw, device="cpu")
    assert solver.route is None and solver.packed is None
    x, u, z_x, z_u = solver(x0s)
    want = admm_box_reference(*solver.kernel_inputs(x0s), **solver.kernel_options)
    assert all(torch.equal(g, w) for g, w in zip((x, u, z_x, z_u), want))
    _raise_without_a_card(monkeypatch)
    with pytest.raises(ValueError, match="no state-bounded kernel.*Nm <= 512, Nd <= 1024"):
        make_fused_lqt_admm(A, B, cost, **kw, device="cuda")


def test_route_and_tile_are_chosen_at_build():
    """The planar fleet builds on the wide route at tile 32 (16 at the edge,
    Nm = 512, Nd = 1,024), its packed operators in the wide form; the 1-D
    bench fleet stays on the narrow route at tile 32."""
    (_, planar) = chip_smoke.box_solver("cpu", nb_dim=2)
    assert planar.route == "wide" and planar.kernel_options["batch_tile"] == 32
    assert tuple(planar.ops_i.shape) == (13 + 25, 4)
    assert box_route(32, 200, 400, planar.ops_f.numel() // 64) == "wide"
    (_, edge) = chip_smoke.box_solver("cpu", horizon=chip_smoke.WIDE_N, nb_dim=4)
    assert edge.route == "wide" and edge.kernel_options["batch_tile"] == 16
    assert tuple(edge.ops_i.shape) == (32 + 64, 4)
    (_, narrow) = chip_smoke.box_solver("cpu")
    assert narrow.route == "narrow" and narrow.kernel_options["batch_tile"] == 32
    assert tuple(narrow.ops_i.shape) == (16, 16)


def test_packed_form_must_match_the_route():
    """Either route's form, named with its route, runs the plain version on
    CPU tensors; a form passed under the other route's name, an unknown
    route, or either form cut short, is refused; the solver passes its
    own route."""
    (_, planar) = chip_smoke.box_solver("cpu", nb_dim=2, n_iters=4)
    x0s = chip_smoke.via_point_problem("cpu", 2, batch=32)[3]
    inputs = planar.kernel_inputs(x0s)
    kw = planar.kernel_options
    want = admm_box_reference(*inputs, **kw)
    for route, other in (("wide", "narrow"), ("narrow", "wide")):
        packed = pack_box_operators(planar.W_s, planar.SuT, route)
        got = admm_box(*inputs, packed, **kw, route=route)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        with pytest.raises(ValueError, match="shapes of pack_box_operators"):
            admm_box(*inputs, (packed[0], packed[1][1:].contiguous()), **kw, route=route)
        with pytest.raises(ValueError, match=f"shapes of pack_box_operators.*'{other}'"):
            admm_box(*inputs, packed, **kw, route=other)
    with pytest.raises(ValueError, match="route must be"):
        admm_box(*inputs, packed, **kw, route="medium")
    before = (fused_admm.box_launch_count, fused_admm.box_wide_launch_count)
    planar(x0s)
    assert (fused_admm.box_launch_count, fused_admm.box_wide_launch_count) == before


# ---- (b), (c): the planar fleet against the JAX package --------------------


def test_planar_fixed_point_matches_long_jax_fleet():
    """The port's plain version in f64 at the full planar width (N = 100, 8
    instances, 600 iterations) reaches the fixed point of the JAX f64 fleet
    `make_batched_lqt_admm` at 4,000 iterations within the 5e-3 of
    `test_fixed_point_matches_long_jax_fleet`; its iterates keep their
    boxes."""
    (A, B, cost), port = _planar()
    x_lower, x_upper = chip_smoke.velocity_box(N, nb_dim=2)
    x0s = _x0s(3, 8)
    star = make_batched_lqt_admm(
        A.astype(jnp.float64), B.astype(jnp.float64), cost,
        project_x=lambda x: jnp.clip(x, x_lower, x_upper),
        project_u=lambda u: project_bound(u, -5.0, 5.0), rho_x=10.0, rho_u=0.1, n_iters=4000,
    )
    x_s, u_s = star(jnp.asarray(x0s, jnp.float64))
    solver = make_fused_lqt_admm(*port(F64), **_OPTIONS, x_lower=x_lower, x_upper=x_upper,
                                 n_iters=600, batch_tile=8, dtype=F64, device="cpu")
    x, u, z_x, z_u = solver(torch.tensor(x0s, dtype=F64))
    assert u.shape == (8, 200) and x.shape == (8, 400)
    assert np.abs(_np(u) - np.asarray(u_s)).max() < 5e-3
    assert np.abs(_np(x) - np.asarray(x_s)).max() < 5e-3
    assert float(z_u.abs().max()) <= 5.0
    assert float(z_x.reshape(8, N, 4)[..., 2:].abs().max()) <= 1.3
    assert bool(torch.isinf(torch.tensor(x_upper)).reshape(N, 4)[:, :2].all())


def test_planar_reference_matches_interpret_pallas():
    """The f32 plain version against the interpret-mode Pallas kernel at the
    full planar width (30 iterations, batch_tile 8), at the 5e-2 of
    `test_box_reference_matches_interpret_pallas` (that side rounds through
    bf16x3; this one is plain f32 with l_inv folded)."""
    (A, B, cost), port = _planar()
    x_lower, x_upper = chip_smoke.velocity_box(N, nb_dim=2)
    kw = dict(_OPTIONS, x_lower=x_lower, x_upper=x_upper, n_iters=30, batch_tile=8)
    x0s = _x0s(2, 8)
    want = make_pallas_lqt_admm(A, B, cost, interpret=True, **kw)(jnp.asarray(x0s))
    got = make_fused_lqt_admm(*port(), **kw, device="cpu")(torch.tensor(x0s))
    for name, g, w in zip(("x", "u", "z_x", "z_u"), got, want):
        assert g.shape == w.shape, name
        assert np.abs(_np(g) - np.asarray(w)).max() < 5e-2, name


def test_planar_fleet_passes_the_state_box_gates_in_f32():
    """The planar main path's configuration (|u| <= 5, |v| <= 1.3, rho_x 10,
    rho_u 0.1, 200 iterations) on 64 of its instances in f32 on the CPU:
    zero violation, converged_frac 1.0, and the f64 SLSQP oracle's gap
    within 1e-4 on 4 of them."""
    (A, B, cost), solver = chip_smoke.box_solver("cpu", nb_dim=2)
    x0s = chip_smoke.via_point_problem("cpu", 2, batch=64)[3]
    x, u, z_x, z_u = solver(x0s)
    lo, hi = chip_smoke.velocity_box(nb_dim=2)
    cert = certify_state_box(A, B, cost, x0s, x, u, z_x, z_u, -5.0, 5.0, lo, hi, n_oracle=4)
    assert state_box_gate_failures(cert) == []
    assert cert["converged_frac"] == 1.0


# ---- (d) the narrow route's fleets as they were -----------------------------


@pytest.mark.parametrize("case", [0, 1, 2])
def test_narrow_route_fleets_are_unchanged(case):
    """The 1-D state-bounded fleets of `chip_smoke.box_cases` (full width,
    state box only at tile 16, Nm = 98 over-relaxed) stay on the narrow
    route with the tile they had, their packed operators are the narrow
    kernel's warp schedule of `pack_box_operators`, and on the CPU their
    output is `admm_box_reference`'s bit for bit."""
    label, solver, inputs = chip_smoke.box_cases("cpu", batch=64)[case]
    assert solver.route == "narrow"
    assert solver.kernel_options["batch_tile"] == (16 if case == 1 else 32)
    ops_f, sched = pack_box_operators(solver.W_s, solver.SuT)
    assert torch.equal(solver.ops_f, ops_f) and torch.equal(solver.ops_i, sched)
    Nm, Nd = solver.SuT.shape
    np1 = -(-Nm // 16)  # W_s's pairs of n-tiles
    table = pack_box_operators(solver.W_s, solver.SuT, "wide")[1]
    assert torch.equal(sched, box_schedule(table[:np1], table[np1:]))
    box_launch_geometry(solver.kernel_options["batch_tile"], Nm, Nd, ops_f.numel() // 64)
    got = admm_box(*inputs, solver.packed, **solver.kernel_options)
    want = admm_box_reference(*inputs, **solver.kernel_options)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_ptxas_builds_reads_each_box_wide_builds_registers_and_spills():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_120admm_box_wide_kernelILi2ELb0EEEv"
        "NS_7ProblemE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN4_GLOBAL__N_120admm_box_wide_kernelILi2ELb0EEEv",
        "    352 bytes stack frame, 500 bytes spill stores, 776 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 352 bytes cumulative stack size",
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_120admm_box_wide_kernelILi1ELb1EEEv"
        "NS_7ProblemE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN4_GLOBAL__N_120admm_box_wide_kernelILi1ELb1EEEv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 127 registers, used 1 barriers",
    ])
    got = chip_smoke.ptxas_builds(log, "admm_box_wide_kernel")
    assert set(got) == {(32, 0), (16, 1)}
    assert got[(32, 0)].startswith("352 bytes stack frame")
    assert got[(16, 1)].endswith("Used 127 registers, used 1 barriers")


def test_pair_tables_are_pair_packs():
    """The wide form's tables are `pair_pack`'s own (Su^T's offsets moved
    past W_s's blocks)."""
    (_, planar) = chip_smoke.box_solver("cpu", nb_dim=2, n_iters=1)
    f1, t1 = pair_pack(planar.W_s)
    f2, t2 = pair_pack(planar.SuT)
    table = planar.ops_i
    assert torch.equal(table[:13], t1) and torch.equal(table[13:, 1:], t2[:, 1:])
    assert torch.equal(table[13:, 0], t2[:, 0] + f1.numel())
    assert torch.equal(planar.ops_f, torch.cat([f1, f2]))
