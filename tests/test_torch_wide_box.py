"""Port vs JAX package: the state-bounded path of `make_fused_lqt_admm` past
the narrow kernel's Nm = 128, on the wide route `csrc/admm_box_wide.cu`.

The planar double integrator of the examples (`DoubleIntegrator(2, 2,
dt=1/N)`, N = 100: Nm = 200, Nd = 400) with the bench's cost to (1, 1),
|u| <= 5 and |v_x|, |v_y| <= 1.3. The JAX side runs the Pallas kernel
`_admm_kernel` in interpret mode (bf16x3 products) or the XLA fleet
`make_batched_lqt_admm`; the port runs on CPU tensors, where `admm_box`
takes its plain version `admm_box_reference` on either route. Also: the
route and geometry at the edges of both kernels; the wide route's column
groups, packed A fragments, tiles and warpgroup streams replayed in
numpy (f64) and its tensor-core schedule emulated in f32; the permuted
fleet the kernel runs against the plain fleet; the build-time refusal on
a CUDA device; and the narrow route's fleets unchanged.
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
    box_components,
    box_schedule,
    box_wide_launch_geometry,
    box_wide_smem,
    default_box_tile,
    make_fused_lqt_admm,
    pack_box_operators,
)
from ilqr_admm_tpu_torch.utils.certify import certify_state_box, state_box_gate_failures
from ilqr_admm_tpu_torch.utils.precision import tf32_split, tf32x3_matmul

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


def _unfragment(frags):
    """(..., 512) wgmma A fragments back to (..., 64, 8) blocks: thread 32 w
    + 4 g + t holds (16 w + g, t), (16 w + g + 8, t), (16 w + g, t + 4),
    (16 w + g + 8, t + 4)."""
    f = np.asarray(frags).reshape(*np.shape(frags)[:-1], 4, 8, 4, 2, 2)  # w, g, t, q, h
    n = f.ndim - 5
    return f.transpose(*range(n), n, n + 4, n + 1, n + 3, n + 2).reshape(
        *np.shape(frags)[:-1], 64, 8)


def _walk(packed):
    """(phase, warpgroup, tile row, (col0, rows, steps), first step) of
    every tile, in the kernel's order: each warpgroup's stream, its
    phase-1 tiles then its phase-2 tiles."""
    layout = packed.layout
    for w, (n1, n2, tile0, length, step0, p2) in enumerate(layout.groups):
        step = step0
        for i in range(n1 + n2):
            tile = layout.tiles[tile0 + i]
            yield (0 if i < n1 else 1), w, tile0 + i, tile, step
            step += tile[2]
        assert step == step0 + length


def _dense_from_packed(packed):
    """The two operators the kernel multiplies, rebuilt from its A
    fragments and k-steps: A1 (nu x (nx + nu)) = W_s^T over s = [s_x,
    s_u] and A2 (nx x nu) = Su, in the layout's padded order, f64."""
    layout = packed.layout
    nx, nu = layout.nx, layout.nu
    blocks = _unfragment(packed[0].double().numpy().reshape(-1, 512))
    A = [np.zeros((nu, nx + nu)), np.zeros((nx, nu))]
    for phase, _, _, (col0, rows, steps), step in _walk(packed):
        for q in range(step, step + steps):
            k = layout.ksteps[q] - (nx // 8 if phase else 0)
            assert np.all(blocks[q][rows:] == 0)
            A[phase][col0:col0 + rows, 8 * k:8 * k + 8] += blocks[q][:rows]
    return A


def _spread(packed, t, width, original):
    """t's columns at their padded positions of the layout (zeros between)."""
    layout = packed.layout
    pos = packed[1][layout.positions:].long()
    p = pos[:layout.Nd] if original == layout.Nd else pos[layout.Nd:]
    return t.new_zeros(t.shape[0], width).index_copy_(1, p, t), p


def _wide_fleet(inputs, packed, **kw):
    """The fleet as the wide kernel runs it: the inputs spread to the
    layout's order, the iteration of `admm_box_reference` on the operators
    rebuilt from the packed fragments, the outputs gathered back."""
    free, u_base, u0, W_s, SuT, xb, ub = inputs
    layout = packed.layout
    A1, A2 = (torch.tensor(a, dtype=free.dtype) for a in _dense_from_packed(packed))
    free_p, px = _spread(packed, free, layout.nx, layout.Nd)
    xb_p, _ = _spread(packed, xb, layout.nx, layout.Nd)
    (u_base_p, pu), (u0_p, _), (ub_p, _) = (_spread(packed, t, layout.nu, layout.Nm)
                                             for t in (u_base, u0, ub))
    out = admm_box_reference(free_p, u_base_p, u0_p, A1.T.contiguous(), A2.T.contiguous(),
                             xb_p, ub_p, **kw)
    return [o.index_select(1, px if o.shape[1] == layout.nx else pu) for o in out]


# ---- (a) the route and the geometry at the edges ---------------------------


def _dense_blocks(Nm, Nd):
    """8 x 8 blocks of W_s ((8 n2 + Nm) x Nm) and Su^T with none skipped."""
    n1, n2 = -(-Nm // 8), -(-Nd // 8)
    return (n2 + n1) * n1 + n1 * n2


_TILES = (8, 16, 32)


@pytest.mark.parametrize("Nm,Nd,n_blocks,routes", [
    # the narrow kernel's widest: 16 warps; few blocks, so its shared memory fits
    (128, 256, 0, ("wide", "narrow", "narrow")),
    # the 1-D bench fleet's 663 blocks at Nm = 100 (227,456 B at tile 32)
    (100, 200, 663, ("wide", "narrow", "narrow")),
    # past 16 narrow warps
    (136, 272, 0, ("wide", "wide", "wide")),
    # the planar fleet, with its 2,525 blocks and with none skipped
    (200, 400, 2525, ("wide", "wide", "wide")),
    (200, 400, None, ("wide", "wide", "wide")),
    # the narrow kernel's 16 warps but its operators past shared memory
    (120, 240, 800, ("wide", "wide", "wide")),
    # past tile 32's shared memory, then past tile 16's
    (256, 512, None, ("wide", "wide", None)),
    (264, 512, None, ("wide", "wide", None)),
    (256, 520, None, ("wide", "wide", None)),
    (512, 1024, None, ("wide", None, None)),
    # past both kernels
    (520, 1024, None, (None, None, None)),
    (512, 1032, None, (None, None, None)),
])
def test_route_at_the_edges_of_each_kernel(Nm, Nd, n_blocks, routes):
    """`box_route` for tiles 8, 16 and 32 (None where it raises, naming
    both kernels' limits): the narrow kernel wherever `box_launch_geometry`
    takes the launch (16 or 32), the wide one to Nm = 512, Nd = 1,024 with
    the tiles its shared memory takes (8 at the edge), neither beyond;
    `default_box_tile` follows. n_blocks None: every block, none
    skipped."""
    if n_blocks is None:
        n_blocks = _dense_blocks(Nm, Nd)
    for tile, want in zip(_TILES, routes):
        if want is None:
            with pytest.raises(ValueError, match="Nm <= 128, Nd <= 256.*Nm <= 512, Nd <= 1024"):
                box_route(tile, Nm, Nd, n_blocks)
        else:
            assert box_route(tile, Nm, Nd, n_blocks) == want
    if routes == (None, None, None):
        with pytest.raises(ValueError, match="no state-bounded kernel"):
            default_box_tile(Nm, Nd, n_blocks)
    else:
        narrow = [t for t, r in zip(_TILES, routes) if r == "narrow"]
        assert default_box_tile(Nm, Nd, n_blocks) == max(
            narrow or [t for t, r in zip(_TILES, routes) if r is not None])


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
    """s as TF32 hi and lo, four rings of 4 k-steps of A fragments, the
    bounds and the tables in shared memory: 196,448 B for the planar
    fleet's two column groups at tile 32, 145,824 B for the edge's four at
    tile 8; the one-group layout of a width (every k-step counted) bounds
    the route's choice."""
    (_, planar) = chip_smoke.box_solver("cpu", nb_dim=2, n_iters=1)
    assert box_wide_launch_geometry(32, 200, 400, planar.layout) == (512, 196448)
    (_, edge) = chip_smoke.box_solver("cpu", horizon=chip_smoke.WIDE_N, nb_dim=4, n_iters=1)
    assert box_wide_launch_geometry(8, 512, 1024, edge.layout) == (512, 145824)
    # one group: nx = 400, nu = 200, 11 tiles, 4 x 76 + 7 x 26 k-steps
    assert box_wide_launch_geometry(32, 200, 400) == (512, box_wide_smem(32, 400, 200, 11, 486))
    assert box_wide_smem(32, 400, 200, 11, 486) == 4 * 4 * 2048 + 4 * (64 * 600 + 1200 + 33 + 486)
    with pytest.raises(ValueError, match="8, 16, 32"):
        box_wide_launch_geometry(64, 200, 400)
    with pytest.raises(ValueError, match="2 tiles of u columns on a warpgroup"):
        box_wide_launch_geometry(32, 512, 1024, edge.layout)
    with pytest.raises(ValueError, match="shared memory"):
        box_wide_launch_geometry(16, 512, 1024)
    with pytest.raises(ValueError, match="Nm <= 512, Nd <= 1024"):
        box_wide_launch_geometry(16, 520, 400)
    with pytest.raises(ValueError, match="layout is for Nm=200"):
        box_wide_launch_geometry(32, 198, 396, planar.layout)


@pytest.mark.parametrize("batch_tile", _TILES)
def test_wide_geometry_fits_at_every_width_it_takes(batch_tile):
    """At every (Nm, Nd) on a grid that crosses the route's limits, the wide
    geometry either raises or gives 4 warpgroups and shared memory within a
    block's limit, growing with both widths; tile 8 takes exactly the
    widths up to the limits (the edge, Nm = 512, Nd = 1,024, included),
    and a width a tile takes, every smaller tile takes."""
    Nms = sorted({*range(4, 530, 12), 512, 513})
    Nds = sorted({*range(4, 1050, 20), 1024, 1025})
    for Nm in Nms:
        last = 0
        for Nd in Nds:
            try:
                threads, smem = box_wide_launch_geometry(batch_tile, Nm, Nd)
            except ValueError:
                assert batch_tile > 8 or Nm > 512 or Nd > 1024
                continue
            assert Nm <= 512 and Nd <= 1024
            assert threads == 512 and smem % 4 == 0
            assert last <= smem <= fused_admm._MAX_SMEM
            last = smem
            if batch_tile > 8:
                box_wide_launch_geometry(batch_tile // 2, Nm, Nd)


def _random_operators(Nm, Nd, seed=0):
    """W_s and Su^T of (Nm, Nd) with two coupled groups of columns (even and
    odd ones), zero rows and a triangular Su^T."""
    rng = np.random.default_rng(seed)
    ui, xi = np.arange(Nm) % 2, np.arange(Nd) % 2
    rows = np.concatenate([xi, ui])
    W_s = rng.normal(size=(Nd + Nm, Nm)) * (rows[:, None] == ui[None]) \
        * (rng.random((Nd + Nm, 1)) > 0.2)
    SuT = np.triu(rng.normal(size=(Nm, Nd))) * (ui[:, None] == xi[None])
    return torch.tensor(W_s), torch.tensor(SuT)


def _operators(case):
    """(W_s, Su^T) in f64 of a named fleet."""
    if case in ("random", "tiny"):
        return _random_operators(*((136, 1000) if case == "random" else (8, 8)))
    if case == "edge":
        solver = chip_smoke.box_solver("cpu", horizon=chip_smoke.WIDE_N, nb_dim=4, n_iters=1,
                                       dtype=F64)[1]
    elif case == "1-D":
        solver = chip_smoke.box_solver("cpu", n_iters=1, dtype=F64)[1]
    else:
        horizon = N if case == "planar" else 99
        x_lower, x_upper = chip_smoke.velocity_box(horizon, nb_dim=2)
        solver = make_fused_lqt_admm(*_planar(horizon)[1](F64), **_OPTIONS, x_lower=x_lower,
                                     x_upper=x_upper, batch_tile=8, dtype=F64, device="cpu")
    return solver.W_s, solver.SuT


@pytest.mark.parametrize("batch_tile,case", [(32, "planar"), (8, "edge"), (32, "odd"),
                                              (16, "random"), (32, "tiny")])
def test_wide_tiles_cover_every_column_once(batch_tile, case):
    """The wide form's M tiles: each phase-1 tile rows of one group's u
    columns, each phase-2 tile of its x columns, together each padded
    column exactly once; every tile's stored k-steps a multiple of 2; each
    warpgroup's stream its phase-1 tiles then its phase-2 tiles, end to
    end; at most 32 / batch_tile phase-1 tiles a warpgroup, dealt so that
    no warpgroup has more k-steps than another but for one tile; the
    header as the kernel reads it."""
    W_s, SuT = _operators(case)
    Nm, Nd = SuT.shape
    packed = pack_box_operators(W_s, SuT, "wide", batch_tile)
    layout = packed.layout
    box_wide_launch_geometry(batch_tile, Nm, Nd, layout)
    seen = [np.zeros(layout.nu, int), np.zeros(layout.nx, int)]
    loads = [[0] * 4, [0] * 4]
    biggest = [0, 0]
    for phase, w, _, (col0, rows, steps), _ in _walk(packed):
        assert rows % 8 == 0 and 0 < rows <= 64 and steps % 2 == 0
        seen[phase][col0:col0 + rows] += 1
        loads[phase][w] += steps
        biggest[phase] = max(biggest[phase], steps)
    assert all((s == 1).all() for s in seen)
    assert layout.max_u_tiles <= 32 // batch_tile
    for phase in (0, 1):
        assert max(loads[phase]) - min(loads[phase]) <= biggest[phase]
    ints = packed[1].numpy()
    assert list(ints[:4]) == [layout.nx, layout.nu, layout.n_tiles, layout.n_steps]
    assert [list(ints[4 + 4 * i:8 + 4 * i]) for i in range(6)] == [
        [g[i] for g in layout.groups] for i in range(6)]
    assert list(ints[32:32 + 3 * layout.n_tiles]) == [v for t in layout.tiles for v in t]
    assert sorted(x for x in layout.gather_u if x >= 0) == list(range(Nm))
    assert sorted(x for x in layout.gather_x if x >= 0) == list(range(Nd))


@pytest.mark.parametrize("batch_tile,identity", [(32, True), (16, False)])
def test_wide_packing_takes_one_group_where_the_groups_do_not_fit(batch_tile, identity):
    """Five decoupled groups of 48 u and 48 x columns need five u tiles,
    past tile 32's four (one a warpgroup): packed for tile 32 the fleet
    takes the one-group layout, which fits; for tile 16 it keeps its
    groups. Either layout replays the dense product."""
    rng = np.random.default_rng(2)
    label = np.arange(240) % 5
    W_s = torch.tensor(rng.normal(size=(480, 240))
                       * (np.concatenate([label, label])[:, None] == label[None]))
    SuT = torch.tensor(np.triu(rng.normal(size=(240, 240))) * (label[:, None] == label[None]))
    assert len(box_components(W_s, SuT)) == 5
    packed = pack_box_operators(W_s, SuT, "wide", batch_tile)
    assert packed.layout.identity == identity
    box_wide_launch_geometry(batch_tile, 240, 240, packed.layout)
    with pytest.raises(ValueError, match="2 tiles of u columns on a warpgroup"):
        box_wide_launch_geometry(32, 240, 240, pack_box_operators(W_s, SuT, "wide").layout)
    u = torch.tensor(rng.normal(size=(3, 240)))
    A2 = _dense_from_packed(packed)[1]
    up, _ = _spread(packed, u, packed.layout.nu, 240)
    px = packed[1][packed.layout.positions:packed.layout.positions + 240].long()
    np.testing.assert_allclose((up.numpy() @ A2.T)[:, px.numpy()], (u @ SuT).numpy(), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("case", ["planar", "odd", "random", "edge", "1-D"])
def test_wide_tables_replay_the_dense_products(case):
    """`pack_box_operators(W_s, Su^T, "wide")`: the products the kernel
    takes from its A fragments and k-steps, replayed in f64, give s W_s and
    u_hat Su^T to 1e-12 once the layout's permutation is undone; the
    permutation folded into the inputs is the layout's (the 1-D plant's
    the identity)."""
    W_s, SuT = _operators(case)
    Nm, Nd = SuT.shape
    packed = pack_box_operators(W_s, SuT, "wide")
    layout = packed.layout
    assert layout.identity == (case == "1-D")
    A1, A2 = _dense_from_packed(packed)
    rng = np.random.default_rng(0)
    s = torch.tensor(rng.normal(size=(5, Nd + Nm)))
    sx, px = _spread(packed, s[:, :Nd], layout.nx, Nd)
    su, pu = _spread(packed, s[:, Nd:], layout.nu, Nm)
    got = (torch.cat([sx, su], 1).numpy() @ A1.T)[:, pu.numpy()]
    np.testing.assert_allclose(got, (s @ W_s).numpy(), rtol=0, atol=1e-12)
    u = torch.tensor(rng.normal(size=(5, Nm)))
    got = (_spread(packed, u, layout.nu, Nm)[0].numpy() @ A2.T)[:, px.numpy()]
    np.testing.assert_allclose(got, (u @ SuT).numpy(), rtol=0, atol=1e-12)
    if layout.identity:
        assert list(layout.gather_u[:Nm]) == list(range(Nm))
        assert list(layout.gather_x[:Nd]) == list(range(Nd))
    with pytest.raises(ValueError, match="route"):
        pack_box_operators(W_s, SuT, "medium")


@pytest.mark.parametrize("case", ["planar", "edge", "1-D"])
def test_column_groups_of_the_plants(case):
    """`box_components`: the planar plant's two axes, the edge plant's four,
    the 1-D plant's one; each column in exactly one group, each group's u
    and x columns coupled only among themselves."""
    W_s, SuT = _operators(case)
    Nm, Nd = SuT.shape
    groups = box_components(W_s, SuT)
    assert len(groups) == {"planar": 2, "edge": 4, "1-D": 1}[case]
    assert sorted(u for us, _ in groups for u in us) == list(range(Nm))
    assert sorted(x for _, xs in groups for x in xs) == list(range(Nd))
    label_u, label_x = np.zeros(Nm, int), np.zeros(Nd, int)
    for i, (us, xs) in enumerate(groups):
        label_u[us], label_x[xs] = i, i
    rows = np.concatenate([label_x, label_u])
    W, S = W_s.numpy() != 0, SuT.numpy() != 0
    assert not (W & (rows[:, None] != label_u[None])).any()
    assert not (S & (label_u[:, None] != label_x[None])).any()


@pytest.mark.parametrize("phase", [0, 1])
def test_kernel_schedule_in_f32_matches_tf32x3(phase):
    """The wide kernel's products emulated in f32 as it schedules them: the
    operator split once into TF32 hi and lo (its A fragments), s or u_hat
    split by their writer (the B operands), a k-step the sum lo_W hi_s +
    hi_W lo_s + hi_W hi_s, small terms first, each tile's k-steps in
    chunks of `BOX_WIDE_K_CHUNK` added to the total in f32; on the planar
    fleet within 2e-6 relative of `tf32x3_matmul` and of the f64 product
    (the 3xTF32 split errs by ~2^-21 an operand)."""
    W_s, SuT = (t.float() for t in _operators("planar"))
    packed = pack_box_operators(W_s, SuT, "wide")
    layout = packed.layout
    nx, nu = layout.nx, layout.nu
    rng = np.random.default_rng(1)
    width = nx + nu if phase == 0 else nu
    B = torch.tensor(rng.normal(size=(32, width)), dtype=F32)
    (b_hi, b_lo), blocks = tf32_split(B, 2), _unfragment(packed[0].numpy().reshape(-1, 512))
    out = torch.zeros(32, nu if phase == 0 else nx)
    dense = torch.zeros(out.shape[1], width)
    for ph, _, _, (col0, rows, steps), step in _walk(packed):
        if ph != phase:
            continue
        total = torch.zeros(32, 64)
        for c0 in range(0, steps, fused_admm.BOX_WIDE_K_CHUNK):
            part = torch.zeros(32, 64)
            for q in range(step + c0, step + min(c0 + fused_admm.BOX_WIDE_K_CHUNK, steps)):
                k = layout.ksteps[q] - (nx // 8 if phase else 0)
                a_hi, a_lo = tf32_split(torch.tensor(blocks[q], dtype=F32), 2)
                cols = slice(8 * k, 8 * k + 8)
                with fused_admm.full_f32_matmul():
                    part = part + ((b_lo[:, cols] @ a_hi.T + b_hi[:, cols] @ a_lo.T)
                                   + b_hi[:, cols] @ a_hi.T)
                dense[col0:col0 + rows, cols] += torch.tensor(blocks[q][:rows], dtype=F32)
            total = total + part
        out[:, col0:col0 + rows] = total[:, :rows]
    want = tf32x3_matmul(B, dense.T.contiguous())
    exact = B.double() @ dense.T.double()
    scale = float(exact.abs().max())
    assert float((out - want).abs().max()) <= 2e-6 * scale
    assert float((out.double() - exact).abs().max()) <= 2e-6 * scale


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
    """The planar fleet builds on the wide route at tile 32 (8 at the edge,
    Nm = 512, Nd = 1,024), its packed operators in the wide form with
    its layout (two column groups; four at the edge); the 1-D bench fleet
    stays on the narrow route at tile 32."""
    (_, planar) = chip_smoke.box_solver("cpu", nb_dim=2)
    assert planar.route == "wide" and planar.kernel_options["batch_tile"] == 32
    layout = planar.packed.layout
    assert (layout.nx, layout.nu, layout.n_tiles, layout.n_steps) == (408, 208, 12, 228)
    assert not layout.identity and tuple(planar.ops_i.shape) == (layout.ints,)
    assert planar.ops_f.numel() == 512 * 228
    assert box_route(32, 200, 400, 2525) == "wide"
    (_, edge) = chip_smoke.box_solver("cpu", horizon=chip_smoke.WIDE_N, nb_dim=4)
    assert edge.route == "wide" and edge.kernel_options["batch_tile"] == 8
    assert (edge.layout.n_tiles, edge.layout.n_steps) == (24, 544)
    (_, narrow) = chip_smoke.box_solver("cpu")
    assert narrow.route == "narrow" and narrow.kernel_options["batch_tile"] == 32
    assert tuple(narrow.ops_i.shape) == (16, 16) and narrow.layout is None


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


@pytest.mark.parametrize("case", ["planar", "odd, alpha 1.3", "state box only"])
def test_permuted_fleet_equals_the_plain_fleet_in_f64(case):
    """The fleet as the wide kernel runs it (`_wide_fleet`: inputs and
    bounds spread to the layout's column order, the iteration on the
    operators rebuilt from the packed fragments, outputs gathered back)
    equals `admm_box_reference` on the original order to 1e-12 in f64:
    the planar fleet, N = 99 over-relaxed with vector bounds (each group's
    columns padded), and the state box alone (the u block off)."""
    horizon = 99 if case.startswith("odd") else N
    A, B, cost = _planar(horizon)[1](F64)
    x_lower, x_upper = chip_smoke.velocity_box(horizon, nb_dim=2)
    kw = dict(_OPTIONS, x_lower=x_lower, x_upper=x_upper, n_iters=25, batch_tile=8, dtype=F64,
              device="cpu")
    if case.startswith("odd"):
        kw.update(u_lower=np.full(2 * horizon, -4.0), u_upper=np.linspace(3.0, 5.0, 2 * horizon),
                  alpha=1.3)
    elif case == "state box only":
        kw.update(u_lower=None, u_upper=None, rho_u=None)
    solver = make_fused_lqt_admm(A, B, cost, **kw)
    assert solver.route == "wide" and not solver.layout.identity
    inputs = solver.kernel_inputs(torch.tensor(_x0s(4, 16), dtype=F64))
    want = admm_box_reference(*inputs, **solver.kernel_options)
    got = _wide_fleet(inputs, solver.packed, **solver.kernel_options)
    scale = max(1.0, float(want[0].abs().max()), float(want[1].abs().max()))
    for name, g, w in zip(("x", "u", "z_x", "z_u"), got, want):
        assert g.shape == w.shape, name
        assert float((g - w).abs().max()) <= 1e-12 * scale, name


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
    _, t1, t2 = fused_admm._pack_box_pairs(solver.W_s, solver.SuT)
    assert torch.equal(sched, box_schedule(t1, t2))
    box_launch_geometry(solver.kernel_options["batch_tile"], Nm, Nd, ops_f.numel() // 64)
    got = admm_box(*inputs, solver.packed, **solver.kernel_options)
    want = admm_box_reference(*inputs, **solver.kernel_options)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_ptxas_builds_reads_each_box_wide_builds_registers_and_spills():
    """`ptxas_builds` keys each build of the wide kernel (template <int T,
    bool RELAX>, instances in units of 1) by (T, relax)."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_120admm_box_wide_kernelILi32ELb0EEEv"
        "NS_7ProblemE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN4_GLOBAL__N_120admm_box_wide_kernelILi32ELb0EEEv",
        "    352 bytes stack frame, 500 bytes spill stores, 776 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 352 bytes cumulative stack size",
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_120admm_box_wide_kernelILi8ELb1EEEv"
        "NS_7ProblemE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN4_GLOBAL__N_120admm_box_wide_kernelILi8ELb1EEEv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 127 registers, used 1 barriers",
    ])
    got = chip_smoke.ptxas_builds(log, "admm_box_wide_kernel", unit=1)
    assert set(got) == {(32, 0), (8, 1)}
    assert got[(32, 0)].startswith("352 bytes stack frame")
    assert got[(8, 1)].endswith("Used 127 registers, used 1 barriers")
    # the m16-row-tile templates of the other kernels keep their default unit
    assert set(chip_smoke.ptxas_builds(log.replace("ILi32E", "ILi2E"), "admm_box_wide_kernel")) \
        == {(32, 0), (128, 1)}


def test_wide_fragments_hold_the_operator_tiles():
    """Each stored k-step of the wide form is a 64 x 8 block of the
    permuted operator in wgmma A-fragment order (16 bytes a thread),
    exactly the tile's nonzero blocks, in order, then zero blocks to a
    multiple of 2; f32 storage, as the kernel reads it."""
    (_, planar) = chip_smoke.box_solver("cpu", nb_dim=2, n_iters=1)
    packed = planar.packed
    layout = packed.layout
    assert packed[0].dtype == torch.float32 and packed[1].dtype == torch.int32
    A = _dense_from_packed(packed)
    blocks = _unfragment(packed[0].double().numpy().reshape(-1, 512))
    for phase, _, _, (col0, rows, steps), step in _walk(packed):
        k0 = layout.nx // 8 if phase else 0
        M = np.zeros((64, A[phase].shape[1]))
        M[:rows] = A[phase][col0:col0 + rows]
        nonzero = [k for k in range(M.shape[1] // 8) if M[:, 8 * k:8 * k + 8].any()]
        ks = [k - k0 for k in layout.ksteps[step:step + steps]]
        assert ks[:len(nonzero)] == nonzero and steps == -(-len(nonzero) // 2) * 2
        for q, k in enumerate(ks):
            want = M[:, 8 * k:8 * k + 8] if q < len(nonzero) else 0.0
            np.testing.assert_array_equal(blocks[step + q], want)
    # a thread's four values: (16 w + g, t), (16 w + g + 8, t), (16 w + g, t + 4), ...
    f = fused_admm._fragments(torch.arange(512.0).reshape(64, 8))
    tid, (w, g, t) = 32 + 4 * 3 + 1, (1, 3, 1)
    assert f[4 * tid:4 * tid + 4].tolist() == [8.0 * r + c for r, c in (
        (16 * w + g, t), (16 * w + g + 8, t), (16 * w + g, t + 4), (16 * w + g + 8, t + 4))]
