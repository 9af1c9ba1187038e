"""Port vs JAX package: the robust SLS fleet at robust_dim = 2 (p1 = 3 slabs)
with the consensus z-update (`ops/fused_sls.py`, `csrc/sls_admm.cu`).

The chance constraint |du| + psi sigma ||phi|| <= bound with uncertainty
on both initial-state components, as two SOC sets of q = 4 rows
(`chip_smoke.soc_sets_2d`). The port runs in f64 on CPU tensors, where
`sls_admm` takes its plain torch version; the JAX side runs the Pallas
kernel in interpret mode (f32, f32 setup) and the XLA fleet
`make_batched_sls_admm` with `project_set_convex` (f64). Also the
kernel's tile layout at p1 = 3, its z-update constants and the f64
certificate of the p1 = 3 fleet (`utils/certify.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm

import chip_smoke
from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu.ops.pallas_sls import make_pallas_sls_admm
from ilqr_admm_tpu.projections import project_set_convex, project_soc_unit
from ilqr_admm_tpu.solvers.batched_sls import make_batched_sls_admm
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost
from ilqr_admm_tpu_torch.convert import dynamics_from_numpy, quadcost_from_numpy
from ilqr_admm_tpu_torch.ops.fused_sls import (
    CONSENSUS_SHAPES,
    k_split,
    kernel_z_update,
    launch_geometry,
    make_fused_sls_admm,
    sls_admm,
    sls_admm_reference,
    sls_pieces,
    sls_row,
)
from ilqr_admm_tpu_torch.utils.certify import (
    certify_sls,
    project_cone,
    project_diamond,
    sls_cone_violation,
)

torch.set_num_threads(2)

F64 = torch.float64
PSI = float(norm.ppf(0.95))
SIGMA = 0.1
C_COEF = PSI * SIGMA
N_ITERS, N_CONS, CONS_RHO, RHO_U = 60, 20, 10.0, 1.0


def _problem(N=20):
    """The double integrator of test_pallas_sls.py (f32 data), d = 2."""
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])]).astype(jnp.float32)
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e3]).astype(jnp.float32)
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)
    return A.astype(jnp.float32), B.astype(jnp.float32), cost


def _port(A, B, cost, dtype=F64):
    tA, tB = dynamics_from_numpy(np.asarray(A), np.asarray(B), device="cpu", dtype=dtype)
    tcost = quadcost_from_numpy(
        np.asarray(cost.Q), np.asarray(cost.xd), np.asarray(cost.R), device="cpu", dtype=dtype
    )
    return tA, tB, tcost


def _bounds(seed, batch=8):
    return np.random.default_rng(seed).uniform(2.0, 4.0, batch).astype(np.float32)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _port_fleet(bounds, **over):
    A, B, cost = _problem()
    kw = dict(rho_u=RHO_U, robust_dim=2, n_iters=N_ITERS, n_cons_iters=N_CONS,
              cons_rho=CONS_RHO, batch_tile=8, dtype=F64, device="cpu")
    kw.update(over)
    solver = make_fused_sls_admm(*_port(A, B, cost), *chip_smoke.soc_sets_2d(), **kw)
    return solver, solver(torch.tensor(bounds, dtype=F64))


def test_p1_3_consensus_matches_interpret_pallas():
    """f64 port against the interpret-mode Pallas kernel (f32 setup), at the
    1e-3 relative of the p1 = 2 consensus case
    (test_torch_fused_sls.py::CASES)."""
    A, B, cost = _problem()
    bounds = _bounds(0)
    du_p, phi_p, U_p = make_pallas_sls_admm(
        A, B, cost, *chip_smoke.soc_sets_2d(), rho_u=RHO_U, robust_dim=2, n_iters=N_ITERS,
        n_cons_iters=N_CONS, cons_rho=CONS_RHO, batch_tile=8, interpret=True,
    )(jnp.asarray(bounds))
    _, (du_t, phi_t, U_t) = _port_fleet(bounds)
    assert U_t.shape == (8, 20, 3) and phi_t.shape == (8, 20, 40) and du_t.shape == (8, 20)
    assert _rel_err(U_t.numpy(), U_p) < 1e-3
    assert _rel_err(du_t.numpy(), du_p) < 1e-3
    assert _rel_err(phi_t.numpy(), phi_p) < 1e-2  # PHI_unc: f32 setup vs f64 setup
    assert torch.equal(phi_t[:, :, :2], U_t[:, :, 1:]) and torch.equal(du_t, U_t[:, :, 0])


def test_p1_3_consensus_matches_batched_project_set_convex():
    """f64 port against the XLA fleet with `project_set_convex` onto the
    same two cones and f64 data, at the 1e-3 relative of the p1 = 2 tests.
    The kernel ends its consensus loop with one more x-update from the
    last duals, which is the x that `project_set_convex` returns after
    n_cons + 1 iterations, so both project alike; the fused loop starts
    from Z = U_base (as the Pallas kernel), the XLA fleet from Z = 0, so
    they meet at the same fixed point (6.1e-3 apart after 60 iterations,
    4.1e-4 after 200, 4.1e-5 after 400)."""
    A, B, cost = _problem()
    A64, B64 = A.astype(jnp.float64), B.astype(jnp.float64)
    soc_A, b_fixed, b_bound = chip_smoke.soc_sets_2d()
    As = [jnp.asarray(a) for a in soc_A]

    def project(y, bound):
        bs = [jnp.asarray(bf) + bound * jnp.asarray(bb) for bf, bb in zip(b_fixed, b_bound)]
        return project_set_convex(y, As, bs, [project_soc_unit] * 2, rho=CONS_RHO,
                                  max_iter=N_CONS + 1, threshold=0.0, stall_tol=0.0)

    solve = make_batched_sls_admm(
        A64, B64, cost, project_u=lambda y, p: jax.vmap(project)(y, p), rho_u=RHO_U,
        robust_dim=2, n_iters=200,
    )
    bounds = _bounds(1)
    du_x, _, U_x = solve(jnp.asarray(bounds, jnp.float64))
    _, (du_t, _, U_t) = _port_fleet(bounds, n_iters=200)
    assert _rel_err(U_t.numpy(), U_x) < 1e-3
    assert _rel_err(du_t.numpy(), du_x) < 1e-3


def test_p1_3_f32_plain_and_tf32x3_agree_with_f64():
    """The f32 plain version and the one with the kernel's 3xTF32
    products stay within the kernel-vs-plain tolerance of the card
    (chip_smoke.SLS_FIXED_TOL x max(1, max|U|)) of the f64 solve, and
    every output is finite."""
    bounds = _bounds(2)
    solver, (_, _, U64) = _port_fleet(bounds)
    s32, _ = _port_fleet(bounds, dtype=torch.float32)
    b32 = torch.tensor(bounds)
    kw = s32.kernel_options
    f32 = sls_admm_reference(b32, s32.U_base, s32.W, **kw)
    tf32 = sls_admm_reference(b32, s32.U_base, s32.W, **kw, products="tf32x3")
    tol = chip_smoke.SLS_FIXED_TOL * max(1.0, float(U64.abs().max()))
    for got in (f32, tf32):
        assert bool(torch.isfinite(got).all())
        assert float((got.double() - U64).abs().max()) <= tol


@pytest.mark.parametrize("batch_tile", [8, 16])
def test_kernel_rows_hold_every_slab_of_an_instance_in_a_thread(batch_tile):
    """The kernel's tile layout at p1 = 3: each group of eight instances has
    two 16-row m-tiles, slabs 0 and 1 in the first, slab 2 and a zero slab
    in the second (`sls_row`), each row once; in the m16n8k8 accumulator
    layout (element i of m-tile mt at row 16 mt + g + 8 (i // 2), column
    2 t + i % 2) every lane of a piece (its group's two m-tiles) holds all
    three slabs of one instance at each column it holds, and the pieces
    (`sls_pieces`) cover every (m-tile, n-tile) once."""
    p1, ms = 3, 2
    rows = {sls_row(b, p, p1): (b, p) for b in range(batch_tile) for p in range(p1)}
    n_rows = 16 * ms * (batch_tile // 8)
    assert len(rows) == batch_tile * p1 and max(rows) < n_rows
    pad = set(range(n_rows)) - set(rows)  # the zero slab: rows 8-15 of each second m-tile
    assert pad == {16 * (ms * grp + 1) + 8 + r for grp in range(batch_tile // 8)
                   for r in range(8)}
    Nm = 100
    pieces = sls_pieces(batch_tile, Nm, p1)
    assert len(pieces) * 32 == launch_geometry(batch_tile, Nm, p1)[0]
    seen = np.zeros((n_rows // 16, -(-Nm // 8)), dtype=int)
    for pr, m0, mw in pieces:
        assert mw == ms and m0 % ms == 0
        for lane in range(32):
            g, t = lane // 4, lane % 4
            held = {}
            for mt in range(m0, m0 + mw):
                for i in range(4):
                    row = 16 * mt + g + 8 * (i // 2)
                    if row in rows:
                        b, p = rows[row]
                        held.setdefault((b, 2 * t + i % 2), set()).add(p)
            assert all(slabs == {0, 1, 2} for slabs in held.values())
            assert {b for b, _ in held} == {8 * (m0 // ms) + g}
        n_tiles = min(2, seen.shape[1] - 2 * pr)
        seen[m0:m0 + mw, 2 * pr:2 * pr + n_tiles] += 1
    assert (seen == 1).all()
    # p1 = 2 keeps PR 8's slab-major rows
    assert [sls_row(b, p) for b in range(16) for p in range(2)] == [
        16 * (b // 8) + 8 * p + b % 8 for b in range(16) for p in range(2)]


def test_kernel_z_update_packs_the_p1_3_cones():
    """The constants of the (3, 2, 4) consensus build, packed as the
    kernel's `unpack_consensus` reads them; k_split stays 1 at p1 = 3."""
    soc_A, b_fixed, b_bound = chip_smoke.soc_sets_2d()
    lc = np.eye(3) + CONS_RHO * sum(a.T @ a for a in soc_A)
    mode, coeffs, n_sets, q = kernel_z_update(3, "consensus", None, soc_A, b_fixed, b_bound,
                                              np.linalg.inv(lc), CONS_RHO)
    assert (3, n_sets, q) in CONSENSUS_SHAPES and (mode, n_sets, q) == (1, 2, 4)
    assert coeffs.size == 2 * 4 * 3 * 2 + 2 * 4 * 2 + 9
    np.testing.assert_array_equal(coeffs[:24], np.stack(soc_A).ravel().astype(np.float32))
    np.testing.assert_array_equal(coeffs[-9:], np.linalg.inv(lc).ravel().astype(np.float32))
    assert k_split(1024, 8, 100, 132, p1=3) == 1
    with pytest.raises(ValueError, match="not built for"):
        kernel_z_update(3, "consensus", None, [np.zeros((10, 3))], [np.zeros(10)],
                        [np.zeros(10)], np.eye(3), CONS_RHO)


def test_cpu_wrapper_runs_the_plain_version_at_p1_3():
    solver, (_, _, U) = _port_fleet(_bounds(3))
    b = torch.tensor(_bounds(3), dtype=F64)
    want = sls_admm_reference(b, solver.U_base, solver.W, **solver.kernel_options)
    got = sls_admm(b, solver.U_base, solver.W, solver.packed, **solver.kernel_options)
    assert torch.equal(got, want) and torch.equal(U, want)


def test_project_cone_is_the_exact_projection():
    """`project_cone` onto {|a| + c ||phi|| <= r}: feasible, idempotent, the
    diamond at p1 = 2, and no feasible point of a random sample is closer
    than the projection."""
    rng = np.random.default_rng(0)
    v = rng.normal(scale=3.0, size=(64, 3))
    r = rng.uniform(0.5, 2.0, 64)
    z = project_cone(v, C_COEF, r)
    assert (np.abs(z[:, 0]) + C_COEF * np.linalg.norm(z[:, 1:], axis=1) - r).max() <= 1e-12
    np.testing.assert_allclose(project_cone(z, C_COEF, r), z, atol=1e-12)
    d = np.linalg.norm(v - z, axis=1)
    for _ in range(200):
        w = rng.normal(scale=2.0, size=(64, 3))
        feasible = np.abs(w[:, 0]) + C_COEF * np.linalg.norm(w[:, 1:], axis=1) <= r
        assert (np.linalg.norm(v - w, axis=1)[feasible] >= d[feasible] - 1e-12).all()
    v2 = v[:, :2]
    np.testing.assert_array_equal(project_cone(v2, C_COEF, r), project_diamond(v2, C_COEF, r))


def test_certificate_of_the_p1_3_fleet():
    """The f64 certificate: a fleet run further (300 outer and 60 consensus
    iterations) sits within 1e-4 of its set and of the SLSQP oracle's
    cost (2.3e-5 measured); at the bench's 200 and 30 iterations the
    z-update is inexact and the cost gap stays above 1e-5 and ten times
    the first's in exact arithmetic too (1.1e-3 at this N = 20; 3.3e-4 at
    the bench's N = 100)."""
    A, B, cost = _problem()
    bounds = _bounds(4)
    cert = {}
    for name, over in (("further", dict(n_iters=300, n_cons_iters=60)),
                       ("bench", dict(n_iters=200, n_cons_iters=30))):
        _, (_, _, U) = _port_fleet(bounds, **over)
        cert[name] = certify_sls(*_port(A, B, cost), torch.tensor(bounds, dtype=F64), U, C_COEF,
                                 n_oracle=2)
    further, bench = cert["further"], cert["bench"]
    assert further["converged_frac"] == 1.0 and further["prim_max"] < 1e-3
    assert further["cone_violation"] < 1e-4
    assert 0.0 <= further["cost_gap_median"] <= further["cost_gap_max"] < 1e-4
    assert bench["converged_frac"] == 1.0 and bench["cone_violation"] < 1e-3
    assert 1e-5 < bench["cost_gap_median"] < 1e-2
    assert bench["cost_gap_median"] > 10 * further["cost_gap_max"]


def test_cone_violation_reads_the_rows():
    U = torch.zeros(2, 3, 3, dtype=F64)
    U[0, 1] = torch.tensor([1.0, 3.0, 4.0])  # |du| + c * 5
    bounds = torch.tensor([1.0, 1.0], dtype=F64)
    assert sls_cone_violation(U, bounds, 0.5) == pytest.approx(2.5)
    assert sls_cone_violation(U * 0, bounds, 0.5) == -1.0
