"""Port vs JAX package: the generic ADMM solver of `solvers/admm.py`.

A small box-constrained QP (made with numpy from a seed), split into a
state block and a control block, goes through `admm_solve` of both
packages in float64 in each branch: plain (with over-relaxation and
residual weights), Nesterov acceleration with restart, residual-balancing
adaptive rho, and Anderson acceleration. Iterates, iteration counts,
statuses and residual logs must agree to 1e-10 (the x-update is a
Cholesky solve of a 12 x 12 system; only the order of f64 operations
differs).

`admm_solve` is the fleet loop `admm_fleet` on a fleet of one: in each
branch a fleet of one, masked (`part` given) or not, is the single solve
bit for bit; a fleet of three QPs (their linear terms apart) is its
three single solves to 1e-12, iterations and statuses equal; and a solve
reads one flag an iteration, a fleet one an iteration of its slowest
instance.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.problem import ADMMConfig as JConfig
from ilqr_admm_tpu.solvers.admm import admm_solve as j_admm_solve
from ilqr_admm_tpu.solvers.admm import validate_constraint_blocks as j_validate
from ilqr_admm_tpu_torch.problem import ADMMConfig, SolveStatus
from ilqr_admm_tpu_torch.solvers import admm as tadmm

torch.set_num_threads(2)

TOL = 1e-10
NX, NU = 12, 6


@pytest.fixture(scope="module")
def qp():
    rng = np.random.default_rng(4)
    G = rng.normal(size=(NX, NX))
    Px = G @ G.T / NX + 0.1 * np.eye(NX)
    H = rng.normal(size=(NU, NU))
    Pu = H @ H.T / NU + 0.05 * np.eye(NU)
    return dict(Px=Px, qx=3.0 * rng.normal(size=NX), Pu=Pu, qu=3.0 * rng.normal(size=NU),
                wx=rng.uniform(0.5, 2.0, size=NX), rho_x=0.7, rho_u=1.3)


def _make(lib, qp, with_aux=False):
    """(f_argmin, f_argmin with rho scale, project_x, project_u, weight)
    in `lib` (jnp or torch): min 1/2 x'Px x - qx'x + 1/2 u'Pu u - qu'u,
    |x| <= 1, |u| <= 0.8."""
    if lib is jnp:
        arr, solve, eye = jnp.asarray, jnp.linalg.solve, jnp.eye
        clip = jnp.clip
    else:
        arr, solve = (lambda a: torch.tensor(np.asarray(a))), torch.linalg.solve
        eye = lambda n: torch.eye(n, dtype=torch.float64)  # noqa: E731
        clip = torch.clamp
    Px, qx, Pu, qu, wx = (arr(qp[k]) for k in ("Px", "qx", "Pu", "qu", "wx"))
    rx, ru = qp["rho_x"], qp["rho_u"]

    def f_scaled(reg_x, reg_u, s):
        # a disabled block gets reg None: its unconstrained minimizer
        x = solve(Px, qx) if reg_x is None else solve(Px + s * rx * eye(NX), qx + s * rx * reg_x)
        u = solve(Pu, qu) if reg_u is None else solve(Pu + s * ru * eye(NU), qu + s * ru * reg_u)
        return (x, u, x[:2] * 2.0) if with_aux else (x, u)

    def f_argmin(reg_x, reg_u):
        return f_scaled(reg_x, reg_u, 1.0)

    return (f_argmin, f_scaled, lambda x: clip(x, -1.0, 1.0), lambda u: clip(u, -0.8, 0.8),
            lambda r: wx * r)


BRANCHES = {
    "plain": dict(cfg=dict(max_iter=60, tol=1e-6)),
    "plain, relaxed and weighted": dict(cfg=dict(max_iter=60, tol=1e-6, alpha=1.6), weights=True),
    "plain, u block only": dict(cfg=dict(max_iter=60, tol=1e-6), blocks="u"),
    "accel": dict(cfg=dict(max_iter=60, tol=1e-6, accel=True)),
    "adaptive rho": dict(cfg=dict(max_iter=60, tol=1e-6, adaptive_rho=True, rho_freq=3),
                         scaled=True),
    "Anderson": dict(cfg=dict(max_iter=60, tol=1e-6, anderson_m=3)),
    "Anderson, x block only": dict(cfg=dict(max_iter=60, tol=1e-6, anderson_m=4), blocks="x"),
    "stall stop": dict(cfg=dict(max_iter=60, tol=1e-12, stall_tol=0.5)),
}


def _run(lib, qp, branch):
    spec = BRANCHES[branch]
    f, f_scaled, px, pu, w = _make(lib, qp, with_aux=True)
    blocks = spec.get("blocks", "xu")
    proj_x = px if "x" in blocks else None
    proj_u = pu if "u" in blocks else None
    kw = dict(weight_x=w if spec.get("weights") else None)
    if lib is jnp:
        rng = np.random.default_rng(7)
        kw.update(z_u_init=jnp.asarray(rng.normal(size=NU) * 0.1), dtype=jnp.float64)
        return j_admm_solve(f_scaled if spec.get("scaled") else f, proj_x, proj_u, (NX,), (NU,),
                            JConfig(**spec["cfg"]), **kw)
    rng = np.random.default_rng(7)
    kw.update(z_u_init=torch.tensor(rng.normal(size=NU) * 0.1), dtype=torch.float64)
    return tadmm.admm_solve(f_scaled if spec.get("scaled") else f, proj_x, proj_u, (NX,), (NU,),
                            ADMMConfig(**spec["cfg"]), **kw)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_admm_solve_matches_jax(qp, branch):
    want = _run(jnp, qp, branch)
    got = _run(torch, qp, branch)
    j_info, t_info = want[-1], got[-1]
    assert t_info.iters == int(j_info.iters)
    assert t_info.status == int(j_info.status)
    assert 2 <= t_info.iters
    assert t_info.logs.shape == (60, 2)
    np.testing.assert_allclose(t_info.logs.numpy(), np.asarray(j_info.logs), rtol=TOL, atol=TOL)
    for name, g, w in zip(("x_x", "x_u", "aux", "lmb_x", "lmb_u", "z_x", "z_u"), got[:7], want[:7]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL, err_msg=name)
    for g, w in ((t_info.prim_res, j_info.prim_res), (t_info.dual_res, j_info.dual_res)):
        assert abs(float(g) - float(w)) <= TOL * max(1.0, abs(float(w)))


def _fleet_make(qp, n):
    """`_make`'s QP for n instances whose linear terms differ (instance 0's
    is the single QP's): (f_scaled for the fleet's rows, the instances'
    (qx, qu), project_x, project_u, weight) on (n, ...) rows."""
    Px, Pu, wx = (torch.tensor(qp[k]) for k in ("Px", "Pu", "wx"))
    rng = np.random.default_rng(11)
    qx = torch.tensor(np.stack([qp["qx"]] + [3.0 * rng.normal(size=NX) for _ in range(n - 1)]))
    qu = torch.tensor(np.stack([qp["qu"]] + [3.0 * rng.normal(size=NU) for _ in range(n - 1)]))
    rx, ru = qp["rho_x"], qp["rho_u"]
    eye = lambda k: torch.eye(k, dtype=torch.float64)  # noqa: E731

    def f_scaled(reg_x, reg_u, s=None):
        s = torch.ones(n, dtype=torch.float64) if s is None else s
        sx, su = (s * rx)[:, None, None], (s * ru)[:, None, None]
        x = (torch.linalg.solve(Px.expand(n, NX, NX), qx) if reg_x is None else
             torch.linalg.solve(Px + sx * eye(NX), qx + sx[..., 0] * reg_x))
        u = (torch.linalg.solve(Pu.expand(n, NU, NU), qu) if reg_u is None else
             torch.linalg.solve(Pu + su * eye(NU), qu + su[..., 0] * reg_u))
        return x, u, x[:, :2] * 2.0

    return (f_scaled, (qx, qu), lambda x: torch.clamp(x, -1.0, 1.0),
            lambda u: torch.clamp(u, -0.8, 0.8), lambda r: wx * r)


def _fleet_run(qp, branch, n, part=None):
    """admm_fleet of `branch` on n instances, z_u started as `_run` starts
    the single solve (every instance alike)."""
    spec = BRANCHES[branch]
    f_scaled, _, px, pu, w = _fleet_make(qp, n)
    blocks = spec.get("blocks", "xu")
    if spec.get("scaled"):
        f = f_scaled
    else:
        def f(reg_x, reg_u):
            return f_scaled(reg_x, reg_u)
    z_u = torch.tensor(np.random.default_rng(7).normal(size=NU) * 0.1).expand(n, NU).clone()
    z_x = torch.zeros((n, NX), dtype=torch.float64)
    return tadmm.admm_fleet(f, px if "x" in blocks else None, pu if "u" in blocks else None,
                            ADMMConfig(**spec["cfg"]), z_x, z_u, torch.zeros_like(z_x),
                            torch.zeros_like(z_u), part=part,
                            weight_x=w if spec.get("weights") else None)


def _single_of(qp, branch, i, n):
    """The single solve of instance i of `_fleet_make(qp, n)`."""
    spec = BRANCHES[branch]
    _, (qx, qu), _, _, _ = _fleet_make(qp, n)
    inst = dict(qp, qx=qx[i].numpy(), qu=qu[i].numpy())
    return _run(torch, inst, branch)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_a_fleet_of_one_is_the_single_solve(qp, branch):
    want = _run(torch, qp, branch)
    for part in (None, torch.ones(1, dtype=torch.bool)):
        got = _fleet_run(qp, branch, 1, part)
        info = got[-1]
        assert info.fleet_iters == want[-1].iters and info.iters.tolist() == [want[-1].iters]
        assert info.status.tolist() == [want[-1].status]
        assert torch.equal(info.logs[0], want[-1].logs)
        assert torch.equal(info.prim_res[0], want[-1].prim_res)
        assert torch.equal(info.dual_res[0], want[-1].dual_res)
        for name, g, w in zip(("x_x", "x_u", "aux", "lmb_x", "lmb_u", "z_x", "z_u"), got[:7],
                              want[:7]):
            assert torch.equal(g[0], w), (name, part)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_fleet_instances_are_single_solves(qp, branch):
    """Three QPs as one fleet, each to 1e-12 of its single solve (batched
    and unbatched solves may sum in another order), each stopping at its
    own iteration with its own status; the fleet reads one flag an
    iteration until its slowest instance stops."""
    before = tadmm.host_sync_count
    got = _fleet_run(qp, branch, 3)
    info = got[-1]
    assert tadmm.host_sync_count - before == info.fleet_iters == int(info.iters.max())
    for i in range(3):
        want = _single_of(qp, branch, i, 3)
        assert int(info.iters[i]) == want[-1].iters and int(info.status[i]) == want[-1].status
        for name, g, w in zip(("x_x", "x_u", "aux", "lmb_x", "lmb_u", "z_x", "z_u"), got[:7],
                              want[:7]):
            np.testing.assert_allclose(g[i].numpy(), w.numpy(), rtol=1e-12, atol=1e-12,
                                       err_msg=f"{name}, instance {i}")


def test_instances_that_take_no_part_keep_their_carry(qp):
    part = torch.tensor([True, False, True])
    got = _fleet_run(qp, "accel", 3, part)
    info = got[-1]
    assert info.iters[1] == 0 and info.status[1] == SolveStatus.MAX_ITER
    assert not bool(got[0][1].any()) and not bool(got[5][1].any())  # x_x and z_x stay zero
    assert torch.equal(got[6][1], torch.tensor(np.random.default_rng(7).normal(size=NU) * 0.1))


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_each_branch_reads_once_an_iteration(qp, branch):
    before = tadmm.host_sync_count
    info = _run(torch, qp, branch)[-1]
    assert tadmm.host_sync_count - before == info.iters


def test_branches_reach_their_statuses(qp):
    """The plain QP converges; an unreachable tol with a loose stall_tol
    stalls; a cap of 3 ends at MAX_ITER."""
    assert _run(torch, qp, "plain")[-1].status == SolveStatus.CONVERGED
    assert _run(torch, qp, "stall stop")[-1].status == SolveStatus.STALLED
    f, _, px, pu, _ = _make(torch, qp)
    info = tadmm.admm_solve(f, px, pu, (NX,), (NU,), ADMMConfig(max_iter=3), dtype=torch.float64,
                            device="cpu")[-1]
    assert info.status == SolveStatus.MAX_ITER and info.iters == 3


def test_one_host_read_an_iteration(qp):
    before = tadmm.host_sync_count
    info = _run(torch, qp, "accel")[-1]
    assert tadmm.host_sync_count - before == info.iters


def test_zero_iterations_return_zeros_without_an_x_update(qp):
    calls = []
    _, _, px, pu, _ = _make(torch, qp)

    def f(reg_x, reg_u):
        calls.append(1)
        return reg_x, reg_u

    x, u, aux, *_, info = tadmm.admm_solve(f, px, pu, (NX,), (NU,), ADMMConfig(max_iter=0),
                                           dtype=torch.float64, device="cpu")
    assert not calls and info.iters == 0 and info.status == SolveStatus.MAX_ITER
    assert aux is None and not bool(x.any()) and not bool(u.any())


def test_argument_errors(qp):
    f, f_scaled, px, pu, _ = _make(torch, qp)
    kw = dict(dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        tadmm.admm_solve(f, None, None, (NX,), (NU,), ADMMConfig(), **kw)
    with pytest.raises(ValueError, match="incompatible with adaptive_rho"):
        tadmm.admm_solve(f_scaled, px, pu, (NX,), (NU,),
                         ADMMConfig(accel=True, adaptive_rho=True), **kw)
    for cfg in (ADMMConfig(anderson_m=2, accel=True), ADMMConfig(anderson_m=2, adaptive_rho=True)):
        with pytest.raises(ValueError, match="anderson_m > 0 is incompatible"):
            tadmm.admm_solve(f, px, pu, (NX,), (NU,), cfg, **kw)
    with pytest.raises(ValueError, match="requires an f_argmin accepting"):
        tadmm.admm_solve(f, px, pu, (NX,), (NU,), ADMMConfig(adaptive_rho=True), **kw)
    with pytest.raises(ValueError, match="rho_freq must be >= 1"):
        tadmm.admm_solve(f_scaled, px, pu, (NX,), (NU,),
                         ADMMConfig(adaptive_rho=True, rho_freq=0), **kw)


@pytest.mark.parametrize("args,match", [
    ((lambda x: x, None, None, None), "project_x is set but rho_x=None"),
    ((lambda x: x, 0.0, None, None), "project_x is set but rho_x=0.0"),
    ((None, None, lambda u: u, np.zeros((2, 2))), "project_u is set but rho_u="),
    ((None, 1.0, None, None), "rho_x=1.0 is set but project_x is None"),
    ((None, None, None, torch.eye(2)), "is set but project_u is None"),
])
def test_validate_constraint_blocks_errors(args, match):
    with pytest.raises(ValueError, match=match):
        tadmm.validate_constraint_blocks(*args)
    j_args = tuple(a.numpy() if isinstance(a, torch.Tensor) else a for a in args)
    with pytest.raises(ValueError):
        j_validate(*j_args)


def test_validate_accepts_explicit_off():
    tadmm.validate_constraint_blocks(None, 0.0, None, torch.zeros(2, 2))
    tadmm.validate_constraint_blocks(lambda x: x, 1.0, lambda u: u, np.eye(2))


def test_config_stall_defaults_to_tol():
    assert ADMMConfig(tol=3e-4).stall == 3e-4 == JConfig(tol=3e-4).stall
    assert ADMMConfig(tol=3e-4, stall_tol=1e-2).stall == 1e-2
    import dataclasses

    j_fields = {f.name: f.default for f in dataclasses.fields(JConfig)}
    t_fields = {f.name: f.default for f in dataclasses.fields(ADMMConfig)}
    assert j_fields == t_fields
