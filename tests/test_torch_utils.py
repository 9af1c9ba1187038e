"""Port vs JAX package: the small utilities of `utils/`.

The trajopt, checkpoint, metrics, debug and checkpoint-resume tests of
`tests/test_aux.py` run through both packages with the same seeded
numpy inputs in float64; then the rest of `utils/precision.py` and
`utils/cost_assembly.py` against the JAX functions, and the profiling
hooks on the CPU. `use_x64()` changes torch's default dtype for the
whole process, so the `x64` fixture restores it after its test.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ilqr_admm_tpu.utils import cost_assembly as jca
from ilqr_admm_tpu.utils import precision as jprec
from ilqr_admm_tpu.utils.checkpoint import restore_state as j_restore, save_state as j_save
from ilqr_admm_tpu.utils.metrics import admm_info_dict as j_admm_info_dict
from ilqr_admm_tpu.utils.trajopt import TrajOpt as JTrajOpt
from ilqr_admm_tpu_torch.utils import cost_assembly as tca
from ilqr_admm_tpu_torch.utils import precision as tprec
from ilqr_admm_tpu_torch.utils.checkpoint import restore_state, save_state
from ilqr_admm_tpu_torch.utils.debug import assert_finite, checked, debug_nan_hook
from ilqr_admm_tpu_torch.utils.metrics import PhaseTimer, admm_info_dict, ilqr_state_dict
from ilqr_admm_tpu_torch.utils.profiling import RateCounter, annotate, device_trace
from ilqr_admm_tpu_torch.utils.trajopt import TrajOpt

torch.set_num_threads(2)

F64 = torch.float64
DATA = os.path.join(os.path.dirname(__file__), "data", "trajopt_golden.npz")


def _tree_leaves(tree):
    """Leaves in the JAX package's order: dict keys sorted."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _tree_leaves(item)]
    return [tree]


def _n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture
def x64():
    """torch's default dtype float64 for one test (`use_x64`), then back."""
    prev = torch.get_default_dtype()
    tprec.use_x64()
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


def test_trajopt_interpolates_nodes():
    h = [0.5, 0.3, 0.7]
    rng = np.random.default_rng(0)
    y_nodes = rng.normal(size=(4, 2))
    dy0, dyT = np.array([0.2, -0.1]), np.array([-0.3, 0.4])
    topt, jtopt = TrajOpt(2), JTrajOpt(2)
    topt.setup_task(h)
    jtopt.setup_task(h)
    ts = np.concatenate([[0.0], np.cumsum(h)])
    probes = np.concatenate([ts, [0.63, ts[1] - 1e-6, ts[1] + 1e-6]])
    for get in ("get_y", "get_dy", "get_ddy"):
        got = getattr(topt, get)(probes, y_nodes, dy0, dyT)
        np.testing.assert_array_equal(got, getattr(jtopt, get)(probes, y_nodes, dy0, dyT))
    for i, t in enumerate(ts):
        np.testing.assert_allclose(topt.get_y(t, y_nodes, dy0, dyT), y_nodes[i], atol=1e-10)
    np.testing.assert_allclose(topt.get_dy(0.0, y_nodes, dy0, dyT), dy0, atol=1e-10)
    np.testing.assert_allclose(topt.get_dy(ts[-1], y_nodes, dy0, dyT), dyT, atol=1e-10)
    np.testing.assert_allclose(topt.get_dy(ts[1] - 1e-6, y_nodes, dy0, dyT),
                               topt.get_dy(ts[1] + 1e-6, y_nodes, dy0, dyT), atol=1e-4)
    w = np.concatenate([y_nodes.reshape(-1), dy0, dyT])
    np.testing.assert_allclose(topt.get_Phi(0.63) @ w, topt.get_y(0.63, y_nodes, dy0, dyT),
                               atol=1e-12)
    np.testing.assert_allclose(topt.get_ddPhi(0.63) @ w, topt.get_ddy(0.63, y_nodes, dy0, dyT),
                               atol=1e-9)


def test_trajopt_matches_reference_basis_golden():
    g = np.load(DATA)
    for ndof in (1, 3):
        topt, jtopt = TrajOpt(ndof), JTrajOpt(ndof)
        topt.setup_task(list(g["h"]))
        jtopt.setup_task(list(g["h"]))
        for get in ("get_Phi", "get_dPhi", "get_ddPhi"):
            np.testing.assert_array_equal(getattr(topt, get)(g["ts"]),
                                          getattr(jtopt, get)(g["ts"]))
        np.testing.assert_allclose(topt.get_Phi(g["ts"]), np.kron(g["Phi"], np.eye(ndof)),
                                   atol=1e-8)
    topt = TrajOpt(1)
    topt.setup_task(list(g["h"]))
    np.testing.assert_allclose(topt.get_dPhi(g["ts"]), g["dPhi"], atol=1e-8)
    np.testing.assert_allclose(topt.get_ddPhi(g["ts"]), g["ddPhi"], atol=1e-7)


def test_checkpoint_roundtrip(tmp_path):
    state = {"x_nom": torch.arange(12.0, dtype=F64).reshape(3, 4),
             "duals": (torch.ones(5, dtype=F64), torch.zeros(2, dtype=torch.float32))}
    saved = save_state(str(tmp_path / "ckpt"), state)
    restored = restore_state(saved, state)
    for a, b in zip(_tree_leaves(restored), _tree_leaves(state)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    assert isinstance(restored["duals"], tuple)
    # the JAX package restores the port's archive (its .npz format), and
    # its own round trip gives the same leaves
    j_state = {"x_nom": jnp.arange(12.0).reshape(3, 4), "duals": (jnp.ones(5), jnp.zeros(2))}
    from_port = j_restore(saved, j_state)
    j_own = j_restore(j_save(str(tmp_path / "jckpt"), j_state), j_state)
    for a, b, c in zip(_tree_leaves(restored), jax.tree_util.tree_leaves(from_port),
                       jax.tree_util.tree_leaves(j_own)):
        np.testing.assert_array_equal(_n(a), np.asarray(b))
        np.testing.assert_array_equal(_n(a), np.asarray(c))
    with pytest.raises(ValueError, match="leaves"):
        restore_state(saved, {"x_nom": state["x_nom"]})


def test_metrics_helpers():
    from ilqr_admm_tpu.solvers.admm import ADMMInfo as JADMMInfo
    from ilqr_admm_tpu_torch.solvers.admm import ADMMInfo
    from ilqr_admm_tpu_torch.solvers.ilqr import ILQRState

    logs = np.random.default_rng(0).normal(size=(10, 2))
    info = ADMMInfo(iters=3, prim_res=torch.tensor(1e-5, dtype=F64),
                    dual_res=torch.tensor(2e-5, dtype=F64), status=1, logs=torch.tensor(logs))
    j_info = JADMMInfo(iters=jnp.int32(3), prim_res=jnp.float64(1e-5), dual_res=jnp.float64(2e-5),
                       status=jnp.int32(1), logs=jnp.asarray(logs))
    d = admm_info_dict(info)
    assert d == j_admm_info_dict(j_info)
    assert d["status"] == "CONVERGED" and d["iters"] == 3
    assert len(d["residual_history"]) == 3
    st = ILQRState(x_nom=None, u_nom=None, cost=torch.tensor(0.5, dtype=F64),
                   prev_cost=torch.tensor(0.75, dtype=F64), iteration=4, status=4)
    assert ilqr_state_dict(st) == {"iterations": 4, "cost": 0.5, "prev_cost": 0.75,
                                   "status": "LINE_SEARCH_FAILED"}

    timer = PhaseTimer()
    for _ in range(2):
        with timer.phase("backward"):
            pass
    assert timer.summary()["backward"]["count"] == 2
    assert '"backward"' in timer.dumps()


def test_debug_guards():
    assert_finite({"a": torch.ones(3)}, "state")
    with pytest.raises(FloatingPointError, match=r"state\['a'\]\[1\] contains 1"):
        assert_finite({"a": [torch.ones(2), torch.tensor([1.0, float("nan")])]}, "state")

    f = checked(torch.log)
    np.testing.assert_allclose(_n(f(torch.tensor(2.0, dtype=F64))), np.log(2.0))
    with pytest.raises(FloatingPointError):
        f(torch.tensor(-1.0, dtype=F64))

    with debug_nan_hook() as check:
        assert torch.is_anomaly_enabled()
        check((torch.ones(2),), "ok")
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (torch.sqrt(x) * 0.0).sum().backward()  # 0 * inf = nan in the backward pass
    assert not torch.is_anomaly_enabled()


def test_checkpoint_resume_admm(tmp_path):
    """Checkpoint ADMM duals mid-solve and resume to the same fixed point;
    the port's 60 straight iterations match the JAX package's."""
    from jax.scipy.linalg import cho_factor, cho_solve

    from ilqr_admm_tpu.models.double_integrator import DoubleIntegrator
    from ilqr_admm_tpu.ops.lifted import build_Su, sw_x0
    from ilqr_admm_tpu.problem import ADMMConfig as JADMMConfig
    from ilqr_admm_tpu.projections import project_bound as j_project_bound
    from ilqr_admm_tpu.solvers.admm import admm_solve as j_admm_solve
    from ilqr_admm_tpu.solvers.lqt import block_diag_stacked, broadcast_rho
    from ilqr_admm_tpu_torch.problem import ADMMConfig
    from ilqr_admm_tpu_torch.projections import project_bound
    from ilqr_admm_tpu_torch.solvers.admm import admm_solve

    N = 50
    plant = DoubleIntegrator(1, 2, dt=1.0 / N)
    d, m = plant.x_dim, plant.u_dim
    zs = jnp.stack([jnp.zeros(d), jnp.asarray([1.0, 0.0])])
    Qs = jnp.stack([jnp.zeros((d, d)), jnp.eye(d) * 1e4])
    seq = np.zeros(N, dtype=np.int32)
    seq[-1] = 1
    cost = jca.viapoint_cost(zs, Qs, seq, 1e-2, m)
    A, B = plant.AB(N)
    Su = build_Su(A, B)
    SuTQ = Su.T @ cost.lifted_Q()
    Rr = block_diag_stacked(broadcast_rho(1e-2, m, N))
    cf = cho_factor(SuTQ @ Su + cost.lifted_R() + Rr)
    free = sw_x0(A, jnp.zeros(d)).reshape(-1)
    r_side = SuTQ @ (cost.lifted_xd() - free)

    def j_argmin(x, u):
        u_hat = cho_solve(cf, r_side + (Rr @ u if u is not None else 0.0))
        return free + Su @ u_hat, u_hat

    # the port's x-update from the same (JAX-built) operators
    t_cf = torch.tensor(np.asarray(cf[0]))
    t_Su, t_Rr, t_free, t_r = (torch.tensor(np.asarray(a)) for a in (Su, Rr, free, r_side))

    def t_argmin(x, u):
        rhs = t_r + (t_Rr @ u if u is not None else 0.0)
        u_hat = torch.cholesky_solve(rhs[:, None], t_cf, upper=True)[:, 0]
        return t_free + t_Su @ u_hat, u_hat

    def run(iters, **kw):
        return admm_solve(t_argmin, None, lambda u: project_bound(u, -5.0, 5.0), (N * d,),
                          (N * m,), ADMMConfig(max_iter=iters, tol=0.0, stall_tol=0.0),
                          dtype=F64, device="cpu", **kw)

    j_full = j_admm_solve(j_argmin, None, lambda u: j_project_bound(u, -5.0, 5.0), (N * d,),
                          (N * m,), JADMMConfig(max_iter=60, tol=0.0, stall_tol=0.0),
                          dtype=jnp.float64)
    u_full = run(60)[1]
    np.testing.assert_allclose(_n(u_full), np.asarray(j_full[1]), rtol=1e-10, atol=1e-10)

    half = run(30)
    path = save_state(str(tmp_path / "admm_state"), {"z_u": half[6], "lmb_u": half[4]})
    restored = restore_state(path, {"z_u": half[6], "lmb_u": half[4]})
    resumed = run(30, z_u_init=restored["z_u"], lmb_u_init=restored["lmb_u"])
    np.testing.assert_allclose(_n(resumed[1]), _n(u_full), atol=1e-12)


# -- the rest of utils/precision.py and utils/cost_assembly.py --------------


def test_use_x64_is_scoped_by_the_fixture(x64):
    assert torch.get_default_dtype() == torch.float64
    assert torch.zeros(1).dtype == torch.float64


def test_default_dtype_is_float32_outside_the_fixture():
    assert torch.get_default_dtype() == torch.float32


def test_highest_precision_pins_full_f32():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")  # TF32 allowed outside
    try:
        @tprec.highest_precision
        def probe(a, b=1):
            """doc"""
            return torch.get_float32_matmul_precision(), a + b

        assert probe(1, b=2) == ("highest", 3)
        assert probe.__doc__ == "doc" and probe.__name__ == "probe"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("case", ["diag", "dense", "zero_R", "all_zero"])
def test_stiffness_ratio_matches_jax(case):
    rng = np.random.default_rng(1)
    Q = rng.normal(size=(5, 3, 3)) * 1e3
    R = np.abs(rng.normal(size=(5, 2, 2))) * 1e-2
    if case == "diag":
        R = R * np.eye(2)
        R[2] = 0.0
    elif case in ("zero_R", "all_zero"):
        R = np.zeros_like(R)
    if case == "all_zero":
        Q = np.zeros_like(Q)
    got = tprec.stiffness_ratio(torch.tensor(Q), torch.tensor(R))
    assert got == jprec.stiffness_ratio(jnp.asarray(Q), jnp.asarray(R))


def test_cost_assembly_rest_matches_jax():
    rng = np.random.default_rng(2)
    for args in ((2, 3, 4), (1, 1, 0)):
        np.testing.assert_array_equal(_n(tca.selection_matrix(*args)),
                                      np.asarray(jca.selection_matrix(*args)))
    np.testing.assert_array_equal(_n(tca.construct_Z(3, 4)), np.asarray(jca.construct_Z(3, 4)))
    J = rng.normal(size=(2, 5))
    np.testing.assert_allclose(_n(tca.nullspace_matrix(torch.tensor(J))),
                               np.asarray(jca.nullspace_matrix(jnp.asarray(J))), atol=1e-12)
    np.testing.assert_allclose(_n(tca.nullspace_matrix2(torch.tensor(J))),
                               np.asarray(jca.nullspace_matrix2(jnp.asarray(J))), atol=1e-12)
    zs = rng.normal(size=(3, 4))
    Qs = rng.normal(size=(3, 4, 4))
    seq = np.array([0, 2, 1, 1, 0])
    np.testing.assert_array_equal(_n(tca.augment_Qt(torch.tensor(Qs[0]))),
                                  np.asarray(jca.augment_Qt(jnp.asarray(Qs[0]))))
    np.testing.assert_array_equal(_n(tca.augment_mut(torch.tensor(zs[0]))),
                                  np.asarray(jca.augment_mut(jnp.asarray(zs[0]))))
    np.testing.assert_allclose(_n(tca.find_augmented_precs(torch.tensor(zs), torch.tensor(Qs), seq)),
                               np.asarray(jca.find_augmented_precs(zs, Qs, seq)), rtol=1e-12,
                               atol=1e-12)
    for got, want in zip(tca.batch_cost_vars(torch.tensor(zs), torch.tensor(Qs), seq),
                         jca.batch_cost_vars(zs, Qs, seq)):
        np.testing.assert_array_equal(_n(got), np.asarray(want))


def test_run_once_memoizes_only_success():
    calls = []

    @tca.run_once
    def setup(x):
        calls.append(x)
        if x < 0:
            raise ValueError("bad")
        return x * 2

    with pytest.raises(ValueError):
        setup(-1)
    assert setup(3) == 6 and setup(5) == 6
    assert calls == [-1, 3]


def test_profiling_hooks_on_cpu(tmp_path):
    with device_trace(str(tmp_path)) as prof:
        with annotate("matmul region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    names = [e.key for e in prof.key_averages()]
    assert "matmul region" in names
    assert any(f.endswith(".json") for f in os.listdir(tmp_path))
    rate = RateCounter()
    assert rate.rate == 0.0
    rate.start()
    rate.add(10)
    assert rate.rate > 0.0
