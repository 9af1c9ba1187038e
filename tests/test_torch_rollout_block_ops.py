"""Port vs JAX package: the generated rollout takes every step the Pallas rollout takes.

`make_pallas_linesearch_rollout` traces any elementwise jnp step into its
kernel: comparisons and `where`, operations on the whole state and its
slices, sums over the state axis, tensor exponents and bounds, 0-d
constants, the unary ops jnp has, and `.at[i].set(v)`. The port's emitter
(`ops/rollout_codegen.py`) takes their torch twins. Each form here is a
jnp step and its torch twin, held as tests/test_torch_rollout_any_plant.py
holds the earlier plants: the port's plain version (on CPU tensors) to
the Pallas kernel in interpret mode within 1e-5 in f32 and to
`linesearch_rollout_xla` within 1e-12 in f64; its emitted C++ compiled by
g++, the staged program bit for bit the serial `rollout_step`, NaN
positions included (tests/test_torch_rollout_staged.py's harness); the
fleet form to its single calls. Then `chip_smoke.blocks_step` (a d = m = 8
plant over the new table), `examples/car_control_bounds.py`'s solve with
`chip_smoke.car_whole_state_step` as the line search's step against JAX's
with the Pallas hook, a callable plant without `step_cols` (CarSimple, as
JAX rolls it out), the emitter's arithmetic for the new ops, the sources of
the steps taken before, which do not change, and the known differences
between torch and jnp. The CUDA kernel is held to the plain version bit
for bit on the card by `chip_smoke.py`.
"""

import ctypes
import functools
import hashlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from ilqr_admm_tpu.models.car import CarSimple as JCarSimple
from ilqr_admm_tpu.ops.pallas_rollout import linesearch_rollout_xla, make_pallas_linesearch_rollout
from ilqr_admm_tpu.ops.rollout import rollout_nonlinear as j_rollout
from ilqr_admm_tpu.projections import project_bound as j_project_bound
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost as j_viapoint_cost
from ilqr_admm_tpu_torch.models.car import CarSimple
from ilqr_admm_tpu_torch.ops import fused_rollout as fr
from ilqr_admm_tpu_torch.ops.rollout_codegen import PRELUDE, emit_step, f32_literal
from test_torch_rollout_any_plant import X0, _car_cands, jia
from test_torch_rollout_staged import HARNESS

torch.set_num_threads(2)

N, A = 60, 10


def _j_blocks_step(x, u):
    """`chip_smoke.blocks_step` in jnp."""
    dt = cs.EIGHT_DT
    head = x[0:4] + dt * jnp.tanh(u[0:4])
    first = jnp.stack([
        jnp.where((head[0] > 1.0) | (head[0] < -1.0), -0.5 * head[0], head[0]),
        0.3 * x[1:4].sum(axis=0) + dt * u[1],
        0.9 * jnp.clip(head[2], x[4] - 1.0, x[4] + 1.0),
        0.5 * (jnp.abs(x[3]) + 0.5) ** jax.nn.sigmoid(u[3]) + 0.1 * jnp.sign(u[3]),
    ])
    second = jnp.stack([
        jnp.fmod(x[4] + dt * jnp.sinh(u[4]), 2.0),
        0.8 * x[5] + 0.1 * x[0:3].max(axis=0),
        0.9 * x[6] + dt * (jnp.expm1(0.1 * u[6]) + jnp.log1p(jnp.abs(u[5]))
                           - (u[6] // 0.5) * jnp.square(jnp.cos(u[7]))),
        jnp.where(x[7] >= x[6], jnp.minimum(x[7], x[6] + 1.0), 0.5 * (x[7] + x[6])),
    ])
    return jnp.concatenate([first, second])


def _j_car_whole_state_step(x, u, dt=15.0 / cs.CAR_BOUNDS_N):
    """`chip_smoke.car_whole_state_step` in jnp."""
    th, v = x[2:3], x[3:4]
    return x + dt * jnp.concatenate([v * jnp.cos(th), v * jnp.sin(th), v * u[0:1], u[1:2]])


# name -> (jnp step, torch step, d, m, x0, the controls' scale): each form of
# the Pallas rollout that the port refused before, in a step whose states stay
# bounded over N steps
FORMS = {
    "where on a loop-carried row": (
        lambda x, u: jnp.stack([0.9 * x[0] + 0.1 * x[1],
                                jnp.where(x[1] > 1.0, 1.0, x[1] + 0.01 * u[0])]),
        lambda x, u: torch.stack([0.9 * x[0] + 0.1 * x[1],
                                  torch.where(x[1] > 1.0, 1.0, x[1] + 0.01 * u[0])]),
        2, 1, (0.3, 0.97), 3.0),
    "a mask of two comparisons": (
        lambda x, u: jnp.stack([jnp.where((x[0] > 0) & (u[0] < 1), x[0] + 0.01 * u[0], -x[0])]),
        lambda x, u: torch.stack([torch.where((x[0] > 0) & (u[0] < 1), x[0] + 0.01 * u[0],
                                              -x[0])]),
        1, 1, (0.2,), 1.0),
    "an op on the whole state": (
        lambda x, u: x * 2.0 + 0.0 * u[0], lambda x, u: x * 2.0 + 0.0 * u[0],
        4, 2, (0.1, -0.2, 0.3, 0.4), 1.0),
    "clip of the whole state": (
        lambda x, u: jnp.clip(x + 0.01 * u[0], -1, 1),
        lambda x, u: torch.clip(x + 0.01 * u[0], -1, 1),
        4, 2, (0.95, -0.95, 0.0, 0.5), 3.0),
    "concatenate of slices": (
        lambda x, u: jnp.concatenate([x[1:2], 0.5 * x[0:1] + 0.1 * u[0:1]]),
        lambda x, u: torch.cat([x[1:2], 0.5 * x[0:1] + 0.1 * u[0:1]]),
        2, 1, (0.5, -0.5), 1.0),
    "a negative index": (
        lambda x, u: jnp.stack([x[-1] + 0.1 * u[0], 0.5 * x[-2]]),
        lambda x, u: torch.stack([x[-1] + 0.1 * u[0], 0.5 * x[-2]]),
        2, 1, (0.5, -0.5), 1.0),
    "a sum over state rows": (
        lambda x, u: jnp.stack([0.4 * x[1:3].sum(axis=0) + 0.1 * u[0], x[0],
                                0.9 * x[2] + 0.1 * u[1], x[3] - 0.1 * x[0:4].sum(axis=0)]),
        lambda x, u: torch.stack([0.4 * x[1:3].sum(dim=0) + 0.1 * u[0], x[0],
                                  0.9 * x[2] + 0.1 * u[1], x[3] - 0.1 * torch.sum(x[0:4], 0)]),
        4, 2, (0.1, 0.2, 0.3, 0.4), 1.0),
    "a tensor exponent": (
        lambda x, u: jnp.stack([(jnp.abs(x[0]) + 0.5) ** x[1], 0.5 * jnp.tanh(x[1] + u[0])]),
        lambda x, u: torch.stack([(torch.abs(x[0]) + 0.5) ** x[1], 0.5 * torch.tanh(x[1] + u[0])]),
        2, 1, (0.7, 0.2), 1.0),
    "a tensor bound": (
        lambda x, u: jnp.stack([jnp.clip(x[0] + 0.1 * u[0], None, x[1]), x[1] + 0.05 * u[0]]),
        lambda x, u: torch.stack([torch.clip(x[0] + 0.1 * u[0], None, x[1]),
                                  x[1] + 0.05 * u[0]]),
        2, 1, (0.0, 0.3), 1.0),
    "a 0-d constant": (
        lambda x, u: jnp.stack([x[0] * jnp.array(0.75) + 0.1 * u[0]]),
        lambda x, u: torch.stack([x[0] * torch.tensor(0.75) + 0.1 * u[0]]),
        1, 1, (0.5,), 1.0),
    "sign, square, sinh, hypot, sigmoid, //": (
        lambda x, u: jnp.stack([
            0.5 * jax.nn.sigmoid(x[0]) + 0.1 * jnp.sign(u[0]) + 0.05 * jnp.sinh(x[1]),
            0.25 * jnp.hypot(x[1], u[1]) - 0.01 * jnp.square(x[0]) + 0.01 * (u[0] // 0.3)]),
        lambda x, u: torch.stack([
            0.5 * torch.sigmoid(x[0]) + 0.1 * torch.sign(u[0]) + 0.05 * torch.sinh(x[1]),
            0.25 * torch.hypot(x[1], u[1]) - 0.01 * torch.square(x[0]) + 0.01 * (u[0] // 0.3)]),
        2, 2, (0.1, 0.2), 1.0),
    "an indexed write (select_scatter)": (
        lambda x, u: (x + 0.1 * u[0]).at[1].set(x[1] % 6.28),
        lambda x, u: torch.select_scatter(x + 0.1 * u[0], x[1] % 6.28, 0, 1),
        2, 1, (0.5, 6.0), 1.0),
    "an indexed write (index_put)": (
        lambda x, u: (x + 0.1 * u[0]).at[1].set(x[1] % 6.28),
        lambda x, u: (x + 0.1 * u[0]).index_put((torch.tensor([1]),), x[1] % 6.28),
        2, 1, (0.5, 6.0), 1.0),
    "an indexed write (slice_scatter)": (
        lambda x, u: (x + 0.1 * u[0]).at[1].set(x[1] % 6.28),
        lambda x, u: torch.slice_scatter(x + 0.1 * u[0], x[1:2] % 6.28, 0, 1, 2),
        2, 1, (0.5, 6.0), 1.0),
    "blocks_step": (_j_blocks_step, cs.blocks_step, 8, 8, cs.BLOCKS_X0, 1.0),
    "car_whole_state_step": (
        functools.partial(_j_car_whole_state_step, dt=15.0 / N),
        functools.partial(cs.car_whole_state_step, dt=15.0 / N), 4, 2, tuple(X0), None),
}


def _form(name, n=N, a=A, seed=3):
    """(jnp step, torch step, d, m, x0, u (a, n, m)) in float64."""
    jstep, step, d, m, x0, scale = FORMS[name]
    if scale is None:
        u = _car_cands(n, a, seed)
    else:
        u = np.random.default_rng(seed).normal(size=(a, n, m)) * scale
    return jstep, step, d, m, np.array(x0, dtype=np.float64), u


@pytest.mark.parametrize("name", FORMS)
def test_matches_pallas_interpret_in_f32(name):
    jstep, step, d, m, x0, u = _form(name)
    x0, u = x0.astype(np.float32), u.astype(np.float32)
    roll = make_pallas_linesearch_rollout(jstep, N, d, m, A, interpret=True)
    pallas = np.asarray(roll(jnp.asarray(x0), jnp.asarray(u)))
    xs = fr.make_fused_linesearch_rollout(step, N, d, m, A, device="cpu")(
        torch.tensor(x0), torch.tensor(u))
    assert xs.shape == (A, N, d) and xs.dtype == torch.float32
    assert bool(torch.isfinite(xs).all())
    assert np.abs(xs.numpy() - pallas).max() < 1e-5


@pytest.mark.parametrize("name", FORMS)
def test_plain_version_matches_xla_in_f64(name):
    jstep, step, d, m, x0, u = _form(name)
    want = np.asarray(linesearch_rollout_xla(jstep, jnp.asarray(x0), jnp.asarray(u), unroll=1))
    got = fr.linesearch_rollout_reference(step, torch.tensor(x0), torch.tensor(u))
    assert got.shape == (A, N, d)
    assert float(np.abs(got.numpy() - want).max()) < 1e-12


@pytest.mark.parametrize("name", FORMS)
def test_fleet_is_its_single_calls(name):
    """F instances, each from its own x0 with its own candidates, NaN
    controls in instance 1: each row of the fleet call is its single
    call's, NaN positions included; one candidate alone is its row of a
    line search (the plain version's two-column floor)."""
    F, n, a = 3, 25, 7
    rows = [_form(name, n, a, seed=10 + f) for f in range(F)]
    step, d, m = rows[0][1], rows[0][2], rows[0][3]
    x0s = torch.tensor(np.stack([r[4] + 0.05 * f for f, r in enumerate(rows)]),
                       dtype=torch.float32)
    u = torch.tensor(np.stack([r[5] for r in rows]), dtype=torch.float32)
    u[1, :2, 5, 0] = float("nan")
    roll = fr.make_fused_linesearch_rollout(step, n, d, m, a, device="cpu")
    xs = roll(x0s, u)
    assert xs.shape == (F, a, n, d)
    for f in range(F):
        one = roll(x0s[f], u[f])
        assert torch.equal(torch.isnan(xs[f]), torch.isnan(one))
        assert torch.equal(torch.nan_to_num(xs[f], nan=7.0), torch.nan_to_num(one, nan=7.0))
    single = fr.linesearch_rollout_reference(step, x0s[0], u[0, :1].contiguous())
    assert torch.equal(single, xs[0, :1])


@functools.cache
def _host_program(name: str, directory: str):
    """The form's emitted source and the staged test's harness compiled by
    the host's C++ compiler (no FMA contraction)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emitted program with")
    _, step, d, m, _, _ = _form(name)
    tag = "".join(c if c.isalnum() else "_" for c in name)
    src, lib = f"{directory}/{tag}.cpp", f"{directory}/lib{tag}.so"
    with open(src, "w") as f:
        f.write(emit_step(step, d, m).source + HARNESS)
    proc = subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                           src, "-o", lib], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    dll = ctypes.CDLL(lib)
    dll.serial_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    dll.staged_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    return dll


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("block_ops"))


@pytest.mark.parametrize("name", FORMS)
def test_staged_program_is_the_serial_step(name, build_dir):
    """Chunks of 16 over N = 70, 3 candidates, NaN controls in one: the
    staged program's trajectories are the serial step's bit for bit, and
    the serial step's within 1e-6 relative of the plain version's (the
    host's libm and torch's CPU kernels differ by ulps)."""
    jstep, step, d, m, x0, _ = _form(name)
    generated = emit_step(step, d, m)
    dll = _host_program(name, build_dir)
    R, a, n, chunk = 1, 3, 70, 16
    threads = 32 * max(1, generated.plan.most_chains)
    u = _form(name, n, a, seed=5)[5].astype(np.float32)[None]
    x0s = x0.astype(np.float32)[None].copy()
    serial = np.full((R, a, n, d), 7.0, np.float32)
    staged = serial.copy()
    ptr = lambda t: t.ctypes.data  # noqa: E731
    dll.serial_host(ptr(x0s), ptr(u), ptr(serial), R, a, n)
    dll.staged_host(ptr(x0s), ptr(u), ptr(staged), R, a, n, chunk, threads)
    want = fr.linesearch_rollout_reference(step, torch.tensor(x0s[0]), torch.tensor(u[0])).numpy()
    assert np.abs(serial[0] - want).max() <= 1e-6 * max(1.0, float(np.abs(want).max()))
    u[0, a - 1, n // 3, :] = np.nan
    dll.serial_host(ptr(x0s), ptr(u), ptr(serial), R, a, n)
    dll.staged_host(ptr(x0s), ptr(u), ptr(staged), R, a, n, chunk, threads)
    assert np.array_equal(np.isnan(serial), np.isnan(staged))
    fin = ~np.isnan(serial)
    assert np.array_equal(serial[fin].view(np.int32), staged[fin].view(np.int32))


def test_car_whole_state_solve_matches_jax_with_its_hook():
    """examples/car_control_bounds.py's constrained solve at N = 60 in f32,
    the line search rolling out the car's step written on the whole state:
    JAX's `ilqr_admm` with the Pallas rollout (interpret mode) of the jnp
    step against the port's with the generated route's rollout (its plain
    version here). The same stop and outer iterations, the cost within
    1e-3 relative, the example's box kept."""
    n, n_alphas = 60, cs.CAR_BOUNDS_ALPHAS
    alphas = (10.0 ** np.linspace(0.0, -5.0, n_alphas)).astype(np.float32)
    jcar = JCarSimple(dt=15.0 / n)
    seq = np.zeros(n, dtype=np.int32)
    seq[-1] = 1
    Qs = np.stack([np.zeros((4, 4)), np.eye(4) * 1e2]).astype(np.float32)
    jcost = j_viapoint_cost(jnp.zeros((2, 4), jnp.float32), jnp.asarray(Qs), seq, 1e-2, 2)
    x0, u0 = jnp.asarray(X0, jnp.float32), jnp.zeros((n, 2), jnp.float32)
    jstep = functools.partial(_j_car_whole_state_step, dt=15.0 / n)
    want = jia.ilqr_admm(
        jcar.step_unwrapped, jcar.get_AB, jcost, j_rollout(jcar.step_unwrapped, x0, u0), u0,
        quad_cost=jcost, project_u=lambda v: j_project_bound(v, -0.5, 0.5),
        alphas=jnp.asarray(alphas),
        linesearch_rollout=make_pallas_linesearch_rollout(jstep, n, 4, 2, n_alphas,
                                                          interpret=True),
        **cs.CAR_BOUNDS_SOLVE)
    p = cs.car_bounds_problem("cpu", horizon=n)
    p["alphas"] = torch.tensor(alphas)
    step = functools.partial(cs.car_whole_state_step, dt=15.0 / n)
    roll = fr.make_fused_linesearch_rollout(step, n, 4, 2, n_alphas, device="cpu")
    assert roll.route.generated.plan.chains == (((3,),), ((2,),), ((0,), (1,)))
    got = cs.car_bounds_solve(p, roll)
    assert got.status == int(want.status) and got.outer_iters == int(want.outer_iters)
    assert abs(float(got.cost) - float(want.cost)) <= 1e-3 * abs(float(want.cost))
    assert float(got.u_nom.abs().max()) <= 0.5


def test_callable_plant_without_step_cols_rolls_out_its_call():
    """make_pallas_linesearch_rollout(jcar, ...) calls the plant (its
    `step`, the theta wrap included) on columns; so does the port for a
    callable plant without step_cols, in f32 within 1e-5 of the Pallas
    kernel (interpret mode), and its route is the plant's own call."""
    car, jcar = CarSimple(dt=0.25), JCarSimple(dt=0.25)
    x0 = X0.astype(np.float32)
    u = _car_cands(N, A).astype(np.float32)
    pallas = np.asarray(make_pallas_linesearch_rollout(jcar, N, 4, 2, A, interpret=True)(
        jnp.asarray(x0), jnp.asarray(u)))
    roll = fr.make_fused_linesearch_rollout(car, N, 4, 2, A, device="cpu")
    assert roll.route.step_cols is car and roll.route.car is None
    assert "remainder" in roll.route.generated.ops
    xs = roll(torch.tensor(x0), torch.tensor(u))
    assert np.abs(xs.numpy() - pallas).max() < 1e-5
    assert torch.equal(fr.linesearch_rollout(car, torch.tensor(x0), torch.tensor(u)), xs)


def _src(fn, d=1, m=1):
    return emit_step(fn, d, m).source.split("rollout_step(")[1]


def test_emitter_writes_atens_arithmetic_for_the_new_ops():
    """A block lowered row by row; a 0-d CPU tensor as the number ATen
    takes (its divisor's reciprocal, pow's special exponents); floor and
    trunc division by a number through its f32 reciprocal, by 0 a product
    by inf; a row exponent, a number base and row bounds as ATen's
    tensor kernels; a one-sided row bound as maximum / minimum; a sum in
    ATen's fold order; masks as 0/1 floats under `where`."""
    inv = f32_literal(float(np.float32(1.0) / np.float32(0.3)))
    s = _src(lambda x, u: torch.stack([x[0] // 0.3, x[0] // 0.0]), 2)
    assert f"ro_div_floor_scalar(x[0], {f32_literal(0.3)}, {inv})" in s
    assert "ro_mul(x[0], INFINITY)" in s
    assert f"truncf(ro_mul(x[0], {inv}))" in _src(
        lambda x, u: torch.stack([torch.div(x[0], 0.3, rounding_mode="trunc")]))
    assert "ro_div_floor(x[0], u[0])" in _src(lambda x, u: torch.stack([x[0] // u[0]]))
    third = f32_literal(float(np.float32(1.0) / np.float32(3.0)))
    assert f"ro_mul(x[0], {third})" in _src(lambda x, u: torch.stack([x[0] / torch.tensor(3.0)]))
    assert "ro_square(x[0])" in _src(lambda x, u: torch.stack([x[0] ** torch.tensor(2.0)]))
    assert "sqrtf(x[0])" in _src(lambda x, u: torch.stack([x[0] ** torch.tensor(0.5)]))
    assert "powf(x[0], u[0])" in _src(lambda x, u: torch.stack([x[0] ** u[0]]))
    assert f"powf({f32_literal(2.0)}, x[0])" in _src(lambda x, u: torch.stack([2.0 ** x[0]]))
    assert f"out[0] = {f32_literal(1.0)}" in _src(lambda x, u: torch.stack([1.0 ** x[0]]))
    assert "ro_clamp_rows(x[0], u[0], x[1])" in _src(
        lambda x, u: torch.stack([torch.clamp(x[0], u[0], x[1]), x[1]]), 2)
    assert "ro_maximum(x[0], u[0])" in _src(lambda x, u: torch.stack([torch.clamp(x[0], min=u[0])]))
    s = _src(lambda x, u: torch.stack([x[1:4].sum(dim=0)] * 4), 4)
    assert f"ro_fold<ro_sum_op>({f32_literal(0.0)}, x[1], x[2], x[3])" in s
    s = _src(lambda x, u: torch.stack([torch.where((x[0] > 1.0) & ~(u[0] == x[0]), x[0], 2.0)]))
    assert "ro_gt(x[0], " in s and "ro_eq(u[0], x[0])" in s and "ro_not(v1)" in s
    assert "ro_and(v0, v2)" in s and f"ro_where(v3, x[0], {f32_literal(2.0)})" in s
    whole = emit_step(lambda x, u: x * 2.0 + 0.5 * u[0], 2, 1)

    def written(x, u):  # the same rows, one at a time
        c = 0.5 * u[0]
        return torch.stack([x[0] * 2.0 + c, x[1] * 2.0 + c])

    rows = emit_step(written, 2, 1)
    assert sorted(whole.source.count(f"{fn}(") for fn in ("ro_mul", "ro_add")) == \
        sorted(rows.source.count(f"{fn}(") for fn in ("ro_mul", "ro_add"))
    assert whole.n_ops == rows.n_ops == 5 and whole.chain == rows.chain
    assert whole.plan.chains == rows.plan.chains and whole.plan.arrays == rows.plan.arrays


def test_chain_counts_compares_selects_and_reductions():
    """`where(x[1] > c, c, x[1] + dt u[0])`: the compare and the select on
    x[1]'s cycle (2 operations); a sum of three rows, the operations on its
    longest path through ATen's fold (its first element: the identity's
    add and three combines)."""
    g = emit_step(lambda x, u: torch.stack([x[0], torch.where(x[1] > 1.0, 1.0,
                                                              x[1] + 0.01 * u[0])]), 2, 1)
    assert g.chain == 2.0 and g.plan.cycle_ops[(1,)] == ("gt", "add", "where")
    g = emit_step(lambda x, u: torch.stack([x[0:3].sum(dim=0), x[1], x[2]]), 3, 1)
    assert g.chain == 4.0
    assert emit_step(cs.car_whole_state_step, 4, 2).chain == 1.0


# sha256 of each earlier step's emitted source past the prelude, as the
# generated route emitted it before PR 25
EARLIER_SOURCES = {
    "ops 1-ary 0": "d36f781f4f0dc5c5", "ops 1-ary 1": "94ed8c8e5f95924f",
    "ops 1-ary 2": "375b10e947697227", "ops 1-ary 3": "70225a8fd1698445",
    "ops 1-ary 4": "33cda97193b9b25f", "ops 2-ary 0": "2c54f6526c62b704",
    "ops 2-ary 1": "3fd24928b8413d58", "CarSimple.step_unwrapped": "ce41740b29b4c7f8",
    "CarSimple.step": "233cc310d9c18bac", "CarFrontWheel.step_cols, generated": "63d3227c9d3ca9b0",
    "eight_state_step": "764c033f011bdbea", "cycles_step": "5c50a506685e9c0c",
}


@pytest.mark.parametrize("name", EARLIER_SOURCES)
def test_earlier_steps_keep_their_source(name):
    """A step the port took before keeps its emitted step and staged
    program (only the prelude grew), so its plan and bits stay."""
    source = dict(cs.generated_steps())[name][1].source
    assert source.startswith(PRELUDE)
    assert hashlib.sha256(source[len(PRELUDE):].encode()).hexdigest()[:16] == \
        EARLIER_SOURCES[name]


def test_known_differences_sign_of_nan_and_negative_zero():
    """torch.sign gives +0.0 for NaN and for -0.0 (ATen's (0 < a) - (a < 0),
    which the kernel writes too); jnp.sign gives NaN and -0.0. A step that
    feeds sign a NaN or a -0.0 rolls out apart from JAX's there."""
    v = np.array([np.nan, -0.0], np.float32)
    t = torch.sign(torch.tensor(v)).numpy()
    j = np.asarray(jnp.sign(jnp.asarray(v)))
    assert t[0] == 0.0 and not np.signbit(t[1]) and t[1] == 0.0
    assert np.isnan(j[0]) and np.signbit(j[1])


def test_known_difference_out_of_range_index():
    """jnp clamps an index out of range, so the Pallas rollout runs x[4] at
    d = 4 as x[3]; the port refuses it at build."""
    u = _car_cands(10, 4).astype(np.float32)
    x0 = X0.astype(np.float32)
    pallas = np.asarray(make_pallas_linesearch_rollout(
        lambda x, u: jnp.stack([x[4], x[1], x[2], x[3]]), 10, 4, 2, 4, interpret=True)(
            jnp.asarray(x0), jnp.asarray(u)))
    assert np.array_equal(pallas[:, 1, 0], np.full(4, x0[3]))
    with pytest.raises(ValueError, match="out of range"):
        fr.make_fused_linesearch_rollout(lambda x, u: torch.stack([x[4], x[1], x[2], x[3]]),
                                         10, 4, 2, 4, device="cpu")
