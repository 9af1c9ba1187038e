"""Port vs JAX package: the line-search rollout for any plant's step_cols.

`ops/fused_rollout.py` takes what `make_pallas_linesearch_rollout` takes:
a `step_cols` callable or a plant. CarFrontWheel keeps its staged kernel;
every other step takes the generated route, whose step
`ops/rollout_codegen.py` traces and emits as C++. On CPU tensors the
rollout runs its plain version for any step, so these tests hold that
plain version to the JAX package: to the Pallas kernel in interpret mode
at 1e-5 in f32, and to `linesearch_rollout_xla` at 1e-12 in f64 (`tests/test_torch_fused_rollout.py`'s
conventions), for CarSimple and for two d = m = 8 plants written in both
frameworks (`chip_smoke.eight_state_step` and `_j_eight_state_step`
here, over the op table; `chip_smoke.cycles_step` and `_j_cycles_step`,
over the stage plan's cases: a rotation, a pendulum, a copied row, a
swapped pair, a constant row and a control row); the fleet form to its
single calls; and
`examples/car_control_bounds.py`'s constrained solve through JAX's and the
port's hooks at N = 60 (the same stop and outer iterations, the cost
within 1e-3 relative). The emitted step is compiled for the host by g++
and held to the plain version a step at a time, at 1e-6 relative (the
host's libm and torch's CPU kernels differ by ulps). Every refusal raises
when the rollout is built, on the CPU as on the card. The staged
program the kernel runs is held to `rollout_step` bit for bit on the
host by tests/test_torch_rollout_staged.py; the CUDA kernel itself to the
plain version bit for bit on the card by `chip_smoke.py`.
"""

import ctypes
import importlib
import math
import shutil
import subprocess

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke as cs
from ilqr_admm_tpu.models.car import CarSimple as JCarSimple
from ilqr_admm_tpu.ops.pallas_rollout import linesearch_rollout_xla, make_pallas_linesearch_rollout
from ilqr_admm_tpu.ops.rollout import rollout_nonlinear as j_rollout
from ilqr_admm_tpu.projections import project_bound as j_project_bound
from ilqr_admm_tpu.utils.cost_assembly import viapoint_cost as j_viapoint_cost
from ilqr_admm_tpu_torch.models.car import CarFrontWheel, CarSimple
from ilqr_admm_tpu_torch.models.double_integrator import DoubleIntegrator
from ilqr_admm_tpu_torch.ops import fused_rollout as fr
from ilqr_admm_tpu_torch.ops.rollout_codegen import emit_step, f32_literal

torch.set_num_threads(2)
# the JAX package's solvers/__init__ rebinds the module name to the function
jia = importlib.import_module("ilqr_admm_tpu.solvers.ilqr_admm")

X0 = np.array([1.0, 1.0, 3.0 * np.pi / 2, 0.0])
N, A = 60, 10


def _j_eight_state_step(x, u):
    """`chip_smoke.eight_state_step` in jnp."""
    dt = cs.EIGHT_DT
    speed = jnp.tanh(u[0])
    return jnp.stack([
        x[0] + dt * speed * jnp.cos(x[2]),
        x[1] + dt * speed * jnp.sin(x[2]),
        (x[2] + dt * jnp.arctan(u[1])) % (2.0 * math.pi),
        0.9 * x[3] + 0.1 * jnp.arctan2(u[2], 1.0 + jnp.abs(u[3])),
        jnp.clip(x[4] + dt * u[4], -0.5, 0.5),
        0.5 * jnp.sqrt(x[5] ** 2 + 0.01) + 0.1 * jnp.exp(-jnp.abs(u[5])),
        jnp.maximum(jnp.minimum(x[6] + dt * jnp.log(1.0 + u[6] ** 2), 1.0 + x[5]), -1.0 - x[5]),
        jnp.arccos(jnp.clip(0.5 * jnp.cos(x[7]) + 0.1 * jnp.tanh(u[7]), -1.0, 1.0)) / 3.0
        + 0.01 * jnp.tan(0.1 * x[3]) - dt * (1.0 + x[4] ** 2) ** -2
        + 0.01 * (2.0 - x[5]) ** 3 + 0.01 * (3.0 / (1.0 + x[5])) + 0.001 * x[5] ** 0.5
        + 0.001 * (x[5] + 0.1) ** 1.5 + 0.001 * (x[5] + 1.0) ** -0.5
        - 0.001 * (1.0 + x[5]) ** -1 + 0.001 * x[0] / (1.0 + x[1] ** 2),
    ])


def _j_cycles_step(x, u):
    """`chip_smoke.cycles_step` in jnp."""
    dt, c, s = cs.EIGHT_DT, cs.CYCLES_COS, cs.CYCLES_SIN
    return jnp.stack([
        c * x[0] - s * x[1] + dt * u[0],
        s * x[0] + c * x[1] + dt * u[1],
        x[2] - dt * jnp.sin(x[2]) + dt * (u[2] + u[4] * u[5]),
        x[0],
        x[5],
        x[4],
        jnp.full_like(x[0], 0.25),
        u[7],
    ])


def _car_cands(n, a, seed=2):
    delta = np.random.default_rng(seed).normal(size=(n, 2)) * 0.5
    alphas = 10.0 ** np.linspace(0.0, -5.0, max(50, a))[:a]
    return alphas[:, None, None] * delta[None]


def _plant(name, n=N, a=A, seed=2):
    """(JAX step, port step, d, m, x0, u (a, n, m)) in float64."""
    if name == "eight_state_step":
        u = np.random.default_rng(seed).normal(size=(a, n, 8))
        return _j_eight_state_step, cs.eight_state_step, 8, 8, np.array(cs.EIGHT_X0), u
    if name == "cycles_step":
        u = np.random.default_rng(seed).normal(size=(a, n, 8))
        return _j_cycles_step, cs.cycles_step, 8, 8, np.array(cs.CYCLES_X0), u
    method = name.split(".")[1]
    jcar, car = JCarSimple(dt=15.0 / n), CarSimple(dt=15.0 / n)
    return getattr(jcar, method), getattr(car, method), 4, 2, X0, _car_cands(n, a, seed)


PLANTS = ("CarSimple.step_unwrapped", "CarSimple.step", "eight_state_step", "cycles_step")


@pytest.mark.parametrize("which", ["step_unwrapped", "step"])
def test_cpu_takes_any_plant(which):
    """On the CPU the factory and the wrapper take CarSimple's steps (the
    generated route; before, every plant but CarFrontWheel raised), and run
    the plain version: no launch."""
    car = CarSimple(dt=0.5)
    step = getattr(car, which)
    x0 = torch.tensor(X0, dtype=torch.float32)
    u = torch.tensor(_car_cands(30, 6), dtype=torch.float32)
    before = (fr.launch_count, fr.generated_launch_count)
    roll = fr.make_fused_linesearch_rollout(step, 30, 4, 2, 6, device="cpu")
    assert roll.route.car is None and roll.route.generated.d == 4
    xs = roll(x0, u)
    want = fr.linesearch_rollout_reference(step, x0, u)
    assert xs.shape == (6, 30, 4) and torch.equal(xs, want)
    assert torch.equal(fr.linesearch_rollout(step, x0, u), want)
    assert (fr.launch_count, fr.generated_launch_count) == before


@pytest.mark.parametrize("name", PLANTS)
def test_matches_pallas_interpret_in_f32(name):
    jstep, step, d, m, x0, u = _plant(name)
    x0, u = x0.astype(np.float32), u.astype(np.float32)
    roll = make_pallas_linesearch_rollout(jstep, N, d, m, A, interpret=True)
    pallas = np.asarray(roll(jnp.asarray(x0), jnp.asarray(u)))
    xs = fr.make_fused_linesearch_rollout(step, N, d, m, A, device="cpu")(
        torch.tensor(x0), torch.tensor(u))
    assert xs.shape == (A, N, d) and xs.dtype == torch.float32
    assert bool(torch.isfinite(xs).all())
    assert np.abs(xs.numpy() - pallas).max() < 1e-5


@pytest.mark.parametrize("name", PLANTS)
def test_plain_version_matches_xla_in_f64(name):
    jstep, step, d, m, x0, u = _plant(name)
    want = np.asarray(linesearch_rollout_xla(jstep, jnp.asarray(x0), jnp.asarray(u), unroll=1))
    got = fr.linesearch_rollout_reference(step, torch.tensor(x0), torch.tensor(u))
    assert got.shape == (A, N, d)
    assert float(np.abs(got.numpy() - want).max()) < 1e-12


@pytest.mark.parametrize("name", PLANTS)
def test_fleet_is_its_single_calls(name):
    """F instances, each from its own x0 with its own candidates, NaN
    controls in instance 1: each row of the fleet call is its single
    call's, NaN positions included."""
    F, n, a = 3, 25, 7
    rows = [_plant(name, n, a, seed=10 + f) for f in range(F)]
    step, d, m = rows[0][1], rows[0][2], rows[0][3]
    x0s = torch.tensor(np.stack([r[4] + 0.05 * f for f, r in enumerate(rows)]),
                       dtype=torch.float32)
    u = torch.tensor(np.stack([r[5] for r in rows]), dtype=torch.float32)
    u[1, :2, 5, 0] = float("nan")
    roll = fr.make_fused_linesearch_rollout(step, n, d, m, a, device="cpu")
    xs = roll(x0s, u)
    assert xs.shape == (F, a, n, d) and bool(torch.isnan(xs[1, :2, 6:]).any())
    for f in range(F):
        one = roll(x0s[f], u[f])
        assert torch.equal(torch.isnan(xs[f]), torch.isnan(one))
        assert torch.equal(torch.nan_to_num(xs[f], nan=7.0), torch.nan_to_num(one, nan=7.0))


def test_car_control_bounds_solve_matches_jax_with_its_hook():
    """examples/car_control_bounds.py's constrained solve at N = 60 in f32:
    JAX's `ilqr_admm` with the Pallas rollout (interpret mode) of
    CarSimple.step_unwrapped against the port's with the generated route's
    rollout (its plain version here)."""
    n, n_alphas = 60, cs.CAR_BOUNDS_ALPHAS
    alphas = (10.0 ** np.linspace(0.0, -5.0, n_alphas)).astype(np.float32)
    jcar = JCarSimple(dt=15.0 / n)
    seq = np.zeros(n, dtype=np.int32)
    seq[-1] = 1
    Qs = np.stack([np.zeros((4, 4)), np.eye(4) * 1e2]).astype(np.float32)
    jcost = j_viapoint_cost(jnp.zeros((2, 4), jnp.float32), jnp.asarray(Qs), seq, 1e-2, 2)
    x0, u0 = jnp.asarray(X0, jnp.float32), jnp.zeros((n, 2), jnp.float32)
    want = jia.ilqr_admm(
        jcar.step_unwrapped, jcar.get_AB, jcost, j_rollout(jcar.step_unwrapped, x0, u0), u0,
        quad_cost=jcost, project_u=lambda v: j_project_bound(v, -0.5, 0.5),
        alphas=jnp.asarray(alphas),
        linesearch_rollout=make_pallas_linesearch_rollout(jcar.step_unwrapped, n, 4, 2,
                                                          n_alphas, interpret=True),
        **cs.CAR_BOUNDS_SOLVE)
    p = cs.car_bounds_problem("cpu", horizon=n)
    p["alphas"] = torch.tensor(alphas)
    roll = fr.make_fused_linesearch_rollout(p["car"].step_unwrapped, n, 4, 2, n_alphas,
                                            device="cpu")
    got = cs.car_bounds_solve(p, roll)
    assert got.u_nom.dtype == torch.float32
    assert got.status == int(want.status) and got.outer_iters == int(want.outer_iters)
    assert abs(float(got.cost) - float(want.cost)) <= 1e-3 * abs(float(want.cost))
    assert float(got.u_nom.abs().max()) <= 0.5


def _host_step(source, tmp_path):
    """The emitted step compiled by the host's C++ compiler: a callable
    (x (d,), u (m,)) -> (d,) float32."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emitted step with")
    src, lib = tmp_path / "step.cpp", tmp_path / "libstep.so"
    src.write_text(source + '\nextern "C" void rollout_step_host(const float* x, const float* u, '
                            'float* out) { rollout_step(x, u, out); }\n')
    proc = subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                           str(src), "-o", str(lib)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    fn = ctypes.CDLL(str(lib)).rollout_step_host
    fn.argtypes = [ctypes.c_void_p] * 3
    fn.restype = None

    def step(x, u):
        x, u = np.ascontiguousarray(x, np.float32), np.ascontiguousarray(u, np.float32)
        out = np.empty_like(x)
        fn(x.ctypes.data, u.ctypes.data, out.ctypes.data)
        return out

    return step


@pytest.mark.parametrize("name", [*PLANTS, "CarFrontWheel.step_cols"])
def test_emitted_step_compiled_for_the_host_is_the_plain_step(name, tmp_path):
    """Each step of the plain version's f32 trajectory (N = 60), taken by the
    emitted C++ from the same state and controls, within 1e-6 relative."""
    if name == "CarFrontWheel.step_cols":
        step, d, m, x0, u = CarFrontWheel(dt=15.0 / N).step_cols, 4, 2, X0, _car_cands(N, A)
    else:
        _, step, d, m, x0, u = _plant(name)
    xs = fr.linesearch_rollout_reference(step, torch.tensor(x0, dtype=torch.float32),
                                         torch.tensor(u, dtype=torch.float32)).numpy()
    host = _host_step(emit_step(step, d, m).source, tmp_path)
    u = u.astype(np.float32)
    worst = 0.0
    for a in range(A):
        for t in range(N - 1):
            got, want = host(xs[a, t], u[a, t]), xs[a, t + 1]
            worst = max(worst, float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max()))
    assert worst <= 1e-6, worst


def _inplace_add(x, u):
    return torch.stack([x[0].add_(1.0)])


def _set_row(x, u):
    x[0] = u[0]
    return x


def _add_alpha(x, u):
    return torch.stack([torch.add(x[0], u[0], alpha=2.0)])


_VECTOR = torch.tensor([1.0, 2.0])

REFUSALS = {
    "d > 8": (CarSimple().step_unwrapped, 9, 2, 8, r"dims 1\.\.8"),
    "m > 8": (CarSimple().step_unwrapped, 4, 9, 8, r"dims 1\.\.8"),
    "A > 128": (CarSimple().step_unwrapped, 4, 2, 129, "n_alphas=129"),
    "a branch on a value": (lambda x, u: x if x[0] > 0 else -x, 4, 2, 8, "branches on a value"),
    "an in-place write": (_set_row, 4, 2, 8, r"in place \(`__setitem__`\)"),
    "an in-place op": (_inplace_add, 1, 1, 8, r"in place \(`add_`\)"),
    "matmul": (DoubleIntegrator(1, 2, dt=0.1).step, 2, 1, 8, "`matmul`"),
    "an op outside the table": (lambda x, u: torch.stack([torch.erf(x[0])]), 1, 1, 8, "`erf`"),
    "an index out of range": (lambda x, u: torch.stack([x[4]]), 4, 2, 8, "out of range"),
    "a sum over the candidates too": (lambda x, u: torch.stack([x[1:3].sum()]), 4, 2, 8,
                                      "over every dim: it would reduce over the candidates"),
    "a sum over the candidates' axis": (lambda x, u: torch.stack([x[1:3].sum(dim=1)]), 4, 2, 8,
                                        "dim 1 is the candidates'"),
    "a sum of a row": (lambda x, u: torch.stack([x[0].sum(dim=0)]), 1, 1, 8,
                       r"of a row \(A,\)"),
    "a closed-over vector constant": (lambda x, u: torch.stack([x[0] * _VECTOR[0] + _VECTOR]),
                                      1, 1, 8, r"tensor constant of shape \(2,\)"),
    "add with alpha": (_add_alpha, 1, 1, 8, "alpha"),
    "a step that returns a mask": (lambda x, u: torch.stack([x[0] > 0.0]), 1, 1, 8,
                                   "returns a mask"),
    "arithmetic on a mask": (lambda x, u: torch.stack([(x[0] > 0.0) * 2.0]), 1, 1, 8,
                             "`mul` of a mask"),
    "a 0-d tensor clamp bound": (lambda x, u: torch.stack([torch.clamp(x[0], torch.tensor(0.0),
                                                                       torch.tensor(1.0))]),
                                 1, 1, 8, "0-d tensor bound"),
    "clamp with a number and a row": (
        lambda x, u: torch.stack([torch.clamp(x[0], -1.0, x[1]), x[1]]), 2, 1, 8,
        "a number and a row as its bounds"),
    "too few rows": (lambda x, u: torch.stack([x[0], x[1]]), 4, 2, 8, "returns 2 rows, d = 4"),
}


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_raise_at_build(case):
    step, d, m, n_alphas, match = REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        fr.make_fused_linesearch_rollout(step, 10, d, m, n_alphas, device="cpu")


# what the port refused before PR 25 and now takes, as the Pallas rollout
# does: each case, its dims and the table's op that it uses
ACCEPTED = {
    "an op outside the table": (lambda x, u: torch.stack([torch.sinh(x[0])]), 1, 1, "sinh"),
    "a comparison": (lambda x, u: torch.stack([torch.where(x[0] > 0, x[0], u[0])]), 1, 1,
                     "gt"),
    "a tensor constant": (lambda x, u: torch.stack([x[0] * torch.tensor(2.0)]), 1, 1, "mul"),
    "an op on the whole state": (lambda x, u: x * 2.0, 4, 2, "mul"),
    "a tensor exponent": (lambda x, u: torch.stack([x[0] ** x[1], x[1]]), 2, 1, "pow"),
    "a tensor clamp bound": (lambda x, u: torch.stack([torch.clamp(x[0], max=x[1]), x[1]]), 2, 1,
                             "minimum"),
}


@pytest.mark.parametrize("case", ACCEPTED)
def test_former_refusals_are_taken(case):
    """Built on the CPU as on the card (the same trace), and rolled out:
    its plain version, finite from a finite start."""
    step, d, m, op = ACCEPTED[case]
    roll = fr.make_fused_linesearch_rollout(step, 10, d, m, 8, device="cpu")
    assert op in roll.route.generated.ops
    xs = roll(torch.full((d,), 0.5), torch.full((8, 10, m), 0.25))
    assert xs.shape == (8, 10, d) and bool(torch.isfinite(xs).all())


def test_emitter_writes_atens_arithmetic():
    """Scalars as ATen rounds them, division by a number as a product by
    its f32 reciprocal, s / x as reciprocal(x) * s, pow's special
    exponents, and the loop-carried chains of the plants."""
    def src(fn, d=1, m=1):
        return emit_step(fn, d, m).source.split("rollout_step(")[1]

    third = f32_literal(float(np.float32(1.0) / np.float32(3.0)))
    assert f"ro_mul(x[0], {third})" in src(lambda x, u: torch.stack([x[0] / 3.0]))
    s = src(lambda x, u: torch.stack([3.0 / x[0]]))
    assert "ro_reciprocal(x[0])" in s and f32_literal(3.0) in s and "ro_div" not in s
    assert "ro_div(x[0], u[0])" in src(lambda x, u: torch.stack([x[0] / u[0]]))
    for exponent, fn in ((2, "ro_square"), (3, "ro_cube"), (-2, "ro_inv_square"),
                         (0.5, "sqrtf"), (-0.5, "ro_rsqrt"), (-1, "ro_reciprocal"),
                         (2.5, "powf")):
        assert f"{fn}(x[0]" in src(lambda x, u, e=exponent: torch.stack([x[0] ** e])), exponent
    assert f"out[0] = {f32_literal(1.0)}" in src(lambda x, u: torch.stack([x[0] ** 0]))
    assert "out[0] = x[0]" in src(lambda x, u: torch.stack([x[0] ** 1]))
    s = src(CarSimple(dt=0.03).step, 4, 2)
    assert f32_literal(0.03) in s and f"ro_remainder(v10, {f32_literal(2.0 * math.pi)})" in s
    assert f32_literal(0.03) == "0x1.eb851e0000000p-6f"
    assert f32_literal(-0.0) == "(-0x0.0p+0f)" and f32_literal(float("inf")) == "INFINITY"
    chains = {"CarSimple.step_unwrapped": (CarSimple().step_unwrapped, 1.0),
              "CarSimple.step": (CarSimple().step, 2.0),
              "CarFrontWheel.step_cols": (CarFrontWheel().step_cols, 1.0)}
    for label, (step, chain) in chains.items():
        assert emit_step(step, 4, 2).chain == chain, label
    assert emit_step(lambda x, u: torch.stack([torch.sin(u[0])]), 1, 1).chain == 0.0


def test_routes():
    """CarFrontWheel (the plant, its bound step_cols and step) keeps the
    staged kernel; any other step, the car's step as a plain function
    included, takes the generated route; so does a callable plant without
    step_cols (CarSimple: its `__call__`, as JAX's builder calls it), and
    one whose call the emitter does not take (DoubleIntegrator's `A @ x`)
    raises ValueError at build, as the Pallas call refuses it; an object
    that is neither a callable nor a plant with step_cols raises TypeError."""
    car = CarFrontWheel()
    for step in (car, car.step_cols, car.step):
        route = fr.step_route(step)
        assert route.car is car and route.generated is None
    assert fr.step_route(lambda x, u: car.step_cols(x, u)).car is None
    simple = CarSimple()
    assert fr.step_route(simple.step).step_cols == simple.step
    assert fr.step_route(simple).step_cols is simple
    roll = fr.make_fused_linesearch_rollout(simple, 10, 4, 2, 8, device="cpu")
    assert roll.route.car is None and roll.route.generated.ops[-1] == "remainder"
    x0, u = torch.zeros(4), torch.zeros(8, 10, 2)
    assert torch.equal(fr.linesearch_rollout(simple, x0, u), roll(x0, u))
    with pytest.raises(ValueError, match="`matmul`"):
        fr.make_fused_linesearch_rollout(DoubleIntegrator(1, 2, dt=0.1), 10, 2, 1, 8,
                                         device="cpu")
    assert fr.make_fused_linesearch_rollout(car, 10, 4, 2, 8, device="cpu").route.car is car
    with pytest.raises(ValueError, match="d=4, m=2"):
        fr.make_fused_linesearch_rollout(car.step, 10, 4, 3, 8, device="cpu")
    for thing in (object(), 3.0):
        with pytest.raises(TypeError, match="step_cols callable, a callable plant"):
            fr.make_fused_linesearch_rollout(thing, 10, 4, 2, 8, device="cpu")
        with pytest.raises(TypeError, match="step_cols callable, a callable plant"):
            fr.linesearch_rollout(thing, x0, u)


@pytest.mark.parametrize("fleet", [False, True])
@pytest.mark.parametrize("d", [3, 5])
def test_rollout_holds_x0_to_the_traced_dims(d, fleet):
    """A rollout built for d = 4 and m = 2 refuses an x0 of another width,
    single and fleet, on the CPU as on the card, where its kernel has
    d and m compiled in; so does one whose u_cands has another m."""
    roll = fr.make_fused_linesearch_rollout(CarSimple().step_unwrapped, 10, 4, 2, 8,
                                            device="cpu")
    lead = (3,) if fleet else ()
    with pytest.raises(ValueError, match=r"x0 must be \(4,\) or \(F, 4\)"):
        roll(torch.zeros(*lead, d), torch.zeros(*lead, 8, 10, 2))
    with pytest.raises(ValueError, match="u_cands must be"):
        roll(torch.zeros(*lead, 4), torch.zeros(*lead, 8, 10, d))
    assert roll(torch.zeros(*lead, 4), torch.zeros(*lead, 8, 10, 2)).shape == (*lead, 8, 10, 4)
