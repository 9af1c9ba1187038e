"""Port: the stage plan of the generated rollout kernel, proved on the host.

`ops/rollout_codegen.py` plans every traced step (`StagePlan`): the state
graph's strongly connected components by level, each emitted value stage
0, on a component's cycle or parallel at a level, and the values staged in
shared memory; and it emits the staged program that
`csrc/linesearch_rollout_generic.cuh` runs a phase at a time (a pass over
the chunk's steps on all threads, or a level's chains, one thread each),
a block barrier after each. These tests check the plan of every plant the
card's checks run (CarSimple's two steps, CarFrontWheel's, the op plants,
`chip_smoke.eight_state_step`, `chip_smoke.cycles_step`,
`chip_smoke.blocks_step` and `chip_smoke.car_whole_state_step`) and of a
step too wide to stage. Then they compile the emitted program with g++ (no FMA
contraction, as tests/test_torch_rollout_any_plant.py builds
`rollout_step`) beside a host harness that runs the kernel's loop: each
phase on every thread before the next phase, the chunk's rows of xs last.
Its trajectories must equal the serial `rollout_step` looped over t bit for
bit, NaN positions included: at chunk boundaries (chunks of 16 over N =
70), at N = 1, with NaN controls at the card's chunk for N = 500, and for a
fleet of 3 instances. That is the CPU's proof that the plan drops,
reorders and repeats nothing. The CUDA kernel is held to the plain version
bit for bit on the card by chip_smoke.py.
"""

import ctypes
import functools
import math
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke as cs
from ilqr_admm_tpu_torch.models.car import CarFrontWheel, CarSimple
from ilqr_admm_tpu_torch.ops.rollout_codegen import MAX_ARRAYS, emit_step

torch.set_num_threads(2)

# The host's counterpart of the staged kernel's loop (the template's
# staged_rollout_kernel), and the serial step looped over t (the one-thread
# design). Shared memory is poisoned with NaN before each chunk but for the
# states' carries, so a phase that reads what no earlier phase wrote shows.
HARNESS = r"""
#include <vector>

extern "C" void serial_host(const float* x0s, const float* u, float* xs, int R, int A, int N) {
  for (long b = 0; b < static_cast<long>(R) * A; ++b) {
    float x[ROLLOUT_D], next[ROLLOUT_D];
    for (int k = 0; k < ROLLOUT_D; ++k) x[k] = x0s[(b / A) * ROLLOUT_D + k];
    for (int t = 0; t < N; ++t) {
      for (int k = 0; k < ROLLOUT_D; ++k) xs[(b * N + t) * ROLLOUT_D + k] = x[k];
      if (t + 1 < N) {
        rollout_step(x, u + (b * N + t) * ROLLOUT_M, next);
        for (int k = 0; k < ROLLOUT_D; ++k) x[k] = next[k];
      }
    }
  }
}

extern "C" void staged_host(const float* x0s, const float* u, float* xs, int R, int A, int N,
                            int chunk, int threads) {
  const int row = chunk + 32;
  std::vector<float> shared(ROLLOUT_ARRAYS * row, NAN);
  float* s = shared.data();
  for (long b = 0; b < static_cast<long>(R) * A; ++b) {
    for (int tid = 0; tid < threads; ++tid)
      rollout_init(s, row, x0s + (b / A) * ROLLOUT_D, tid, threads);
    for (int c0 = 0; c0 < N; c0 += chunk) {
      const int len = chunk < N - c0 ? chunk : N - c0;
      for (int a = 0; a < ROLLOUT_ARRAYS; ++a)
        for (int i = a < ROLLOUT_D ? 1 : 0; i < row; ++i) s[a * row + i] = NAN;
      for (int p = 0; p < ROLLOUT_PHASES; ++p)
        for (int tid = 0; tid < threads; ++tid)
          rollout_phase(p, s, row, u + (b * N + c0) * ROLLOUT_M, len, tid, threads);
      for (int tid = 0; tid < threads; ++tid)
        rollout_write(s, row, xs + (b * N + c0) * ROLLOUT_D, len, tid, threads);
    }
  }
}
"""


def wide_step(x, u):
    """A step with more values to stage than MAX_ARRAYS: 300 values of the
    controls alone feed x[0]'s chain, so the plan runs it as one chain."""
    acc = x[0]
    for i in range(300):
        acc = acc + torch.sin(u[0] + 0.01 * i)
    return torch.stack([acc, 0.5 * x[1] + u[1]])


@functools.cache
def _steps() -> dict:
    """name -> (step, GeneratedStep): chip_smoke's generated steps and the
    wide one."""
    steps = dict(cs.generated_steps())
    steps["wide_step"] = (wide_step, emit_step(wide_step, 2, 2))
    return steps


PLANTS = (*cs.generated_steps(), "wide_step")


@functools.cache
def _host_program(name: str, directory: str):
    """The plant's emitted source and HARNESS compiled by the host's C++
    compiler; (serial, staged) entry points."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emitted program with")
    tag = "".join(c if c.isalnum() else "_" for c in name)
    src, lib = f"{directory}/{tag}.cpp", f"{directory}/lib{tag}.so"
    with open(src, "w") as f:
        f.write(_steps()[name][1].source + HARNESS)
    proc = subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                           src, "-o", lib], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    dll = ctypes.CDLL(lib)
    dll.serial_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    dll.staged_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    return dll


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("staged"))


# name -> (R, A, N, chunk, threads; 0: the fewest the plan takes), NaN controls
CASES = {
    "chunks of 16 over N = 70": ((1, 3, 70, 16, 0), True),
    "N = 1": ((1, 2, 1, 32, 0), False),
    "N = 500 at the card's chunk, 256 threads, NaN controls": ((1, 4, 500, 512, 256), True),
    "a fleet of 3, chunks of 32 over N = 45, NaN controls in instance 1": ((3, 2, 45, 32, 0),
                                                                            True),
}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", PLANTS)
def test_staged_program_is_the_serial_step(name, case, build_dir):
    (R, A, N, chunk, threads), nan = CASES[case]
    generated = _steps()[name][1]
    threads = max(threads, 32 * max(1, generated.plan.most_chains))
    dll = _host_program(name, build_dir)
    rng = np.random.default_rng(len(name) * 100 + N)
    x0s = rng.normal(size=(R, generated.d)).astype(np.float32)
    u = rng.normal(size=(R, A, N, generated.m)).astype(np.float32)
    if nan:
        u[R // 2, A - 1, N // 3, :] = np.nan
    serial = np.full((R, A, N, generated.d), 7.0, np.float32)
    staged = serial.copy()
    ptr = lambda a: a.ctypes.data  # noqa: E731
    dll.serial_host(ptr(x0s), ptr(u), ptr(serial), R, A, N)
    dll.staged_host(ptr(x0s), ptr(u), ptr(staged), R, A, N, chunk, threads)
    assert np.array_equal(np.isnan(serial), np.isnan(staged))
    fin = ~np.isnan(serial)
    assert np.array_equal(serial[fin].view(np.int32), staged[fin].view(np.int32)), (
        np.argwhere(serial.view(np.int32) != staged.view(np.int32))[:5])
    if nan and generated.plan.chains:
        assert np.isnan(serial).any()


def _chained(plan) -> dict:
    return {"chains": plan.chains, "cycle_ops": plan.cycle_ops}


ADD = ("add",)
CAR_CHAINS = (((3,),), ((2,),), ((0,), (1,)))
PLANS = {
    # v (x[3]), then the heading x[2], then x[0] and x[1] on two warps
    "CarSimple.step_unwrapped": {"chains": CAR_CHAINS,
                                 "cycle_ops": {(3,): ADD, (2,): ADD, (0,): ADD, (1,): ADD}},
    "CarSimple.step": {"chains": CAR_CHAINS, "cycle_ops": {(3,): ADD, (2,): ("add", "remainder"),
                                                           (0,): ADD, (1,): ADD}},
    # the car's hand staging of csrc/linesearch_rollout.cu: v, then o, then x and y
    "CarFrontWheel.step_cols, generated": {
        "chains": CAR_CHAINS, "cycle_ops": {(3,): ADD, (2,): ADD, (0,): ADD, (1,): ADD}},
    "eight_state_step": {
        "chains": (((2,), (3,), (4,), (5,)), ((0,), (1,), (6,)), ((7,),)),
        "cycle_ops": {(2,): ("add", "remainder"), (3,): ("mul", "add"), (4,): ("add", "clamp"),
                      (5,): ("pow", "add", "sqrt", "mul", "add"), (0,): ADD, (1,): ADD,
                      (6,): ("add", "minimum", "maximum"),
                      (7,): ("cos", "mul", "add", "clamp", "acos", "div", "add", "sub", "add",
                             "add", "add", "add", "add", "sub", "add")}},
    # the car written on the whole state: step_unwrapped's chains
    "car_whole_state_step": {"chains": CAR_CHAINS,
                             "cycle_ops": {(3,): ADD, (2,): ADD, (0,): ADD, (1,): ADD}},
    # a compare and a select on x[0]'s and x[7]'s cycles, a sum on x[1]'s
    "blocks_step": {
        "chains": (((0,), (3,), (4,), (6,)), ((2,), (7,)), ((1,),), ((5,),)),
        "cycle_ops": {(0,): ("add", "gt", "lt", "or", "mul", "where"),
                      (3,): ("abs", "add", "pow", "mul", "add"), (4,): ("add", "fmod"),
                      (6,): ("mul", "add"), (2,): ("add", "clamp", "mul"),
                      (7,): ("ge", "minimum", "add", "mul", "where"),
                      (1,): ("sum", "mul", "add"), (5,): ("mul", "add")}},
    # a rotation, a pendulum with sin on its cycle, a swapped pair of no operation
    "cycles_step": {
        "chains": (((0, 1), (2,), (4, 5)),),
        "cycle_ops": {(0, 1): ("mul", "mul", "sub", "add", "mul", "mul", "add", "add"),
                      (2,): ("sin", "mul", "sub", "add"), (4, 5): ()}},
}


@pytest.mark.parametrize("name", PLANS)
def test_plan_chains(name):
    assert _chained(_steps()[name][1].plan) == PLANS[name]


def test_cycles_step_plan():
    """The copied row is a state of level 1 (a function of the rotation),
    the constant and the control rows states of level 0, none a chain; the
    copy is written by level 1's pass, after the level's chains."""
    plan = _steps()["cycles_step"][1].plan
    assert plan.sccs == ((0, 1), (2,), (4, 5), (6,), (7,), (3,))
    assert plan.cyclic == (True, True, True, False, False, False)
    assert plan.levels == ((0, 1, 2, 3, 4), (5,))
    assert plan.phases == (("pass", 0), ("chains", 0), ("pass", 1))
    assert plan.most_chains == 3 and not plan.serial


@pytest.mark.parametrize("name", [n for n in PLANTS if n.startswith("ops ")])
def test_op_plants_are_stage_0_only(name):
    """No state feedback: one pass, every value stage 0, nothing staged."""
    generated = _steps()[name][1]
    plan = generated.plan
    assert plan.chains == () and plan.phases == (("pass", 0),) and plan.staged == ()
    assert plan.classes == ("stage 0",) * generated.n_ops
    assert plan.arrays == generated.d and not any(plan.cyclic)


def test_car_plan_stages_only_what_crosses_a_phase():
    """CarSimple.step_unwrapped: u[0] (read by level 1's pass), dt x[3] for
    rows 0 and 1 (level 1's pass to level 2's), the chains' addends; cos and
    sin of the heading stay in registers of level 2's pass."""
    generated = _steps()["CarSimple.step_unwrapped"][1]
    plan = generated.plan
    assert plan.staged == ("u[0]", "v0", "v2", "v4", "v6", "v9", "v11")
    assert plan.classes == (("parallel", 0), ("parallel", 1), ("parallel", 1), ("cycle", 2),
                            ("parallel", 0), ("parallel", 1), ("parallel", 1), ("cycle", 3),
                            ("parallel", 0), ("parallel", 0), ("cycle", 1), "stage 0",
                            ("cycle", 0))
    assert plan.arrays == 4 + len(plan.staged)


def test_wide_step_runs_as_one_chain():
    """No refusal: a step whose plan would stage more than MAX_ARRAYS
    values is planned as one chain over all its states (the serial plan),
    staging only its controls."""
    generated = _steps()["wide_step"][1]
    plan = generated.plan
    assert plan.serial and plan.sccs == ((0, 1),) and plan.chains == (((0, 1),),)
    assert plan.staged == ("u[0]", "u[1]") and plan.arrays == 4 <= MAX_ARRAYS
    assert set(plan.classes) == {("cycle", 0)}
    assert len(plan.cycle_ops[(0, 1)]) == generated.n_ops


# GeneratedStep.chain as the one-thread design computed it (the loop-carried
# cycle, in operations a step), which the bound reads
CHAINS = {
    **{name: 0.0 for name in PLANTS if name.startswith("ops ")},
    "CarSimple.step_unwrapped": 1.0, "CarSimple.step": 2.0,
    "CarFrontWheel.step_cols, generated": 1.0, "eight_state_step": 15.0,
    "car_whole_state_step": 1.0, "blocks_step": 6.0,
}


@pytest.mark.parametrize("name", CHAINS)
def test_chain_is_unchanged(name):
    assert _steps()[name][1].chain == CHAINS[name]


def test_plan_of_the_car_steps_as_the_factory_builds_them():
    """The factory's route carries the same plan the emitter gives."""
    from ilqr_admm_tpu_torch.ops import fused_rollout as fr

    for step in (CarSimple(dt=0.03).step_unwrapped, CarSimple(dt=0.03).step,
                 lambda x, u, car=CarFrontWheel(dt=0.03): car.step_cols(x, u)):
        roll = fr.make_fused_linesearch_rollout(step, 20, 4, 2, 5, device="cpu")
        assert roll.route.generated.plan.chains == CAR_CHAINS
    assert math.isfinite(roll.route.generated.chain)
