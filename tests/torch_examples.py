"""The comparison of an `examples_torch/` twin with its JAX example.

`compare(name)` runs the JAX example in a subprocess on the CPU (the
wrapper of `tests/test_examples.py`) and the twin beside it with
`--device cpu`, holds the twin's output to the example's `GOLDENS` rows
(read by `examples_torch/goldens.py`, without editing or importing
`tests/test_examples.py`), then compares the two outputs:

- every number a golden regex captures, within the twin's dtype
  tolerance: float64 1e-6 relative, float32 1e-3 relative and its
  Monte-Carlo rates (percent) within 0.5 points (float64 rates 1e-6 too). A printed number carries its own
  rounding, so one unit in its last printed digit is added to each
  tolerance;
- the iteration counts and statuses the example prints (the `counts`
  regexes of `SPECS`): equal.

Where a float32 number or count is further apart, `SPECS` names the row
with the measured cause beside it; such a number is then held only to
its golden range (which the twin's output passes above), and such a
count to the stated slack with its statuses equal. Nothing is held more
loosely than its golden range.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
TWINS = os.path.join(REPO, "examples_torch")
sys.path.insert(0, TWINS)

from goldens import check_output, load_goldens  # noqa: E402

GOLDENS = load_goldens()
REL = {"float64": 1e-6, "float32": 1e-3}
MC_POINTS = 0.5
TIMEOUT = 900

# name -> dtype of the example, counts (regexes whose every match, all
# groups, must be equal), mc (indices of golden rows that are Monte-Carlo
# rates), golden_only {golden row index: cause} and count_slack {regex:
# (index of the count's group, slack, cause)}, its other groups equal.
SPECS = {
    "double_integrator_control_bounds": dict(
        dtype="float32", mc=[3],
        counts=[r"ADMM status (\d+) after (\d+) iters;[^\n]*\nADMM batch"],
        count_slack={
            r"ADMM status (\d+) after (\d+) iters;[^\n]*\nrobust SLS": (
                1, 49, "the robust ADMM_SLS stops on the facade's relative stall test "
                    "(stall_tol 1e-2, status 2 in both), whose iteration f32 rounding "
                    "moves (JAX 37, the twin 23 on the CPU); any count below its cap of "
                    "50 with the same status"),
        }),
    "double_integrator_state_bounds": dict(
        dtype="float32", mc=[2],
        counts=[r"ADMM status (\d+) after (\d+) iters"]),
    "double_integrator_obstacles": dict(
        dtype="float32",
        counts=[r"ADMM status (\d+) after (\d+) iters"],
        golden_only={
            1: "the ADMM stops at its 500-iteration cap unconverged (residuals ~0.06-1.3), "
               "and the start-goal line runs through obstacle 0's centre, a symmetric "
               "saddle: rounding picks each stretch's side. JAX's own f32 run with x0 "
               "moved by 1e-5 ends at 0.2509, the twin's f64 run at 0.2712, JAX f64 at "
               "0.2676",
            2: "as row 1: the projected iterate's clearance of obstacle 0 follows the "
               "path the saddle picked",
        }),
    "car_control_bounds": dict(
        dtype="float32",
        counts=[r"status ([A-Z_]+)", r"outer iters (\d+)"]),
    "car_state_constraints": dict(
        dtype="float32",
        counts=[r"ilqr_admm: (\d+) outer iterations, final cost [\d.e+-]+, status (\d+)",
                r"(Maximum iterations reached)"],
        golden_only={
            0: "both ilqr_admm runs stop at k_max = 10 outer steps mid-descent (status 3), "
               "where the line search's pick at a step follows rounding: f64 with 1 and 4 "
               "BLAS threads ends 3.9% apart (the facade's tests)",
            1: "as row 0",
            2: "as row 0: the clearance follows the path of the unconverged run",
        }),
    "arm_constrained": dict(
        dtype="float64",
        counts=[r"cannot improve anymore at iteration (\d+)",
                r"ilqr_admm: (\d+) outer iterations, final cost [\d.e+-]+, status (\d+)"]),
    "arm_robust": dict(dtype="float32", mc=[1, 2], counts=[]),
    "tutorial_car_parking": dict(
        dtype="float32",
        counts=[r"ilqr_admm: (\d+) outer iterations, final cost [\d.e+-]+, status (\d+)"],
        count_slack={
            r"cannot improve anymore at iteration (\d+)": (
                0, 1, "the dp iLQR stops once an accepted step changes the cost by less than "
                   "tol_fun 1e-5; near the optimum one step more or fewer crosses it in f32 "
                   "(JAX 55, the twin 54 on the CPU), both at cost 0.9283"),
            r"after (\d+) evals": (0, 1, "as the iteration: one accepted step more or fewer"),
        }),
    "mpc_car": dict(dtype="float32", counts=[]),
    "boxddp_car_parking": dict(
        dtype="float32",
        counts=[r"status ([A-Z_]+)"],
        golden_only={
            0: "the sequential boxDDP stops at its 100-iteration cap (MAX_ITER in both) "
               "still taking rounding-level steps down the cost: JAX 1.9085, the twin "
               "1.9130 on the CPU; the parallel backward's 250 reach 1.9054 in both",
        }),
    "admm_acceleration": dict(
        dtype="float32",
        counts=[r"(\d+) iters  status=MAX_ITER "],
        count_slack={
            r"(\d+) iters  status=CONVERGED ": (
                0, 1, "tol 5e-4 sits just above this problem's f32 dual-residual floor (~3e-4, "
                   "the example's own note), so the iteration whose residual crosses it "
                   "moves by one with rounding (JAX 15/14/7, the twin 14/13/6 on the CPU); "
                   "the statuses are equal and the MAX_ITER counts exact"),
        },
        golden_only={1: "the Anderson count, as the counts above (JAX 7, the twin 6)"}),
    "al_obstacle_avoidance": dict(
        dtype="float32", counts=[],
        golden_only={
            0: "tol_con 1e-7 is past what f32 resolves in the keep-out distances, so both "
               "runs end on the n_al = 12 stages with a violation at the penalty's "
               "rounding floor (JAX 4.86e-6, the twin 3.67e-6 on the CPU)",
        }),
    "batched_multistart": dict(
        dtype="float32", mc=[1],
        counts=[r"mesh: (\d+) devices"]),
    "inverse_lqt_learning": dict(dtype="float64", counts=[r"iter +(\d+):"]),
    "pd_ilqr_infeasible_start": dict(dtype="float32", counts=[r"(\d+) iterations"]),
    "robust_fleet_diamond": dict(dtype="float32", counts=[]),
    "robust_joint_calibration": dict(
        dtype="float64", counts=[r"solved in (\d+) outer iterations"]),
    "sparse_control_l1": dict(dtype="float32", counts=[]),
}


def example_names() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(EXAMPLES) if f.endswith(".py"))


def twin_names() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(TWINS)
                  if f.endswith(".py") and f != "goldens.py")


def _jax_cmd(name):
    script = os.path.join(EXAMPLES, name + ".py")
    code = (
        "import jax; jax.config.update('jax_platforms','cpu')\n"
        "import runpy, sys\n"
        f"sys.argv = [{script!r}]\n"
        f"runpy.run_path({script!r}, run_name='__main__')\n"
    )
    return [sys.executable, "-c", code]


def _twin_cmd(name):
    return [sys.executable, os.path.join(TWINS, name + ".py"), "--device", "cpu"]


def run_pair(name) -> tuple[str, str]:
    """Both runs at once; each must exit 0. Returns (jax stdout, twin stdout)."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env.setdefault("OMP_NUM_THREADS", "2")
    procs = {label: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True, cwd=REPO, env=env)
             for label, cmd in (("jax", _jax_cmd(name)), ("twin", _twin_cmd(name)))}
    outs = {}
    try:
        for label, proc in procs.items():
            out, err = proc.communicate(timeout=TIMEOUT)
            assert proc.returncode == 0, (
                f"{name} ({label}) exited {proc.returncode}\nstdout:\n{out[-3000:]}\n"
                f"stderr:\n{err[-3000:]}")
            outs[label] = out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs["jax"], outs["twin"]


def _decimals(text: str) -> int:
    mantissa = text.lower().split("e")[0]
    return len(mantissa.split(".")[1]) if "." in mantissa else 0


def _print_unit(text: str) -> float:
    """One unit in the last printed digit of a number as printed."""
    exp = int(text.lower().split("e")[1]) if "e" in text.lower() else 0
    return 10.0 ** (exp - _decimals(text))


def _captures(pattern, out):
    m = re.search(pattern, out, re.DOTALL)
    return None if m is None else m.group(1)


def compare_outputs(name, jax_out, twin_out) -> list[str]:
    """The differences between the two outputs that the rules above do not
    allow (an empty list when the twin matches)."""
    spec = SPECS[name]
    rel = REL[spec["dtype"]]
    golden_only = spec.get("golden_only", {})
    problems = []
    for i, row in enumerate(GOLDENS[name]):
        if row[0] != "float" or i in golden_only:
            continue  # golden_only rows: held to the golden range by check_output
        a, b = _captures(row[1], jax_out), _captures(row[1], twin_out)
        if a is None or b is None:
            problems.append(f"row {i} {row[1]!r}: no match (jax {a}, twin {b})")
            continue
        fa, fb = float(a), float(b)
        unit = max(_print_unit(a), _print_unit(b))
        if i in spec.get("mc", []):
            tol, what = MC_POINTS + unit, f"{MC_POINTS} points"
        else:
            tol, what = rel * max(abs(fa), abs(fb)) + unit, f"{rel:g} relative"
        if abs(fa - fb) > tol:
            problems.append(f"row {i} {row[1]!r}: jax {a}, twin {b} (beyond {what} and one "
                            "unit of the last printed digit)")
    for pattern in spec.get("counts", []):
        a, b = re.findall(pattern, jax_out), re.findall(pattern, twin_out)
        if a != b:
            problems.append(f"counts {pattern!r}: jax {a}, twin {b}")
    for pattern, (group, slack, _cause) in spec.get("count_slack", {}).items():
        a = [m.groups() for m in re.finditer(pattern, jax_out)]
        b = [m.groups() for m in re.finditer(pattern, twin_out)]
        ok = len(a) == len(b) and len(a) > 0
        for ga, gb in zip(a, b):
            ok = ok and abs(int(ga[group]) - int(gb[group])) <= slack and all(
                x == y for j, (x, y) in enumerate(zip(ga, gb)) if j != group)
        if not ok:
            problems.append(f"counts {pattern!r}: jax {a}, twin {b} (slack {slack})")
    return problems


def compare(name):
    """Run both, assert the goldens on the twin and the comparison."""
    jax_out, twin_out = run_pair(name)
    failures, _ = check_output(name, twin_out)
    assert not failures, "\n".join(failures) + f"\ntwin output:\n{twin_out[-3000:]}"
    problems = compare_outputs(name, jax_out, twin_out)
    assert not problems, ("\n".join(problems) + f"\njax output:\n{jax_out[-3000:]}\n"
                          f"twin output:\n{twin_out[-3000:]}")
