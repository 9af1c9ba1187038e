#!/usr/bin/env python3
"""The staged line-search rollout against the per-thread design it
replaced, on one CUDA card, and the chain it is bound by.

Builds `tools/linesearch_rollout_per_thread.cu` (one thread a candidate,
a loop over t) beside the port's own library, runs both on the same
candidates at N = 500 and N = 10,000 (20 candidates, chip_smoke's
`rollout_case`), checks that both are bit-identical to the plain version,
and times each kernel's device time from a CUDA graph of 10 wrapper calls
(chip_smoke's `_graph_ms`, median of 7 windows) in the order per-thread,
staged, staged, per-thread. Then builds and runs `tools/fadd_chain_bench.cu`
(an FADD's latency, the staged kernel's chain loop in cycles a link, the
SM clock). The builds go to build/rollout_variants/ under the repository
root.

Then the generated route (any plant's step, `ops/rollout_codegen.py`):
CarSimple.step_unwrapped and CarFrontWheel's step as a plain function,
each built into the staged template (csrc/linesearch_rollout_generic.cuh)
and into the one-thread template it replaced
(tools/linesearch_rollout_generic_one_thread.cuh), timed the same way in
the order one-thread, staged, staged, one-thread at the line search of
`examples/car_control_bounds.py` (N = 500, A = 50), the fleet (64, 50,
500) and N = 10,000, A = 1, the staged kernel also at 64, 128 and 256
threads a block (its launcher's own choice first), every output checked
bit for bit against the plain version.

Run from the repository root on a machine with a card and nvcc:
    python3 tools/rollout_variants.py              # both parts
    python3 tools/rollout_variants.py --generated  # the generated route only
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ilqr_admm_tpu_torch import _build  # noqa: E402
from ilqr_admm_tpu_torch.ops import fused_rollout  # noqa: E402
from ilqr_admm_tpu_torch.ops.rollout_codegen import emit_step  # noqa: E402

ENTRY = "linesearch_rollout_car_front_wheel_launch"


def build(out_dir: Path):
    """(the per-thread library, the FADD benchmark's executable)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    so, exe = out_dir / "per_thread.so", out_dir / "fadd_chain_bench"
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in ([_build._nvcc(), *_build._FLAGS, "-shared", "-o", str(so),
                          str(ROOT / "tools" / "linesearch_rollout_per_thread.cu")],
                         [_build._nvcc(), *_build._ARCH, "-O3", "-o", str(exe),
                          str(ROOT / "tools" / "fadd_chain_bench.cu")])]
    for proc in procs:
        out, _ = proc.communicate()
        print(out, end="")
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed:\n{out}")
    lib = ctypes.CDLL(str(so))
    ours = _build.load_library()
    for name in (ENTRY, "linesearch_rollout_error_string"):
        getattr(lib, name).argtypes = getattr(ours, name).argtypes
        getattr(lib, name).restype = getattr(ours, name).restype
    return lib, exe


def build_one_thread(source: str, out: Path) -> ctypes.CDLL:
    """A generated step built into the one-thread template."""
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "one_thread.cu", out / "one_thread.so"
    cu.write_text(source + "\n" + (ROOT / "tools" / "linesearch_rollout_generic_one_thread.cuh")
                  .read_text())
    proc = subprocess.run([_build._nvcc(), *_build._FLAGS, "-shared", "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    print("".join(line + "\n" for line in (proc.stdout + proc.stderr).splitlines()
                  if "registers" in line or "spill" in line), end="")
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.linesearch_rollout_generic_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.linesearch_rollout_generic_launch.restype = ctypes.c_int
    return lib


def generated_variants(card: str):
    """The generated route's staged kernel against its one-thread design."""
    car = chip_smoke.CarSimple(dt=chip_smoke.ROLLOUT_GEN_DT)
    front = chip_smoke.CarFrontWheel(dt=chip_smoke.ROLLOUT_GEN_DT)
    steps = {"CarSimple.step_unwrapped": car.step_unwrapped,
             "CarFrontWheel.step_cols (generated)": lambda x, u: front.step_cols(x, u)}
    F, A, N = chip_smoke.ROLLOUT_GEN_FLEET
    for label, step in steps.items():
        generated = emit_step(step, 4, 2)
        staged = _build.load_rollout(generated.source)
        one = build_one_thread(generated.source,
                               ROOT / "build" / "rollout_variants" / label.split()[0])
        print(f"[generated variant] {label}: chains by level {generated.plan.chains}, "
              f"{len(generated.plan.phases)} phases, {generated.plan.arrays} arrays", flush=True)
        for horizon, n_cands, fleet in ((N, A, None), (N, A, F), (10_000, 1, None)):
            if fleet is None:
                _, x0, u = chip_smoke.rollout_case("cuda", horizon, n_cands)
            else:
                _, x0, u = chip_smoke.rollout_fleet_case("cuda", fleet, n_cands, horizon)
            want = fused_rollout.linesearch_rollout_reference(step, x0, u)
            R = 1 if fleet is None else fleet
            xs = torch.empty(tuple(u.shape[:-1]) + (4,), device="cuda")
            default = chip_smoke.rollout_geometry(generated, R, n_cands, horizon)[0]

            def run(name, threads=0):
                stream = torch.cuda.current_stream().cuda_stream  # the capture's, in a graph
                if name == "one-thread":
                    err = one.linesearch_rollout_generic_launch(
                        x0.data_ptr(), u.data_ptr(), xs.data_ptr(), R, n_cands, horizon, stream)
                else:
                    err = staged.linesearch_rollout_generic_launch_threads(
                        x0.data_ptr(), u.data_ptr(), xs.data_ptr(), R, n_cands, horizon, threads,
                        stream)
                if err != 0:
                    raise SystemExit(f"{name} launch failed: cudaError {err}")
                return xs

            order = [("one-thread", 0), ("staged", default), ("staged", default),
                     ("one-thread", 0)] + [("staged", t) for t in (64, 128, 256) if t != default]
            shape = f"N={horizon}, A={n_cands}" + (f", F={fleet}" if fleet else "")
            for name, threads in order:
                got = run(name, threads).clone()
                same = chip_smoke.bits_equal(got, want)
                med, q1, q3 = chip_smoke._graph_ms(lambda: run(name, threads))
                geometry = ("" if name == "one-thread" else
                            f", threads, chunk, shared bytes "
                            f"{chip_smoke.rollout_geometry(generated, R, n_cands, horizon, threads)}")
                print(f"[generated variant] {label} {shape}, {name}{geometry}: {med:.4f} ms "
                      f"(IQR {q1:.4f}-{q3:.4f}, CUDA graph of 10 calls); bit-identical to the "
                      f"plain version {same}; card: {card}", flush=True)
                if not same:
                    raise SystemExit(f"{label} {shape} {name}: not bit-identical")


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    _, card = chip_smoke.phase_device()
    if "--generated" in sys.argv[1:]:
        generated_variants(card)
        return 0
    staged = _build.load_library()
    per_thread, exe = build(ROOT / "build" / "rollout_variants")
    libs = {"per-thread": per_thread, "staged": staged}
    saved = _build.load_library
    try:
        for horizon in (chip_smoke.CAR_N, 10_000):
            car, x0, u = chip_smoke.rollout_case("cuda", horizon, chip_smoke.CAR_ALPHAS)
            want = fused_rollout.linesearch_rollout_reference(car.step_cols, x0, u)
            for name in ("per-thread", "staged", "staged", "per-thread"):
                _build.load_library = lambda lib=libs[name]: lib
                got = fused_rollout.linesearch_rollout(car, x0, u)
                same = torch.equal(torch.nan_to_num(got, nan=7.0), torch.nan_to_num(want, nan=7.0))
                med, q1, q3 = chip_smoke._graph_ms(lambda: fused_rollout.linesearch_rollout(car, x0, u))
                print(f"[rollout variant] N={horizon}, A={chip_smoke.CAR_ALPHAS}, {name}: {med:.4f} ms "
                      f"(IQR {q1:.4f}-{q3:.4f}, CUDA graph of 10 calls); bit-identical to the "
                      f"plain version {same}; card: {card}", flush=True)
    finally:
        _build.load_library = saved
    generated_variants(card)
    return subprocess.run([str(exe)]).returncode


if __name__ == "__main__":
    sys.exit(main())
