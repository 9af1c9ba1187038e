#!/usr/bin/env python3
"""This tree's kernels against another tree's (the parent commit, unpacked
with `git archive`), on one CUDA card: times, and outputs bit for bit.

Each tree runs in its own processes with its own package, wrapper and
library, on the same inputs: the u-only bench fleet (16,384 instances,
refresh_every 1, `admm_u_only`), the wide fleet of
`benchmarks/bench_wide_certified.py` (8,192 instances, Nm = 512, the wide
route; refresh_every 8 and 1), the SLS bench fleet (1,024 instances,
`sls_admm`) in the diamond_ee, diamond and consensus modes, and the planar
state-bounded fleet (16,384 instances, Nm = 200, Nd = 400, 200
iterations, `admm_box` on the wide route with each tree's own packing),
in the order other, this, this, other. Each process times the kernels
with CUDA events (7 windows of 10 calls, 3 of 2 for the planar fleet,
after a warm-up); the first two save their outputs. The script prints
each run's medians, then each kernel's median and IQR over the runs of
each tree, whether the trees' outputs are equal bit for bit and their
largest difference (a reordered sum cannot match bit for bit). The other
tree builds its library under its own build/ directory.

Run from the repository root on a machine with a card and nvcc, with the
outputs (~600 MB) in a directory that is not brought back, e.g.:
    git archive <parent> | tar -x -C build/parent
    python3 tools/parent_vs_change.py build/parent build/parent_vs_change
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent

CHILD = r'''
import json, sys, numpy as np, torch
import chip_smoke as cs
from ilqr_admm_tpu_torch.ops.fused_admm import admm_box, admm_u_only, make_fused_lqt_admm
from ilqr_admm_tpu_torch.ops.fused_sls import sls_admm

def time_ms(run, windows=7, calls=10):
    run()
    torch.cuda.synchronize()
    return [cs._event_ms(run, calls) for _ in range(windows)]

runs, shape = {}, {}
A, B, cost, x0s = cs.bench_problem("cuda")
solver = make_fused_lqt_admm(A, B, cost, u_lower=-cs.U_MAX, u_upper=cs.U_MAX, rho_u=cs.RHO_U,
                             n_iters=cs.ADMM_ITERS, batch_tile=cs.BATCH_TILE, device="cuda")
inputs = solver.kernel_inputs(x0s)
runs["admm_u_only"] = lambda: admm_u_only(*inputs, solver.packed, **solver.kernel_options)
problem = cs.wide_problem("cuda")
wide = cs.wide_solver("cuda", problem)
wide_inputs = wide.kernel_inputs(problem[3])
for r in (cs.WIDE_REFRESH, 1):
    runs[f"admm_u_only_wide refresh_every={r}"] = (
        lambda r=r: admm_u_only(*wide_inputs, wide.packed, **dict(wide.kernel_options,
                                                                  refresh_every=r)))
for mode in ("diamond_ee", "diamond", "consensus"):
    _, s = cs.sls_solver("cuda", mode)
    bounds = cs.sls_bounds("cuda", sort=mode == "diamond_ee")
    runs[f"sls_admm {mode}"] = (lambda s=s, b=bounds:
                                sls_admm(b, s.U_base, s.W, s.packed, **s.kernel_options))
_, box = cs.box_solver("cuda", nb_dim=2)
box_inputs = box.kernel_inputs(cs.via_point_problem("cuda", 2)[3])
runs["admm_box_wide planar"] = lambda: admm_box(*box_inputs, box.packed, **box.kernel_options,
                                                route=box.route)
shape["admm_box_wide planar"] = (3, 2)
outputs, times = {}, {}
for name, run in runs.items():
    out = run()
    outputs[name] = [t.cpu() for t in (out if isinstance(out, tuple) else (out,))]
    times[name] = time_ms(run, *shape.get(name, (7, 10)))
if sys.argv[2] == "save":
    torch.save(outputs, sys.argv[1])
print("RESULT " + json.dumps(times), flush=True)
'''


def median_iqr(samples: list) -> tuple:
    q = torch.tensor(samples, dtype=torch.float64).quantile(torch.tensor([0.5, 0.25, 0.75],
                                                                          dtype=torch.float64))
    return tuple(q.tolist())


def run_tree(tree: Path, out: Path, save: bool) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, str(out), "save" if save else "-"],
                          cwd=tree,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{tree} failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    line = next(x for x in proc.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    other, out_dir = Path(sys.argv[1]).resolve(), Path(sys.argv[2]).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    trees = {"other": other, "this": ROOT}
    times = {"other": [], "this": []}
    for i, side in enumerate(("other", "this", "this", "other")):
        times[side].append(run_tree(trees[side], out_dir / f"{side}{i}.pt", save=i < 2))
        print(f"[parent vs change] run {i}, {side} ({trees[side]}): "
              + ", ".join(f"{k} {median_iqr(v)[0]:.4f} ms" for k, v in times[side][-1].items())
              + f"; card: {card}", flush=True)
    a, b = torch.load(out_dir / "other0.pt"), torch.load(out_dir / "this1.pt")
    for name in a:
        same = all(torch.equal(x, y) for x, y in zip(a[name], b[name]))
        diff = max(float((x - y).abs().max()) for x, y in zip(a[name], b[name]))
        print(f"[parent vs change] {name}: outputs bit for bit equal: {same} (max diff {diff:.3e})")
    for name in times["this"][0]:
        line = []
        for side in ("other", "this"):
            runs = [median_iqr(t[name])[0] for t in times[side]]
            med, q1, q3 = median_iqr([x for t in times[side] for x in t[name]])
            line.append(f"{side} {', '.join(f'{x:.4f}' for x in runs)} ms (all windows: median "
                        f"{med:.4f} [IQR {q1:.4f}-{q3:.4f}])")
        print(f"[parent vs change] {name}: {'; '.join(line)}; card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
