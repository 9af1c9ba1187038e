#!/usr/bin/env python3
"""This tree's kernels against another tree's (the parent commit, unpacked
with `git archive`), on one CUDA card: times, and outputs bit for bit.

Each tree runs in its own processes with its own package, wrapper and
library, on the same inputs: the u-only bench fleet (16,384 instances,
refresh_every 1, `admm_u_only`), the wide fleet of
`benchmarks/bench_wide_certified.py` (8,192 instances, Nm = 512, the wide
route; refresh_every 8 and 1) and the SLS bench fleet (1,024 instances,
`sls_admm`) in the diamond_ee, diamond and consensus modes, in the order
other, this, this, other. Each process times the kernels with CUDA events
(median of 7 windows of 10 calls, after a warm-up) and saves their
outputs; the script prints each time and whether the trees' outputs are
equal bit for bit. The other tree builds its library under its own
build/ directory.

Run from the repository root on a machine with a card and nvcc, with the
outputs (~290 MB) in a directory that is not brought back, e.g.:
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
from ilqr_admm_tpu_torch.ops.fused_admm import admm_u_only, make_fused_lqt_admm
from ilqr_admm_tpu_torch.ops.fused_sls import sls_admm

def time_ms(run):
    run()
    torch.cuda.synchronize()
    return float(np.median([cs._event_ms(run, 10) for _ in range(7)]))

runs = {}
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
outputs, times = {}, {}
for name, run in runs.items():
    out = run()
    outputs[name] = [t.cpu() for t in (out if isinstance(out, tuple) else (out,))]
    times[name] = time_ms(run)
torch.save(outputs, sys.argv[1])
print("RESULT " + json.dumps(times), flush=True)
'''


def run_tree(tree: Path, out: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, str(out)], cwd=tree,
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
        times[side].append(run_tree(trees[side], out_dir / f"{side}{i}.pt"))
        print(f"[parent vs change] run {i}, {side} ({trees[side]}): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in times[side][-1].items())
              + f"; card: {card}", flush=True)
    a, b = torch.load(out_dir / "other0.pt"), torch.load(out_dir / "this1.pt")
    for name in a:
        same = all(torch.equal(x, y) for x, y in zip(a[name], b[name]))
        diff = max(float((x - y).abs().max()) for x, y in zip(a[name], b[name]))
        print(f"[parent vs change] {name}: outputs bit for bit equal: {same} (max diff {diff:.3e})")
    for name in times["this"][0]:
        o = [t[name] for t in times["other"]]
        t = [t[name] for t in times["this"]]
        print(f"[parent vs change] {name}: other {', '.join(f'{x:.4f}' for x in o)} ms, this "
              f"{', '.join(f'{x:.4f}' for x in t)} ms; card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
