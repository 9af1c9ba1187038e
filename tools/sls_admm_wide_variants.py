#!/usr/bin/env python3
"""The wide SLS kernel (`csrc/sls_admm_wide.cu`) with other chunks of its
products, on one CUDA card: time, and distance to the plain versions.

The kernel sums each tile's k range on the tensor cores in chunks of
`fused_sls.SLS_WIDE_K_CHUNK` k-steps, each chunk added to its f32 total
(a run-time argument, so one build serves every value). At the wide fleet
(`chip_smoke.sls_wide_solver`: N = 400, 1,024 instances, 200 iterations)
the loop amplifies rounding: the plain version with the kernel's 3xTF32
products and the f32 one land ~5e-4 apart, near the SLS tolerance. For
each fleet and chunk this prints the kernel's time (CUDA events, 5 calls)
and its largest distance to the 3xTF32, f32 and f64 plain versions (the
f64 one: the same f32 operators and bounds in f64, the loop without
rounding to speak of), and the plain versions' distances to each other.
Then the general consensus build's time on both routes beside the
compiled (3, 2, 4) one's.

Run from the repository root on a machine with a card and nvcc:
    python3 tools/sls_admm_wide_variants.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from ilqr_admm_tpu_torch.ops import fused_sls  # noqa: E402
from ilqr_admm_tpu_torch.ops.fused_sls import sls_admm, sls_admm_reference  # noqa: E402

CHUNKS = (2, 4, 8)


def _dist(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def variants(label, solver, bounds, chunks=CHUNKS):
    kw = solver.kernel_options
    ops = (bounds, solver.U_base, solver.W)
    em = sls_admm_reference(*ops, **kw, products="tf32x3")
    f32 = sls_admm_reference(*ops, **kw)
    f64 = sls_admm_reference(bounds.double(), solver.U_base.double(), solver.W.double(), **kw)
    torch.cuda.synchronize()
    tol = cs.SLS_FIXED_TOL * max(1.0, float(em.abs().max()))
    print(f"{label}: tolerance {tol:.3e}; 3xTF32 plain vs f32 plain {_dist(em, f32):.3e}, f32 "
          f"plain vs f64 plain {_dist(f32, f64):.3e}, 3xTF32 plain vs f64 plain "
          f"{_dist(em, f64):.3e}", flush=True)
    saved = fused_sls.SLS_WIDE_K_CHUNK
    try:
        for kc in chunks:
            fused_sls.SLS_WIDE_K_CHUNK = kc

            def run():
                return sls_admm(*ops, solver.packed, **kw, route=solver.route)

            got = run()
            torch.cuda.synchronize()
            ms = cs._event_ms(run, 5)
            print(f"  chunk {kc}: against the 3xTF32 plain {_dist(got, em):.3e}, the f32 plain "
                  f"{_dist(got, f32):.3e}, the f64 plain {_dist(got, f64):.3e}; {ms:.4f} ms",
                  flush=True)
    finally:
        fused_sls.SLS_WIDE_K_CHUNK = saved


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    name, card = cs.phase_device()
    fleet = cs.sls_bounds("cuda", batch=cs.SLS_BATCH)
    for seed in (0, 1):
        variants(f"diamond, N={cs.SLS_WIDE_N}, {cs.SLS_ITERS} iterations, batch {cs.SLS_BATCH}, "
                 f"bounds seed {seed}",
                 cs.sls_wide_solver("cuda", "diamond", n_iters=cs.SLS_ITERS)[1],
                 cs.sls_bounds("cuda", batch=cs.SLS_BATCH, seed=seed))
    variants(f"diamond_ee, N={cs.SLS_WIDE_N}, {cs.SLS_WIDE_ITERS} iterations, batch "
             f"{cs.SLS_BATCH}, sorted",
             cs.sls_wide_solver("cuda", "diamond_ee")[1],
             cs.sls_bounds("cuda", batch=cs.SLS_BATCH, sort=True))
    variants(f"robust_dim 2, N={cs.SLS_WIDE_N}, batch {cs.SLS_BATCH}, "
             f"{cs.SLS_WIDE_CONS_ITERS} iterations",
             cs.sls_robust2_solver("cuda", horizon=cs.SLS_WIDE_N,
                                   n_iters=cs.SLS_WIDE_CONS_ITERS)[1], fleet, (2, 8))
    variants(f"diamond at the edge, Nm={cs.SLS_WIDE_EDGE}, batch 16, 50 iterations",
             cs.sls_solver("cuda", "diamond", horizon=cs.SLS_WIDE_EDGE, n_iters=50)[1],
             cs.sls_bounds("cuda", 16, seed=5))
    # the general consensus build (the shape read at run time, its cone
    # state in local memory) on both routes, beside the compiled (3, 2, 4)
    for label, make in (
            (f"general {cs.SLS_GENERAL_SHAPE}, N={cs.SLS_WIDE_N} (wide)",
             lambda: cs.sls_general_solver("cuda", horizon=cs.SLS_WIDE_N)),
            (f"compiled (3, 2, 4), N={cs.SLS_WIDE_N} (wide)",
             lambda: cs.sls_robust2_solver("cuda", horizon=cs.SLS_WIDE_N)),
            (f"general {cs.SLS_GENERAL_SHAPE}, N={cs.N} (narrow)",
             lambda: cs.sls_general_solver("cuda")),
            (f"compiled (3, 2, 4), N={cs.N} (narrow)", lambda: cs.sls_robust2_solver("cuda"))):
        solver = make()[1]
        kw = solver.kernel_options

        def run():
            return sls_admm(fleet, solver.U_base, solver.W, solver.packed, **kw,
                            route=solver.route)

        run()
        torch.cuda.synchronize()
        print(f"{label}, batch {cs.SLS_BATCH}, {kw['n_iters']} iterations, {solver.route} route: "
              f"{cs._event_ms(run, 3):.4f} ms", flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
