"""Structured solver metrics (counterpart of `ilqr_admm_tpu/utils/metrics.py`).

Converts the solvers' typed results (`ADMMInfo`, `ILQRState`) to plain
dicts for logging or JSON, and times host-side phases.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any, Dict

import numpy as np

from ilqr_admm_tpu_torch.problem import SolveStatus


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def admm_info_dict(info) -> Dict[str, Any]:
    """ADMMInfo -> JSON-able dict with the residual history trimmed to iters."""
    iters = int(info.iters)
    return {
        "iters": iters,
        "prim_res": float(info.prim_res),
        "dual_res": float(info.dual_res),
        "status": SolveStatus(int(info.status)).name,
        "residual_history": _host(info.logs[:iters]).tolist(),
    }


def ilqr_state_dict(state) -> Dict[str, Any]:
    return {
        "iterations": int(state.iteration),
        "cost": float(state.cost),
        "prev_cost": float(state.prev_cost),
        "status": SolveStatus(int(state.status)).name,
    }


class PhaseTimer:
    """Wall-clock phase timing (backward pass / rollout / projection ...).

    Times are host-side: synchronize the device inside the phase
    (`torch.cuda.synchronize()`) to time its work.
    """

    def __init__(self):
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Any]:
        return {
            name: {"total_s": t, "count": self.counts[name], "mean_s": t / self.counts[name]}
            for name, t in self.times.items()
        }

    def dumps(self) -> str:
        return json.dumps(self.summary(), indent=2)
