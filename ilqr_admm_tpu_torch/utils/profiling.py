"""Profiler hooks (counterpart of `ilqr_admm_tpu/utils/profiling.py`):
`torch.profiler` traces with CUDA activity, named trace regions and an
iterations/s counter."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Optional

import torch


@contextmanager
def device_trace(logdir: str):
    """Capture a `torch.profiler` trace of the body, the card's kernels
    too when a card is present, and write it to `logdir` as a
    Chrome/TensorBoard trace. Yields the profiler, whose `key_averages()`
    tables the recorded ops."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    ) as prof:
        yield prof


def annotate(name: str):
    """Named trace region (shows up in the profiler timeline)."""
    return torch.profiler.record_function(name)


class RateCounter:
    """iterations/s counter with warmup exclusion."""

    def __init__(self):
        self._t0: Optional[float] = None
        self._units = 0.0

    def start(self):
        self._t0 = time.perf_counter()
        self._units = 0.0

    def add(self, units: float):
        self._units += units

    @property
    def rate(self) -> float:
        if self._t0 is None:
            return 0.0
        dt = time.perf_counter() - self._t0
        return self._units / dt if dt > 0 else 0.0
