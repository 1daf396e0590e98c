"""Profiling helpers: phase timers and profiler traces (port of
utils/profiling.py).

`PhaseTimer` accumulates wall-clock time per named phase and waits for the
card at a phase's end when it is given a result to wait on. `trace`
records a `torch.profiler` trace of the CPU and, when there is a card, its
kernels (the JAX package's `xla_trace`); `annotate` names a span in it
(`jax.profiler.TraceAnnotation` there).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Accumulating wall-clock timers with a device sync at phase ends.

    with timer.phase("render", result):  waits for the card at exit when
    given a result to wait on and the process uses the card.
    """

    def __init__(self):
        self.totals: dict = defaultdict(float)
        self.counts: dict = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(
                    1000 * self.totals[name] / max(self.counts[name], 1), 3
                ),
            }
            for name in self.totals
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a torch.profiler trace; written to `<log_dir>/trace.json`
    (Chrome trace format) at exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named span in the profiler trace."""
    return torch.profiler.record_function(name)
