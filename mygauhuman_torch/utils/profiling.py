"""Profiling helpers: the program's spans and phase counters (port of
utils/profiling.py).

`annotate(name)` is the program's span (`jax.profiler.TraceAnnotation` in
the JAX package): a `torch.profiler.record_function` while a profiler runs,
else one shared null context behind one bool check, so a span on a
per-frame or per-iteration path costs nothing measurable when nobody
traces (an ungated `record_function` costs ~15 us on the CPU even then).
Spans are named `mgh.<layer>.<step>` and wrap host code only: a span
recorded while a CUDA graph is captured is not replayed, so what runs
inside a replay is told apart by its kernels' names.

`PhaseTimer` accumulates wall-clock time per named phase, each phase also
a span, and waits for the card at a phase's end when it is given a result
to wait on (and at its start too with `wait=True`). `PHASES` is the
program's own: it counts the densify events (`mgh.train.densify`, met at
most once per event), branch B's camera bakes (`mgh.pbr.bake`, one per
camera, waited for at both ends) and `cli.train`'s eval, saves and state
gathers. `COUNTERS`, beside it, counts work the phases hold:
`mgh.pbr.sweeps` and `mgh.pbr.faces`, the bake's sweeps and the cube faces
they rasterize (every slot of a sweep's window on the card, the occupied
ones on the CPU), and `mgh.pbr.face_batches`, the blend launches those
faces take (kernel C on the card, plain-blend calls on the CPU: one per
group of a sweep's cells, one per face in the per-cell program), so that
faces over face batches reads the faces a launch blends.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A named span in the profiler's trace while a profiler runs; the
    shared null context otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


class PhaseTimer:
    """Accumulating wall-clock timers with a device sync at phase ends.

    with timer.phase("render", result):  waits for the card at exit when
    given a result to wait on and the process uses the card. The phase is
    also the span `name`.
    """

    def __init__(self):
        self.totals: dict = defaultdict(float)
        self.counts: dict = defaultdict(int)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None, wait: bool = False):
        """Time the body as phase `name`; with `wait`, the card's queued work
        is waited for before the clock starts and the body's work before it
        stops (on a process that uses the card)."""
        if wait:
            sync_on = True
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
        with annotate(name):
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


PHASES = PhaseTimer()
COUNTERS: dict = defaultdict(int)
