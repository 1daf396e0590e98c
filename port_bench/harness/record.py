"""What a run hands its metric readers, and the comparison's verdict."""
from __future__ import annotations

import dataclasses
import statistics

import torch


@dataclasses.dataclass
class Run:
    """One run's readings. Host seconds are by `time.perf_counter`."""
    kind: str                     # "train" or "serve"
    seconds: float                # the window's length
    setup_s: float                # process start to the window's start
    units: int = 0                # iterations (train) or frames (serve) done in the window
    latencies_s: list = dataclasses.field(default_factory=list)   # serve: per request
    call_host_s: list = dataclasses.field(default_factory=list)   # serve: inside the call
    capture_s: float = 0.0        # train: graph warm-ups and captures in the window
    trace: object = None          # harness/trace.py::Trace of the traced sub-window
    traced_units: int = 0         # iterations or frames inside the traced sub-window
    work: list = dataclasses.field(default_factory=list)  # blend work of sample frames
    flops_per_unit: float = 0.0   # counted operations per iteration or frame
    live: int = 0                 # live Gaussians of the counted frames
    vertices: int = 0
    extra: dict = dataclasses.field(default_factory=dict)


def median_work(work: list) -> dict:
    """The per-key median of sample frames' blend work."""
    return {k: statistics.median(w[k] for w in work) for k in work[0]}


def leaf_gaps(prog: dict, ref: dict, counted=None) -> tuple[float, str]:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and the median
    leaf's; `counted` restricts the leaves. -> (gap, leaf)."""
    names = [n for n in ref if counted is None or n in counted]
    rn = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in names}
    pn = {n: float(torch.linalg.vector_norm(prog[n].double())) for n in names}
    med = statistics.median(rn.values())
    worst, leaf = 0.0, ""
    for n in names:
        g = abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30)
        if g > worst:
            worst, leaf = g, n
    return worst, leaf


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): each number within its limit; a
    number without a limit, or not finite, fails."""
    checks = {}
    ok = bool(numbers)
    for name, value in numbers.items():
        limit = limits.get(name)
        passed = limit is not None and value == value and value <= limit
        ok = ok and passed
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
