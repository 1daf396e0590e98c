"""The traced sub-window of a `--trace 1` run: `torch.profiler` (CUPTI) over
a stretch of the window, read back from its Chrome trace.

What it gives the per-layer readers: every device operation (kernels,
copies, fills) with its name, start and duration; the union of their
intervals (busy seconds) inside the window span; the window's length; the
host spans the harness marked (`bench.<name>`), so that each idle gap can
be named by what the host was doing; and the operations that took most
time. The profiler has been seen to drop some kernel events of a trace,
so readers take medians per launch and report how many events they found.
"""
from __future__ import annotations

import json
import os
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


class Trace:
    """Start with `start()`, mark host spans with `span(name)`, end with
    `stop()`; then `events`, `busy_s`, `window_s`, `breakdown()`."""

    def __init__(self):
        self.prof = None
        self._window = None
        self.events: list = []        # (category, name, start us, duration us)
        self.spans: list = []         # (name, start us, end us) of bench.* host spans
        self.window = (0.0, 0.0)      # us
        self.busy_s = 0.0
        self.window_s = 0.0
        self.overhead_s = 0.0         # host seconds spent starting, stopping and reading it

    def start(self) -> None:
        """Start tracing. The seconds this takes (CUPTI's set-up) are not the
        program's: the mixes take them out of their windows (`overhead_s`)."""
        t0 = time.perf_counter()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._window = record_function(WINDOW)
        self._window.__enter__()
        self.overhead_s += time.perf_counter() - t0

    @staticmethod
    def span(name: str):
        return record_function(f"bench.{name}")

    def stop(self) -> None:
        """End the trace and read it (its seconds count in `overhead_s`)."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        self._window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        finally:
            os.remove(path)
        self.prof = None
        self._read(raw.get("traceEvents", raw) if isinstance(raw, dict) else raw)
        self.overhead_s += time.perf_counter() - t0

    def _read(self, trace_events: list) -> None:
        for e in trace_events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.events.append((cat, name, ts, dur))
            elif name == WINDOW and cat != "gpu_user_annotation":
                self.window = (ts, ts + dur)
            elif name.startswith("bench.") and cat != "gpu_user_annotation":
                self.spans.append((name[len("bench."):], ts, ts + dur))
        w0, w1 = self.window
        self.window_s = (w1 - w0) / 1e6
        self.busy_s = sum(b - a for a, b in self.intervals()) / 1e6

    def intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        window, as sorted (start, end) in us."""
        w0, w1 = self.window
        iv = sorted((max(ts, w0), min(ts + dur, w1)) for _, _, ts, dur in self.events
                    if ts + dur > w0 and ts < w1)
        out: list = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [tuple(x) for x in out]

    def kernels(self, keys) -> list:
        """Durations (us) of the kernels whose name holds one of `keys`."""
        return [dur for cat, name, _, dur in self.events
                if cat == "kernel" and any(k in name for k in keys)]

    def kernel_time(self, keys=None) -> float:
        """Seconds of kernel time, of all kernels or of those named by `keys`."""
        return sum(dur for cat, name, _, dur in self.events if cat == "kernel" and (
            keys is None or any(k in name for k in keys))) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the host span around each."""
        by_name: dict = {}
        for _, name, _, dur in self.events:
            by_name[name] = by_name.get(name, 0.0) + dur / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        w0, w1 = self.window
        iv = self.intervals()
        gaps, prev = [], w0
        for a, b in iv:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if w1 > prev:
            gaps.append((prev, w1))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        named = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inner = [(s1 - s0, n) for n, s0, s1 in self.spans if s0 <= mid <= s1]
            named.append([min(inner)[1] if inner else "harness", (b - a) / 1e6])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
