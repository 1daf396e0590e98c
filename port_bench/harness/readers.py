"""Arithmetic shared by the metric readers (`end_to_end/`, `layer_metrics/`)."""
from __future__ import annotations

import statistics
import sys

from port_bench.counts import kernels as K

# cuDNN's convolution kernels: implicit GEMMs (fprop, dgrad, wgrad), FFT
# convolutions (fft2d_*, and their complex GEMMs, cf32), Winograd; the
# correction MLPs' GEMMs are real (f32f32) and do not match
CONV_TOKENS = ("conv", "fprop", "dgrad", "wgrad", "fft", "cgemm", "cf32", "cudnn",
               "winograd", "flip_filter", "implicit")


def roofline(run, label: str, keys: tuple, bound) -> float | None:
    """100 x the least time the sampled frames' work needs (the median over
    the samples of `bound(work)` -> (ops, bytes)) over the median duration
    of the kernels named by `keys` in the trace (for several names, the sum
    of their medians); None without a trace, work or events."""
    if run.trace is None or not run.work:
        return None
    medians = []
    for key in keys:
        durs = run.trace.kernels((key,))
        print(f"[roofline] {label}: {len(durs)} events of {key} in the trace "
              f"({run.traced_units} units traced)", file=sys.stderr)
        if not durs:
            return None
        medians.append(statistics.median(durs) / 1e6)
    least = statistics.median(K.bound_s(*bound(w)) for w in run.work)
    return 100.0 * least / sum(medians)


def mfu(run) -> float | None:
    """100 x the counted operations of the window's units over the window
    at the fp32 peak."""
    if run.trace is None or not run.flops_per_unit:
        return None
    return 100.0 * run.flops_per_unit * run.units / (run.seconds * K.FP32_OPS_PER_S)


def idle(run) -> float | None:
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
