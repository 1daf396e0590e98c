"""The whole frame's share of the fp32 peak: its counted operations
(`counts/step.py::render_frame`) times the window's frames, over the window
at 67 TFLOP/s."""
from port_bench.harness.readers import mfu


def read(run):
    return mfu(run) if run.kind == "serve" else None
