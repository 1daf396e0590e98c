"""The whole step's share of the fp32 peak: its counted operations
(`counts/step.py::train_step`) times the window's iterations, over the
window at 67 TFLOP/s."""
from port_bench.harness.readers import mfu


def read(run):
    return mfu(run) if run.kind == "train" else None
