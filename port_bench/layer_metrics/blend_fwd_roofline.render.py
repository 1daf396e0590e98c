"""Kernel C, planar, no checkpoints: its least time for the checked
frames' work over its median duration per launch."""
from port_bench.counts import kernels as K
from port_bench.harness.readers import roofline


def read(run):
    if run.kind != "serve":
        return None
    return roofline(run, "blend_fwd", ("blend_fwd_kernel",), K.blend_fwd)
