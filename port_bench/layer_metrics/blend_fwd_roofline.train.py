"""Kernel C in checkpoint mode (a differentiated forward): its least time
for the traced views' work over its median duration per launch."""
from port_bench.counts import kernels as K
from port_bench.harness.readers import roofline


def read(run):
    if run.kind != "train":
        return None
    return roofline(run, "blend_fwd (checkpoint mode)", ("blend_fwd_kernel",),
                    lambda w: K.blend_fwd(w, checkpoints=True))
