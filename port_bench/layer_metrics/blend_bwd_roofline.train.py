"""Kernel D (D1s + D2): its least time for the traced views' work over the
sum of the two launches' median durations."""
from port_bench.counts import kernels as K
from port_bench.harness.readers import roofline


def read(run):
    if run.kind != "train":
        return None
    return roofline(run, "blend_bwd (D1s + D2)",
                    ("blend_bwd_sums_kernel", "blend_bwd_rows_kernel"), K.blend_bwd)
