"""Kernel A: the nearest big-pose vertex of every live Gaussian; its least
time over its median duration per launch."""
from port_bench.counts import kernels as K
from port_bench.harness.readers import roofline


def read(run):
    if run.kind != "serve":
        return None
    return roofline(run, "knn", ("knn_kernel",), lambda w: K.knn(run.live, run.vertices))
