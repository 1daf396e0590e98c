"""Kernel B's forward: the LBS chain of every live Gaussian; its least time
over its median duration per launch."""
from port_bench.counts import kernels as K
from port_bench.harness.readers import roofline


def read(run):
    if run.kind != "serve":
        return None
    return roofline(run, "deform", ("deform_fwd_kernel",), lambda w: K.deform(run.live))
