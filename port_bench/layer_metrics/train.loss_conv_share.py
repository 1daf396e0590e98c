"""Share of the traced chunk's kernel time in convolution kernels (the
LPIPS VGG trunk and the SSIM window), by kernel name."""
from port_bench.harness.readers import CONV_TOKENS


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    total = run.trace.kernel_time()
    if total <= 0:
        return None
    return 100.0 * run.trace.kernel_time(CONV_TOKENS) / total
