"""Process start to the window's start: imports, the CUDA context, the
kernels' build (first run of a checkout only), the inputs and the ground
truth, the program's set-up and warm-up (the first training iterations,
or the first frames and the graph capture)."""


def read(run):
    return run.setup_s
