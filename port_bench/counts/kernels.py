"""Operations and bytes that the inputs of each kernel need, and the least
time an H100 could take for them.

Copied from `chip_smoke.py` (`bound`, lines 420-424; the counts of
`check_kernel_a` 475-514, `check_kernel_b` 516-550, `check_kernel_c`
552-638, `check_kernel_d` 640-716; the peaks, lines 205-206). A count is of
what the inputs need, whatever implements the work: each input byte read
once, each output byte written once, and for the blend the (pixel,
instance) pairs that some pixel evaluates before it stops, as
`reference/raster.py::blend` counts them. So a change to a kernel cannot
move its yardstick.
"""
from __future__ import annotations

# NVIDIA H100 SXM, dense, at its 700 W limit (the data sheet)
FP32_OPS_PER_S = 67e12          # fp32 outside the tensor cores
BYTES_PER_S = 3.35e12           # HBM3
DEFORM_FWD_OPS = 297            # fp32 operations per Gaussian of kernel B's forward
KNN_OPS_PER_PAIR = 11.0         # fp32 operations per (query, reference) pair of kernel A


def bound_s(ops: float, nbytes: float) -> float:
    """The least seconds: the larger of operations over the fp32 peak and
    bytes over the memory bandwidth."""
    return max(ops / FP32_OPS_PER_S, nbytes / BYTES_PER_S)


def knn(queries: int, refs: int, k: int = 1) -> tuple[float, float]:
    """Kernel A: (operations, bytes) of the nearest `k` of `refs` points
    for each of `queries` points."""
    return KNN_OPS_PER_PAIR * queries * refs, 12.0 * (queries + refs) + 8.0 * queries * k


def deform(n: int) -> tuple[float, float]:
    """Kernel B's forward over n Gaussians: 33 floats in, 21 out each."""
    return float(DEFORM_FWD_OPS * n), (12 + 12 + 9 + 21) * 4.0 * n + 32 * 4.0


def blend_fwd(work: dict, checkpoints: bool = False) -> tuple[float, float]:
    """Kernel C over one frame's lists (`work` of `reference/raster.py::
    blend`): ~20 fp32 operations per evaluated pair and 2 (C + 2) + 4 per
    included one; the 7 + C rows of each instance some pixel evaluates,
    starts and counts, and the C + 3 output planes. Checkpoint mode (a
    differentiated forward) also writes T per (chunk, pixel), the stop and
    final T per pixel of the busy tiles, and the slot map."""
    C, P = work["channels"], work["tile_pixels"]
    ops = 20.0 * work["pairs_evaluated"] + (2.0 * (C + 2) + 4.0) * work["pairs_included"]
    nbytes = ((7 + C) * 4.0 * work["instances_read"] + 8.0 * work["tiles"]
              + (C + 3) * 4.0 * work["pixels"])
    if checkpoints:
        nbytes += 4.0 * (work["chunks"] + 2 * work["busy_tiles"]) * P + 8.0 * work["chunks"]
    return ops, nbytes


def blend_bwd(work: dict) -> tuple[float, float]:
    """Kernel D (D1s + D2) over one frame's lists: both passes evaluate the
    pairs before each pixel stops (~40 operations together), the included
    pairs add the gradient arithmetic (~3 C + 30); the instances' 7 + C rows
    are read and their gradient rows written, with the C + 3 cotangent
    planes of the busy tiles and starts / counts."""
    C, P = work["channels"], work["tile_pixels"]
    ops = 40.0 * work["pairs_evaluated"] + (3.0 * C + 30.0) * work["pairs_included"]
    nbytes = (2 * (7 + C) * 4.0 * work["instances_read"]
              + work["busy_tiles"] * P * (C + 3) * 4.0 + 8.0 * work["tiles"])
    return ops, nbytes
