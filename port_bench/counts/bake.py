"""Operations and bytes of one cube face of branch B's occlusion bake, and
its least time on an H100, counted from what the face's inputs need: every
alive Gaussian's posed rows read once (3 position, 6 covariance and 1
opacity floats: the projection and binning read each once), and the blend
of its tile lists as `counts/kernels.py::blend_fwd` counts it (one opacity
channel: the instances each pixel evaluates before it stops, the C + 3
output planes), from the plain reference's lists, which hold every
instance. A bake's faces are 6 per occupied cell.
"""
from __future__ import annotations

from port_bench.counts import kernels as K

POSED_ROW_BYTES = (3 + 6 + 1) * 4.0


def face(work: dict, n_alive: int) -> tuple[float, float]:
    """(operations, bytes) of one face (`work` of `reference/raster.py::blend`)."""
    ops, nbytes = K.blend_fwd(work)
    return ops, nbytes + POSED_ROW_BYTES * n_alive


def face_least_s(work: dict, n_alive: int) -> float:
    return K.bound_s(*face(work, n_alive))
