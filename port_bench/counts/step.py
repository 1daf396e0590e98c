"""Floating-point operations of a whole training step and of a served frame,
counted from the configuration's shapes: the work the forward and backward
passes require, not what an implementation recomputes. Counted: the LPIPS
VGG convolutions, the SSIM window, the blend (from `reference/raster.py`'s
work counts), the correction MLPs, the nearest-vertex search and the LBS
chain. Elementwise chains are not counted, so a share of the peak from
these counts reads a little low.
"""
from __future__ import annotations

from port_bench.counts import kernels as K

VGG_PLAN = ((3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 256),
            (256, 512), (512, 512), (512, 512), (512, 512), (512, 512), (512, 512))
STAGE_OF = (0, 0, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4)
SSIM_TAPS = 11
MLP_WIDTH, PE_DIM = 128, 63


def vgg_flops(side: int) -> float:
    """One image's forward through the 13 3 x 3 convolutions at side x side
    (each stage after the first at half the side of the one before)."""
    total = 0.0
    for (cin, cout), stage in zip(VGG_PLAN, STAGE_OF):
        r = side // (2 ** stage)
        total += 2.0 * 9 * cin * cout * r * r
    return total


def ssim_flops(height: int, width: int) -> float:
    """One SSIM of 3-channel images: five maps, each two 11-tap passes."""
    return 5 * 2 * 2.0 * SSIM_TAPS * 3 * height * width


def lbs_offset_flops(n: int, joints: int) -> float:
    dims = ((PE_DIM, MLP_WIDTH), (MLP_WIDTH, MLP_WIDTH), (MLP_WIDTH, MLP_WIDTH),
            (MLP_WIDTH + PE_DIM, MLP_WIDTH), (MLP_WIDTH, joints))
    return 2.0 * n * sum(a * b for a, b in dims)


def pose_refiner_flops(joints: int) -> float:
    d = 3 * (joints - 1)
    return 2.0 * (d * MLP_WIDTH + MLP_WIDTH * MLP_WIDTH + MLP_WIDTH * d)


def train_step(*, height: int, width: int, crop: int, lpips: bool, work: dict, n: int,
               vertices: int, joints: int) -> float:
    """A branch-A step: LPIPS forward on the four cropped images (render,
    ground truth, normal, ground-truth normal) and its input gradient on
    the two rendered ones; both SSIMs forward and the rendered side's
    gradient (3 of 5 maps); the blend forward in checkpoint mode and its
    backward; the MLPs forward and backward (x3); the search and the chain
    forward and backward over the n live Gaussians."""
    ops = 0.0
    if lpips:
        ops += 6 * vgg_flops(crop)
    ops += 2 * (ssim_flops(height, width) * (1 + 3 / 5))
    ops += K.blend_fwd(work, checkpoints=True)[0] + K.blend_bwd(work)[0]
    ops += 3 * (lbs_offset_flops(n, joints) + pose_refiner_flops(joints))
    ops += K.knn(n, vertices)[0] + (K.DEFORM_FWD_OPS + 669) * n
    return ops


def render_frame(*, work: dict, n: int, vertices: int, joints: int, branch: str) -> float:
    """A served frame: the blend, and on the deform branch the MLPs forward,
    the search and the chain over the n live Gaussians."""
    ops = K.blend_fwd(work)[0]
    if branch == "deform":
        ops += lbs_offset_flops(n, joints) + pose_refiner_flops(joints)
        ops += K.knn(n, vertices)[0] + K.deform(n)[0]
    return ops
