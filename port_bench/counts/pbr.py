"""Floating-point operations of a branch-B training step and of a camera's
bake, counted from the configuration's shapes as `counts/step.py` counts a
branch-A step: the work the passes require, not what an implementation
recomputes; elementwise chains (the shading, the occlusion colour, the
losses' maps) are not counted, so a share of the peak from these counts
reads a little low.

A step: LPIPS on the whole frame (the rendered and the ground-truth image
forward, the rendered one's input gradient), one SSIM forward and the
rendered side's gradient (3 of 5 maps), the blend forward in checkpoint
mode and its backward (the materials' gradient), the correction MLPs, the
nearest-vertex search and the LBS chain forward only (the geometry is
frozen), and the light's prefilters (the diffuse and each specular
level's product, forward and the light's gradient). A bake: its faces'
blends (`counts/bake.py`).
"""
from __future__ import annotations

from port_bench.counts import kernels as K
from port_bench.counts import step as S

LIGHT_MIN_RES = 8


def vgg_flops(height: int, width: int) -> float:
    """One image's forward through the 13 convolutions at height x width."""
    total = 0.0
    for (cin, cout), stage in zip(S.VGG_PLAN, S.STAGE_OF):
        total += 2.0 * 9 * cin * cout * (height // 2 ** stage) * (width // 2 ** stage)
    return total


def light_flops(base_res: int) -> float:
    """The prefilters' products forward and backward: the diffuse over the
    base and one specular level per mip of the chain (base_res halved down
    to 8 x 8), each a [6 r^2, 6 r^2] x [6 r^2, 3] product."""
    chain = [base_res]
    while chain[-1] > LIGHT_MIN_RES:
        chain.append(chain[-1] // 2)
    return 2 * sum(2.0 * (6 * r * r) ** 2 * 3 for r in [base_res] + chain)


def pbr_step(*, height: int, width: int, lpips: bool, work: dict, n: int, vertices: int,
             joints: int, light_res: int) -> float:
    ops = 3 * vgg_flops(height, width) if lpips else 0.0
    ops += S.ssim_flops(height, width) * (1 + 3 / 5)
    ops += K.blend_fwd(work, checkpoints=True)[0] + K.blend_bwd(work)[0]
    ops += S.lbs_offset_flops(n, joints) + S.pose_refiner_flops(joints)
    ops += K.knn(n, vertices)[0] + K.DEFORM_FWD_OPS * n
    return ops + light_flops(light_res)
