"""Rendering orchestration: deform -> features -> one fused rasterize pass.

Port of render/renderer.py. All 19 channels (rgb, camera-space normal,
world normal, albedo, occlusion, roughness, min-scale axis) ride one blend
as feature columns. Two branches:
  * deform (default): SMPL transforms -> nearest-vertex KNN (kernel A) ->
    LBS chain (kernel B), optionally with the pose-refiner and LBS-offset
    MLPs (`mlp_params`);
  * replay: cached per-Gaussian `transforms` / `translation` (as returned
    by a deform render) skip the MLPs and the deform.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from mygauhuman_torch.data.camera import Camera
from mygauhuman_torch.models.gaussians import (
    GaussianParams,
    GaussianState,
    flip_align_view,
    get_albedo,
    get_covariance6,
    get_features,
    get_minimum_axis,
    get_opacity,
    get_roughness,
)
from mygauhuman_torch.models.lbs import coarse_deform_c2source
from mygauhuman_torch.models.mlps import apply_lbs_offset, apply_pose_refiner
from mygauhuman_torch.models.smpl import SMPLModel
from mygauhuman_torch.ops.rasterize import RasterizerConfig, rasterize
from mygauhuman_torch.ops.sh import eval_sh_color
from mygauhuman_torch.utils.transforms import normalize, rot_apply


class _Channels:
    """Fused feature-column layout. C = 19."""

    rgb = slice(0, 3)
    normal = slice(3, 6)
    world_normal = slice(6, 9)
    albedo = slice(9, 12)
    occlusion = slice(12, 15)
    roughness = slice(15, 16)
    axis = slice(16, 19)
    total = 19


CH = _Channels()


class FrameInputs(NamedTuple):
    """Per-frame pose data."""

    smpl_param: Any               # dict: poses [72], shapes [B], R [3,3], Th [3]
    big_pose_param: Any           # dict for the canonical big pose
    big_pose_verts: torch.Tensor  # [V, 3] canonical SMPL vertices


class RenderResult(NamedTuple):
    render: torch.Tensor          # [H, W, 3]
    render_depth: torch.Tensor    # [H, W]
    render_alpha: torch.Tensor    # [H, W]
    normal: torch.Tensor          # [H, W, 3] camera-space, mapped to [0, 1]
    world_normal: torch.Tensor    # [H, W, 3] mapped to [0, 1]
    albedo: torch.Tensor          # [H, W, 3]
    occlusion: torch.Tensor       # [H, W, 3]
    roughness: torch.Tensor       # [H, W]
    render_axis: torch.Tensor     # [H, W, 3]
    radii: torch.Tensor           # [cap] int32
    visibility_filter: torch.Tensor  # [cap] bool
    transforms: torch.Tensor      # [cap, 3, 3] LBS rotations (for replay)
    translation: torch.Tensor     # [cap, 3]
    correct_Rs: torch.Tensor | None
    overflow_tiles: torch.Tensor  # binning truncation counters
    overflow_gauss: torch.Tensor
    overflow_inst: torch.Tensor


def _pack_bg(bg_rgb: torch.Tensor) -> torch.Tensor:
    """Per-channel background: the rgb background for every 3-channel group,
    its mean for roughness."""
    bg_rgb = bg_rgb.float()
    return torch.cat([bg_rgb, bg_rgb, bg_rgb, bg_rgb, bg_rgb,
                      bg_rgb.mean()[None], bg_rgb])


def render_frame(
    state: GaussianState,
    camera: Camera,
    frame: FrameInputs,
    smpl_model: SMPLModel,
    *,
    bg: torch.Tensor,                      # [3]
    active_sh_degree: int,
    mlp_params: dict | None = None,        # {pose_refiner, lbs_offset}
    config: RasterizerConfig = RasterizerConfig(),
    means2d_offset: torch.Tensor | None = None,
    occlusion_color: torch.Tensor | None = None,   # [cap, 3] baked AO
    transforms: torch.Tensor | None = None,        # replay branch
    translation: torch.Tensor | None = None,
    scaling_modifier: float = 1.0,
    raster_fn=None,        # rasterize-compatible; parallel/raster.py's strip
                           # rasterizer for the tile-sharded steps
) -> RenderResult:
    """Render one camera view of the articulated Gaussian human."""
    p: GaussianParams = state.params
    means_canonical = p.xyz
    correct_Rs = None

    if transforms is not None and translation is not None:
        means3d = rot_apply(transforms, means_canonical) + translation
        world_normal = rot_apply(transforms, p.normal)
    else:
        lbs_offset = None
        if mlp_params is not None:
            pose_vec = frame.smpl_param["poses"].reshape(-1)[3:]
            correct_Rs = apply_pose_refiner(mlp_params["pose_refiner"], pose_vec)
            lbs_offset = apply_lbs_offset(mlp_params["lbs_offset"],
                                          means_canonical.detach())
        deform = coarse_deform_c2source(
            smpl_model, means_canonical, frame.smpl_param, frame.big_pose_param,
            frame.big_pose_verts, lbs_offset=lbs_offset, correct_Rs=correct_Rs,
            normals=p.normal,
        )
        means3d = deform.world_pts
        world_normal = deform.world_normals
        transforms = deform.transforms
        translation = deform.translation

    viewdir = normalize(means3d - camera.cam_center[None, :])

    # min-scale axis as pseudo-normal, flipped toward the viewer, rotated
    # to world by the LBS transform
    axis, _ = flip_align_view(get_minimum_axis(p), viewdir)
    world_axis = normalize(rot_apply(transforms, axis))
    world_normal = normalize(world_normal)

    R_w2c = camera.w2c[:3, :3]
    # filled on the device: a CUDA graph capture refuses copies from the host
    flip_y = torch.ones(3, dtype=torch.float32, device=means3d.device)
    flip_y[1:2].fill_(-1.0)

    def to_cam01(v):
        return (v @ R_w2c.T) * flip_y * 0.5 + 0.5

    opacity = get_opacity(p)[:, 0]
    if occlusion_color is None:
        occlusion_color = opacity[:, None].repeat(1, 3)

    sh_coeffs = get_features(p).transpose(1, 2)       # [cap, 3, coeffs]
    rgb = eval_sh_color(active_sh_degree, sh_coeffs, viewdir)

    features = torch.cat(
        [rgb, to_cam01(world_normal), world_normal * 0.5 + 0.5, get_albedo(p),
         occlusion_color, get_roughness(p), to_cam01(world_axis)],
        dim=1,
    )
    # dead slots never blend, but keep their rows finite
    features = torch.where(state.alive[:, None], features, torch.zeros_like(features))

    cov6 = get_covariance6(p, scaling_modifier, transforms)
    out = (raster_fn or rasterize)(
        means3d, cov6, opacity, features, camera.w2c, camera.full_proj, _pack_bg(bg),
        width=camera.width, height=camera.height, tan_fovx=camera.tan_fovx,
        tan_fovy=camera.tan_fovy, config=config, means2d_offset=means2d_offset,
        alive=state.alive,
    )

    img = out.image
    return RenderResult(
        render=img[..., CH.rgb],
        render_depth=out.depth,
        render_alpha=out.alpha,
        normal=img[..., CH.normal],
        world_normal=img[..., CH.world_normal],
        albedo=img[..., CH.albedo],
        occlusion=img[..., CH.occlusion],
        roughness=img[..., CH.roughness][..., 0],
        render_axis=img[..., CH.axis],
        radii=out.radii,
        visibility_filter=out.radii > 0,
        transforms=transforms,
        translation=translation,
        correct_Rs=correct_Rs,
        overflow_tiles=out.overflow_tiles,
        overflow_gauss=out.overflow_gauss,
        overflow_inst=out.overflow_inst,
    )
