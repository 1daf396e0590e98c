"""One frame of the plain reference: deform (or replay), features, project,
bin, blend.

The frame's mathematics follow `mygauhuman_torch/render/renderer.py`: the
19 feature columns (SH colour, camera-space normal, world normal, albedo,
occlusion, roughness, the min-scale axis flipped to the viewer), the
activations of `models/gaussians.py` (exp of the clamped log-scale,
sigmoid opacity / albedo / roughness, the covariance conjugated by the
Gaussian's LBS rotation), and the rasterizer of `reference/raster.py`.
Parameters are a dict of raw tensors: xyz [N, 3], features_dc [N, 1, 3],
features_rest [N, R, 3], scaling [N, 3], rotation [N, 4], opacity [N, 1],
normal [N, 3], albedo [N, 3], roughness [N, 1].
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from port_bench.reference import raster as RZ
from port_bench.reference.deform import deform
from port_bench.reference.sh import eval_sh_color
from port_bench.reference.transforms import (
    covariance6_from_scaling_rotation,
    normalize,
    quat_to_rotmat_cols,
    rot_apply,
)


class Raster(NamedTuple):
    """The program's rasterizer settings (its `RasterizerConfig`)."""
    tile_w: int = 16
    tile_h: int = 16
    max_tiles_per_gaussian: int = 16
    tile_capacity: int = 1024
    instance_capacity: int | None = None


class Frame(NamedTuple):
    render: torch.Tensor        # [H, W, 3]
    alpha: torch.Tensor         # [H, W]
    normal: torch.Tensor        # [H, W, 3] camera-space, in [0, 1]
    axis: torch.Tensor          # [H, W, 3]
    depth: torch.Tensor         # [H, W]
    radii: torch.Tensor         # [N] int32
    transforms: torch.Tensor    # [N, 3, 3]
    translation: torch.Tensor   # [N, 3]
    work: dict


def scaling(p):
    return torch.exp(torch.clamp(p["scaling"], -15.0, 8.0))


def min_axis(p):
    s = scaling(p)
    r = quat_to_rotmat_cols(p["rotation"])
    idx = torch.argmin(s, dim=-1)
    pick0, pick1 = idx == 0, idx == 1

    def col(c0, c1, c2):
        return torch.where(pick0, c0, torch.where(pick1, c1, c2))

    return torch.stack([col(r[0], r[1], r[2]), col(r[3], r[4], r[5]), col(r[6], r[7], r[8])],
                       dim=-1)


def render(p: dict, alive, camera: dict, frame: dict, body: dict, *, sh_degree: int,
           mlp: dict | None, raster: Raster, bg, transforms=None, translation=None,
           means2d_offset=None, opacity_eps=0.0) -> Frame:
    """Render one camera view (`camera`: w2c, full_proj, cam_center,
    tan_fovx, tan_fovy, width, height; `frame`: poses, shapes, R, Th, and
    the big pose `big` and its vertices `big_verts`)."""
    xyz = p["xyz"]
    if transforms is None:
        means3d, world_normal, transforms, translation = deform(
            body, xyz, p["normal"], frame, frame["big"], frame["big_verts"], mlp)
    else:
        means3d = rot_apply(transforms, xyz) + translation
        world_normal = rot_apply(transforms, p["normal"])
    viewdir = normalize(means3d - camera["cam_center"][None, :])
    axis = min_axis(p)
    axis = torch.where((axis * -viewdir).sum(-1, keepdim=True) >= 0.0, axis, -axis)
    world_axis = normalize(rot_apply(transforms, axis))
    world_normal = normalize(world_normal)
    R_w2c = camera["w2c"][:3, :3]
    flip_y = torch.tensor([1.0, -1.0, 1.0], device=xyz.device)

    def to_cam01(v):
        return (v @ R_w2c.T) * flip_y * 0.5 + 0.5

    opacity = torch.sigmoid(p["opacity"] + opacity_eps)[:, 0]
    sh = torch.cat([p["features_dc"], p["features_rest"]], dim=1).transpose(1, 2)
    rgb = eval_sh_color(sh_degree, sh, viewdir)
    features = torch.cat([rgb, to_cam01(world_normal), world_normal * 0.5 + 0.5,
                          torch.sigmoid(p["albedo"]), opacity[:, None].repeat(1, 3),
                          torch.sigmoid(p["roughness"]), to_cam01(world_axis)], dim=1)
    features = torch.where(alive[:, None], features, torch.zeros_like(features))
    cov6 = covariance6_from_scaling_rotation(scaling(p), p["rotation"], 1.0, transforms)
    W, H = camera["width"], camera["height"]
    proj = RZ.preprocess(means3d, cov6, camera["w2c"], camera["full_proj"], W, H,
                         camera["tan_fovx"], camera["tan_fovy"])
    means2d = proj.means2d if means2d_offset is None else proj.means2d + means2d_offset
    visible = proj.visible & alive
    bins = RZ.bin_gaussians(means2d.detach(), proj.radii, proj.depths.detach(), visible,
                            width=W, height=H, tile_w=raster.tile_w, tile_h=raster.tile_h,
                            max_tiles_per_gaussian=raster.max_tiles_per_gaussian,
                            tile_capacity=raster.tile_capacity,
                            instance_capacity=raster.instance_capacity)
    bg_c = bg.float()
    bg19 = torch.cat([bg_c, bg_c, bg_c, bg_c, bg_c, bg_c.mean()[None], bg_c])
    out = RZ.blend(bins, means2d, proj.conics, opacity, features, proj.depths, bg19,
                   width=W, height=H, tile_w=raster.tile_w, tile_h=raster.tile_h)
    img = out.image
    return Frame(render=img[..., 0:3], alpha=out.alpha, normal=img[..., 3:6],
                 axis=img[..., 16:19], depth=out.depth,
                 radii=torch.where(visible, proj.radii, torch.zeros_like(proj.radii)),
                 transforms=transforms, translation=translation, work=out.work)
