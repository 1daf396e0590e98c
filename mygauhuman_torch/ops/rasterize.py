"""Gaussian rasterizer: preprocess -> bin -> blend (port of ops/rasterize.py).

One multi-channel pass: callers stack their channels as feature columns.
The blend follows the device of the inputs: CUDA tensors go through kernel
C (`ops/pallas_blend.py::blend_pallas`, counts capped at tile_capacity as
the JAX kernel path does), CPU tensors through the masked-cumprod spec
(`ops/blend.py::blend`, which autograd differentiates).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mygauhuman_torch.ops.binning import bin_gaussians
from mygauhuman_torch.ops.blend import blend
from mygauhuman_torch.ops.pallas_blend import blend_pallas
from mygauhuman_torch.ops.projection import preprocess


class RasterizerConfig(NamedTuple):
    tile_w: int = 16
    tile_h: int = 16
    max_tiles_per_gaussian: int = 16
    tile_capacity: int = 1024
    chunk_tiles: int = 64
    instance_capacity: int | None = None  # compacted instance-list cap I
                                          # (None = exact N * S)


class RasterizeOutput(NamedTuple):
    image: torch.Tensor      # [H, W, C]
    alpha: torch.Tensor      # [H, W] sum of blend weights
    depth: torch.Tensor      # [H, W]
    final_t: torch.Tensor    # [H, W]
    radii: torch.Tensor      # [N] int32
    means2d: torch.Tensor    # [N, 2]
    visible: torch.Tensor    # [N] bool
    overflow_tiles: torch.Tensor
    overflow_gauss: torch.Tensor
    overflow_inst: torch.Tensor


def rasterize(
    means3d: torch.Tensor,      # [N, 3] world
    cov3d6: torch.Tensor,       # [N, 6]
    opacities: torch.Tensor,    # [N] activated
    features: torch.Tensor,     # [N, C]
    w2c: torch.Tensor,          # [4, 4]
    full_proj: torch.Tensor,    # [4, 4]
    bg: torch.Tensor,           # [C]
    *,
    width: int,
    height: int,
    tan_fovx: float,
    tan_fovy: float,
    config: RasterizerConfig = RasterizerConfig(),
    means2d_offset: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
) -> RasterizeOutput:
    """Render one camera. `alive` masks padded slots of fixed-capacity arrays."""
    proj = preprocess(means3d, cov3d6, w2c, full_proj, width, height, tan_fovx, tan_fovy)
    means2d = proj.means2d
    if means2d_offset is not None:
        means2d = means2d + means2d_offset
    visible = proj.visible if alive is None else (proj.visible & alive)

    bins = bin_gaussians(
        means2d.detach(), proj.radii, proj.depths.detach(), visible,
        width=width, height=height, tile_w=config.tile_w, tile_h=config.tile_h,
        max_tiles_per_gaussian=config.max_tiles_per_gaussian,
        tile_capacity=config.tile_capacity,
        instance_capacity=config.instance_capacity,
    )
    if means3d.is_cuda:
        out = blend_pallas(
            bins.sorted_rank, bins.order, bins.rank, bins.starts,
            torch.clamp(bins.counts, max=config.tile_capacity),
            means2d, proj.conics, opacities, features, proj.depths, bg,
            width=width, height=height, tile_w=config.tile_w, tile_h=config.tile_h,
        )
    else:
        out = blend(
            bins.idx, bins.valid, means2d, proj.conics, opacities, features,
            proj.depths, bg, width=width, height=height, tile_w=config.tile_w,
            tile_h=config.tile_h, chunk_tiles=config.chunk_tiles,
        )
    return RasterizeOutput(
        image=out.image,
        alpha=out.alpha,
        depth=out.depth,
        final_t=out.final_t,
        radii=torch.where(visible, proj.radii, torch.zeros_like(proj.radii)),
        means2d=means2d,
        visible=visible,
        overflow_tiles=bins.overflow_tiles,
        overflow_gauss=bins.overflow_gauss,
        overflow_inst=bins.overflow_inst,
    )


def mark_visible(means3d: torch.Tensor, w2c: torch.Tensor, full_proj: torch.Tensor,
                 znear: float = 0.2) -> torch.Tensor:
    """Frustum visibility [N] bool without rendering: camera-space z > znear
    (full_proj is unused, as in the JAX signature)."""
    hom = torch.cat([means3d, torch.ones_like(means3d[:, :1])], dim=-1)
    return (hom @ w2c.T)[:, 2] > znear
