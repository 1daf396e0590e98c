"""Depth map -> world points -> normal map, the alternative normal
supervision (port of render/depth_normal.py).

Parity: utils/graphics_utils.py:111-172 (depth2point_world,
depth_pcd2normal, normal_from_depth_image) consumed by render_normal
(gaussian_renderer/__init__.py:40-50). The per-Gaussian `_normal` channel is
the active path in the reference; this depth-derived normal is the drop-in
alternative.
"""
from __future__ import annotations

import torch


def depth_to_world_points(depth: torch.Tensor, intrinsic: torch.Tensor,
                          c2w: torch.Tensor) -> torch.Tensor:
    """Back-project a depth map [H, W] with K [3, 3] and camera-to-world
    [4, 4] to world-space points [H, W, 3]."""
    H, W = depth.shape
    xs = torch.arange(W, dtype=torch.float32, device=depth.device) + 0.5
    ys = torch.arange(H, dtype=torch.float32, device=depth.device) + 0.5
    v, u = torch.meshgrid(ys, xs, indexing="ij")
    x = (u - intrinsic[0, 2]) / intrinsic[0, 0] * depth
    y = (v - intrinsic[1, 2]) / intrinsic[1, 1] * depth
    cam = torch.stack([x, y, depth, torch.ones_like(depth)], dim=-1)
    return torch.einsum("ij,hwj->hwi", c2w, cam)[..., :3]


def points_to_normals(points: torch.Tensor) -> torch.Tensor:
    """Central-difference cross-product normals of a point map [H, W, 3],
    zero at the 1-pixel border (depth_pcd2normal, graphics_utils.py:127-146)."""
    dy = points[2:, 1:-1] - points[:-2, 1:-1]
    dx = points[1:-1, 2:] - points[1:-1, :-2]
    n = torch.linalg.cross(dx, dy, dim=-1)
    n = n * torch.rsqrt((n * n).sum(dim=-1, keepdim=True) + 1e-12)
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))


def normal_from_depth_image(depth: torch.Tensor, intrinsic: torch.Tensor,
                            c2w: torch.Tensor) -> torch.Tensor:
    """World-space normal map [H, W, 3] from a rendered depth map."""
    return points_to_normals(depth_to_world_points(depth, intrinsic, c2w))
