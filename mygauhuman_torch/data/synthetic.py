"""Synthetic scene factory (port of data/synthetic.py).

A known "true" Gaussian scene on a synthetic SMPL body, with ground truth
rendered through the port's own `render_frame`. The numpy draws (colours,
normals, poses) are those of the JAX factory for the same seed.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mygauhuman_torch.data.camera import Camera, make_camera
from mygauhuman_torch.device import DEFAULT_DEVICE, resolve_device
from mygauhuman_torch.models import gaussians as G
from mygauhuman_torch.models.smpl import (
    SMPLModel,
    big_pose_params,
    smpl_forward,
    synthetic_smpl,
)
from mygauhuman_torch.ops.rasterize import RasterizerConfig
from mygauhuman_torch.render import FrameInputs, render_frame
from mygauhuman_torch.train.trainer import TrainBatch
from mygauhuman_torch.utils.transforms import inverse_sigmoid


class SyntheticScene(NamedTuple):
    smpl_model: SMPLModel
    gt_state: G.GaussianState       # the optimum
    init_state: G.GaussianState     # perturbed init for training
    batches: list                   # list[TrainBatch]
    big_pose_verts: torch.Tensor
    extent: float
    raster_config: RasterizerConfig


def look_at_camera(eye, target, width, height, fov=1.0,
                   device: str | torch.device = DEFAULT_DEVICE) -> Camera:
    """Camera at `eye` looking at `target` (camera +z forward)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])
    if abs(np.dot(up, fwd)) > 0.98:
        up = np.array([0.0, 0.0, 1.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_c2w = np.stack([right, down, fwd], axis=1)
    t = -R_c2w.T @ eye
    return make_camera(R=R_c2w, t=t, width=width, height=height,
                       fovx=fov, fovy=fov, device=device)


def _masks(alpha: torch.Tensor, width: int, height: int, pad: int = 4):
    """(person mask, dilated person-bbox mask) from a rendered alpha."""
    bkgd = (alpha > 0.5).float()
    ys, xs = torch.nonzero(alpha > 0.01, as_tuple=True)
    any_px = ys.numel() > 0
    y0 = max((int(ys.min()) if any_px else height) - pad, 0)
    y1 = min((int(ys.max()) if any_px else 0) + pad, height)
    x0 = max((int(xs.min()) if any_px else width) - pad, 0)
    x1 = min((int(xs.max()) if any_px else 0) + pad, width)
    yy = torch.arange(height, device=alpha.device)[:, None]
    xx = torch.arange(width, device=alpha.device)[None, :]
    bound = (yy >= y0) & (yy <= y1) & (xx >= x0) & (xx <= x1)
    return bkgd, bound.float()


def make_synthetic_scene(
    n_views: int = 4,
    width: int = 64,
    height: int = 64,
    n_verts: int = 300,
    seed: int = 0,
    n_poses: int = 1,
    radius: float = 3.0,
    capacity: int | None = None,
    raster_config: RasterizerConfig | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> SyntheticScene:
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    model = synthetic_smpl(num_vertices=n_verts, seed=seed, device=dev)
    big = big_pose_params(device=dev)
    with torch.no_grad():
        verts, _ = smpl_forward(model, big["poses"], big["shapes"])
    verts_np = verts.cpu().numpy()
    center = verts_np.mean(axis=0)

    colors = rng.rand(n_verts, 3).astype(np.float32)
    normals = rng.randn(n_verts, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)

    gt_state = G.create_from_pcd(verts_np, colors, normals, capacity=capacity, device=dev)
    # solid human: opacity 0.9 in the ground-truth scene
    gt_state = gt_state._replace(params=gt_state.params._replace(
        opacity=torch.full((gt_state.capacity, 1), inverse_sigmoid(0.9),
                           dtype=torch.float32, device=dev)))

    cfg = raster_config or RasterizerConfig(tile_capacity=512, chunk_tiles=16)
    batches = []
    for v in range(n_views):
        theta = 2 * np.pi * v / n_views
        eye = center + radius * np.array([np.sin(theta), 0.0, np.cos(theta)])
        cam = look_at_camera(eye, center, width, height, device=dev)
        for p in range(n_poses):
            pose = (0.1 * rng.randn(72)).astype(np.float32) if n_poses > 1 or p > 0 \
                else np.zeros(72, np.float32)
            frame = FrameInputs(
                smpl_param={
                    "poses": torch.as_tensor(pose, device=dev),
                    "shapes": torch.zeros(model.shapedirs.shape[-1], device=dev),
                    "R": torch.eye(3, device=dev),
                    "Th": torch.zeros(3, device=dev),
                },
                big_pose_param=big,
                big_pose_verts=verts,
            )
            with torch.no_grad():
                out = render_frame(gt_state, cam, frame, model, bg=torch.zeros(3, device=dev),
                                   active_sh_degree=0, config=cfg)
            bkgd, bound = _masks(out.render_alpha, width, height)
            batches.append(TrainBatch(camera=cam, frame=frame, gt_image=out.render,
                                      gt_normal=out.normal, bkgd_mask=bkgd,
                                      bound_mask=bound))

    # training init: same geometry, gray colours, default opacity (0.1)
    init_state = G.create_from_pcd(verts_np, np.full((n_verts, 3), 0.5, np.float32),
                                   normals, capacity=capacity, device=dev)
    extent = float(np.linalg.norm(verts_np.max(0) - verts_np.min(0))) * 0.5
    return SyntheticScene(smpl_model=model, gt_state=gt_state, init_state=init_state,
                          batches=batches, big_pose_verts=verts, extent=extent,
                          raster_config=cfg)
