"""Scene: the reference's top-level dataset/model holder (port of
data/scene.py).

Parity: scene/__init__.py:25-161 — dataset-type dispatch, camera lists,
scene extent from the nerf++ normalization, Gaussian init from the point
cloud (or PLY reload at a given iteration), save(), and per-pixel canonical
rays. Tensors (the Gaussians, the batches) live on `device`.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from mygauhuman_torch.data.readers import (
    SceneInfo,
    camera_info_to_batch,
    load_scene_info,
)
from mygauhuman_torch.device import DEFAULT_DEVICE, resolve_device
from mygauhuman_torch.models import gaussians as G
from mygauhuman_torch.models.io import load_ply, save_ply


class Scene:
    def __init__(
        self,
        source_path: str,
        output_path: str = "exp",
        white_background: bool = False,
        eval: bool = True,
        smpl_model=None,
        load_iteration: int | None = None,
        model_dir: str | None = None,
        sh_degree: int = 3,
        shuffle: bool = True,
        seed: int = 0,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        self.device = resolve_device(device)
        self.info: SceneInfo = load_scene_info(
            source_path, white_background, output_path, eval, smpl_model
        )
        self.cameras_extent = self.info.nerf_normalization["radius"]

        self.train_cameras = list(self.info.train_cameras)
        self.test_cameras = list(self.info.test_cameras)
        if shuffle:
            rng = np.random.RandomState(seed)
            rng.shuffle(self.train_cameras)

        if load_iteration is not None and model_dir is not None:
            ply = os.path.join(model_dir, f"point_cloud_{load_iteration}.ply")
            self.gaussians = load_ply(ply, sh_degree=sh_degree, device=self.device)
            self.loaded_iter = load_iteration
        else:
            pcd = self.info.point_cloud
            self.gaussians = G.create_from_pcd(
                pcd.points, pcd.colors, pcd.normals, sh_degree=sh_degree,
                device=self.device,
            )
            self.loaded_iter = None

    def get_train_cameras(self) -> list:
        return self.train_cameras

    def get_test_cameras(self) -> list:
        return self.test_cameras

    def train_batches(self) -> list:
        return [camera_info_to_batch(c, self.device) for c in self.train_cameras]

    def test_batches(self) -> list:
        return [camera_info_to_batch(c, self.device) for c in self.test_cameras]

    def save(self, model_dir: str, iteration: int) -> str:
        os.makedirs(model_dir, exist_ok=True)
        path = os.path.join(model_dir, f"point_cloud_{iteration}.ply")
        save_ply(self.gaussians, path)
        return path

    def get_canonical_rays(self) -> np.ndarray:
        """[H*W, 3] unnormalized camera-space ray dirs of the first train
        camera (scene/__init__.py:129-161)."""
        ref = self.train_cameras[0]
        H, W = ref.height, ref.width
        tan_fovx = math.tan(ref.FovX * 0.5)
        tan_fovy = math.tan(ref.FovY * 0.5)
        focal_x = W / (2.0 * tan_fovx)
        focal_y = H / (2.0 * tan_fovy)
        x, y = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
        dirs = np.stack(
            [
                (x.ravel() - W / 2 + 0.5) / focal_x,
                (y.ravel() - H / 2 + 0.5) / focal_y,
                np.ones(H * W),
            ],
            axis=-1,
        )
        return dirs.astype(np.float32)
