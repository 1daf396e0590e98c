"""Blender/NeRF-synthetic scene reader (dataset_readers.py:244-310; port of
data/blender.py). Images are read through `utils/image_io.py::read_image`
(PNG in numpy, other formats through cv2), where the JAX reader uses
imageio."""
from __future__ import annotations

import json
import os

import numpy as np

from mygauhuman_torch.data.camera import focal2fov, fov2focal
from mygauhuman_torch.data.readers import (
    BasicPointCloud,
    CameraInfo,
    SceneInfo,
    get_nerfpp_norm,
)
from mygauhuman_torch.utils.image_io import read_image


def _read_split(path: str, transforms_file: str, white_background: bool,
                extension: str = ".png") -> list:
    with open(os.path.join(path, transforms_file)) as f:
        meta = json.load(f)
    fovx = meta["camera_angle_x"]
    infos = []
    for idx, frame in enumerate(meta["frames"]):
        file_path = os.path.join(path, frame["file_path"] + extension)
        c2w = np.array(frame["transform_matrix"])
        # OpenGL/Blender (Y up, Z back) -> COLMAP (Y down, Z forward)
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]

        image = read_image(file_path).astype(np.float32) / 255.0
        if image.shape[-1] == 4:
            bg = 1.0 if white_background else 0.0
            alpha = image[..., 3:4]
            image = image[..., :3] * alpha + bg * (1 - alpha)
        H, W = image.shape[:2]
        fovy = focal2fov(fov2focal(fovx, W), H)
        K = np.array([
            [fov2focal(fovx, W), 0, W / 2],
            [0, fov2focal(fovy, H), H / 2],
            [0, 0, 1],
        ])
        infos.append(CameraInfo(
            uid=idx, pose_id=idx, R=R, T=T, K=K, FovY=fovy, FovX=fovx,
            image=image, image_path=file_path,
            image_name=os.path.basename(frame["file_path"]),
            width=W, height=H,
        ))
    return infos


def read_nerf_synthetic_info(
    path: str, white_background: bool = False, eval: bool = False,
    extension: str = ".png",
) -> SceneInfo:
    train = _read_split(path, "transforms_train.json", white_background,
                        extension)
    test = (
        _read_split(path, "transforms_test.json", white_background, extension)
        if eval and os.path.exists(os.path.join(path, "transforms_test.json"))
        else []
    )
    if not eval:
        train.extend(test)
        test = []

    # random init cloud inside the synthetic bounds (dataset_readers.py:291-300)
    rng = np.random.RandomState(0)
    num_pts = 100_000
    xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
    colors = rng.random((num_pts, 3))
    pcd = BasicPointCloud(points=xyz, colors=colors,
                          normals=np.zeros_like(xyz))
    return SceneInfo(
        point_cloud=pcd, train_cameras=train, test_cameras=test,
        nerf_normalization=get_nerfpp_norm(train),
        ply_path=os.path.join(path, "points3d.ply"),
    )
