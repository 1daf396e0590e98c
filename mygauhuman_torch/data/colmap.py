"""Colmap scene reader (stock 3DGS path, dataset_readers.py:155-240; port of
data/colmap.py). Images are read through `utils/image_io.py::read_image`
(PNG in numpy, other formats through cv2), where the JAX reader uses
imageio."""
from __future__ import annotations

import os

import numpy as np

from mygauhuman_torch.data.camera import focal2fov
from mygauhuman_torch.data.colmap_loader import qvec2rotmat, read_model
from mygauhuman_torch.data.readers import (
    BasicPointCloud,
    CameraInfo,
    SceneInfo,
    get_nerfpp_norm,
)
from mygauhuman_torch.utils.image_io import read_image


def read_colmap_scene_info(
    path: str, white_background: bool = False, eval: bool = False,
    images_dir: str = "images", llffhold: int = 8,
) -> SceneInfo:
    sparse = os.path.join(path, "sparse", "0")
    if not os.path.exists(sparse):
        sparse = os.path.join(path, "sparse")
    cams, images, (xyz, rgb, _) = read_model(sparse)

    cam_infos = []
    for idx, (img_id, img) in enumerate(sorted(images.items())):
        cam = cams[img.camera_id]
        R = np.transpose(qvec2rotmat(img.qvec))
        T = np.array(img.tvec)
        if cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
            cx, cy = cam.params[1], cam.params[2]
        elif cam.model == "PINHOLE":
            fx, fy, cx, cy = cam.params[:4]
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {cam.model} "
                "(undistort with `convert` first, like the reference)"
            )
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        image_path = os.path.join(path, images_dir, img.name)
        image = read_image(image_path).astype(np.float32) / 255.0
        H, W = image.shape[:2]
        cam_infos.append(CameraInfo(
            uid=idx, pose_id=idx, R=R, T=T, K=K,
            FovY=focal2fov(fy, H), FovX=focal2fov(fx, W),
            image=image[..., :3], image_path=image_path,
            image_name=os.path.splitext(img.name)[0], width=W, height=H,
        ))

    if eval:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    pcd = BasicPointCloud(points=xyz, colors=rgb / 255.0,
                          normals=np.zeros_like(xyz))
    return SceneInfo(
        point_cloud=pcd, train_cameras=train, test_cameras=test,
        nerf_normalization=get_nerfpp_norm(train),
        ply_path=os.path.join(sparse, "points3D.ply"),
    )
