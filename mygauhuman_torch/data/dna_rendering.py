"""DNA-Rendering dataset reader: SMC files and SMPL-X (port of
data/dna_rendering.py).

Parity: readDNARenderingInfo / readCamerasDNARendering
(scene/dataset_readers.py:998-1248): the main .smc for images, the sibling
annotations .smc for masks, calibration and SMPL-X (the main file when
there is none), the body in SMPL-X space (R = I, Th = transl), 0.5 image
scaling. The SMPL-X vertices come from the port's `smpl_forward` on the
model's device, then go to numpy as the rest of the reader's payload.
`cv2` is imported inside the function that uses it, `h5py` inside
`SMCReader`.

Two reference quirks are kept as they are: the annotations path is
`path.replace("main", "annotations").split(".")[0] + "_annots.smc"`, so a
dot in a directory name misses the sibling file and the main file is read
instead; and `load_scene_info` tests "render" before "dna_rendering".
"""
from __future__ import annotations

import os

import numpy as np
import torch

from mygauhuman_torch.data.camera import focal2fov
from mygauhuman_torch.data.readers import (
    BasicPointCloud,
    CameraInfo,
    SceneInfo,
    get_bound_2d_mask,
    get_nerfpp_norm,
)
from mygauhuman_torch.data.smc_reader import SMCReader
from mygauhuman_torch.models.smpl import smpl_forward
from mygauhuman_torch.models.smplx import load_smplx, smplx_big_pose_params, smplx_full_pose


def _vertices(model, poses, shapes) -> np.ndarray:
    """SMPL-X vertices [V, 3] as float32 numpy."""
    dev = model.v_template.device
    with torch.no_grad():
        verts, _ = smpl_forward(model, torch.as_tensor(np.asarray(poses), device=dev),
                                torch.as_tensor(np.asarray(shapes), device=dev))
    return verts.cpu().numpy().astype(np.float32)


def read_cameras_dna_rendering(
    path: str,
    output_view: list,
    white_background: bool,
    smplx_model,
    image_scaling: float = 0.5,
    split: str = "train",
) -> list:
    import cv2

    pose_start, pose_interval, pose_num = (
        (0, 1, 100) if split == "train" else (0, 5, 20)
    )

    smc_reader = SMCReader(path)
    annots_path = path.replace("main", "annotations").split(".")[0] + "_annots.smc"
    smc_annots = SMCReader(annots_path) if os.path.exists(annots_path) \
        else smc_reader

    big_param = smplx_big_pose_params(device="cpu")
    big_param = {k: v.numpy() for k, v in big_param.items()}
    big_xyz = _vertices(smplx_model, big_param["poses"], big_param["shapes"])
    big_bound = np.stack([big_xyz.min(0) - 0.05, big_xyz.max(0) + 0.05])

    cam_infos = []
    idx = 0
    # clip the schedule to the frames actually present (the reference would
    # IndexError past the end of shorter captures)
    n_avail = smc_reader.get_frame_count("Camera_5mp", int(output_view[0]))
    for pose_index in range(pose_start, pose_start + pose_num * pose_interval,
                            pose_interval):
        if pose_index >= n_avail:
            break
        for view_index in output_view:
            image = smc_reader.get_img(
                "Camera_5mp", int(view_index), Image_type="color",
                Frame_id=int(pose_index),
            )
            image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB) / 255.0

            msk = smc_annots.get_mask(view_index, Frame_id=pose_index)
            msk = (np.asarray(msk) != 0).astype(np.float32)

            cam_params = smc_annots.get_Calibration(view_index)
            K = cam_params["K"].copy()
            D = cam_params["D"]
            RT = cam_params["RT"]
            R = RT[:3, :3]
            T = RT[:3, 3]

            image = cv2.undistort(image.astype(np.float32), K, D)
            msk = cv2.undistort(msk, K, D)

            image[msk == 0] = 1.0 if white_background else 0.0

            c2w = np.eye(4)
            c2w[:3, :3] = R
            c2w[:3, 3] = T
            w2c = np.linalg.inv(c2w)
            R_glm = np.transpose(w2c[:3, :3])
            T_vec = w2c[:3, 3]

            if image_scaling != 1.0:
                H = int(image.shape[0] * image_scaling)
                W = int(image.shape[1] * image_scaling)
                image = cv2.resize(image, (W, H), interpolation=cv2.INTER_AREA)
                msk = cv2.resize(msk, (W, H), interpolation=cv2.INTER_NEAREST)
                K[:2] = K[:2] * image_scaling

            H, W = image.shape[:2]
            fovx = focal2fov(float(K[0, 0]), W)
            fovy = focal2fov(float(K[1, 1]), H)

            smpl_dict = smc_annots.get_SMPLx(Frame_id=pose_index)
            fullpose = np.asarray(smpl_dict["fullpose"], np.float32)
            poses = smplx_full_pose(
                fullpose[0], fullpose[1:22],
                jaw_pose=fullpose[22], leye_pose=fullpose[23],
                reye_pose=fullpose[24],
                left_hand_pose=fullpose[25:40],
                right_hand_pose=fullpose[40:55],
            )
            betas = np.asarray(smpl_dict["betas"], np.float32).reshape(-1)[:10]
            expr = np.asarray(smpl_dict["expression"], np.float32).reshape(-1)[:10]
            shapes = np.concatenate([betas, expr])
            transl = np.asarray(smpl_dict["transl"], np.float32).reshape(3)

            smpl_param = {
                "poses": poses.astype(np.float32),
                "shapes": shapes.astype(np.float32),
                "R": np.eye(3, dtype=np.float32),
                "Th": transl.reshape(1, 3),
            }
            xyz = _vertices(smplx_model, smpl_param["poses"], smpl_param["shapes"]) \
                + transl[None, :]

            lo = xyz.min(0) - 0.05
            hi = xyz.max(0) + 0.05
            world_bound = np.stack([lo, hi])
            bound_mask = get_bound_2d_mask(world_bound, K, w2c[:3], H, W)

            cam_infos.append(CameraInfo(
                uid=idx, pose_id=pose_index, R=R_glm, T=T_vec, K=K,
                FovY=fovy, FovX=fovx, image=image,
                normal=np.zeros_like(image),
                image_path=path, image_name=f"{view_index}_{pose_index}",
                bkgd_mask=msk, bound_mask=bound_mask, width=W, height=H,
                smpl_param=smpl_param, world_vertex=xyz,
                world_bound=world_bound, big_pose_smpl_param={
                    "poses": big_param["poses"],
                    "shapes": big_param["shapes"],
                    "R": big_param["R"],
                    "Th": big_param["Th"].reshape(1, 3),
                },
                big_pose_world_vertex=big_xyz,
                big_pose_world_bound=big_bound,
            ))
            idx += 1
    return cam_infos


def read_dna_rendering_info(
    path: str, white_background: bool, output_path: str, eval: bool,
    smplx_model=None, smplx_model_path: str = "assets/models/smplx/",
) -> SceneInfo:
    reader = SMCReader(path)
    if smplx_model is None:
        gender = (reader.actor_info or {}).get("gender", "neutral")
        # only the vertices are read from it, as numpy
        smplx_model = load_smplx(smplx_model_path, gender=gender, device="cpu")

    # reference view split (dataset_readers.py:1002-1006: 48 cameras, test
    # [12, 30]) clipped to the cameras actually present in the capture —
    # small/partial captures keep working (the reference would KeyError)
    avail = sorted(int(c) for c in reader.get_camera_ids())
    reader.release()
    train_view = [i for i in range(48) if i not in (12, 30) and i in avail]
    test_view = [i for i in (12, 30) if i in avail]
    if not test_view:
        test_view = [avail[-1]]
        if len(avail) > 1:
            train_view = [v for v in train_view if v != avail[-1]]
    train = read_cameras_dna_rendering(path, train_view, white_background,
                                       smplx_model, split="train")
    test = read_cameras_dna_rendering(path, test_view, white_background,
                                      smplx_model, split="test")
    if not eval:
        train.extend(test)
        test = []

    norm = get_nerfpp_norm(train)
    first = train[0]
    xyz = first.big_pose_world_vertex
    rng = np.random.RandomState(0)
    colors = rng.random((xyz.shape[0], 3)).astype(np.float32)
    pcd = BasicPointCloud(points=xyz, colors=colors, normals=np.zeros_like(xyz))
    return SceneInfo(point_cloud=pcd, train_cameras=train, test_cameras=test,
                     nerf_normalization=norm,
                     ply_path=os.path.join("output", output_path, "points3d.ply"))
