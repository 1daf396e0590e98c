"""Dataset readers: ZJU-MoCap-refine, MonoCap, the render/mixamo layout, and
the dispatch to DNA-Rendering, COLMAP and Blender (port of data/readers.py).

A copy of the JAX package's numpy readers, which re-derive the reference's
`scene/dataset_readers.py` (SURVEY.md §2.13). Three places call the port
instead of JAX code: the big-pose SMPL evaluation (`_prep_big_pose`,
`models/smpl.py::smpl_forward`), the point-cloud colours (`_finish_scene`,
`ops/sh.py::sh2rgb`) and `camera_info_to_batch` (the port's camera,
`FrameInputs` and `TrainBatch`, on `device`). `cv2` and `imageio` are
imported inside the functions that use them. The DNA-Rendering, COLMAP and
Blender readers live in `data/dna_rendering.py`, `data/colmap.py` and
`data/blender.py`, imported by `load_scene_info` when a source asks for
them.

  * readers return SceneInfo(train/test CameraInfo lists, point cloud,
    nerf++ normalization) exactly like the reference dispatcher
    (`sceneLoadTypeCallbacks`, dataset_readers.py:1312-1319).
  * per-frame pipeline parity: undistort with K/D, optional downscale
    (ZJU 0.5 of 1024^2 -> 512^2, :553), background masking, world bound from
    SMPL vertices +-0.05 m, projected-box bound mask (:1288-1299), big-pose
    canonical SMPL shared across frames (45/-30 degree limb spread,
    :586-594), mesh vertex normals (numpy, replacing trimesh).
  * view splits parity: ZJU train [0,6,12,18] / test [3], 50 poses x10
    (train) / 17 x30 (test); MonoCap per-sequence views (:465-478).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

import torch

from mygauhuman_torch.data.camera import focal2fov, make_camera
from mygauhuman_torch.device import DEFAULT_DEVICE, resolve_device
from mygauhuman_torch.render import FrameInputs
from mygauhuman_torch.train.trainer import TrainBatch
from mygauhuman_torch.utils.ply import write_ply


def _prefetch_decoded(paths: list, workers: int = 8) -> list:
    """Decode an image-path list concurrently -> float32 [H, W, C] in [0, 1].

    Uses the native C++ decode pipeline (native/dataloader.cpp: worker
    threads, libjpeg/libpng, one submit/collect queue) and falls back to a
    sequential imageio loop when the toolchain is unavailable or
    MYGAUHUMAN_NATIVE_LOADER=0. None entries pass through as None (missing
    optional files, e.g. ZJU normal maps). Both paths produce identical
    arrays (8-bit decode / 255)."""
    real = [(i, p) for i, p in enumerate(paths) if p is not None]
    out: list = [None] * len(paths)
    use_native = os.environ.get("MYGAUHUMAN_NATIVE_LOADER", "1") not in (
        "0", "off", "false")
    if use_native and real:
        from mygauhuman_torch.data.native_loader import (
            NativeImageLoader,
            native_available,
        )

        if native_available():
            with NativeImageLoader(workers=workers) as dl:
                for j, (_, p) in enumerate(real):
                    dl.submit(p, j)
                for _ in real:
                    j, img = dl.collect()
                    out[real[j][0]] = img
            return out
    import imageio.v2 as imageio

    for i, p in real:
        img = imageio.imread(p).astype(np.float32) / 255.0
        if img.ndim == 2:
            img = img[..., None]
        out[i] = img
    return out


# ----------------------------------------------------------------------------
# Structures (dataset_readers.py:36-66)
# ----------------------------------------------------------------------------

@dataclass
class BasicPointCloud:
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


@dataclass
class CameraInfo:
    uid: int
    pose_id: int
    R: np.ndarray            # c2w rotation block (glm convention)
    T: np.ndarray            # w2c translation
    K: np.ndarray
    FovY: float
    FovX: float
    image: np.ndarray        # [H, W, 3] float32 in [0, 1]
    image_path: str
    image_name: str
    width: int
    height: int
    normal: np.ndarray | None = None       # [H, W, 3]
    bkgd_mask: np.ndarray | None = None    # [H, W] float32
    bound_mask: np.ndarray | None = None   # [H, W] float32
    smpl_param: dict | None = None
    world_vertex: np.ndarray | None = None
    world_bound: np.ndarray | None = None
    big_pose_smpl_param: dict | None = None
    big_pose_world_vertex: np.ndarray | None = None
    big_pose_world_bound: np.ndarray | None = None
    smpl_normal: np.ndarray | None = None


@dataclass
class SceneInfo:
    point_cloud: BasicPointCloud | None
    train_cameras: list
    test_cameras: list
    nerf_normalization: dict
    ply_path: str


# ----------------------------------------------------------------------------
# Geometry helpers
# ----------------------------------------------------------------------------

def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals (trimesh.vertex_normals equivalent,
    used at dataset_readers.py:606-611)."""
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)              # area-weighted
    vn = np.zeros_like(vertices)
    for i in range(3):
        np.add.at(vn, faces[:, i], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(norm, 1e-12)


def get_bound_corners(bounds: np.ndarray) -> np.ndarray:
    """[2, 3] min/max -> [8, 3] box corners (dataset_readers.py:1277-1287)."""
    lo, hi = bounds
    return np.array([
        [lo[0], lo[1], lo[2]], [lo[0], lo[1], hi[2]],
        [lo[0], hi[1], lo[2]], [lo[0], hi[1], hi[2]],
        [hi[0], lo[1], lo[2]], [hi[0], lo[1], hi[2]],
        [hi[0], hi[1], lo[2]], [hi[0], hi[1], hi[2]],
    ])


def project_np(pts: np.ndarray, K: np.ndarray, RT: np.ndarray) -> np.ndarray:
    """World -> pixel (dataset_readers.py project)."""
    cam = pts @ RT[:, :3].T + RT[:, 3:].T
    pix = cam @ K.T
    return pix[:, :2] / pix[:, 2:]


def get_bound_2d_mask(bounds: np.ndarray, K: np.ndarray, pose: np.ndarray,
                      H: int, W: int) -> np.ndarray:
    """Filled projection of the 3D bound box (dataset_readers.py:1288-1299)."""
    import cv2

    corners = project_np(get_bound_corners(bounds), K, pose)
    corners = np.round(corners).astype(int)
    mask = np.zeros((H, W), dtype=np.uint8)
    for quad in ([0, 1, 3, 2], [4, 5, 7, 6], [0, 1, 5, 4],
                 [2, 3, 7, 6], [0, 2, 6, 4], [1, 3, 7, 5]):
        cv2.fillPoly(mask, [corners[quad]], 1)
    return mask.astype(np.float32)


def get_nerfpp_norm(cam_infos: list) -> dict:
    """Camera-centroid radius normalization (stock 3DGS getNerfppNorm)."""
    centers = []
    for cam in cam_infos:
        w2c = np.eye(4)
        w2c[:3, :3] = cam.R.T
        w2c[:3, 3] = cam.T
        c2w = np.linalg.inv(w2c)
        centers.append(c2w[:3, 3])
    centers = np.stack(centers)
    avg = centers.mean(axis=0, keepdims=True)
    dist = np.linalg.norm(centers - avg, axis=1)
    radius = float(dist.max()) * 1.1
    return {"translate": -avg[0], "radius": radius if radius > 0 else 1.0}


def big_pose_smpl_param() -> dict:
    """Canonical big-pose parameters (dataset_readers.py:586-594)."""
    p = {
        "R": np.eye(3, dtype=np.float32),
        "Th": np.zeros((1, 3), dtype=np.float32),
        "shapes": np.zeros((1, 10), dtype=np.float32),
        "poses": np.zeros((1, 72), dtype=np.float32),
    }
    p["poses"][0, 5] = 45 / 180 * np.pi
    p["poses"][0, 8] = -45 / 180 * np.pi
    p["poses"][0, 23] = -30 / 180 * np.pi
    p["poses"][0, 26] = 30 / 180 * np.pi
    return p


def _prep_big_pose(smpl_model):
    """Shared canonical SMPL evaluation; returns (param, verts, bound, normals)."""
    from mygauhuman_torch.models.smpl import smpl_forward

    param = big_pose_smpl_param()
    dev = smpl_model.v_template.device
    with torch.no_grad():
        verts, _ = smpl_forward(
            smpl_model, torch.as_tensor(param["poses"].reshape(-1), device=dev),
            torch.as_tensor(param["shapes"].reshape(-1), device=dev)
        )
    verts = verts.cpu().numpy().astype(np.float32)
    lo = verts.min(axis=0) - 0.05
    hi = verts.max(axis=0) + 0.05
    bound = np.stack([lo, hi])
    normals = vertex_normals(verts, np.asarray(smpl_model.faces))
    return param, verts, bound, normals


# ----------------------------------------------------------------------------
# ZJU-MoCap-refine (dataset_readers.py:553-758)
# ----------------------------------------------------------------------------

def read_cameras_zju(
    path: str,
    output_view: list,
    white_background: bool,
    smpl_model,
    image_scaling: float = 0.5,
    split: str = "train",
    schedule: tuple | None = None,
) -> list:
    import cv2
    import imageio.v2 as imageio

    pose_start, pose_interval, pose_num = schedule or (
        (0, 10, 50) if split == "train" else (0, 30, 17)
    )

    annots = np.load(os.path.join(path, "annots.npy"), allow_pickle=True).item()
    cams = annots["cams"]
    frame_slice = annots["ims"][
        pose_start: pose_start + pose_num * pose_interval
    ][::pose_interval]
    ims = np.array([np.array(d["ims"])[output_view] for d in frame_slice])
    cam_inds = np.array(
        [np.arange(len(d["ims"]))[output_view] for d in frame_slice]
    )

    big_param, big_xyz, big_bound, big_normals = _prep_big_pose(smpl_model)

    # metadata pass: gather every (image, normal, mask) path, then decode
    # them ALL through the prefetching native pipeline (the sequential
    # per-view imageio loop was the scene-load bottleneck — PERF.md)
    flat_paths: list = []
    for pose_index in range(len(ims)):
        for view_index in range(len(output_view)):
            ip = os.path.join(
                path, str(ims[pose_index][view_index]).replace("\\", "/")
            )
            npth = ip.replace("images", "normal")
            flat_paths += [
                ip,
                npth if os.path.exists(npth) else None,
                ip.replace("images", "mask").replace("jpg", "png"),
            ]
    decoded = _prefetch_decoded(flat_paths)

    def build_view(args):
        idx, pose_index, view_index = args
        image_path = os.path.join(
            path, str(ims[pose_index][view_index]).replace("\\", "/")
        )
        image_name = str(ims[pose_index][view_index]).split(".")[0]
        d_img, d_nrm, d_msk = decoded[3 * idx: 3 * idx + 3]
        image = d_img

        normal = d_nrm if d_nrm is not None else np.zeros_like(image)
        msk = (d_msk != 0).astype(np.uint8)
        if msk.ndim == 3:
            msk = msk[..., 0]

        cam_ind = cam_inds[pose_index][view_index]
        K = np.array(cams["K"][cam_ind], np.float64)
        D = np.array(cams["D"][cam_ind], np.float64)
        R = np.array(cams["R"][cam_ind], np.float64)
        T = np.array(cams["T"][cam_ind], np.float64) / 1000.0

        image = cv2.undistort(image, K, D)
        normal = cv2.undistort(normal, K, D)
        msk = cv2.undistort(msk, K, D)

        bg = 1.0 if white_background else 0.0
        image[msk == 0] = bg
        normal[msk == 0] = bg

        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3:4] = T.reshape(3, 1)
        R_glm = np.transpose(w2c[:3, :3])
        T_vec = w2c[:3, 3]

        if image_scaling != 1.0:
            H = int(image.shape[0] * image_scaling)
            W = int(image.shape[1] * image_scaling)
            image = cv2.resize(image, (W, H), interpolation=cv2.INTER_AREA)
            normal = cv2.resize(normal, (W, H),
                                interpolation=cv2.INTER_AREA)
            msk = cv2.resize(msk, (W, H), interpolation=cv2.INTER_NEAREST)
            K = K.copy()
            K[:2] = K[:2] * image_scaling

        H, W = image.shape[:2]
        fovx = focal2fov(float(K[0, 0]), W)
        fovy = focal2fov(float(K[1, 1]), H)

        i = int(os.path.basename(image_path)[:-4])
        xyz = np.load(
            os.path.join(path, "smpl_vertices", f"{i}.npy")
        ).astype(np.float32)
        smpl_param = np.load(
            os.path.join(path, "smpl_params", f"{i}.npy"),
            allow_pickle=True,
        ).item()
        smpl_param = dict(smpl_param)
        smpl_param["R"] = cv2.Rodrigues(np.asarray(smpl_param["Rh"], np.float64).reshape(3))[0].astype(
            np.float32
        )
        for k in ("Th", "shapes", "poses"):
            smpl_param[k] = np.asarray(smpl_param[k], np.float32)

        lo = xyz.min(axis=0) - 0.05
        hi = xyz.max(axis=0) + 0.05
        world_bound = np.stack([lo, hi])
        bound_mask = get_bound_2d_mask(world_bound, K, w2c[:3], H, W)

        return CameraInfo(
            uid=idx, pose_id=pose_index, R=R_glm, T=T_vec, K=K,
            FovY=fovy, FovX=fovx, image=image, normal=normal,
            image_path=image_path, image_name=image_name,
            bkgd_mask=msk.astype(np.float32), bound_mask=bound_mask,
            width=W, height=H, smpl_param=smpl_param, world_vertex=xyz,
            world_bound=world_bound, big_pose_smpl_param=big_param,
            big_pose_world_vertex=big_xyz, big_pose_world_bound=big_bound,
            smpl_normal=big_normals,
        )

    # per-view assembly (undistort/resize/bound-mask: cv2 + numpy, all
    # GIL-releasing) runs on a thread pool; order-preserving map
    from concurrent.futures import ThreadPoolExecutor

    jobs = [(i, pi, vi)
            for i, (pi, vi) in enumerate(
                (p_, v_) for p_ in range(len(ims))
                for v_ in range(len(output_view)))]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        cam_infos = list(ex.map(build_view, jobs))
    return cam_infos


def read_zju_mocap_refine_info(
    path: str, white_background: bool, output_path: str, eval: bool,
    smpl_model=None,
) -> SceneInfo:
    smpl_model = smpl_model or _default_smpl()
    train_view = [0, 6, 12, 18]
    test_view = [3]
    train = read_cameras_zju(path, train_view, white_background, smpl_model,
                             split="train")
    test = read_cameras_zju(path, test_view, white_background, smpl_model,
                            split="test")
    if not eval:
        train.extend(test)
        test = []
    return _finish_scene(train, test, output_path, train_view)


# ----------------------------------------------------------------------------
# MonoCap (dataset_readers.py:313-518)
# ----------------------------------------------------------------------------

def read_cameras_monocap(
    path: str,
    output_view: list,
    white_background: bool,
    smpl_model,
    image_scaling: float = 1.0,
    split: str = "train",
) -> list:
    import cv2
    import imageio.v2 as imageio

    pose_start = 1 if ("olek_images0812" in path or "vlad_images1011" in path) else 0
    pose_interval, pose_num = (5, 100) if split == "train" else (30, 17)

    annots = np.load(os.path.join(path, "annots.npy"), allow_pickle=True).item()
    cam = annots["cams"]

    big_param, big_xyz, big_bound, big_normals = _prep_big_pose(smpl_model)

    def img_paths(view_index, pose_index):
        if "olek_images0812" in path:
            return (
                os.path.join(path, "images", str(view_index).zfill(2),
                             str(pose_index).zfill(6) + ".jpg"),
                os.path.join(path, "mask", str(view_index).zfill(2),
                             str(pose_index).zfill(6) + ".png"),
            )
        if "vlad_images1011" in path:
            return (
                os.path.join(path, "images", str(view_index).zfill(3),
                             str(pose_index).zfill(6) + ".jpg"),
                os.path.join(path, "mask", str(view_index).zfill(3),
                             str(pose_index).zfill(6) + ".jpg"),
            )
        return (
            os.path.join(path, "images", str(view_index).zfill(2),
                         str(pose_index).zfill(4) + ".jpg"),
            os.path.join(path, "mask", str(view_index).zfill(2),
                         str(pose_index).zfill(4) + ".png"),
        )

    # metadata pass + prefetching decode (native pipeline; see ZJU reader)
    pose_range = range(pose_start, pose_start + pose_num * pose_interval,
                       pose_interval)
    flat_paths = []
    for pose_index in pose_range:
        for view_index in output_view:
            flat_paths += list(img_paths(view_index, pose_index))
    decoded = _prefetch_decoded(flat_paths)

    cam_infos = []
    idx = 0
    for pose_index in pose_range:
        for view_index in output_view:
            image_path, msk_path = img_paths(view_index, pose_index)
            image, msk = decoded[2 * idx], decoded[2 * idx + 1]
            if msk.ndim == 3:
                msk = msk[..., 0]

            K = np.array(cam["K"][view_index], np.float64)
            D = np.array(cam["D"][view_index], np.float64)
            R = np.array(cam["R"][view_index], np.float64)
            T = np.array(cam["T"][view_index], np.float64).reshape(-1, 1) / 1000.0

            image = cv2.undistort(image, K, D)
            msk = cv2.undistort(msk, K, D)

            bg = 1.0 if white_background else 0.0
            image[msk == 0] = bg

            w2c = np.eye(4)
            w2c[:3, :3] = R
            w2c[:3, 3:4] = T
            R_glm = np.transpose(w2c[:3, :3])
            T_vec = w2c[:3, 3]

            if image_scaling != 1.0:
                H = int(image.shape[0] * image_scaling)
                W = int(image.shape[1] * image_scaling)
                image = cv2.resize(image, (W, H), interpolation=cv2.INTER_AREA)
                msk = cv2.resize(msk, (W, H), interpolation=cv2.INTER_NEAREST)
                K = K.copy()
                K[:2] = K[:2] * image_scaling

            H, W = image.shape[:2]
            fovx = focal2fov(float(K[0, 0]), W)
            fovy = focal2fov(float(K[1, 1]), H)

            params_path = os.path.join(path, "params",
                                       f"{pose_index}.npy")
            smpl_param = dict(np.load(params_path, allow_pickle=True).item())
            vertices_path = os.path.join(path, "vertices",
                                         f"{pose_index}.npy")
            xyz = np.load(vertices_path).astype(np.float32)
            smpl_param["R"] = cv2.Rodrigues(
                np.asarray(smpl_param["Rh"], np.float64).reshape(3)
            )[0].astype(np.float32)
            for k in ("Th", "shapes", "poses"):
                smpl_param[k] = np.asarray(smpl_param[k], np.float32)

            lo = xyz.min(axis=0) - 0.1
            hi = xyz.max(axis=0) + 0.1
            world_bound = np.stack([lo, hi])
            bound_mask = get_bound_2d_mask(world_bound, K, w2c[:3], H, W)

            cam_infos.append(CameraInfo(
                uid=idx, pose_id=pose_index, R=R_glm, T=T_vec, K=K,
                FovY=fovy, FovX=fovx, image=image,
                normal=np.zeros_like(image),
                image_path=image_path, image_name=str(view_index),
                bkgd_mask=(msk > 0).astype(np.float32),
                bound_mask=bound_mask, width=W, height=H,
                smpl_param=smpl_param, world_vertex=xyz,
                world_bound=world_bound, big_pose_smpl_param=big_param,
                big_pose_world_vertex=big_xyz, big_pose_world_bound=big_bound,
                smpl_normal=big_normals,
            ))
            idx += 1
    return cam_infos


def read_monocap_info(
    path: str, white_background: bool, output_path: str, eval: bool,
    smpl_model=None,
) -> SceneInfo:
    smpl_model = smpl_model or _default_smpl()
    if "olek_images0812" in path:
        train_view, test_view = [44], [45]
    elif "vlad_images1011" in path:
        train_view, test_view = [66], [0, 10, 20, 30, 40, 50, 60, 70, 80, 90,
                                      100]
    else:
        train_view, test_view = [0], list(range(1, 11))
    train = read_cameras_monocap(path, train_view, white_background,
                                 smpl_model, split="train")
    test = read_cameras_monocap(path, test_view, white_background,
                                smpl_model, split="test")
    if not eval:
        train.extend(test)
        test = []
    return _finish_scene(train, test, output_path, train_view)


# ----------------------------------------------------------------------------
# Shared scene assembly
# ----------------------------------------------------------------------------

def _default_smpl():
    from mygauhuman_torch.models.smpl import load_smpl

    for candidate in (
        "assets/SMPL_NEUTRAL_renderpeople.pkl",
        "assets/SMPL_NEUTRAL.pkl",
    ):
        if os.path.exists(candidate):
            # only the big-pose vertices are read from it, as numpy
            return load_smpl(candidate, device="cpu")
    raise FileNotFoundError(
        "No SMPL model found under assets/; pass smpl_model= explicitly "
        "(reference expects assets/SMPL_NEUTRAL_renderpeople.pkl)"
    )


def _finish_scene(train, test, output_path, train_view) -> SceneInfo:
    norm = get_nerfpp_norm(train)
    if len(train_view) == 1:
        norm["radius"] = 1.0

    ply_path = os.path.join("output", output_path, "points3d.ply")
    first = train[0]
    xyz = first.big_pose_world_vertex
    normals = first.smpl_normal
    shs = np.random.RandomState(0).random((xyz.shape[0], 3)) / 255.0
    from mygauhuman_torch.ops.sh import sh2rgb

    colors = sh2rgb(torch.as_tensor(shs, dtype=torch.float32)).numpy()
    pcd = BasicPointCloud(points=xyz, colors=colors, normals=normals)
    if not os.path.exists(ply_path):
        os.makedirs(os.path.dirname(ply_path), exist_ok=True)
        cols = np.concatenate([xyz, normals, colors], axis=1)
        write_ply(ply_path, ["x", "y", "z", "nx", "ny", "nz", "red", "green",
                             "blue"], cols)
    return SceneInfo(point_cloud=pcd, train_cameras=train, test_cameras=test,
                     nerf_normalization=norm, ply_path=ply_path)


# ----------------------------------------------------------------------------
# Dispatcher (Scene.__init__ path sniffing, scene/__init__.py:47-65)
# ----------------------------------------------------------------------------

def load_scene_info(
    source_path: str, white_background: bool = False, output_path: str = "exp",
    eval: bool = True, smpl_model=None,
) -> SceneInfo:
    if "zju" in source_path.lower():
        return read_zju_mocap_refine_info(source_path, white_background,
                                          output_path, eval, smpl_model)
    if "monocap" in source_path.lower():
        return read_monocap_info(source_path, white_background, output_path,
                                 eval, smpl_model)
    if "render" in source_path.lower() or "mixamo" in source_path.lower():
        return read_render_info(source_path, white_background, output_path,
                                eval, smpl_model)
    if source_path.endswith(".smc") or "dna_rendering" in source_path.lower():
        from mygauhuman_torch.data.dna_rendering import read_dna_rendering_info

        # forward only a 55-joint SMPL-X model (cli passes load_smplx's
        # output for --smpl_type smplx); a 24-joint SMPL (or None) falls
        # back to the reader's own gender-matched load from the default
        # assets path
        smplx_model = (
            smpl_model if smpl_model is not None
            and smpl_model.j_regressor.shape[0] == 55 else None
        )
        return read_dna_rendering_info(source_path, white_background,
                                       output_path, eval,
                                       smplx_model=smplx_model)
    if os.path.exists(os.path.join(source_path, "sparse")):
        from mygauhuman_torch.data.colmap import read_colmap_scene_info

        return read_colmap_scene_info(source_path, white_background, eval)
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        from mygauhuman_torch.data.blender import read_nerf_synthetic_info

        return read_nerf_synthetic_info(source_path, white_background, eval)
    raise ValueError(f"Could not recognize scene type for {source_path}")


# conversion: CameraInfo -> TrainBatch
def camera_info_to_batch(info: CameraInfo,
                         device: str | torch.device = DEFAULT_DEVICE):
    """Build the trainer's TrainBatch from a CameraInfo, on `device`."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def pose(p):
        return {"poses": f32(p["poses"].reshape(-1)),
                "shapes": f32(p["shapes"].reshape(-1)),
                "R": f32(p["R"]), "Th": f32(p["Th"].reshape(-1))}

    cam = make_camera(R=info.R, t=info.T, width=info.width,
                      height=info.height, K=info.K, device=dev)
    frame = FrameInputs(
        smpl_param=pose(info.smpl_param),
        big_pose_param=pose(info.big_pose_smpl_param),
        big_pose_verts=f32(info.big_pose_world_vertex),
    )
    # ZJU GT normal maps arrive in display encoding; train.py:247-251
    # re-encodes (n*2-1, flip z, back to [0,1]) for 'zju' sources — applied
    # by the caller when needed.
    return TrainBatch(
        camera=cam,
        frame=frame,
        gt_image=f32(info.image),
        gt_normal=f32(info.normal),
        bkgd_mask=f32(info.bkgd_mask),
        bound_mask=f32(info.bound_mask),
    )


def zju_normal_reencode(gt_normal: np.ndarray) -> np.ndarray:
    """train.py:247-251: n = n*2-1; n.z = -n.z; back to [0,1]."""
    n = gt_normal * 2.0 - 1.0
    n[..., 2] = -n[..., 2]
    return (n + 1.0) / 2.0


# ----------------------------------------------------------------------------
# Render / mixamo dataset (dataset_readers.py:792-996) — ZJU layout with a
# different view split and pose schedule
# ----------------------------------------------------------------------------

def read_render_info(
    path: str, white_background: bool, output_path: str, eval: bool,
    smpl_model=None,
) -> SceneInfo:
    smpl_model = smpl_model or _default_smpl()
    train_view = [1, 4, 7, 9]
    test_view = [0, 2, 5, 8]
    train = read_cameras_zju(path, train_view, white_background, smpl_model,
                             split="train", schedule=(0, 2, 50))
    test = read_cameras_zju(path, test_view, white_background, smpl_model,
                            split="test", schedule=(0, 5, 20))
    if not eval:
        train.extend(test)
        test = []
    return _finish_scene(train, test, output_path, train_view)


# ----------------------------------------------------------------------------
# Novel-view orbit cameras (get_camera_extrinsics_* family,
# dataset_readers.py:282-311, 522-551, 761-790)
# ----------------------------------------------------------------------------

def novel_view_extrinsics(
    view_index: int,
    camera_view_num: int = 36,
    center: tuple = (0.0, 0.0, -0.8),
    camera_distance: float = 3.0,
) -> np.ndarray:
    """[4, 4] w2c for an orbit around the subject (novel_view_vis path)."""
    at = np.asarray(center, np.float64)
    phi = np.pi + 2 * np.pi * view_index / camera_view_num + 1e-6
    theta = np.pi / 2 + np.pi / 12 + 1e-6
    eye = at + camera_distance * np.array([
        np.sin(theta) * np.cos(phi),
        np.sin(theta) * np.sin(phi),
        np.cos(theta),
    ])
    up = np.array([0.0, 0.0, -1.0])

    def norm(v):
        return v / np.linalg.norm(v)

    z = norm(at - eye)
    x = norm(np.cross(z, up))
    y = np.cross(x, z)
    w2c = np.array([
        [x[0], x[1], x[2], -np.dot(x, eye)],
        [y[0], y[1], y[2], -np.dot(y, eye)],
        [-z[0], -z[1], -z[2], np.dot(z, eye)],
        [0.0, 0.0, 0.0, 1.0],
    ])
    # OpenGL -> COLMAP axis flip (dataset_readers.py:646)
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    return (flip @ w2c).astype(np.float32)


def orbit_camera_infos(
    template: CameraInfo, n_views: int = 36, camera_view_num: int = 36,
) -> list:
    """Novel-view CameraInfos orbiting the subject, reusing a template
    frame's intrinsics and SMPL payloads (novel_view_vis parity)."""
    out = []
    for v in range(n_views):
        w2c = novel_view_extrinsics(v, camera_view_num)
        info = CameraInfo(
            uid=v, pose_id=template.pose_id,
            R=np.transpose(w2c[:3, :3]), T=w2c[:3, 3],
            K=template.K, FovY=template.FovY, FovX=template.FovX,
            image=template.image, image_path=template.image_path,
            image_name=f"novel_{v:03d}", width=template.width,
            height=template.height, normal=template.normal,
            bkgd_mask=template.bkgd_mask, bound_mask=template.bound_mask,
            smpl_param=template.smpl_param,
            world_vertex=template.world_vertex,
            world_bound=template.world_bound,
            big_pose_smpl_param=template.big_pose_smpl_param,
            big_pose_world_vertex=template.big_pose_world_vertex,
            big_pose_world_bound=template.big_pose_world_bound,
            smpl_normal=template.smpl_normal,
        )
        out.append(info)
    return out
