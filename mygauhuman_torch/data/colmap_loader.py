"""COLMAP sparse-reconstruction parsers (binary + text); a copy of the JAX
package's data/colmap_loader.py (numpy only).

Parity: scene/colmap_loader.py (stock 3DGS, 294 LoC) — cameras.bin/txt,
images.bin/txt, points3D.bin/txt in the documented COLMAP format
(https://colmap.github.io/format.html).
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: i for i, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3d_ids: np.ndarray


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> dict:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<" + "d" * n_params))
            cams[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return cams


def read_cameras_text(path: str) -> dict:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            cams[cam_id] = ColmapCamera(
                cam_id, parts[1], int(parts[2]), int(parts[3]),
                np.array([float(p) for p in parts[4:]]),
            )
    return cams


def read_images_binary(path: str) -> dict:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<dddd"))
            tvec = np.array(_read(f, "<ddd"))
            cam_id = _read(f, "<i")[0]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (n_pts,) = _read(f, "<Q")
            data = np.array(_read(f, "<" + "ddq" * n_pts)).reshape(-1, 3)
            images[img_id] = ColmapImage(
                img_id, qvec, tvec, cam_id, name.decode("utf-8"),
                data[:, :2], data[:, 2].astype(np.int64),
            )
    return images


def read_images_text(path: str) -> dict:
    images = {}
    with open(path) as f:
        # keep empty POINTS2D lines — each image is exactly two lines
        lines = [l.rstrip("\n") for l in f if not l.startswith("#")]
    for meta, pts in zip(lines[0::2], lines[1::2]):
        p = meta.split()
        img_id = int(p[0])
        qvec = np.array([float(v) for v in p[1:5]])
        tvec = np.array([float(v) for v in p[5:8]])
        cam_id = int(p[8])
        name = p[9]
        vals = pts.split()
        data = np.array([float(v) for v in vals]).reshape(-1, 3) \
            if vals else np.zeros((0, 3))
        images[img_id] = ColmapImage(
            img_id, qvec, tvec, cam_id, name, data[:, :2],
            data[:, 2].astype(np.int64),
        )
    return images


def read_points3d_binary(path: str):
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3))
        err = np.empty((n, 1))
        for i in range(n):
            _read(f, "<Q")  # point id
            xyz[i] = _read(f, "<ddd")
            rgb[i] = _read(f, "<BBB")
            err[i] = _read(f, "<d")
            (track_len,) = _read(f, "<Q")
            f.read(8 * track_len)
    return xyz, rgb, err


def read_points3d_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            xyz.append([float(v) for v in p[1:4]])
            rgb.append([float(v) for v in p[4:7]])
            err.append([float(p[7])])
    return np.array(xyz), np.array(rgb), np.array(err)


def read_model(sparse_dir: str):
    """Auto-detect binary vs text model files."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        images = read_images_binary(os.path.join(sparse_dir, "images.bin"))
        pts = read_points3d_binary(os.path.join(sparse_dir, "points3D.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        images = read_images_text(os.path.join(sparse_dir, "images.txt"))
        pts = read_points3d_text(os.path.join(sparse_dir, "points3D.txt"))
    return cams, images, pts
