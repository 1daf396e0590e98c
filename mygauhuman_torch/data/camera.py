"""Camera as a dataclass of tensors, and the projection matrices.

Port of data/camera.py. All 4x4 matrices act on column vectors
(x_cam = w2c @ x_h). The matrices are built in numpy (float64, then
float32) exactly as the JAX package builds them, then moved to `device`.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mygauhuman_torch.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class Camera:
    w2c: torch.Tensor          # [4, 4] world -> camera
    full_proj: torch.Tensor    # [4, 4] proj @ w2c
    cam_center: torch.Tensor   # [3]
    tan_fovx: float
    tan_fovy: float
    width: int
    height: int


def world2view(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Dataset convention (R = c2w rotation block, t = w2c translation)."""
    w2c = np.zeros((4, 4), dtype=np.float64)
    w2c[:3, :3] = R.T
    w2c[:3, 3] = t.reshape(3)
    w2c[3, 3] = 1.0
    return w2c.astype(np.float32)


def projection_from_fov(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    tx = math.tan(fovx / 2)
    ty = math.tan(fovy / 2)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tx
    P[1, 1] = 1.0 / ty
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -2.0 * zfar * znear / (zfar - znear)
    P[3, 2] = 1.0
    return P


def projection_from_K(
    K: np.ndarray, H: int, W: int, znear: float = 0.001, zfar: float = 1000.0
) -> np.ndarray:
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    s = K[0, 1]
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2 * fx / W
    P[0, 1] = 2 * s / W
    P[0, 2] = -1 + 2 * (cx / W)
    P[1, 1] = 2 * fy / H
    P[1, 2] = -1 + 2 * (cy / H)
    P[2, 2] = (zfar + znear) / (zfar - znear)
    P[2, 3] = -2 * zfar * znear / (zfar - znear)
    P[3, 2] = 1.0
    return P


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def make_camera(
    R: np.ndarray,
    t: np.ndarray,
    width: int,
    height: int,
    K: np.ndarray | None = None,
    fovx: float | None = None,
    fovy: float | None = None,
    znear: float = 0.001,
    zfar: float = 1000.0,
    device: str | torch.device = DEFAULT_DEVICE,
) -> Camera:
    """Build a Camera from dataset extrinsics + either K or fovs."""
    dev = resolve_device(device)
    w2c = world2view(np.asarray(R), np.asarray(t))
    if K is not None:
        P = projection_from_K(np.asarray(K, dtype=np.float64), height, width, znear, zfar)
        fovx = focal2fov(float(K[0, 0]), width)
        fovy = focal2fov(float(K[1, 1]), height)
    else:
        if fovx is None or fovy is None:
            raise ValueError("make_camera needs K or both fovx and fovy")
        P = projection_from_fov(znear, zfar, fovx, fovy)
    full_proj = (P.astype(np.float64) @ w2c.astype(np.float64)).astype(np.float32)
    c2w = np.linalg.inv(w2c.astype(np.float64))
    return Camera(
        w2c=torch.as_tensor(w2c, device=dev),
        full_proj=torch.as_tensor(full_proj, device=dev),
        cam_center=torch.as_tensor(c2w[:3, 3].astype(np.float32), device=dev),
        tan_fovx=math.tan(fovx / 2),
        tan_fovy=math.tan(fovy / 2),
        width=int(width),
        height=int(height),
    )
