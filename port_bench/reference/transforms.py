"""Rotation and covariance helpers of the plain reference.

A frozen copy of `mygauhuman_torch/utils/transforms.py` (normalize, the
quaternion rotation, Rodrigues, the pose refiner's Rodrigues, the
covariance 6-vector, the guarded 3x3 inverse), kept here so that the reference
imports nothing of the program.
"""
from __future__ import annotations

import torch


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    # rsqrt(sum^2 + eps^2) keeps the gradient finite at v == 0 (dead slots)
    return v * torch.rsqrt((v * v).sum(dim=dim, keepdim=True) + eps * eps)


def quat_to_rotmat_cols(q: torch.Tensor, normalize_quat: bool = True) -> tuple:
    """Quaternion (w, x, y, z) [..., 4] -> 9 row-major rotation components."""
    if normalize_quat:
        q = normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        1.0 - 2.0 * (y * y + z * z),
        2.0 * (x * y - w * z),
        2.0 * (x * z + w * y),
        2.0 * (x * y + w * z),
        1.0 - 2.0 * (x * x + z * z),
        2.0 * (y * z - w * x),
        2.0 * (x * z - w * y),
        2.0 * (y * z + w * x),
        1.0 - 2.0 * (x * x + y * y),
    )


def _stack33(c: tuple) -> torch.Tensor:
    return torch.stack(
        [torch.stack(c[0:3], -1), torch.stack(c[3:6], -1), torch.stack(c[6:9], -1)],
        dim=-2,
    )


def rodrigues(rvec: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3] (angle = ||r + eps||)."""
    angle = torch.linalg.vector_norm(rvec + eps, dim=-1, keepdim=True)
    axis = rvec / angle
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    rx, ry, rz = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(rx)
    K = _stack33((zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros))
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def rodrigues_mlp(rvec: torch.Tensor) -> torch.Tensor:
    """Rodrigues with theta = sqrt(1e-5 + ||r||^2) (the pose-refiner head)."""
    theta = torch.sqrt(1e-5 + (rvec ** 2).sum(dim=-1, keepdim=True))
    axis = rvec / theta
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    one = torch.ones_like(x)
    cth = torch.cos(theta)[..., 0]
    sth = torch.sin(theta)[..., 0]
    return _stack33((
        x * x + (one - x * x) * cth,
        x * y * (one - cth) - z * sth,
        x * z * (one - cth) + y * sth,
        x * y * (one - cth) + z * sth,
        y * y + (one - y * y) * cth,
        y * z * (one - cth) - x * sth,
        x * z * (one - cth) - y * sth,
        y * z * (one - cth) + x * sth,
        z * z + (one - z * z) * cth,
    ))


def mat_cols(m: torch.Tensor) -> tuple:
    """[..., 3, 3] -> 9 row-major component slices."""
    return tuple(m[..., i, j] for i in range(3) for j in range(3))


def rot_apply(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y = M v per row, [N, 3, 3] x [N, 3] -> [N, 3]."""
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = mat_cols(m)
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [
            m00 * v0 + m01 * v1 + m02 * v2,
            m10 * v0 + m11 * v1 + m12 * v2,
            m20 * v0 + m21 * v1 + m22 * v2,
        ],
        dim=-1,
    )


def covariance6_from_scaling_rotation(
    scaling: torch.Tensor,
    quat: torch.Tensor,
    scaling_modifier: float = 1.0,
    transform: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sigma = (R S)(R S)^T, optionally T Sigma T^T -> [N, 6]
    (xx, xy, xz, yy, yz, zz)."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = quat_to_rotmat_cols(quat)
    s0 = scaling_modifier * scaling[..., 0]
    s1 = scaling_modifier * scaling[..., 1]
    s2 = scaling_modifier * scaling[..., 2]
    a, b, c = s0 * s0, s1 * s1, s2 * s2
    xx = a * r00 * r00 + b * r01 * r01 + c * r02 * r02
    xy = a * r00 * r10 + b * r01 * r11 + c * r02 * r12
    xz = a * r00 * r20 + b * r01 * r21 + c * r02 * r22
    yy = a * r10 * r10 + b * r11 * r11 + c * r12 * r12
    yz = a * r10 * r20 + b * r11 * r21 + c * r12 * r22
    zz = a * r20 * r20 + b * r21 * r21 + c * r22 * r22
    if transform is not None:
        t00, t01, t02, t10, t11, t12, t20, t21, t22 = mat_cols(transform)
        a00 = t00 * xx + t01 * xy + t02 * xz
        a01 = t00 * xy + t01 * yy + t02 * yz
        a02 = t00 * xz + t01 * yz + t02 * zz
        a10 = t10 * xx + t11 * xy + t12 * xz
        a11 = t10 * xy + t11 * yy + t12 * yz
        a12 = t10 * xz + t11 * yz + t12 * zz
        a20 = t20 * xx + t21 * xy + t22 * xz
        a21 = t20 * xy + t21 * yy + t22 * yz
        a22 = t20 * xz + t21 * yz + t22 * zz
        xx = a00 * t00 + a01 * t01 + a02 * t02
        xy = a00 * t10 + a01 * t11 + a02 * t12
        xz = a00 * t20 + a01 * t21 + a02 * t22
        yy = a10 * t10 + a11 * t11 + a12 * t12
        yz = a10 * t20 + a11 * t21 + a12 * t22
        zz = a20 * t20 + a21 * t21 + a22 * t22
    return torch.stack([xx, xy, xz, yy, yz, zz], dim=-1)


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Adjugate 3x3 inverse with the |det| < 1e-8 guard of the LBS chain
    (blends of opposing joint rotations can be near-singular)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(det.abs() < 1e-8, torch.sign(det) * 1e-8 + 1e-12, det)
    return _stack33((A, B, C, D, E, F, G, H, I)) / det[..., None, None]
