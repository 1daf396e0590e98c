"""Per-Gaussian projection / covariance math (port of ops/projection.py).

EWA splatting with the 0.3 low-pass, the conic, the ceil(3 sqrt(lambda_max))
radius and the z > 0.2 near cull. Culled Gaussians get radius 0 and
visible=False; nothing is compacted.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mygauhuman_torch.utils.transforms import covariance6_from_scaling_rotation


class ProjectedGaussians(NamedTuple):
    means2d: torch.Tensor   # [N, 2] pixel coords
    depths: torch.Tensor    # [N] camera-space z
    conics: torch.Tensor    # [N, 3] inverse 2D covariance (a, b, c)
    radii: torch.Tensor     # [N] int32 (0 = culled)
    cov2d: torch.Tensor     # [N, 3] (xx, xy, yy) before inversion
    visible: torch.Tensor   # [N] bool


def ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def project_points(means3d: torch.Tensor, full_proj: torch.Tensor) -> torch.Tensor:
    """World points [N, 3] through a 4x4 projection -> NDC [N, 3]."""
    ph = means3d @ full_proj[:3, :3].T + full_proj[:3, 3]
    pw = means3d @ full_proj[3, :3] + full_proj[3, 3]
    return ph / (pw[..., None] + 1e-7)


def compute_cov2d(
    means3d: torch.Tensor,
    cov3d6: torch.Tensor,
    w2c: torch.Tensor,
    focal_x: float,
    focal_y: float,
    tan_fovx: float,
    tan_fovy: float,
) -> torch.Tensor:
    """cov2d = J W Sigma W^T J^T + 0.3 I -> [N, 3] (xx, xy, yy)."""
    t = means3d @ w2c[:3, :3].T + w2c[:3, 3]
    return cov2d_from_view(t, cov3d6, w2c[:3, :3], focal_x, focal_y, tan_fovx, tan_fovy)


def cov2d_from_view(
    t: torch.Tensor,
    cov3d6: torch.Tensor,
    W: torch.Tensor,
    focal_x: float,
    focal_y: float,
    tan_fovx: float,
    tan_fovy: float,
) -> torch.Tensor:
    """`compute_cov2d` from the camera-space means t [..., 3] and the view
    rotation W, each entry W[i, j] of which broadcasts against t[..., 0]: a
    [3, 3] matrix for one camera, [3, 3, F, 1] for F cameras' [F, N, 3]."""
    tz = t[..., 2]
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tx = torch.clamp(t[..., 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[..., 1] / tz, -limy, limy) * tz

    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    j00 = focal_x * inv_tz
    j02 = -focal_x * tx * inv_tz2
    j11 = focal_y * inv_tz
    j12 = -focal_y * ty * inv_tz2
    t00 = j00 * W[0, 0] + j02 * W[2, 0]
    t01 = j00 * W[0, 1] + j02 * W[2, 1]
    t02 = j00 * W[0, 2] + j02 * W[2, 2]
    t10 = j11 * W[1, 0] + j12 * W[2, 0]
    t11 = j11 * W[1, 1] + j12 * W[2, 1]
    t12 = j11 * W[1, 2] + j12 * W[2, 2]

    xx, xy, xz, yy, yz, zz = (cov3d6[..., i] for i in range(6))
    a00 = t00 * xx + t01 * xy + t02 * xz
    a01 = t00 * xy + t01 * yy + t02 * yz
    a02 = t00 * xz + t01 * yz + t02 * zz
    a10 = t10 * xx + t11 * xy + t12 * xz
    a11 = t10 * xy + t11 * yy + t12 * yz
    a12 = t10 * xz + t11 * yz + t12 * zz
    c00 = a00 * t00 + a01 * t01 + a02 * t02
    c01 = a00 * t10 + a01 * t11 + a02 * t12
    c11 = a10 * t10 + a11 * t11 + a12 * t12
    return torch.stack([c00 + 0.3, c01, c11 + 0.3], dim=-1)


def compute_cov3d(scaling: torch.Tensor, quat: torch.Tensor, scaling_modifier: float = 1.0,
                  transform: torch.Tensor | None = None) -> torch.Tensor:
    """[N, 3] scales (activated), [N, 4] quats -> [N, 6] symmetric covariance."""
    return covariance6_from_scaling_rotation(scaling, quat, scaling_modifier, transform)


def preprocess(
    means3d: torch.Tensor,
    cov3d6: torch.Tensor,
    w2c: torch.Tensor,
    full_proj: torch.Tensor,
    image_width: int,
    image_height: int,
    tan_fovx: float,
    tan_fovy: float,
) -> ProjectedGaussians:
    """Project Gaussians to screen space, computing conics and radii."""
    means3d = means3d.float()
    cov3d6 = cov3d6.float()
    focal_x = image_width / (2.0 * tan_fovx)
    focal_y = image_height / (2.0 * tan_fovy)

    p_view_z = means3d @ w2c[2, :3] + w2c[2, 3]
    p_ndc = project_points(means3d, full_proj)
    cov2d = compute_cov2d(means3d, cov3d6, w2c, focal_x, focal_y, tan_fovx, tan_fovy)
    return screen_space(p_view_z, p_ndc, cov2d, image_width, image_height)


def screen_space(p_view_z: torch.Tensor, p_ndc: torch.Tensor, cov2d: torch.Tensor,
                 image_width: int, image_height: int) -> ProjectedGaussians:
    """The rest of `preprocess` from the view depths [...], the NDC points
    [..., 3] and cov2d [..., 3]: elementwise, so leading camera dimensions
    broadcast."""
    in_front = p_view_z > 0.2
    means2d = torch.stack(
        [ndc2pix(p_ndc[..., 0], image_width), ndc2pix(p_ndc[..., 1], image_height)],
        dim=-1,
    )
    det = cov2d[..., 0] * cov2d[..., 2] - cov2d[..., 1] * cov2d[..., 1]
    det_ok = det != 0.0
    det_inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conics = torch.stack(
        [cov2d[..., 2] * det_inv, -cov2d[..., 1] * det_inv, cov2d[..., 0] * det_inv],
        dim=-1,
    )

    mid = 0.5 * (cov2d[..., 0] + cov2d[..., 2])
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=0.0)))

    visible = in_front & det_ok & (radius_f > 0.0)
    radii = torch.where(visible, radius_f, torch.zeros_like(radius_f)).to(torch.int32)
    return ProjectedGaussians(means2d=means2d, depths=p_view_z, conics=conics,
                              radii=radii, cov2d=cov2d, visible=visible)
