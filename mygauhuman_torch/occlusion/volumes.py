"""SH occlusion / irradiance volumes — the gs-ir CUDA kernels in plain
PyTorch (port of occlusion/volumes.py).

Replaces (SURVEY.md §2.4):
  * trilinear_interpolate_coefficients fwd/bwd (irradiance_kernel.cu:11-130):
    a differentiable gather + lerp (the grid's gradient through
    `gather_rows`, in a fixed order);
  * sparse_interpolate_coefficients (occlusion_kernel.cu:22-128): validity-
    masked trilinear interpolation over a sparse voxel-id grid;
  * SH_reconstruction (occlusion_kernel.cu:146-243): GGX-importance-sampled
    SH evaluation around the normal lobe (Hammersley sequence);
  * dialate_occlusion_ids (occlusion_kernel.cu:244+): nearest-neighbor fill;
  * IrradianceVolumes (gs_ir/volumes.py:217-261): a learnable [R^3, d^2, C]
    SH grid.

`degree` follows the gs-ir convention: the number of SH bands, i.e.
degree^2 coefficients (degree=4 -> l in 0..3 -> 16 coeffs).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mygauhuman_torch.device import DEFAULT_DEVICE, resolve_device
from mygauhuman_torch.ops.sh import C0, C1, C2, C3
from mygauhuman_torch.pbr.cubemap import gather_rows


def sh_components(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH basis values, bands l < degree: [..., degree^2].

    Parity: components_from_spherical_harmonics (gs_ir/volumes.py:9-86)."""
    if not 1 <= degree <= 4:
        raise ValueError(f"SH degree (bands) must be 1..4, got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    comps = [torch.full_like(x, C0)]
    if degree > 1:
        comps += [-C1 * y, C1 * z, -C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        comps += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy), C2[3] * xz,
                  C2[4] * (xx - yy)]
    if degree > 3:
        comps += [
            C3[0] * y * (3 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4 * zz - xx - yy),
            C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            C3[4] * x * (4 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3 * yy),
        ]
    return torch.stack(comps, dim=-1)


def reconstruct_envmap_from_sh(coefficients: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate an SH-encoded envmap [..., d2, C] at directions [H, W, 3]
    -> [..., H, W, C]. Parity: gs_ir/volumes.py:89-150."""
    degree = int(np.sqrt(coefficients.shape[-2]))
    comps = sh_components(degree, dirs)
    return torch.einsum("...dc,hwd->...hwc", coefficients, comps)


# ---- trilinear interpolation over dense / sparse grids ------------------------

_CORNERS = [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def _grid_corners(aabb: torch.Tensor, res: int, points: torch.Tensor):
    """Corner indices [N, 8, 3] and trilinear weights [N, 8] for points in
    an aabb = [min_xyz(3), max_xyz(3)] over a res^3 vertex grid."""
    lo, hi = aabb[:3], aabb[3:]
    cell = (hi - lo) / (res - 1)
    f = (points - lo) / cell
    i0 = torch.clamp(torch.floor(f).long(), 0, res - 2)
    t = torch.clamp(f - i0, 0.0, 1.0)
    offs = torch.tensor(_CORNERS, dtype=torch.int64, device=points.device)
    corners = i0[:, None, :] + offs[None, :, :]
    w = torch.where(offs[None] == 1, t[:, None, :], 1.0 - t[:, None, :]).prod(dim=-1)
    return corners, w


def _flat(corners, res):
    return (corners[..., 0] * res + corners[..., 1]) * res + corners[..., 2]


def trilinear_interpolate(grid: torch.Tensor, aabb: torch.Tensor,
                          points: torch.Tensor) -> torch.Tensor:
    """Differentiable dense-grid SH interpolation: grid [R, R, R, d2, C] ->
    [N, d2, C]."""
    res = grid.shape[0]
    corners, w = _grid_corners(aabb, res, points)
    vals = gather_rows(grid.reshape((res ** 3,) + tuple(grid.shape[3:])), _flat(corners, res))
    return torch.einsum("nk,nkdc->ndc", w, vals)


def sparse_interpolate_coefficients(coefficients: torch.Tensor, occlusion_ids: torch.Tensor,
                                    aabb: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Validity-masked trilinear interp over a sparse voxel grid -> [N, d2, C].

    Empty corners (id < 0) are dropped and weights renormalized
    (occlusion_kernel.cu:22-128)."""
    res = occlusion_ids.shape[0]
    corners, w = _grid_corners(aabb, res, points)
    ids = occlusion_ids.reshape(-1)[_flat(corners, res)]
    w = torch.where(ids >= 0, w, torch.zeros_like(w))
    w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-8)
    vals = gather_rows(coefficients, torch.clamp(ids, min=0))
    return torch.einsum("nk,nkdc->ndc", w, vals)


def dilate_occlusion_ids(ids: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """Fill empty (-1) voxels from their 6-neighborhood (max id wins).

    Parity: dialate_occlusion_ids (occlusion_kernel.cu:244+)."""
    for _ in range(iterations):
        p = torch.nn.functional.pad(ids, (1, 1, 1, 1, 1, 1), value=-1)
        neigh = torch.stack([p[:-2, 1:-1, 1:-1], p[2:, 1:-1, 1:-1], p[1:-1, :-2, 1:-1],
                             p[1:-1, 2:, 1:-1], p[1:-1, 1:-1, :-2], p[1:-1, 1:-1, 2:]])
        ids = torch.where(ids >= 0, ids, neigh.max(dim=0).values)
    return ids


# ---- GGX-sampled SH reconstruction (occlusion_kernel.cu:146-243) -------------------

def _hammersley(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.uint32)
    bits = i.copy()
    bits = (bits << 16) | (bits >> 16)
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    return np.stack([i / n, bits.astype(np.float64) * 2.3283064365386963e-10], axis=1)


def sh_reconstruction(coefficients: torch.Tensor, normals: torch.Tensor,
                      roughness: torch.Tensor, sample_rays: int = 256,
                      degree: int = 4) -> torch.Tensor:
    """Average SH radiance over GGX-sampled directions around the normal
    lobe: coefficients [N, d2, C] -> [N, C]."""
    dev = normals.device
    ham = torch.as_tensor(_hammersley(sample_rays), dtype=torch.float32, device=dev)
    alpha = torch.clamp(roughness, 1e-3, 1.0) ** 2
    phi = 2.0 * math.pi * ham[:, 0]
    xi2 = ham[:, 1]
    a2 = (alpha * alpha)[:, 0][:, None]
    cos_t = torch.sqrt((1.0 - xi2[None, :]) / (1.0 + (a2 - 1.0) * xi2[None, :]))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t ** 2, min=0.0))
    local = torch.stack([torch.cos(phi)[None, :] * sin_t, torch.sin(phi)[None, :] * sin_t,
                         cos_t], dim=-1)                                   # [N, S, 3]
    n = normals
    up = torch.where(n[..., 2:3].abs() < 0.999,
                     torch.tensor([0.0, 0.0, 1.0], device=dev),
                     torch.tensor([1.0, 0.0, 0.0], device=dev))
    tang = torch.linalg.cross(up, n, dim=-1)
    tang = tang / torch.clamp(torch.linalg.norm(tang, dim=-1, keepdim=True), min=1e-12)
    bitang = torch.linalg.cross(n, tang, dim=-1)
    dirs = (local[..., 0:1] * tang[:, None, :] + local[..., 1:2] * bitang[:, None, :]
            + local[..., 2:3] * n[:, None, :])
    comps = sh_components(degree, dirs)
    return torch.einsum("nsd,ndc->nsc", comps, coefficients).mean(dim=1)


def recon_occlusion(points: torch.Tensor, normals: torch.Tensor,
                    occlusion_coefficients: torch.Tensor, occlusion_ids: torch.Tensor,
                    aabb: torch.Tensor, bound: float, sample_rays: int = 256,
                    degree: int = 4) -> torch.Tensor:
    """Per-point scalar ambient occlusion from the baked SH grid.

    Parity: recon_occlusion (gs_ir/__init__.py:6-41): query points shifted
    half a grid cell along the normal, sparse interp, GGX SH reconstruction
    at roughness 1."""
    half_grid = bound / float(occlusion_ids.shape[0])
    coeffs = sparse_interpolate_coefficients(occlusion_coefficients, occlusion_ids, aabb,
                                             points + normals * half_grid)
    rough = torch.ones((points.shape[0], 1), dtype=torch.float32, device=points.device)
    return torch.clamp(sh_reconstruction(coeffs, normals, rough, sample_rays, degree), 0.0, 1.0)


# ---- irradiance volumes (gs_ir/volumes.py:217-261) -------------------------------

class IrradianceVolumes(NamedTuple):
    coefficients: torch.Tensor   # [R, R, R, degree^2, C] trainable
    aabb: torch.Tensor           # [6] frozen


def init_irradiance_volumes(aabb, grid_res: int = 64, degree: int = 3,
                            single_channel: bool = True,
                            device: str | torch.device = DEFAULT_DEVICE) -> IrradianceVolumes:
    dev = resolve_device(device)
    c = 1 if single_channel else 3
    return IrradianceVolumes(
        coefficients=torch.zeros((grid_res, grid_res, grid_res, degree ** 2, c),
                                 dtype=torch.float32, device=dev),
        aabb=torch.as_tensor(np.asarray(aabb, np.float32), device=dev))


def query_irradiance(vol: IrradianceVolumes, points: torch.Tensor,
                     normals: torch.Tensor) -> torch.Tensor:
    """Irradiance at surface points: SH grid interp x SH basis at the normal.

    Parity: IrradianceVolumes.query_irradiance (gs_ir/volumes.py:245-261)."""
    degree = int(np.sqrt(vol.coefficients.shape[-2]))
    comps = sh_components(degree, normals).detach()
    coeffs = trilinear_interpolate(vol.coefficients, vol.aabb, points)
    return torch.clamp(torch.einsum("ndc,nd->nc", coeffs, comps), min=0.0)
