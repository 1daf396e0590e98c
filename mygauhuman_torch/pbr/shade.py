"""Split-sum image-based PBR shading (port of pbr/shade.py; reference
pbr/shade.py:105-213).

diffuse = irradiance(normal)^(1/2.2) * albedo * occlusion
specular = prefiltered_env(reflect_dir, mip(roughness)) * F0 * BRDF_LUT.x
with F0 = 0.04 (or metallic mix), the gs-ir / nvdiffrec recipe.

The 256x256x2 BRDF LUT is computed here (Karis split-sum integration with a
Hammersley GGX sample set, a numpy copy of the JAX package's) instead of
loading the reference's `brdf_256_256.bin`; `get_brdf_lut` caches it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from mygauhuman_torch.device import DEFAULT_DEVICE, resolve_device
from mygauhuman_torch.pbr.cubemap import (
    sample_2d,
    sample_2d_planar,
    sample_cubemap,
    sample_cubemap_mips,
    sample_cubemap_mips_planar,
    sample_cubemap_planar,
)
from mygauhuman_torch.pbr.light import CubemapLight, get_mip


def saturate_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Parity: shade.py saturate_dot (clamp [1e-4, 1])."""
    return torch.clamp((a * b).sum(dim=-1, keepdim=True), 1e-4, 1.0)


def aces_film(rgb: torch.Tensor) -> torch.Tensor:
    """ACES filmic tone map (shade.py:33-44)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((rgb * (a * rgb + b)) / (rgb * (c * rgb + d) + e), 0.0, 1.0)


def linear_to_srgb(linear: torch.Tensor) -> torch.Tensor:
    """Parity: shade.py:47-60."""
    eps = torch.finfo(torch.float32).eps
    srgb0 = 323.0 / 25.0 * linear
    srgb1 = (211.0 * torch.clamp(linear, min=eps) ** (5.0 / 12.0) - 11.0) / 200.0
    return torch.where(linear <= 0.0031308, srgb0, srgb1)


def envBRDF_approx(roughness: torch.Tensor, nov: torch.Tensor) -> torch.Tensor:
    """Lazarov analytic split-sum approximation (shade.py:15-25, unused by
    the training path but part of the API)."""
    dev = roughness.device
    c0 = torch.tensor([-1.0, -0.0275, -0.572, 0.022], device=dev)
    c1 = torch.tensor([1.0, 0.0425, 1.04, -0.04], device=dev)
    c2 = torch.tensor([-1.04, 1.04], device=dev)
    r = roughness * c0 + c1
    a004 = torch.minimum(r[..., 0:1] ** 2, torch.exp2(-9.28 * nov)) * r[..., 0:1] + r[..., 1:2]
    return torch.clamp(a004 * c2 + r[..., 2:], 0.0, 1.0)


# ---- BRDF LUT: Karis split-sum (A, B) over (NoV, roughness) -----------------------

def _hammersley(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.uint32)
    bits = i.copy()
    bits = (bits << 16) | (bits >> 16)
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    return np.stack([i / n, bits.astype(np.float64) * 2.3283064365386963e-10], axis=1)


def _brdf_lut_np(res: int, n_samples: int) -> np.ndarray:
    ham = _hammersley(n_samples)
    nov = (np.arange(res) + 0.5) / res                 # u axis
    rough = (np.arange(res) + 0.5) / res               # v axis
    nov_g, rough_g = np.meshgrid(nov, rough, indexing="xy")   # [res(v), res(u)]
    nov_g = np.maximum(nov_g, 1e-4)
    V = np.stack([np.sqrt(1 - nov_g**2), np.zeros_like(nov_g), nov_g], axis=-1)
    alpha = np.maximum(rough_g * rough_g, 1e-4)
    a2 = alpha**2
    A = np.zeros_like(nov_g)
    B = np.zeros_like(nov_g)
    for xi1, xi2 in ham:
        phi = 2 * np.pi * xi1
        cos_th = np.sqrt((1 - xi2) / (1 + (a2 - 1) * xi2))
        sin_th = np.sqrt(np.maximum(1 - cos_th**2, 0))
        H = np.stack([np.cos(phi) * sin_th, np.sin(phi) * sin_th, cos_th], axis=-1)
        L = 2 * np.sum(V * H, axis=-1, keepdims=True) * H - V
        nol = np.maximum(L[..., 2], 0.0)
        noh = np.maximum(H[..., 2], 0.0)
        voh = np.maximum(np.sum(V * H, axis=-1), 0.0)
        # height-correlated Smith GGX: G = 2 NoL NoV / (Λ_V + Λ_L)
        lam_v = nol * np.sqrt(nov_g**2 * (1 - a2) + a2)
        lam_l = nov_g * np.sqrt(nol**2 * (1 - a2) + a2)
        g = 2 * nol * nov_g / (lam_v + lam_l + 1e-9)
        g_vis = np.where(nol > 0, g * voh / (noh * nov_g + 1e-9), 0.0)
        fc = (1 - voh) ** 5
        A += (1 - fc) * g_vis
        B += fc * g_vis
    return (np.stack([A, B], axis=-1) / n_samples).astype(np.float32)


def compute_brdf_lut(res: int = 256, n_samples: int = 1024,
                     device: str | torch.device = DEFAULT_DEVICE) -> torch.Tensor:
    """[res, res, 2] split-sum LUT: u = NoV, v = roughness.

    Karis split-sum integration: importance-sampled GGX half-vectors
    accumulate the Fresnel scale (A) and bias (B) with height-correlated
    Smith visibility, the convention of the reference's shipped
    `pbr/brdf_256_256.bin`."""
    return torch.as_tensor(_brdf_lut_np(res, n_samples), device=resolve_device(device))


@functools.lru_cache(maxsize=None)
def _default_lut() -> np.ndarray:
    return _brdf_lut_np(256, 1024)


@functools.lru_cache(maxsize=None)
def get_brdf_lut(device: str | torch.device = DEFAULT_DEVICE) -> torch.Tensor:
    """[256, 256, 2] on `device`. The reference loads pbr/brdf_256_256.bin
    (shade.py:97-102); the same quantity is integrated once and cached."""
    return torch.as_tensor(_default_lut(), device=resolve_device(device))


# ---- shading ------------------------------------------------------------------------

def pbr_shading(
    light: CubemapLight,
    normals: torch.Tensor,      # [H, W, 3] world, unit
    view_dirs: torch.Tensor,    # [H, W, 3] surface -> camera, unit
    albedo: torch.Tensor,       # [H, W, 3]
    roughness: torch.Tensor,    # [H, W, 1]
    mask: torch.Tensor,         # [H, W, 1]
    brdf_lut: torch.Tensor,     # [256, 256, 2]
    occlusion: torch.Tensor | None = None,   # [H, W, 1]
    metallic: torch.Tensor | None = None,    # [H, W, 1]
    tone: bool = False,
    gamma: bool = False,
    background: torch.Tensor | None = None,
) -> dict:
    """Split-sum IBL shading. Parity: pbr/shade.py:105-213 (the diffuse^(1/2.2)
    gamma and the scale-only reflectance: the reference comments out the
    bias term fg_lookup[..., 1:2])."""
    if background is None:
        background = torch.zeros_like(normals)
    diffuse_map = torch.clamp(light.diffuse ** (1.0 / 2.2), 0.0, 1.0)
    ref_dirs = (2.0 * torch.clamp((normals * view_dirs).sum(dim=-1, keepdim=True), min=0.0)
                * normals - view_dirs)

    diffuse_light = sample_cubemap(diffuse_map, normals)
    if occlusion is not None:
        diffuse_light = diffuse_light * occlusion
    diffuse_rgb = diffuse_light * albedo

    nov = saturate_dot(normals, view_dirs)
    fg = sample_2d(brdf_lut, torch.cat([nov, roughness], dim=-1))

    mip = get_mip(roughness[..., 0], len(light.specular))
    spec = sample_cubemap_mips(list(light.specular), ref_dirs, mip)

    if metallic is None:
        f0 = torch.full_like(albedo, 0.04)
    else:
        f0 = (1.0 - metallic) * 0.04 + albedo * metallic
    specular_rgb = spec * (f0 * fg[..., 0:1])   # scale term only (reference parity)

    render_rgb = diffuse_rgb + specular_rgb
    render_rgb = aces_film(render_rgb) if tone else torch.clamp(render_rgb, 0.0, 1.0)
    if gamma:
        render_rgb = linear_to_srgb(render_rgb)
    render_rgb = torch.where(mask > 0, render_rgb, background)
    return {"render_rgb": render_rgb, "diffuse_rgb": diffuse_rgb,
            "specular_rgb": specular_rgb, "diffuse_light": diffuse_light}


def pbr_shading_planar(
    light: CubemapLight,
    normals: tuple,            # 3 x [H, W] planes, world, unit
    view_dirs: tuple,          # 3 x [H, W] planes, surface -> camera, unit
    albedo: tuple,             # 3 x [H, W] planes
    roughness: torch.Tensor,   # [H, W]
    mask: torch.Tensor,        # [H, W]
    brdf_lut: torch.Tensor,    # [256, 256, 2]
    occlusion: torch.Tensor | None = None,   # [H, W]
    metallic: torch.Tensor | None = None,    # [H, W]
    tone: bool = False,
    gamma: bool = False,
    background: tuple | None = None,         # 3 x [H, W]
) -> dict:
    """pbr_shading on channel-planar images (tuples of [H, W] planes), with
    the same math. The JAX package needs it for the TPU's layouts; here it
    keeps the callers' form, and every tuple of the result is of planes."""
    if background is None:
        background = (0.0, 0.0, 0.0)
    diffuse_map = torch.clamp(light.diffuse ** (1.0 / 2.2), 0.0, 1.0)

    nx, ny, nz = normals
    vx, vy, vz = view_dirs
    ndv = nx * vx + ny * vy + nz * vz
    two_ndv = 2.0 * torch.clamp(ndv, min=0.0)
    rx, ry, rz = two_ndv * nx - vx, two_ndv * ny - vy, two_ndv * nz - vz

    diffuse_light = sample_cubemap_planar(diffuse_map, nx, ny, nz)
    if occlusion is not None:
        diffuse_light = tuple(d * occlusion for d in diffuse_light)
    diffuse_rgb = tuple(d * a for d, a in zip(diffuse_light, albedo))

    nov = torch.clamp(ndv, 1e-4, 1.0)
    fg0 = sample_2d_planar(brdf_lut, nov, roughness)[0]

    mip = get_mip(roughness, len(light.specular))
    spec = sample_cubemap_mips_planar(list(light.specular), rx, ry, rz, mip)

    if metallic is None:
        f0 = (0.04, 0.04, 0.04)
    else:
        f0 = tuple((1.0 - metallic) * 0.04 + a * metallic for a in albedo)
    specular_rgb = tuple(s * (f * fg0) for s, f in zip(spec, f0))

    render_rgb = tuple(d + s for d, s in zip(diffuse_rgb, specular_rgb))
    render_rgb = tuple(aces_film(c) if tone else torch.clamp(c, 0.0, 1.0) for c in render_rgb)
    if gamma:
        render_rgb = tuple(linear_to_srgb(c) for c in render_rgb)
    render_rgb = tuple(torch.where(mask > 0, c, bg if torch.is_tensor(bg)
                                   else torch.full_like(c, bg))
                       for c, bg in zip(render_rgb, background))
    return {"render_rgb": render_rgb, "diffuse_rgb": diffuse_rgb,
            "specular_rgb": specular_rgb, "diffuse_light": diffuse_light}
