"""Branch B's split-sum image-based shading of the plain reference
(myGauHuman `pbr/shade.py:105-213`, `pbr_shading`, as `train.py` calls it:
no tone map, no gamma, no metallic):

  diffuse  = clamp(irradiance^(1 / 2.2), 0, 1)(n) * occlusion * albedo
  specular = prefiltered(reflect(v, n), mip(roughness)) * 0.04 * LUT(n.v, roughness).x
  rgb      = clamp(diffuse + specular, 0, 1) where the alpha is > 0, else 0

with reflect(v, n) = 2 max(n.v, 0) n - v and n.v clamped to [1e-4, 1] for
the lookup. The normals are the rendered world-normal G-buffer mapped
back to [-1, 1], not renormalised (as the published code takes them).

The BRDF LUT (256 x 256, u = n.v, v = roughness, bilinear with clamped
edges) is Karis' split-sum integral with 1,024 Hammersley samples of GGX
half-vectors and height-correlated Smith visibility, integrated here in
float64. Departure from the published description: the published code
loads a shipped `brdf_256_256.bin`, which is not available; the integral
is the one that file tabulates.
"""
from __future__ import annotations

import functools
import math

import torch

from port_bench.reference import light as RL


@functools.lru_cache(maxsize=None)
def _lut(res: int, samples: int) -> torch.Tensor:
    i = torch.arange(samples, dtype=torch.int64)
    bits = i.clone()
    bits = ((bits << 16) | (bits >> 16)) & 0xFFFFFFFF
    for shift, mask in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F), (8, 0x00FF00FF)):
        bits = ((bits & mask) << shift) | ((bits & (mask << shift)) >> shift)
    xi1 = i.double() / samples
    xi2 = bits.double() * 2.3283064365386963e-10
    grid = (torch.arange(res, dtype=torch.float64) + 0.5) / res
    rough, nov = torch.meshgrid(grid, grid, indexing="ij")       # rows: roughness
    nov = torch.clamp(nov, min=1e-4)
    vx, vz = torch.sqrt(1 - nov ** 2), nov
    alpha = torch.clamp(rough * rough, min=1e-4)
    a2 = alpha ** 2
    A = torch.zeros_like(nov)
    B = torch.zeros_like(nov)
    for s in range(samples):
        phi = 2 * math.pi * float(xi1[s])
        x2 = float(xi2[s])
        cos_th = torch.sqrt((1 - x2) / (1 + (a2 - 1) * x2))
        sin_th = torch.sqrt(torch.clamp(1 - cos_th ** 2, min=0.0))
        hx, hy, hz = math.cos(phi) * sin_th, math.sin(phi) * sin_th, cos_th
        vdh = vx * hx + 0.0 * hy + vz * hz
        lz = 2 * vdh * hz - vz
        nol = torch.clamp(lz, min=0.0)
        noh = torch.clamp(hz, min=0.0)
        voh = torch.clamp(vdh, min=0.0)
        lam_v = nol * torch.sqrt(nov ** 2 * (1 - a2) + a2)
        lam_l = nov * torch.sqrt(nol ** 2 * (1 - a2) + a2)
        g = 2 * nol * nov / (lam_v + lam_l + 1e-9)
        g_vis = torch.where(nol > 0, g * voh / (noh * nov + 1e-9), torch.zeros_like(g))
        fc = (1 - voh) ** 5
        A += (1 - fc) * g_vis
        B += fc * g_vis
    return (torch.stack([A, B], dim=-1) / samples).float()


def brdf_lut(device, res: int = 256, samples: int = 1024) -> torch.Tensor:
    """[res, res, 2] (scale, bias) over (roughness rows, n.v columns)."""
    return _lut(res, samples).to(device)


def lut_scale(lut, nov, roughness):
    """The LUT's scale term, bilinear at (u = n.v, v = roughness)."""
    H, W, _ = lut.shape
    return RL.bilinear(lut[None], torch.zeros_like(nov, dtype=torch.long),
                       nov * W - 0.5, roughness * H - 0.5)[..., 0]


def shade(light: RL.Light, normals, view_dirs, albedo, roughness, alpha, occlusion, lut):
    """[H, W, 3] shaded colour (normals, view_dirs, albedo [H, W, 3];
    roughness, alpha, occlusion [H, W])."""
    diffuse_map = torch.clamp(light.diffuse ** (1.0 / 2.2), 0.0, 1.0)
    ndv = (normals * view_dirs).sum(dim=-1)
    refl = 2.0 * torch.clamp(ndv, min=0.0)[..., None] * normals - view_dirs
    diffuse = RL.sample_cube(diffuse_map, normals) * occlusion[..., None] * albedo
    fg = lut_scale(lut, torch.clamp(ndv, 1e-4, 1.0), roughness)
    spec = RL.sample_mips(light.specular, refl, RL.mip_level(roughness, len(light.specular)))
    rgb = torch.clamp(diffuse + spec * (0.04 * fg)[..., None], 0.0, 1.0)
    return torch.where(alpha[..., None] > 0, rgb, torch.zeros_like(rgb))
