"""Branch B's cubemap light of the plain reference (myGauHuman
`pbr/light.py:57-149`, `CubemapLight`): a trainable 6 x 32 x 32 x 3
cubemap, its average-pooled mip chain down to 8 x 8, the GGX-prefiltered
specular levels (roughness 0.08 and 0.5 over the chain, 1.0 at 8 x 8),
the cosine-weighted diffuse irradiance, the roughness -> mip level map and
the lat-long export (`export_envmap`).

The prefilters are the published split-sum integrals as sums over every
input texel (the published CUDA kernels, `cubemap.cu:110-138,246-297`): a
texel's direction, its solid angle 4 / (R^2 (gx^2 + gy^2 + 1)^1.5), the
diffuse weight max(N.L, 0) / pi, the specular weight max(N.L, 0)
D_GGX(alpha^2, N.H) / 4 normalised by its sum (N = V = R, H = normalize(N
+ L), N.H clamped to [1e-4, 1 - 1e-4], alpha = roughness^2), as float32
matrix products with TF32 off. Lookups are bilinear with each face's edge
clamped (no seams across faces), the mip chain trilinear.

Departure from the published description: the lookups clamp at each
face's edge where nvdiffrast's cube sampling filters across the seam (the
program does the same, so the comparison holds it there).
"""
from __future__ import annotations

import math

import torch

LIGHT_MIN_RES = 8
MIN_ROUGHNESS, MAX_ROUGHNESS = 0.08, 0.5
ROW_BLOCK = 1024      # output texels per block of the specular weights


def cube_dir(face: int, gx, gy):
    """Directions (not unit) of the texel coordinates of one face."""
    one = torch.ones_like(gx)
    return torch.stack({0: (one, -gy, -gx), 1: (-one, -gy, gx), 2: (gx, one, gy),
                        3: (gx, -one, -gy), 4: (gx, -gy, one), 5: (-gx, -gy, -one)}[face],
                       dim=-1)


def texel_grid(res: int, device):
    lin = torch.linspace(-1.0 + 1.0 / res, 1.0 - 1.0 / res, res, device=device)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    return gx, gy


def texel_dirs(res: int, device) -> torch.Tensor:
    """[6 res^2, 3] unit directions of every texel, face-major."""
    gx, gy = texel_grid(res, device)
    d = torch.stack([cube_dir(f, gx, gy) for f in range(6)])
    return (d / torch.linalg.norm(d, dim=-1, keepdim=True)).reshape(-1, 3)


def solid_angles(res: int, device) -> torch.Tensor:
    gx, gy = texel_grid(res, device)
    return (4.0 / (res * res * (gx * gx + gy * gy + 1.0) ** 1.5)).expand(6, res, res).reshape(-1)


def diffuse_weights(res: int, device) -> torch.Tensor:
    d = texel_dirs(res, device)
    return torch.clamp(d @ d.T, min=0.0) * solid_angles(res, device)[None, :] / math.pi


def specular_weights(res: int, roughness: float, device) -> tuple:
    """([O, I] GGX weights, [O, 1] their sums clamped at 1e-8)."""
    d = texel_dirs(res, device)
    omega = solid_angles(res, device)
    a2 = (roughness * roughness) ** 2
    rows = []
    for o0 in range(0, d.shape[0], ROW_BLOCK):
        out = d[o0:o0 + ROW_BLOCK]
        cos = out @ d.T
        h = out[:, None, :] + d[None, :, :]
        h = h / torch.clamp(torch.linalg.norm(h, dim=-1, keepdim=True), min=1e-12)
        c = torch.clamp(torch.einsum("oc,oic->oi", out, h), 1e-4, 1.0 - 1e-4)
        dd = (c * a2 - c) * c + 1.0
        rows.append(torch.clamp(cos, min=0.0) * (a2 / (dd * dd * math.pi)) * omega[None, :]
                    / 4.0)
    w = torch.cat(rows)
    return w, torch.clamp(w.sum(dim=1, keepdim=True), min=1e-8)


def level_roughness(n_levels: int) -> list:
    ramp = [i / max(n_levels - 2, 1) * (MAX_ROUGHNESS - MIN_ROUGHNESS) + MIN_ROUGHNESS
            for i in range(n_levels - 1)]
    return ramp + [1.0]


class Light:
    """The derived maps of a light: `diffuse` [6, R, R, 3] and the specular
    levels `specular` (descending resolution)."""

    def __init__(self, base: torch.Tensor):
        chain = [base]
        while chain[-1].shape[1] > LIGHT_MIN_RES:
            f, r, _, c = chain[-1].shape
            chain.append(chain[-1].reshape(f, r // 2, 2, r // 2, 2, c).mean(dim=(2, 4)))
        dev = base.device
        R = base.shape[1]
        self.diffuse = (diffuse_weights(R, dev) @ base.reshape(-1, 3)).reshape(base.shape)
        rough = level_roughness(len(chain))
        levels = list(zip(chain[:-1], rough[:-1])) + [(chain[-1], 1.0)]
        self.specular = []
        for tex, r in levels:
            w, norm = specular_weights(tex.shape[1], r, dev)
            self.specular.append(((w @ tex.reshape(-1, 3)) / norm).reshape(tex.shape))


def mip_level(roughness, n_levels: int):
    """Roughness -> fractional specular level: linear over [0.08, 0.5] to
    level n - 2, then over [0.5, 1] to n - 1."""
    low = ((torch.clamp(roughness, MIN_ROUGHNESS, MAX_ROUGHNESS) - MIN_ROUGHNESS)
           / (MAX_ROUGHNESS - MIN_ROUGHNESS) * (n_levels - 2))
    high = ((torch.clamp(roughness, MAX_ROUGHNESS, 1.0) - MAX_ROUGHNESS)
            / (1.0 - MAX_ROUGHNESS) + n_levels - 2)
    return torch.where(roughness < MAX_ROUGHNESS, low, high)


def cube_coords(d) -> tuple:
    """(face, gx, gy) of directions [..., 3] by their major axis (the
    inverse of `cube_dir`), gx, gy in [-1, 1]."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    on_x = (ax >= ay) & (ax >= az)
    on_y = ~on_x & (ay >= az)
    face = torch.where(on_x, torch.where(x >= 0, 0, 1),
                       torch.where(on_y, torch.where(y >= 0, 2, 3), torch.where(z >= 0, 4, 5)))
    major = torch.where(on_x, ax, torch.where(on_y, ay, az)) + 1e-12
    gx = torch.where(on_x, torch.where(x >= 0, -z, z) / major,
                     torch.where(on_y, x / major, torch.where(z >= 0, x, -x) / major))
    gy = torch.where(on_x, -y / major,
                     torch.where(on_y, torch.where(y >= 0, z, -z) / major, -y / major))
    return face.long(), gx, gy


def bilinear(tex, face, fx, fy):
    """tex [F, H, W, C] at fractional texel coordinates (texel centres at
    integers) on `face`, each face's edge clamped -> [..., C]."""
    _, H, W, _ = tex.shape
    x0 = torch.clamp(torch.floor(fx).long(), 0, W - 1)
    y0 = torch.clamp(torch.floor(fy).long(), 0, H - 1)
    x1, y1 = torch.clamp(x0 + 1, 0, W - 1), torch.clamp(y0 + 1, 0, H - 1)
    tx = torch.clamp(fx - x0, 0.0, 1.0)[..., None]
    ty = torch.clamp(fy - y0, 0.0, 1.0)[..., None]
    top = tex[face, y0, x0] * (1 - tx) + tex[face, y0, x1] * tx
    bot = tex[face, y1, x0] * (1 - tx) + tex[face, y1, x1] * tx
    return top * (1 - ty) + bot * ty


def sample_cube(cube, d):
    """Bilinear lookup of a cubemap [6, R, R, C] in directions [..., 3]."""
    face, gx, gy = cube_coords(d)
    R = cube.shape[1]
    return bilinear(cube, face, (gx + 1.0) * 0.5 * R - 0.5, (gy + 1.0) * 0.5 * R - 0.5)


def sample_mips(levels: list, d, level):
    """Trilinear lookup across the levels at fractional `level` [...]."""
    n = len(levels)
    samples = torch.stack([sample_cube(m, d) for m in levels])
    lv = torch.clamp(level, 0.0, n - 1.0)
    l0 = torch.clamp(torch.floor(lv).long(), 0, n - 1)
    l1 = torch.clamp(l0 + 1, 0, n - 1)
    frac = (lv - l0.float())[..., None]

    def pick(idx):
        return torch.take_along_dim(samples, idx[None, ..., None], dim=0)[0]

    return pick(l0) * (1 - frac) + pick(l1) * frac


def latlong_dirs(height: int, width: int, device) -> torch.Tensor:
    """[H, W, 3] directions of the lat-long map: theta = pi v over rows,
    phi = pi u over columns (v in [0, 1], u in [-1, 1] at the grid's ends),
    d = (sin t sin p, cos t, -sin t cos p)."""
    v = torch.linspace(0.0, 1.0, height, device=device)[:, None] * math.pi
    u = torch.linspace(-1.0, 1.0, width, device=device)[None, :] * math.pi
    return torch.stack([(torch.sin(v) * torch.sin(u)).expand(height, width),
                        torch.cos(v).expand(height, width),
                        (-torch.sin(v) * torch.cos(u)).expand(height, width)], dim=-1)


def export_envmap(base, height: int, width: int):
    """The lat-long map [H, W, 3] of the base cubemap."""
    return sample_cube(base, latlong_dirs(height, width, base.device))
