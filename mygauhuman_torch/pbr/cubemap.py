"""Differentiable cubemap / 2D texture sampling (port of pbr/cubemap.py).

Face/uv convention of the reference's `cube_to_dir` (pbr/light.py:9-26,
nvdiffrec order +x,-x,+y,-y,+z,-z):
    s0 (+x): d = ( 1, -gy, -gx)        s1 (-x): d = (-1, -gy,  gx)
    s2 (+y): d = (gx,   1,  gy)        s3 (-y): d = (gx,  -1, -gy)
    s4 (+z): d = (gx, -gy,   1)        s5 (-z): d = (-gx, -gy, -1)
with gx, gy in [-1, 1] at pixel centers linspace(-1+1/R, 1-1/R, R).

Bilinear filtering clamps at face edges. Sampling gathers the four taps of
each lookup with `gather_rows`, whose backward sums the cotangent rows per
texel in a fixed order (sort by texel, float64 prefix sums in fixed blocks),
so the texture gradient has the same bits on every run; autograd's own
scatter would accumulate in whatever order the device runs it.

Deliberate difference from the JAX module: no `_bilinear_rows_matmul`. The
JAX planar samplers contract one-hot matrices instead of gathering only to
avoid the TPU's scalar gather lowering; here the `_planar` functions keep
their names and tuple-of-planes signatures and gather like the rest.
"""
from __future__ import annotations

import torch

PREFIX_BLOCK = 1024   # rows per block of the fixed-order prefix sums


def segment_sums(rows: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Sum rows [M, C] by target idx [M] into [n, C], in a fixed order.

    The rows are sorted by target (stable), prefix-summed in float64 within
    blocks of PREFIX_BLOCK rows and then across the blocks' totals (scans
    along the innermost and the outer dimension: no atomics, no look-back),
    and each target's sum is the difference of the prefix at its segment's
    ends, rounded once to float32."""
    C = rows.shape[-1]
    rows = rows.reshape(-1, C)
    key, perm = torch.sort(idx.reshape(-1), stable=True)
    M = key.shape[0]
    nb = max(-(-M // PREFIX_BLOCK), 1)
    vals = rows[perm].double()
    vals = torch.cat([vals, vals.new_zeros((nb * PREFIX_BLOCK - M, C))])
    within = torch.cumsum(vals.reshape(nb, PREFIX_BLOCK, C).transpose(1, 2), dim=2)
    totals = within[:, :, -1]                                        # [nb, C]
    before = torch.cat([totals.new_zeros((1, C)), torch.cumsum(totals, dim=0)[:-1]])
    prefix = (within + before[:, :, None]).transpose(1, 2).reshape(-1, C)[:M]
    prefix = torch.cat([prefix.new_zeros((1, C)), prefix])
    targets = torch.arange(n, device=key.device, dtype=key.dtype)
    hi = torch.searchsorted(key, targets, right=True)
    lo = torch.searchsorted(key, targets, right=False)
    return (prefix[hi] - prefix[lo]).float()


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape = table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        n = ctx.shape[0]
        rest = tuple(ctx.shape[1:])
        flat = g.reshape(idx.numel(), -1)
        return segment_sums(flat, idx, n).reshape((n,) + rest), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] (rows of table [n, ...] at the int64 indices idx) with a
    fixed-order backward (`segment_sums`)."""
    return _GatherRows.apply(table, idx.long())


def cube_to_dir(face: int, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    one = torch.ones_like(gx)
    v = {0: (one, -gy, -gx), 1: (-one, -gy, gx), 2: (gx, one, gy),
         3: (gx, -one, -gy), 4: (gx, -gy, one)}.get(face, (-gx, -gy, -one))
    return torch.stack(v, dim=-1)


def dir_to_cube_uv_planar(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """Directions as component planes -> (face, gx, gy), gx and gy in [-1, 1]."""
    ax, ay, az = x.abs(), y.abs(), z.abs()
    eps = 1e-12
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)

    def sel(a, b, c):   # by the major axis
        return torch.where(is_x, a, torch.where(is_y, b, c))

    face = sel(torch.where(x >= 0, 0, 1), torch.where(y >= 0, 2, 3),
               torch.where(z >= 0, 4, 5)).to(torch.int64)
    a = sel(ax, ay, az) + eps
    gx = sel(torch.where(x >= 0, -z, z) / a, x / a, torch.where(z >= 0, x, -x) / a)
    gy = sel(-y / a, torch.where(y >= 0, z, -z) / a, -y / a)
    return face, gx, gy


def dir_to_cube_uv(dirs: torch.Tensor):
    """[..., 3] directions -> (face [...], gx [...], gy [...]) in [-1, 1]."""
    return dir_to_cube_uv_planar(dirs[..., 0], dirs[..., 1], dirs[..., 2])


def face_grid(res: int, device=None):
    """Pixel-center (gx, gy) grids, each [res, res] (gy rows, gx cols)."""
    lin = torch.linspace(-1.0 + 1.0 / res, 1.0 - 1.0 / res, res, device=device)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    return gx, gy


def face_directions(res: int, device=None) -> torch.Tensor:
    """Unit direction of every texel: [6, res, res, 3]."""
    gx, gy = face_grid(res, device)
    dirs = torch.stack([cube_to_dir(s, gx, gy) for s in range(6)], dim=0)
    return dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)


def texel_solid_angles(res: int, device=None) -> torch.Tensor:
    """Solid angle of every texel: [6, res, res],
    4 / (res^2 (gx^2 + gy^2 + 1)^1.5)."""
    gx, gy = face_grid(res, device)
    w = 4.0 / (res * res * (gx * gx + gy * gy + 1.0) ** 1.5)
    return w.expand(6, res, res)


def _taps(fx, fy, W, H):
    """Bilinear taps of pixel-space coords: (x0, x1, y0, y1, tx, ty), edges clamped."""
    x0 = torch.clamp(torch.floor(fx).long(), 0, W - 1)
    y0 = torch.clamp(torch.floor(fy).long(), 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    tx = torch.clamp(fx - x0, 0.0, 1.0)
    ty = torch.clamp(fy - y0, 0.0, 1.0)
    return x0, x1, y0, y1, tx, ty


def _bilinear(table, rows0, rows1, x0, x1, tx, ty, width):
    """Bilinear mix of table [rows * width, C] at the four taps
    (row0/row1 x x0/x1) -> [..., C]; one gather for the four taps."""
    idx = torch.stack([rows0 * width + x0, rows0 * width + x1,
                       rows1 * width + x0, rows1 * width + x1])
    c = gather_rows(table, idx)
    tx, ty = tx[..., None], ty[..., None]
    top = c[0] * (1 - tx) + c[1] * tx
    bot = c[2] * (1 - tx) + c[3] * tx
    return top * (1 - ty) + bot * ty


def _sample_cube(cubemap, face, gx, gy):
    R, C = cubemap.shape[1], cubemap.shape[-1]
    fx = (gx + 1.0) * 0.5 * R - 0.5
    fy = (gy + 1.0) * 0.5 * R - 0.5
    x0, x1, y0, y1, tx, ty = _taps(fx, fy, R, R)
    return _bilinear(cubemap.reshape(6 * R * R, C), face * R + y0, face * R + y1,
                     x0, x1, tx, ty, R)


def sample_cubemap(cubemap: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear cubemap lookup. cubemap [6, R, R, C], dirs [..., 3] -> [..., C]."""
    return _sample_cube(cubemap, *dir_to_cube_uv(dirs))


def _mip_mix(samples, mip_level, n):
    """Trilinear blend of per-level samples [n, ..., C] at fractional levels."""
    lvl = torch.clamp(mip_level, 0.0, n - 1.0)
    l0 = torch.clamp(torch.floor(lvl).long(), 0, n - 1)
    l1 = torch.clamp(l0 + 1, 0, n - 1)
    frac = (lvl - l0.float())[..., None]

    def pick(lv):   # a masked sum over the levels, as the JAX planar form
        return sum((lv == k).float()[..., None] * samples[k] for k in range(n))

    return pick(l0) * (1 - frac) + pick(l1) * frac


def sample_cubemap_mips(mips: list, dirs: torch.Tensor, mip_level: torch.Tensor) -> torch.Tensor:
    """Trilinear (linear-mipmap-linear) lookup across a mip chain.

    Parity: dr.texture(..., filter_mode="linear-mipmap-linear") in
    pbr_shading (pbr/shade.py:170-180)."""
    samples = torch.stack([sample_cubemap(m, dirs) for m in mips], dim=0)
    return _mip_mix(samples, mip_level, len(mips))


def sample_cubemap_planar(cubemap: torch.Tensor, x, y, z) -> tuple:
    """Bilinear cubemap lookup on direction planes: [6, R, R, C] x three
    [H, W] planes -> a tuple of C [H, W] planes (the math of sample_cubemap)."""
    return tuple(_sample_cube(cubemap, *dir_to_cube_uv_planar(x, y, z)).unbind(-1))


def sample_cubemap_mips_planar(mips, x, y, z, mip_level: torch.Tensor) -> tuple:
    """Trilinear mip-chain lookup on planes -> tuple of C [H, W] planes."""
    face, gx, gy = dir_to_cube_uv_planar(x, y, z)
    samples = torch.stack([_sample_cube(m, face, gx, gy) for m in mips], dim=0)
    return tuple(_mip_mix(samples, mip_level, len(mips)).unbind(-1))


def _sample_2d(tex, u, v):
    Ht, Wt, C = tex.shape
    x0, x1, y0, y1, tx, ty = _taps(u * Wt - 0.5, v * Ht - 0.5, Wt, Ht)
    return _bilinear(tex.reshape(Ht * Wt, C), y0, y1, x0, x1, tx, ty, Wt)


def sample_2d(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear 2D lookup with clamp boundary. tex [H, W, C], uv [..., 2] in
    [0, 1] (u -> W, v -> H). Parity: dr.texture(boundary_mode="clamp")."""
    return _sample_2d(tex, uv[..., 0], uv[..., 1])


def sample_2d_planar(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> tuple:
    """Bilinear 2D lookup on planes: tex [H', W', C], u / v [H, W] ->
    tuple of C [H, W] planes (the math of sample_2d)."""
    return tuple(_sample_2d(tex, u, v).unbind(-1))


def latlong_dirs(height: int, width: int, device=None) -> torch.Tensor:
    """Lat-long pixel directions [H, W, 3].

    Parity: export_envmap (pbr/light.py:124-135): theta = v*pi over [0,1],
    phi = u*pi over [-1,1]; dir = (sin t sin p, cos t, -sin t cos p)."""
    gy = torch.linspace(0.0, 1.0, height, device=device)[:, None]
    gx = torch.linspace(-1.0, 1.0, width, device=device)[None, :]
    sin_t, cos_t = torch.sin(gy * torch.pi), torch.cos(gy * torch.pi)
    sin_p, cos_p = torch.sin(gx * torch.pi), torch.cos(gx * torch.pi)
    return torch.stack([(sin_t * sin_p).expand(height, width),
                        cos_t.expand(height, width),
                        (-sin_t * cos_p).expand(height, width)], dim=-1)


def cubemap_to_latlong(cubemap: torch.Tensor, height: int, width: int) -> torch.Tensor:
    return sample_cubemap(cubemap, latlong_dirs(height, width, cubemap.device))


def latlong_to_cubemap(latlong: torch.Tensor, res: int) -> torch.Tensor:
    """Inverse mapping for loading novel HDR lights (render.py:74-94 path)."""
    dirs = face_directions(res, latlong.device)                    # [6, R, R, 3]
    y = torch.clamp(dirs[..., 1], -1.0, 1.0)
    theta = torch.arccos(y) / torch.pi                              # [0, 1] -> v
    phi = torch.arctan2(dirs[..., 0], -dirs[..., 2]) / torch.pi     # [-1, 1] -> u
    return _sample_2d(latlong, (phi + 1.0) * 0.5, theta)


def avg_pool_cubemap(cubemap: torch.Tensor) -> torch.Tensor:
    """2x2 average-pool mip reduction [6,R,R,C] -> [6,R/2,R/2,C].

    Parity: cubemap_mip.forward (pbr/light.py:30-36)."""
    f, R, _, C = cubemap.shape
    return cubemap.reshape(f, R // 2, 2, R // 2, 2, C).mean(dim=(2, 4))
