"""Projection and tile binning of the plain reference: frozen copies of
`mygauhuman_torch/ops/projection.py` (EWA splatting with the 0.3 low-pass,
the conic, the ceil(3 sqrt(lambda_max)) radius, the z > 0.2 near cull) and
`ops/binning.py` (depth-sorted per-tile lists with the rasterizer
configuration's caps: S tiles per Gaussian, the global instance capacity
I, K instances per tile). The caps are part of the configuration the
program states (its `RasterizerConfig`), so the reference applies the
same ones; every truncation is counted.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.utils.checkpoint


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
    W = w2c[:3, :3]
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
    in_front = p_view_z > 0.2

    p_ndc = project_points(means3d, full_proj)
    means2d = torch.stack(
        [ndc2pix(p_ndc[..., 0], image_width), ndc2pix(p_ndc[..., 1], image_height)],
        dim=-1,
    )

    cov2d = compute_cov2d(means3d, cov3d6, w2c, focal_x, focal_y, tan_fovx, tan_fovy)
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


class TileLists(NamedTuple):
    idx: torch.Tensor            # [T, K] int32 Gaussian ids, front-to-back
    valid: torch.Tensor          # [T, K] bool
    counts: torch.Tensor         # [T] int32 instances per tile
    overflow_tiles: torch.Tensor  # int32: instances dropped by K truncation
    overflow_gauss: torch.Tensor  # int32: instances dropped by S truncation
    overflow_inst: torch.Tensor   # int32: instances dropped by I compaction
    sorted_gid: torch.Tensor     # [I] int32 tile-major depth-sorted ids
    sorted_tile: torch.Tensor    # [I] int32 tile of each sorted instance (T = dead)
    starts: torch.Tensor         # [T] int32 offset of each tile's slice
    sorted_rank: torch.Tensor    # [I] int32 depth rank of each sorted instance
    order: torch.Tensor          # [N] int32 rank -> Gaussian id
    rank: torch.Tensor           # [N] int32 Gaussian id -> depth rank


def tile_dims(width: int, height: int, tile_w: int, tile_h: int) -> tuple[int, int]:
    return -(-width // tile_w), -(-height // tile_h)


def gaussian_tile_rects(means2d, radii, tw, th, tile_w, tile_h):
    """Covered tile rect [min_x, min_y, max_x, max_y) per Gaussian."""
    r = radii.float()
    x, y = means2d[..., 0], means2d[..., 1]
    min_x = torch.clamp(torch.floor((x - r) / tile_w), 0, tw).to(torch.int32)
    min_y = torch.clamp(torch.floor((y - r) / tile_h), 0, th).to(torch.int32)
    max_x = torch.clamp(torch.floor((x + r + tile_w - 1) / tile_w), 0, tw).to(torch.int32)
    max_y = torch.clamp(torch.floor((y + r + tile_h - 1) / tile_h), 0, th).to(torch.int32)
    return min_x, min_y, max_x, max_y


def slot_counts(flat_tile: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """[T] int32 number of slots per tile, dead slots (tile T) dropped: a
    fixed [T + 1] buffer of integer ones added at each slot's tile. Unlike
    `torch.bincount`, whose CUDA version reads the input's max back to size
    its output, nothing here waits on the device, so a CUDA graph can
    capture it."""
    counts = torch.zeros(n_tiles + 1, dtype=torch.int32, device=flat_tile.device)
    ones = torch.ones(flat_tile.shape, dtype=torch.int32, device=flat_tile.device)
    return counts.index_add_(0, flat_tile.long(), ones)[:n_tiles]


def bin_gaussians(
    means2d: torch.Tensor,
    radii: torch.Tensor,
    depths: torch.Tensor,
    visible: torch.Tensor,
    *,
    width: int,
    height: int,
    tile_w: int = 16,
    tile_h: int = 16,
    max_tiles_per_gaussian: int = 16,
    tile_capacity: int = 1024,
    instance_capacity: int | None = None,
) -> TileLists:
    """Build depth-sorted per-tile lists (see the module docstring)."""
    dev = means2d.device
    N = means2d.shape[0]
    S = max_tiles_per_gaussian
    K = tile_capacity
    tw, th = tile_dims(width, height, tile_w, tile_h)
    T = tw * th
    i32 = torch.int32

    min_x, min_y, max_x, max_y = gaussian_tile_rects(means2d, radii, tw, th, tile_w, tile_h)
    rw = max_x - min_x
    rh = max_y - min_y
    touched = rw * rh
    live = visible & (radii > 0) & (touched > 0)
    overflow_gauss = torch.where(live, torch.clamp(touched - S, min=0),
                                 torch.zeros_like(touched)).sum().to(i32)

    # slot s of Gaussian n -> tile (min_x + s % rw, min_y + s // rw), [S, N]
    s = torch.arange(S, dtype=i32, device=dev)[:, None]
    rw_safe = torch.clamp(rw, min=1)[None, :]
    dx = s % rw_safe
    dy = torch.div(s, rw_safe, rounding_mode="floor")
    slot_ok = live[None, :] & (s < torch.clamp(touched, max=S)[None, :])
    tile_id = (min_y[None, :] + dy) * tw + (min_x[None, :] + dx)
    flat_tile = torch.where(slot_ok, tile_id, torch.full_like(tile_id, T)).reshape(-1)

    # per-tile counts are exact integer counts of the emitted slots (integer
    # sums are exact in any order); starts are their exclusive prefix sum
    counts = slot_counts(flat_tile, T)
    bounds = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                        torch.cumsum(counts, dim=0, dtype=i32)])
    starts = bounds[:T]
    ends = bounds[1:]
    total_live = bounds[T]

    rank_radix = 1
    while rank_radix < N:
        rank_radix *= 2
    # int32 key when (tile, rank) fits, as the JAX key; int64 otherwise (same
    # order, so no second code path is needed)
    key_dtype = i32 if (T + 1) * rank_radix < 2 ** 31 else torch.int64
    order = torch.argsort(depths.float(), stable=True).to(i32)
    rank = torch.empty_like(order)
    rank[order.long()] = torch.arange(N, dtype=i32, device=dev)
    flat_rank = rank[None, :].expand(S, N).reshape(-1)
    key = flat_tile.to(key_dtype) * rank_radix + flat_rank.to(key_dtype)
    sorted_key = torch.sort(key).values
    I = N * S
    overflow_inst = torch.zeros((), dtype=i32, device=dev)
    if instance_capacity is not None and instance_capacity < N * S:
        # dead slots (tile = T) sort to the end, so the live instances are
        # the sorted prefix; the deepest global tail is what a small I drops
        I = instance_capacity
        overflow_inst = torch.clamp(total_live - I, min=0)
        sorted_key = sorted_key[:I]
        starts = torch.clamp(starts, max=I)
        ends = torch.clamp(ends, max=I)
    sorted_tile = torch.div(sorted_key, rank_radix, rounding_mode="floor").to(i32)
    sorted_rank = (sorted_key % rank_radix).to(i32)
    sorted_gid = order[sorted_rank.long()]
    counts = ends - starts

    k = torch.arange(K, dtype=i32, device=dev)[None, :]
    pos = torch.clamp(starts[:, None] + k, 0, I - 1)
    idx = sorted_gid[pos.long()]
    valid = k < counts[:, None]
    overflow_tiles = torch.clamp(counts - K, min=0).sum().to(i32)

    return TileLists(
        idx=idx,
        valid=valid,
        counts=counts,
        overflow_tiles=overflow_tiles,
        overflow_gauss=overflow_gauss,
        overflow_inst=overflow_inst.to(i32),
        sorted_gid=sorted_gid,
        sorted_tile=sorted_tile,
        starts=starts,
        sorted_rank=sorted_rank,
        order=order,
        rank=rank,
    )


# ---- the blend (a frozen copy of ops/blend.py's masked-cumprod spec) -------

class BlendOutput(NamedTuple):
    image: torch.Tensor    # [H, W, C]
    alpha: torch.Tensor    # [H, W]
    depth: torch.Tensor    # [H, W]
    work: dict             # what the inputs need: pairs evaluated / included,
                           # instances read, busy tiles, 32-instance chunks


def tile_pixels(tiles, tiles_x: int, tile_w: int, tile_h: int):
    p = torch.arange(tile_w * tile_h, device=tiles.device)
    px = ((tiles % tiles_x) * tile_w)[:, None] + (p % tile_w)[None, :]
    py = (torch.div(tiles, tiles_x, rounding_mode="floor") * tile_h)[:, None] \
        + torch.div(p, tile_w, rounding_mode="floor")[None, :]
    return px.float(), py.float()


def composite(x, y, cxx, cxy, cyy, op, dep, feat, valid, px, py):
    """B tiles of K depth-ordered instances over their P pixels:
      alpha = min(0.99, op exp(power)), kept where power <= 0 and
      alpha >= 1/255; T the exclusive product of (1 - alpha); an instance
      is included while T (1 - alpha) >= 1e-4, and every later one is
      not (T is monotone)."""
    dx = x[..., None] - px[:, None, :]
    dy = y[..., None] - py[:, None, :]
    power = (-0.5 * (cxx[..., None] * dx * dx + cyy[..., None] * dy * dy)
             - cxy[..., None] * dx * dy)
    alpha = torch.clamp(op[..., None] * torch.exp(power), max=0.99)
    ok = valid[..., None] & (power <= 0.0) & (alpha >= (1.0 / 255.0))
    a = torch.where(ok, alpha, torch.zeros_like(alpha))
    l1ma = torch.log1p(-a)
    cum = torch.cumsum(l1ma, dim=1)
    t_after = torch.exp(cum)
    t_before = torch.exp(cum - l1ma)
    include = ok & (t_after >= 1e-4)
    final_t = torch.exp(torch.where(include, l1ma, torch.zeros_like(l1ma)).sum(dim=1))
    w = torch.where(include, a * t_before, torch.zeros_like(a))
    color = torch.einsum("bkp,bkc->bpc", w, feat)
    d_sum = torch.einsum("bkp,bk->bp", w, dep)
    evaluated = valid[..., None] & (t_before >= 1e-4)
    return color, w.sum(dim=1), d_sum, final_t, evaluated, include


def blend(bins: TileLists, means2d, conics, opacities, features, depths, bg, *,
          width: int, height: int, tile_w: int = 16, tile_h: int = 16,
          chunk_tiles: int = 64) -> BlendOutput:
    """Blend every tile's list and assemble the image, `chunk_tiles` tiles
    at a time, each chunk's lists cut to its longest."""
    tw, th = tile_dims(width, height, tile_w, tile_h)
    T = tw * th
    C = features.shape[-1]
    counts = torch.clamp(bins.counts, max=bins.idx.shape[1])
    longest = [int(v) for v in torch.stack([counts[t0:t0 + chunk_tiles].max()
                                            for t0 in range(0, T, chunk_tiles)]).cpu()]
    parts = []
    n_eval = n_incl = n_read = 0
    for ci, t0 in enumerate(range(0, T, chunk_tiles)):
        k = max(longest[ci], 1)
        tiles = torch.arange(t0, min(t0 + chunk_tiles, T), device=means2d.device)
        idx = bins.idx[t0:t0 + chunk_tiles, :k].long()
        valid = bins.valid[t0:t0 + chunk_tiles, :k]
        px, py = tile_pixels(tiles, tw, tile_w, tile_h)
        args = (means2d[idx, 0], means2d[idx, 1], conics[idx, 0], conics[idx, 1],
                conics[idx, 2], opacities[idx], depths[idx], features[idx], valid, px, py)
        if torch.is_grad_enabled():
            # recomputed in the backward: a chunk's [B, K, P] terms are not kept
            color, w_sum, d_sum, final_t, ev, inc = torch.utils.checkpoint.checkpoint(
                composite, *args, use_reentrant=False)
        else:
            color, w_sum, d_sum, final_t, ev, inc = composite(*args)
        n_eval += int(ev.sum())
        n_incl += int(inc.sum())
        n_read += int(ev.any(dim=2).sum())
        color = color + final_t[..., None] * bg
        parts.append(torch.cat([color, w_sum[..., None], d_sum[..., None]], dim=-1))
    x = torch.cat(parts).reshape(th, tw, tile_h, tile_w, C + 2)
    x = x.permute(0, 2, 1, 3, 4).reshape(th * tile_h, tw * tile_w, C + 2)[:height, :width]
    work = {"pairs_evaluated": n_eval, "pairs_included": n_incl, "instances_read": n_read,
            "busy_tiles": int((counts > 0).sum()), "tiles": T,
            "chunks": int(((counts + 31) // 32).sum()), "channels": C,
            "tile_pixels": tile_w * tile_h, "pixels": width * height,
            "overflow": int(bins.overflow_tiles + bins.overflow_gauss + bins.overflow_inst)}
    return BlendOutput(image=x[..., :C], alpha=x[..., C], depth=x[..., C + 1], work=work)
