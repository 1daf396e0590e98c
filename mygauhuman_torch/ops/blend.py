"""Per-tile front-to-back alpha blending: the masked-cumprod spec.

Port of ops/blend.py. This is the CPU path of `rasterize` and the yardstick
for kernel C (`ops/pallas_blend.py`); autograd differentiates it.

  alpha_i   = min(0.99, op_i * exp(power_i)),  power_i <= 0, alpha_i >= 1/255
  T_i       = prod_{j<i, valid_j} (1 - alpha_j)           (exclusive)
  include_i = valid_i AND T_i * (1 - alpha_i) >= 1e-4
  w_i       = include_i * alpha_i * T_i
  color     = sum_i w_i feat_i + T_final * bg  (T_final = prod over included)
  depth     = sum_i w_i depth_i,  alpha = sum_i w_i

T is monotone, so the include test on the full cumprod equals the CUDA
reference's sequential sticky `done` decision.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class BlendOutput(NamedTuple):
    image: torch.Tensor    # [H, W, C]
    alpha: torch.Tensor    # [H, W]
    depth: torch.Tensor    # [H, W]
    final_t: torch.Tensor  # [H, W]


def tile_pixels(tiles: torch.Tensor, tiles_x: int, tile_w: int, tile_h: int):
    """Pixel coordinates [B, P] (row-major inside each tile) of global tiles."""
    p = torch.arange(tile_w * tile_h, device=tiles.device)
    px = ((tiles % tiles_x) * tile_w)[:, None] + (p % tile_w)[None, :]
    py = (torch.div(tiles, tiles_x, rounding_mode="floor") * tile_h)[:, None] \
        + torch.div(p, tile_w, rounding_mode="floor")[None, :]
    return px.float(), py.float()


class Transmittance(NamedTuple):
    """Per (tile, instance, pixel) terms [B, K, P] of the blend, and the
    final T [B, P]."""
    a: torch.Tensor         # alpha where valid, else 0
    ok: torch.Tensor        # valid: in the list, power <= 0, alpha >= 1/255
    t_before: torch.Tensor  # T before the instance over every valid alpha
    t_after: torch.Tensor   # T after it
    include: torch.Tensor
    final_t: torch.Tensor   # [B, P] T over the included instances


def transmittance(x, y, cxx, cxy, cyy, op, valid, px, py) -> Transmittance:
    """Alpha and T of B tiles of K depth-ordered instances over their P
    pixels (x..op, valid: [B, K]; px, py: [B, P])."""
    dx = x[..., None] - px[:, None, :]          # [B, K, P]
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
    return Transmittance(a, ok, t_before, t_after, include, final_t)


def composite(x, y, cxx, cxy, cyy, op, dep, feat, valid, px, py):
    """Blend B tiles of K depth-ordered instances each over their P pixels.

    x..dep, valid: [B, K]; feat: [B, K, C]; px, py: [B, P].
    Returns (color [B, P, C], w_sum [B, P], d_sum [B, P], final_t [B, P]),
    without the background term, and the [B, K, P] masks of the pairs a
    sequential per-pixel loop evaluates (T before the instance >= 1e-4)
    and includes."""
    tr = transmittance(x, y, cxx, cxy, cyy, op, valid, px, py)
    w = torch.where(tr.include, tr.a * tr.t_before, torch.zeros_like(tr.a))   # [B, K, P]

    color = torch.einsum("bkp,bkc->bpc", w, feat)
    d_sum = torch.einsum("bkp,bk->bp", w, dep)
    w_sum = w.sum(dim=1)
    evaluated = valid[..., None] & (tr.t_before >= 1e-4)
    return color, w_sum, d_sum, tr.final_t, evaluated, tr.include


def blend(
    tile_idx: torch.Tensor,
    tile_valid: torch.Tensor,
    means2d: torch.Tensor,
    conics: torch.Tensor,
    opacities: torch.Tensor,
    features: torch.Tensor,
    depths: torch.Tensor,
    bg: torch.Tensor,
    *,
    width: int,
    height: int,
    tile_w: int = 16,
    tile_h: int = 16,
    chunk_tiles: int = 64,
    images: int | None = None,
) -> BlendOutput:
    """Blend all tiles ([T, K] id lists) and assemble the image, chunk_tiles
    tiles at a time so the [B, K, P] tensors stay bounded. With `images`,
    tile_idx holds that many images' lists one after another ([images T,
    K]), each image is blended in the chunks of one image, and every output
    gains a leading [images] dimension."""
    tw = -(-width // tile_w)
    th = -(-height // tile_h)
    T = tw * th
    n = 1 if images is None else images
    if tile_idx.shape[0] != n * T:
        raise ValueError(f"tile_idx has {tile_idx.shape[0]} tiles, {n} images have {n * T}")
    C = features.shape[-1]
    means2d, conics, opacities, features, depths, bg = (
        t.float() for t in (means2d, conics, opacities, features, depths, bg))

    parts = []
    for base in range(0, n * T, T):
        for t0 in range(0, T, chunk_tiles):
            tiles = torch.arange(t0, min(t0 + chunk_tiles, T), device=means2d.device)
            rows = slice(base + t0, base + min(t0 + chunk_tiles, T))
            idx = tile_idx[rows].long()
            px, py = tile_pixels(tiles, tw, tile_w, tile_h)
            color, w_sum, d_sum, final_t, _, _ = composite(
                means2d[idx, 0], means2d[idx, 1], conics[idx, 0], conics[idx, 1],
                conics[idx, 2], opacities[idx], depths[idx], features[idx],
                tile_valid[rows], px, py)
            color = color + final_t[..., None] * bg
            parts.append(torch.cat([color, w_sum[..., None], d_sum[..., None],
                                    final_t[..., None]], dim=-1))
    # [n T, P, C + 3] -> [n, H, W, C + 3]
    x = torch.cat(parts).reshape(n, th, tw, tile_h, tile_w, C + 3)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, th * tile_h, tw * tile_w, C + 3)
    x = x[:, :height, :width]
    if images is None:
        x = x[0]
    return BlendOutput(image=x[..., :C], alpha=x[..., C], depth=x[..., C + 1],
                       final_t=x[..., C + 2])
