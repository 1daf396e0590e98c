"""Blend over the depth-sorted instance list: kernel C, and the autograd
wrapper whose backward is kernel D.

Port of ops/pallas_blend.py. Binning's depth-sorted
(tile, Gaussian) list is gathered once into the instance matrix
[8 + ceil8(C), NS]:

  0 x | 1 y | 2 cxx | 3 cxy | 4 cyy | 5 opacity | 6 depth | 7 ones | 8.. feat

and each tile's instances are a contiguous column slice [start, start +
count). `blend_rows_raw` (planar [C+3, H, W] output) and `blend_tiles_raw`
(tile-major [T, C+3, P] output) run the CUDA kernel (`csrc/blend_fwd.cu`)
on CUDA tensors and `blend_instances_plain`, the masked-cumprod spec over
the same slices, on CPU tensors. Output rows: C colours, sum w, sum w depth,
final T; `finish_planar` / `finish_tiles` add the background.

`blend_pallas` differentiates with respect to the per-Gaussian inputs: its
backward runs kernel D (`ops/pallas_blend_bwd.py`) for per-instance gradient
rows and sums them per Gaussian itself, in a fixed order, so autograd never
differentiates the instance gather (whose CUDA backward would use atomics).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mygauhuman_torch.ops import cuda_lib
from mygauhuman_torch.ops.blend import BlendOutput, composite, tile_pixels

HDR = 8            # header rows before the feature rows
MAX_CHANNELS = 32  # kernels C and D's register accumulator width
SMEM_LIMIT = 48 * 1024


class InstanceData(NamedTuple):
    data: torch.Tensor    # [8 + ceil8(C), NS] f32
    starts: torch.Tensor  # [T] i32 column offset of each tile's slice
    counts: torch.Tensor  # [T] i32 instances per tile


def attr_matrix(means2d, conics, opacities, depths, features) -> torch.Tensor:
    """Component-major per-Gaussian attribute matrix [8 + ceil8(C), N]."""
    n, c = features.shape
    c_pad = -(-c // 8) * 8 - c
    return torch.cat(
        [
            means2d.T,
            conics.T,
            opacities[None, :],
            depths[None, :],
            torch.ones((1, n), dtype=torch.float32, device=means2d.device),
            features.T,
            torch.zeros((c_pad, n), dtype=torch.float32, device=means2d.device),
        ],
        dim=0,
    )


def build_instance_data(sorted_idx, starts, counts, means2d, conics, opacities,
                        depths, features, order=None) -> InstanceData:
    """Gather the per-instance columns once. With `order` (rank -> id),
    `sorted_idx` is in rank space: the table is permuted to rank order
    first, then gathered by rank."""
    attrs = attr_matrix(means2d.float(), conics.float(), opacities.float(),
                        depths.float(), features.float())
    if order is not None:
        attrs = attrs[:, order.long()]
    data = attrs[:, sorted_idx.long()].contiguous()
    return InstanceData(data=data, starts=starts, counts=counts)


def row_mode_supported(n_tiles: int, tiles_x: int, tile_w: int, tile_h: int) -> int:
    """The JAX row kernel's tiles_per_step (0 if unsupported). Kept so the
    planar and tile-major layouts are chosen exactly as on the TPU."""
    if n_tiles % tiles_x:
        return 0
    for tb in (1, 2, 4, 8, 16, 32, 64, 128):
        if tiles_x % tb == 0 and (tb * tile_w) % 128 == 0:
            return tb
    if (tiles_x * tile_w) % 128 == 0:
        return tiles_x
    return 0


def _blend_instances_plain(data, starts, counts, tile_base, *, n_tiles, tiles_x,
                           n_channels, tile_w, tile_h, chunk_tiles=64):
    """Tile-major [T, C+3, P] plain version, plus the work these inputs
    need: the (pixel, instance) pairs a sequential per-pixel loop evaluates
    before each pixel stops, the pairs it includes, and the instances that
    must be read (each tile's prefix up to the last one any pixel
    evaluates)."""
    P = tile_w * tile_h
    C = n_channels
    ns = data.shape[1]
    dev = data.device
    out = torch.empty((n_tiles, C + 3, P), dtype=torch.float32, device=dev)
    n_eval = 0
    n_incl = 0
    n_read = 0
    for t0 in range(0, n_tiles, chunk_tiles):
        t1 = min(t0 + chunk_tiles, n_tiles)
        cnt = counts[t0:t1].long()
        kmax = max(int(cnt.max()), 1) if t1 > t0 else 1
        k = torch.arange(kmax, device=dev)
        pos = torch.clamp(starts[t0:t1].long()[:, None] + k[None, :], 0, max(ns - 1, 0))
        valid = k[None, :] < cnt[:, None]
        cols = data[:, pos]                                # [D, B, K]
        px, py = tile_pixels(torch.arange(t0, t1, device=dev) + tile_base,
                             tiles_x, tile_w, tile_h)
        color, w_sum, d_sum, final_t, evaluated, include = composite(
            cols[0], cols[1], cols[2], cols[3], cols[4], cols[5], cols[6],
            cols[HDR:HDR + C].permute(1, 2, 0), valid, px, py)
        out[t0:t1] = torch.cat([color.permute(0, 2, 1), w_sum[:, None],
                                d_sum[:, None], final_t[:, None]], dim=1)
        n_eval += int(evaluated.sum())
        n_incl += int(include.sum())
        # a pixel evaluates a prefix of its slice (T only falls), so the
        # instances any pixel evaluates are a prefix too
        n_read += int(evaluated.any(dim=2).sum())
    return out, n_eval, n_incl, n_read


def blend_instances_plain(data, starts, counts, tile_base, *, n_tiles, tiles_x,
                          n_channels, tile_w=16, tile_h=16, planar=False):
    """Plain PyTorch version of kernel C: tile-major [T, C+3, P] or, with
    planar=True, [C+3, (T / tiles_x) tile_h, tiles_x tile_w]."""
    out, _, _, _ = _blend_instances_plain(
        data, starts, counts, tile_base, n_tiles=n_tiles, tiles_x=tiles_x,
        n_channels=n_channels, tile_w=tile_w, tile_h=tile_h)
    if not planar:
        return out
    n_rows = n_tiles // tiles_x
    x = out.reshape(n_rows, tiles_x, n_channels + 3, tile_h, tile_w)
    return x.permute(2, 0, 3, 1, 4).reshape(n_channels + 3, n_rows * tile_h,
                                            tiles_x * tile_w)


def blend_instances_cuda(data, starts, counts, tile_base, *, n_tiles, tiles_x,
                         n_channels, tile_w=16, tile_h=16, planar=False):
    """Launch kernel C; same outputs as blend_instances_plain."""
    P = tile_w * tile_h
    C = n_channels
    if not data.is_cuda or data.dtype != torch.float32 or data.dim() != 2:
        raise ValueError("kernel C takes a float32 CUDA instance matrix [D, NS]")
    if data.shape[0] < HDR + C:
        raise ValueError(f"instance matrix has {data.shape[0]} rows, needs {HDR + C}")
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"kernel C takes 1..{MAX_CHANNELS} channels, got {C}")
    if (7 + C) * P * 4 > SMEM_LIMIT:
        raise ValueError(f"tile {tile_w}x{tile_h} with {C} channels exceeds "
                         "kernel C's shared memory")
    for name, t in (("starts", starts), ("counts", counts)):
        if t.shape != (n_tiles,) or t.device != data.device:
            raise ValueError(f"{name} must be [{n_tiles}] on {data.device}")
    if planar and n_tiles % tiles_x:
        raise ValueError("planar output needs whole tile rows")
    data = data.contiguous()
    starts = starts.to(torch.int32).contiguous()
    counts = counts.to(torch.int32).contiguous()
    n_rows = n_tiles // tiles_x
    if planar:
        out_h, out_w = n_rows * tile_h, tiles_x * tile_w
        out = torch.empty((C + 3, out_h, out_w), dtype=torch.float32, device=data.device)
    else:
        out_h = out_w = 0
        out = torch.empty((n_tiles, C + 3, P), dtype=torch.float32, device=data.device)
    fn = cuda_lib.library("blend_fwd").blend_fwd
    err = fn(data.data_ptr(), data.shape[1], starts.data_ptr(), counts.data_ptr(),
             n_tiles, int(tile_base), tiles_x, C, tile_w, tile_h, int(planar),
             out_h, out_w, out.data_ptr(),
             torch.cuda.current_stream(data.device).cuda_stream)
    cuda_lib.check("blend_fwd", err)
    cuda_lib.LAUNCHES["blend_fwd"] += 1
    return out


def _blend_raw(data, starts, counts, tile_base, planar, **kw):
    if data.is_cuda:
        return blend_instances_cuda(data, starts, counts, tile_base, planar=planar, **kw)
    return blend_instances_plain(data, starts, counts, tile_base, planar=planar, **kw)


def blend_rows_raw(data, starts, counts, tile_base=0, *, n_tiles, tiles_x,
                   n_channels, tile_w=16, tile_h=16):
    """Planar [C+3, (n_tiles / tiles_x) tile_h, tiles_x tile_w] blend."""
    return _blend_raw(data, starts, counts, tile_base, True, n_tiles=n_tiles,
                      tiles_x=tiles_x, n_channels=n_channels, tile_w=tile_w,
                      tile_h=tile_h)


def blend_tiles_raw(data, starts, counts, tile_base=0, *, n_tiles, tiles_x,
                    n_channels, tile_w=16, tile_h=16):
    """Tile-major [n_tiles, C+3, P] blend of tiles [tile_base, tile_base +
    n_tiles) of a tiles_x-wide grid."""
    return _blend_raw(data, starts, counts, tile_base, False, n_tiles=n_tiles,
                      tiles_x=tiles_x, n_channels=n_channels, tile_w=tile_w,
                      tile_h=tile_h)


def finish_planar(planar, bg, *, n_channels, width, height):
    """Background-compose and crop the planar output -> (image [H, W, C],
    alpha, depth, final_t)."""
    planar = planar[:, :height, :width]
    final_t = planar[n_channels + 2]
    color = planar[:n_channels] + final_t[None] * bg[:, None, None]
    return color.permute(1, 2, 0), planar[n_channels], planar[n_channels + 1], final_t


def finish_tiles(tiles_out, bg, *, n_channels, width, height, tile_w, tile_h):
    """Background-compose the tile-major output and assemble [H, W, ...]."""
    tw = -(-width // tile_w)
    th = -(-height // tile_h)
    final_t = tiles_out[:, n_channels + 2, :]
    color = tiles_out[:, :n_channels, :] + final_t[:, None, :] * bg[None, :, None]
    x = torch.cat([color, tiles_out[:, n_channels:]], dim=1)   # [T, C+3, P]
    x = x.reshape(th, tw, n_channels + 3, tile_h, tile_w)
    x = x.permute(0, 3, 1, 4, 2).reshape(th * tile_h, tw * tile_w, n_channels + 3)
    x = x[:height, :width]
    return x[..., :n_channels], x[..., n_channels], x[..., n_channels + 1], x[..., n_channels + 2]


def blend_pallas_raw(inst: InstanceData, bg, *, width, height, n_channels,
                     tile_w=16, tile_h=16):
    """(image [H, W, C], alpha, depth, final_t) through the planar layout
    where the TPU row kernel would run, the tile-major one elsewhere."""
    tw = -(-width // tile_w)
    th = -(-height // tile_h)
    T = tw * th
    if row_mode_supported(T, tw, tile_w, tile_h):
        planar = blend_rows_raw(inst.data, inst.starts, inst.counts, 0, n_tiles=T,
                                tiles_x=tw, n_channels=n_channels,
                                tile_w=tile_w, tile_h=tile_h)
        return finish_planar(planar, bg, n_channels=n_channels, width=width,
                             height=height)
    tiles_out = blend_tiles_raw(inst.data, inst.starts, inst.counts, 0, n_tiles=T,
                                tiles_x=tw, n_channels=n_channels,
                                tile_w=tile_w, tile_h=tile_h)
    return finish_tiles(tiles_out, bg, n_channels=n_channels, width=width,
                        height=height, tile_w=tile_w, tile_h=tile_h)


def _tile_major(x, th, tw, tile_h, tile_w):
    """[H, W, C] -> [T, P, C] (the inverse of finish_tiles' assembly)."""
    H, W = x.shape[:2]
    x = torch.nn.functional.pad(x, (0, 0, 0, tw * tile_w - W, 0, th * tile_h - H))
    x = x.reshape(th, tile_h, tw, tile_w, x.shape[-1])
    return x.permute(0, 2, 1, 3, 4).reshape(th * tw, tile_h * tile_w, -1)


def per_gaussian_rows(rows, sorted_rank, rank, n, max_tiles_per_gaussian):
    """Sum per-instance rows [NS, G] per Gaussian -> [n, G] in id order.

    Instances are grouped by depth rank with a stable sort; a Gaussian has
    at most max_tiles_per_gaussian instances (binning emits that many slots
    per Gaussian), so its rows land in a dense [n, S, G] block and are
    summed over S in a fixed order. No atomics: the same bits on every run."""
    S = max_tiles_per_gaussian
    ns, g = rows.shape
    key, perm = torch.sort(sorted_rank.long(), stable=True)
    slot = torch.arange(ns, device=rows.device) - torch.searchsorted(key, key)
    dense = rows.new_zeros((n * S, g))
    dense[key * S + slot] = rows[perm]
    return dense.view(n, S, g).sum(dim=1)[rank.long()]


class _BlendPallas(torch.autograd.Function):
    """Forward: kernel C. Backward: the background terms, kernel D over the
    tile-major cotangents, then the per-Gaussian reduction."""

    @staticmethod
    def forward(ctx, sorted_rank, order, rank, starts, counts, means2d, conics,
                opacities, features, depths, bg, width, height, tile_w, tile_h,
                max_tiles_per_gaussian):
        inst = build_instance_data(sorted_rank, starts, counts, means2d, conics,
                                   opacities, depths, features, order=order)
        image, alpha, depth, final_t = blend_pallas_raw(
            inst, bg.float(), width=width, height=height, n_channels=features.shape[-1],
            tile_w=tile_w, tile_h=tile_h)
        ctx.save_for_backward(inst.data, sorted_rank, rank, starts, counts, bg, final_t)
        ctx.geom = (width, height, tile_w, tile_h, max_tiles_per_gaussian,
                    means2d.shape[0], features.shape[-1])
        return image, alpha, depth, final_t

    @staticmethod
    def backward(ctx, g_image, g_alpha, g_depth, g_final_t):
        from mygauhuman_torch.ops.pallas_blend_bwd import blend_pallas_bwd_raw

        data, sorted_rank, rank, starts, counts, bg, final_t = ctx.saved_tensors
        width, height, tile_w, tile_h, S, n, c = ctx.geom
        bg = bg.float()
        # colour = raw + final_t * bg
        dbg = torch.einsum("hw,hwc->c", final_t, g_image)
        g_final_t_eff = g_final_t + torch.einsum("hwc,c->hw", g_image, bg)
        c_pad = data.shape[0] - HDR
        cot = torch.cat([g_image, g_image.new_zeros(g_image.shape[:2] + (c_pad - c,)),
                         g_alpha[..., None], g_depth[..., None], g_final_t_eff[..., None]],
                        dim=-1)
        tw = -(-width // tile_w)
        th = -(-height // tile_h)
        rows = blend_pallas_bwd_raw(data, starts, counts,
                                    _tile_major(cot, th, tw, tile_h, tile_w),
                                    width=width, height=height, tile_w=tile_w,
                                    tile_h=tile_h)
        per_g = per_gaussian_rows(rows, sorted_rank, rank, n, S)
        return (None, None, None, None, None, per_g[:, 0:2], per_g[:, 2:5], per_g[:, 5],
                per_g[:, HDR:HDR + c], per_g[:, 6], dbg, None, None, None, None, None)


def blend_pallas(sorted_rank, order, rank, starts, counts, means2d, conics,
                 opacities, features, depths, bg, *, width, height,
                 tile_w=16, tile_h=16, max_tiles_per_gaussian=16) -> BlendOutput:
    """Differentiable blend from binning's rank-space lists. `counts` must
    already be capped at tile_capacity, and max_tiles_per_gaussian must be
    the binning's. Kernels C and D on CUDA tensors, their plain versions on
    CPU tensors."""
    return BlendOutput(*_BlendPallas.apply(
        sorted_rank, order, rank, starts, counts, means2d, conics, opacities, features,
        depths, bg, width, height, tile_w, tile_h, max_tiles_per_gaussian))
