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

With `checkpoints=True` the same call also returns the `Checkpoints` that
kernel D's backward reads (T before every CHUNK-instance chunk of a tile's
list, each pixel's stop and T_final, the slot map): kernel C writes them in
the same pass on CUDA tensors, `blend_fwd_checkpoints_plain` computes them
on CPU tensors.

`blend_pallas` differentiates with respect to the per-Gaussian inputs: a
differentiated forward keeps the checkpoints, and the backward runs kernel
D's chunk launches from them (`ops/pallas_blend_bwd.py`) for per-instance
gradient rows and sums them per Gaussian itself, in a fixed order, so
autograd never differentiates the instance gather (whose CUDA backward
would use atomics). A forward without grad writes no checkpoints.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mygauhuman_torch.ops import cuda_lib
from mygauhuman_torch.ops.blend import BlendOutput, composite, tile_pixels, transmittance

HDR = 8            # header rows before the feature rows
MAX_CHANNELS = 32  # kernels C and D's register accumulator width
SMEM_LIMIT = 48 * 1024
CHUNK = 32         # instances per checkpoint chunk (csrc/blend_fwd.cu, blend_bwd.cu CH)
PLAIN_TILES = 64   # tiles per step of the chunked plain versions ([64, K, P] terms)


class InstanceData(NamedTuple):
    data: torch.Tensor    # [8 + ceil8(C), NS] f32
    starts: torch.Tensor  # [T] i32 column offset of each tile's slice
    counts: torch.Tensor  # [T] i32 instances per tile


class Checkpoints(NamedTuple):
    """What kernel D's chunk launches read: written by kernel C's
    checkpoint mode (or D1), the chunk sums by D1s. Tile t's chunks c <
    ceil(count_t / chunk) take slots off_t + c, off_t the chunks of the
    tiles before it, out of G = ceil(NS / chunk) + T slots (enough for
    disjoint slices)."""
    t_start: torch.Tensor    # [G, P] T before the chunk (T_final once stopped)
    chunk_sum: torch.Tensor  # [G, P] sum of w q over the chunk's included instances
    stop: torch.Tensor       # [T, P] i32 first failing instance (count if none)
    t_final: torch.Tensor    # [T, P]
    chunk_map: torch.Tensor  # [G, 2] i32 (tile, chunk) of each slot in use
    n_chunks: torch.Tensor   # [1] i32 slots in use


def max_chunks(ns: int, n_tiles: int, chunk: int = CHUNK) -> int:
    return -(-ns // chunk) + n_tiles


def empty_checkpoints(ns, n_tiles, P, device) -> Checkpoints:
    """Uninitialised checkpoint scratch for a kernel to fill."""
    G = max_chunks(ns, n_tiles)
    return Checkpoints(
        t_start=torch.empty((G, P), dtype=torch.float32, device=device),
        chunk_sum=torch.empty((G, P), dtype=torch.float32, device=device),
        stop=torch.empty((n_tiles, P), dtype=torch.int32, device=device),
        t_final=torch.empty((n_tiles, P), dtype=torch.float32, device=device),
        chunk_map=torch.empty((G, 2), dtype=torch.int32, device=device),
        n_chunks=torch.empty((1,), dtype=torch.int32, device=device))


def attr_matrix(means2d, conics, opacities, depths, features, pad=True) -> torch.Tensor:
    """Component-major per-Gaussian attribute matrix [8 + ceil8(C), N]
    (with pad=False, [8 + C, N]: the feature rows kernel C reads)."""
    n, c = features.shape
    c_pad = -(-c // 8) * 8 - c if pad else 0
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


def _images_tiles(tile_base, n_tiles, tiles_per_image, planar=False) -> int:
    """The tiles per image of a launch of tiles [tile_base, tile_base +
    n_tiles): one image's own count where `tiles_per_image` is None; several
    images only as a tile-major launch of whole images from tile 0."""
    if tiles_per_image is None:
        return max(int(tile_base) + n_tiles, 1)
    if int(tile_base) + n_tiles > tiles_per_image and (
            planar or tile_base or n_tiles % tiles_per_image):
        raise ValueError("several images of tiles_per_image tiles take a tile-major launch "
                         "of whole images from tile 0")
    return int(tiles_per_image)


def _blend_instances_plain(data, starts, counts, tile_base, *, n_tiles, tiles_x,
                           n_channels, tile_w, tile_h, chunk_tiles=64, tiles_per_image=None):
    """Tile-major [T, C+3, P] plain version, plus the work these inputs
    need: the (pixel, instance) pairs a sequential per-pixel loop evaluates
    before each pixel stops, the pairs it includes, and the instances that
    must be read (each tile's prefix up to the last one any pixel
    evaluates). `tiles_per_image` as `blend_instances_cuda`'s."""
    per_image = _images_tiles(tile_base, n_tiles, tiles_per_image)
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
        px, py = tile_pixels((torch.arange(t0, t1, device=dev) + tile_base) % per_image,
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


def _chunk_layout(counts, n_tiles, chunk):
    """Chunks per tile, each tile's first slot, and the slots in use."""
    nch = torch.div(counts.long().clamp(min=0) + chunk - 1, chunk, rounding_mode="floor")
    off = torch.cumsum(nch, 0) - nch
    return nch, off, int(nch.sum()) if n_tiles else 0


def _tile_group(data, starts, counts, tile_base, t0, t1, tiles_x, tile_w, tile_h, chunk):
    """Instance columns of tiles [t0, t1), padded to whole chunks."""
    ns = data.shape[1]
    dev = data.device
    cnt = counts[t0:t1].long().clamp(min=0)
    nchk = max(-(-int(cnt.max()) // chunk), 1)
    k = torch.arange(nchk * chunk, device=dev)
    pos = torch.clamp(starts[t0:t1].long()[:, None] + k[None, :], 0, max(ns - 1, 0))
    valid = k[None, :] < cnt[:, None]
    px, py = tile_pixels(torch.arange(t0, t1, device=dev) + tile_base, tiles_x,
                         tile_w, tile_h)
    return data[:, pos], valid, pos, k, nchk, px, py


def _checkpoints_plain(data, starts, counts, tile_base, cot, C, *, n_tiles, tiles_x,
                       tile_w, tile_h, chunk) -> Checkpoints:
    """The checkpoints from kernel C's plain per-pixel T (the log-space
    cumulative product of `ops/blend.py::transmittance`); the chunk sums of
    w q at the cotangents `cot` [T, P, Cf + 3] (feature pad past C zero), or
    zeros where `cot` is None."""
    P = tile_w * tile_h
    cf = data.shape[0] - HDR
    dev = data.device
    G = max_chunks(data.shape[1], n_tiles, chunk)
    nch_all, off_all, total = _chunk_layout(counts, n_tiles, chunk)
    if total > G:
        raise ValueError(f"{total} chunks exceed the {G} slots: tile slices overlap")
    t_start = torch.zeros((G, P), dtype=torch.float32, device=dev)
    chunk_sum = torch.zeros((G, P), dtype=torch.float32, device=dev)
    stop = torch.zeros((n_tiles, P), dtype=torch.int32, device=dev)
    t_final = torch.ones((n_tiles, P), dtype=torch.float32, device=dev)
    chunk_map = torch.full((G, 2), -1, dtype=torch.int32, device=dev)
    tiles = torch.repeat_interleave(torch.arange(n_tiles, device=dev), nch_all)
    chunk_map[:total, 0] = tiles.int()
    chunk_map[:total, 1] = (torch.arange(total, device=dev) - off_all[tiles]).int()
    for t0 in range(0, n_tiles, PLAIN_TILES):
        t1 = min(t0 + PLAIN_TILES, n_tiles)
        cols, valid, _, k, nchk, px, py = _tile_group(
            data, starts, counts, tile_base, t0, t1, tiles_x, tile_w, tile_h, chunk)
        tr = transmittance(cols[0], cols[1], cols[2], cols[3], cols[4], cols[5], valid,
                           px, py)
        fail = tr.ok & ~tr.include          # valid but T would fall below 1e-4
        cnt = counts[t0:t1].long().clamp(min=0)
        stp = torch.where(fail.any(dim=1), fail.int().argmax(dim=1), cnt[:, None])
        first = torch.arange(nchk, device=dev) * chunk
        ts = torch.where(first[None, :, None] < stp[:, None, :], tr.t_before[:, first, :],
                         tr.final_t[:, None, :])
        b_idx, c_idx = torch.nonzero(torch.arange(nchk, device=dev)[None, :]
                                     < nch_all[t0:t1, None], as_tuple=True)
        slots = off_all[t0:t1][b_idx] + c_idx
        t_start[slots] = ts[b_idx, c_idx]
        if cot is not None:
            g = cot[t0:t1]
            q = (torch.einsum("bkc,bpc->bkp", cols[HDR:HDR + C].permute(1, 2, 0), g[..., :C])
                 + g[:, None, :, cf] + cols[6][..., None] * g[:, None, :, cf + 1])
            w = torch.where(tr.include, tr.a * tr.t_before, torch.zeros_like(tr.a))
            sums = (w * q).reshape(t1 - t0, nchk, chunk, P).sum(dim=2)
            chunk_sum[slots] = sums[b_idx, c_idx]
        stop[t0:t1] = stp.int()
        t_final[t0:t1] = tr.final_t
    n_chunks = torch.tensor([total], dtype=torch.int32, device=dev)
    return Checkpoints(t_start, chunk_sum, stop, t_final, chunk_map, n_chunks)


def blend_fwd_checkpoints_plain(data, starts, counts, tile_base, *, n_tiles, tiles_x,
                                tile_w=16, tile_h=16, chunk=CHUNK) -> Checkpoints:
    """Plain PyTorch version of kernel C's checkpoint mode: everything but
    the chunk sums (zeros, left for D1s)."""
    return _checkpoints_plain(data, starts, counts, tile_base, None, 0, n_tiles=n_tiles,
                              tiles_x=tiles_x, tile_w=tile_w, tile_h=tile_h, chunk=chunk)


def blend_instances_plain(data, starts, counts, tile_base, *, n_tiles, tiles_x,
                          n_channels, tile_w=16, tile_h=16, planar=False,
                          checkpoints=False, tiles_per_image=None):
    """Plain PyTorch version of kernel C: tile-major [T, C+3, P] or, with
    planar=True, [C+3, (T / tiles_x) tile_h, tiles_x tile_w]; with
    checkpoints=True, (that, blend_fwd_checkpoints_plain's Checkpoints);
    `tiles_per_image` as `blend_instances_cuda`'s (checkpoints of one
    image only)."""
    if _images_tiles(tile_base, n_tiles, tiles_per_image, planar) < tile_base + n_tiles \
            and checkpoints:
        raise ValueError("the plain checkpoints take one image")
    out, _, _, _ = _blend_instances_plain(
        data, starts, counts, tile_base, n_tiles=n_tiles, tiles_x=tiles_x,
        n_channels=n_channels, tile_w=tile_w, tile_h=tile_h, tiles_per_image=tiles_per_image)
    if planar:
        n_rows = n_tiles // tiles_x
        x = out.reshape(n_rows, tiles_x, n_channels + 3, tile_h, tile_w)
        out = x.permute(2, 0, 3, 1, 4).reshape(n_channels + 3, n_rows * tile_h,
                                               tiles_x * tile_w)
    if not checkpoints:
        return out
    return out, blend_fwd_checkpoints_plain(data, starts, counts, tile_base,
                                            n_tiles=n_tiles, tiles_x=tiles_x,
                                            tile_w=tile_w, tile_h=tile_h)


def blend_instances_cuda(data, starts, counts, tile_base, *, n_tiles, tiles_x,
                         n_channels, tile_w=16, tile_h=16, planar=False,
                         checkpoints=False, tiles_per_image=None):
    """Launch kernel C; same outputs as blend_instances_plain (with
    checkpoints=True, the Checkpoints where blend_fwd_checkpoints_plain
    defines them: slots < n_chunks; the chunk sums are left for D1s). A
    tile-major launch may blend several images of `tiles_per_image` tiles
    one after another (tile_base 0): each tile takes the pixel coordinates
    of its index within its image. A launch of one image passes the
    image's tile count, or None: its tiles [tile_base, tile_base + n_tiles)
    keep their coordinates either way."""
    P = tile_w * tile_h
    C = n_channels
    if not data.is_cuda or data.dtype != torch.float32 or data.dim() != 2:
        raise ValueError("kernel C takes a float32 CUDA instance matrix [D, NS]")
    if data.shape[0] < HDR + C:
        raise ValueError(f"instance matrix has {data.shape[0]} rows, needs {HDR + C}")
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"kernel C takes 1..{MAX_CHANNELS} channels, got {C}")
    if P > 1024:
        raise ValueError(f"kernel C takes tiles of at most 1,024 pixels, got {P}")
    for name, t in (("starts", starts), ("counts", counts)):
        if t.shape != (n_tiles,) or t.device != data.device:
            raise ValueError(f"{name} must be [{n_tiles}] on {data.device}")
    if planar and n_tiles % tiles_x:
        raise ValueError("planar output needs whole tile rows")
    tiles_per_image = _images_tiles(tile_base, n_tiles, tiles_per_image, planar)
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
    ck = empty_checkpoints(data.shape[1], n_tiles, P, data.device) if checkpoints else None
    ck_ptrs = ((ck.t_start.shape[0], ck.t_start.data_ptr(), ck.stop.data_ptr(),
                ck.t_final.data_ptr(), ck.chunk_map.data_ptr(), ck.n_chunks.data_ptr())
               if checkpoints else (0, None, None, None, None, None))
    fn = cuda_lib.library("blend_fwd").blend_fwd
    err = fn(data.data_ptr(), data.shape[1], starts.data_ptr(), counts.data_ptr(),
             n_tiles, int(tile_base), int(tiles_per_image), tiles_x, C, tile_w, tile_h,
             int(planar), out_h, out_w, out.data_ptr(), *ck_ptrs,
             torch.cuda.current_stream(data.device).cuda_stream)
    cuda_lib.check("blend_fwd", err)
    cuda_lib.LAUNCHES["blend_fwd"] += 1
    if not planar:
        cuda_lib.LAUNCHES["blend_fwd_tiles"] += 1
    if not checkpoints:
        return out
    cuda_lib.LAUNCHES["blend_fwd_ckpt"] += 1
    return out, ck


def _blend_raw(data, starts, counts, tile_base, planar, **kw):
    fn = blend_instances_cuda if data.is_cuda else blend_instances_plain
    return fn(data, starts, counts, tile_base, planar=planar, **kw)


def blend_rows_raw(data, starts, counts, tile_base=0, *, n_tiles, tiles_x,
                   n_channels, tile_w=16, tile_h=16, checkpoints=False):
    """Planar [C+3, (n_tiles / tiles_x) tile_h, tiles_x tile_w] blend (and
    the Checkpoints with checkpoints=True)."""
    return _blend_raw(data, starts, counts, tile_base, True, n_tiles=n_tiles,
                      tiles_x=tiles_x, n_channels=n_channels, tile_w=tile_w,
                      tile_h=tile_h, checkpoints=checkpoints)


def blend_tiles_raw(data, starts, counts, tile_base=0, *, n_tiles, tiles_x,
                    n_channels, tile_w=16, tile_h=16, checkpoints=False):
    """Tile-major [n_tiles, C+3, P] blend of tiles [tile_base, tile_base +
    n_tiles) of a tiles_x-wide grid (and the Checkpoints with
    checkpoints=True)."""
    return _blend_raw(data, starts, counts, tile_base, False, n_tiles=n_tiles,
                      tiles_x=tiles_x, n_channels=n_channels, tile_w=tile_w,
                      tile_h=tile_h, checkpoints=checkpoints)


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
                     tile_w=16, tile_h=16, checkpoints=False):
    """(image [H, W, C], alpha, depth, final_t) through the planar layout
    where the TPU row kernel would run, the tile-major one elsewhere; with
    checkpoints=True, (those four, the Checkpoints)."""
    tw = -(-width // tile_w)
    th = -(-height // tile_h)
    T = tw * th
    planar = bool(row_mode_supported(T, tw, tile_w, tile_h))
    res = (blend_rows_raw if planar else blend_tiles_raw)(
        inst.data, inst.starts, inst.counts, 0, n_tiles=T, tiles_x=tw,
        n_channels=n_channels, tile_w=tile_w, tile_h=tile_h, checkpoints=checkpoints)
    out, ckpt = res if checkpoints else (res, None)
    if planar:
        outs = finish_planar(out, bg, n_channels=n_channels, width=width, height=height)
    else:
        outs = finish_tiles(out, bg, n_channels=n_channels, width=width, height=height,
                            tile_w=tile_w, tile_h=tile_h)
    return (outs, ckpt) if checkpoints else outs


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
    """Forward: kernel C, writing kernel D's checkpoints when the call is
    differentiated. Backward: the background terms, then kernel D's chunk
    launches (D1s, D2) from those checkpoints over the tile-major
    cotangents, then the per-Gaussian reduction."""

    @staticmethod
    def forward(ctx, sorted_rank, order, rank, starts, counts, means2d, conics,
                opacities, features, depths, bg, width, height, tile_w, tile_h,
                max_tiles_per_gaussian, differentiated):
        inst = build_instance_data(sorted_rank, starts, counts, means2d, conics,
                                   opacities, depths, features, order=order)
        res = blend_pallas_raw(inst, bg.float(), width=width, height=height,
                               n_channels=features.shape[-1], tile_w=tile_w, tile_h=tile_h,
                               checkpoints=differentiated)
        if not differentiated:
            return res
        (image, alpha, depth, final_t), ckpt = res
        ctx.save_for_backward(inst.data, sorted_rank, rank, starts, counts, bg, final_t,
                              *ckpt)
        ctx.geom = (width, height, tile_w, tile_h, max_tiles_per_gaussian,
                    means2d.shape[0], features.shape[-1])
        return image, alpha, depth, final_t

    @staticmethod
    def backward(ctx, g_image, g_alpha, g_depth, g_final_t):
        from mygauhuman_torch.ops.pallas_blend_bwd import blend_pallas_bwd_raw

        data, sorted_rank, rank, starts, counts, bg, final_t, *ckpt = ctx.saved_tensors
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
                                    Checkpoints(*ckpt), width=width, height=height,
                                    tile_w=tile_w, tile_h=tile_h, n_channels=c)
        per_g = per_gaussian_rows(rows, sorted_rank, rank, n, S)
        return (None, None, None, None, None, per_g[:, 0:2], per_g[:, 2:5], per_g[:, 5],
                per_g[:, HDR:HDR + c], per_g[:, 6], dbg, None, None, None, None, None, None)


def blend_pallas(sorted_rank, order, rank, starts, counts, means2d, conics,
                 opacities, features, depths, bg, *, width, height,
                 tile_w=16, tile_h=16, max_tiles_per_gaussian=16) -> BlendOutput:
    """Differentiable blend from binning's rank-space lists. `counts` must
    already be capped at tile_capacity, and max_tiles_per_gaussian must be
    the binning's. Kernels C and D on CUDA tensors, their plain versions on
    CPU tensors. Only a differentiated call (grad mode on, an input that
    requires grad) keeps checkpoints for the backward."""
    differentiated = torch.is_grad_enabled() and any(
        x.requires_grad for x in (means2d, conics, opacities, features, depths, bg))
    return BlendOutput(*_BlendPallas.apply(
        sorted_rank, order, rank, starts, counts, means2d, conics, opacities, features,
        depths, bg, width, height, tile_w, tile_h, max_tiles_per_gaussian, differentiated))


# ---- the instance-level differentiable blend (the tile-strip entry) ----------
#
# blend_pallas differentiates with respect to per-Gaussian inputs and gathers
# the instance matrix itself, which needs every Gaussian on one device. The
# tile-sharded rasterizer (parallel/raster.py) holds only the instances the
# exchange delivered for its strip, so these differentiate with respect to
# the instance matrix: the exchange's backward routes the rows to their
# owners.


def _strip_cotangent(g, n_channels, cf, planar, n_tiles, tiles_x, tile_w, tile_h):
    """Kernel D's cotangent layout [T, P, Cf + 3] from the cotangent of a
    strip blend's output: the feature channels, zeros for the instance
    matrix's pad rows, then w_sum, d_sum and final_t."""
    P = tile_w * tile_h
    if planar:
        n_rows = n_tiles // tiles_x
        g = g.reshape(g.shape[0], n_rows, tile_h, tiles_x, tile_w)
        g = g.permute(1, 3, 2, 4, 0).reshape(n_tiles, P, -1)
    else:
        g = g.permute(0, 2, 1)
    return torch.cat([g[..., :n_channels], g.new_zeros((n_tiles, P, cf - n_channels)),
                      g[..., n_channels:n_channels + 3]], dim=-1).contiguous()


class _BlendInstances(torch.autograd.Function):
    """Forward: kernel C at `tile_base`, in checkpoint mode when the call is
    differentiated. Backward: kernel D's D1s and D2 on those checkpoints,
    returning the instance matrix's cotangent [D, NS]."""

    @staticmethod
    def forward(ctx, data, starts, counts, tile_base, n_tiles, tiles_x, n_channels, tile_w,
                tile_h, planar, differentiated):
        kw = dict(n_tiles=n_tiles, tiles_x=tiles_x, n_channels=n_channels, tile_w=tile_w,
                  tile_h=tile_h, checkpoints=differentiated)
        res = _blend_raw(data, starts, counts, tile_base, planar, **kw)
        if not differentiated:
            return res
        out, ckpt = res
        ctx.save_for_backward(data, starts, counts, *ckpt)
        ctx.geom = (tile_base, n_tiles, tiles_x, n_channels, tile_w, tile_h, planar)
        return out

    @staticmethod
    def backward(ctx, g):
        from mygauhuman_torch.ops.pallas_blend_bwd import blend_tiles_bwd_from_ckpt_raw

        data, starts, counts, *ckpt = ctx.saved_tensors
        tile_base, n_tiles, tiles_x, C, tile_w, tile_h, planar = ctx.geom
        cot = _strip_cotangent(g.float(), C, data.shape[0] - HDR, planar, n_tiles, tiles_x,
                               tile_w, tile_h)
        rows = blend_tiles_bwd_from_ckpt_raw(data, starts, counts, tile_base, cot,
                                             Checkpoints(*ckpt), n_tiles=n_tiles,
                                             tiles_x=tiles_x, tile_w=tile_w, tile_h=tile_h,
                                             n_channels=C)
        return (rows.T,) + (None,) * 10


def _blend_instances(data, starts, counts, tile_base, n_tiles, tiles_x, n_channels, tile_w,
                     tile_h, planar):
    differentiated = torch.is_grad_enabled() and data.requires_grad
    return _BlendInstances.apply(data, starts, counts, int(tile_base), n_tiles, tiles_x,
                                 n_channels, tile_w, tile_h, planar, differentiated)


def blend_instances(data, starts, counts, tile_base, n_tiles, tiles_x, n_channels,
                    tile_w=16, tile_h=16):
    """Differentiable tile-major blend of tiles [tile_base, tile_base +
    n_tiles) of a tiles_x-wide grid: instance matrix [D, NS] -> [n_tiles,
    C+3, P]. Kernel C forward (checkpoint mode when differentiated) and
    kernel D (D1s, D2) backward on CUDA tensors, their plain versions on CPU
    tensors; the gradient is the instance matrix's [D, NS]."""
    return _blend_instances(data, starts, counts, tile_base, n_tiles, tiles_x, n_channels,
                            tile_w, tile_h, False)


def blend_instances_planar(data, starts, counts, tile_base, n_tiles, tiles_x, n_channels,
                           tile_w=16, tile_h=16):
    """blend_instances with the planar output [C+3, (n_tiles / tiles_x)
    tile_h, tiles_x tile_w], for strips of whole tile rows (where
    row_mode_supported holds, as the TPU row kernel needs): strips then
    concatenate along H and finish with finish_planar."""
    return _blend_instances(data, starts, counts, tile_base, n_tiles, tiles_x, n_channels,
                            tile_w, tile_h, True)
