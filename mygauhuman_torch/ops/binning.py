"""Tile binning: depth-sorted, fixed-capacity per-tile Gaussian lists.

Port of ops/binning.py. Each live Gaussian emits up to S =
max_tiles_per_gaussian (tile, depth) instances over its screen rect; the
instances are ordered by one int32 key (tile << log2(radix) | depth rank)
where the depth rank comes from a STABLE argsort, so equal depths keep id
order as `jnp.argsort` does. A finite instance_capacity I keeps the sorted
prefix of I instances; each tile keeps its K = tile_capacity nearest. Every
truncation is counted (overflow_gauss / overflow_inst / overflow_tiles).
`bin_faces` bins many images at once, every instance kept (the occlusion
bake's cube faces), with the same slots, ranks and order per image.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


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


def tile_slots(means2d, radii, visible, tw, th, tile_w, tile_h, S):
    """The S slots of each Gaussian over its covered tile rect, for inputs
    with any leading dimensions ([..., N]): slot s -> tile (min_x + s % rw,
    min_y + s // rw) -> (tile id [..., S, N] int32, whether the slot is
    emitted [..., S, N], live [..., N], tiles touched [..., N])."""
    min_x, min_y, max_x, max_y = gaussian_tile_rects(means2d, radii, tw, th, tile_w, tile_h)
    rw = max_x - min_x
    touched = rw * (max_y - min_y)
    live = visible & (radii > 0) & (touched > 0)
    s = torch.arange(S, dtype=torch.int32, device=means2d.device)[:, None]
    rw_safe = torch.clamp(rw, min=1)[..., None, :]
    dx = s % rw_safe
    dy = torch.div(s, rw_safe, rounding_mode="floor")
    slot_ok = live[..., None, :] & (s < torch.clamp(touched, max=S)[..., None, :])
    tile_id = (min_y[..., None, :] + dy) * tw + (min_x[..., None, :] + dx)
    return tile_id, slot_ok, live, touched


def rank_radix(n: int) -> int:
    """The smallest power of two >= n: the depth rank's field in a key."""
    return 1 << max(n - 1, 0).bit_length()


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

    tile_id, slot_ok, live, touched = tile_slots(means2d, radii, visible, tw, th, tile_w,
                                                 tile_h, S)
    overflow_gauss = torch.where(live, torch.clamp(touched - S, min=0),
                                 torch.zeros_like(touched)).sum().to(i32)
    flat_tile = torch.where(slot_ok, tile_id, torch.full_like(tile_id, T)).reshape(-1)

    # per-tile counts are exact integer counts of the emitted slots (integer
    # sums are exact in any order); starts are their exclusive prefix sum
    counts = slot_counts(flat_tile, T)
    bounds = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                        torch.cumsum(counts, dim=0, dtype=i32)])
    starts = bounds[:T]
    ends = bounds[1:]
    total_live = bounds[T]

    radix = rank_radix(N)
    # int32 key when (tile, rank) fits, as the JAX key; int64 otherwise (same
    # order, so no second code path is needed)
    key_dtype = i32 if (T + 1) * radix < 2 ** 31 else torch.int64
    order = torch.argsort(depths.float(), stable=True).to(i32)
    rank = torch.empty_like(order)
    rank[order.long()] = torch.arange(N, dtype=i32, device=dev)
    flat_rank = rank[None, :].expand(S, N).reshape(-1)
    key = flat_tile.to(key_dtype) * radix + flat_rank.to(key_dtype)
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
    sorted_tile = torch.div(sorted_key, radix, rounding_mode="floor").to(i32)
    sorted_rank = (sorted_key % radix).to(i32)
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


class FaceLists(NamedTuple):
    starts: torch.Tensor   # [F T] int64 offset of each tile's slice, images one after another
    counts: torch.Tensor   # [F T] int64 instances per tile (every one: no tile cap)
    src: torch.Tensor      # [F S N] int64 row of each sorted instance in the images'
                           # stacked [F N] attributes (the live ones a prefix)


def bin_faces(
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
) -> FaceLists:
    """`bin_gaussians` of F images at once (inputs [F, N, ...]), every
    instance kept: each image's depth ranks from one stable sort along N,
    then one sort of every image's (image, tile, rank) keys, the dead slots
    in one bucket past every image, so that image f's segment of the sorted
    keys is the list `bin_gaussians` sorts for it. Tile starts and counts
    are searched in the sorted keys, so nothing is counted by atomic adds."""
    dev = means2d.device
    F, N = depths.shape
    S = max_tiles_per_gaussian
    tw, th = tile_dims(width, height, tile_w, tile_h)
    T = tw * th
    tile_id, slot_ok, _, _ = tile_slots(means2d, radii, visible, tw, th, tile_w, tile_h, S)
    image = torch.arange(F, dtype=torch.int32, device=dev)[:, None, None]
    bucket = torch.where(slot_ok, image * T + tile_id, torch.full_like(tile_id, F * T))
    radix = rank_radix(N)
    key_dtype = torch.int32 if (F * T + 1) * radix < 2 ** 31 else torch.int64
    order = torch.argsort(depths, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(1, order, torch.arange(N, device=dev).expand(F, N))
    key = bucket.to(key_dtype) * radix + rank[:, None, :].to(key_dtype)
    sorted_key = torch.sort(key.reshape(-1)).values
    bounds = torch.searchsorted(
        sorted_key, torch.arange(F * T + 1, dtype=key_dtype, device=dev) * radix)
    image_of = torch.clamp(torch.div(sorted_key, T * radix, rounding_mode="floor"),
                           max=F - 1).long()
    src = image_of * N + order.reshape(-1)[image_of * N + (sorted_key % radix).long()]
    return FaceLists(starts=bounds[:-1], counts=bounds[1:] - bounds[:-1], src=src)
