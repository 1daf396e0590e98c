"""Tile-sharded rasterizer over the raster axes' process group (port of
parallel/raster.py).

  1. Per-Gaussian arrays split over the raster ranks: each rank
     preprocesses and bins its own capacity slice against the whole tile
     grid (no communication).
  2. The tile grid splits into n_shards contiguous strips. Each rank caps
     every tile of its local list at K first (so that an exchange overflow
     drops the deepest instances of a tile, as the single-device K cap does)
     and cuts a window of at most `exchange_capacity` instances per
     destination strip, with their attribute columns (the payload).
  3. One all_to_all over the raster group delivers strip s's windows to the
     rank that owns s.
  4. Each rank orders what it received by (tile, depth, global id), the id
     being shard * n_local + local depth rank, so that ties break as in the
     single-device sort, and blends its strip with kernel C
     (`ops/pallas_blend.py::blend_instances{,_planar}`) at its `tile_base`.

The gradient runs back through kernel D (the instance matrix's rows), the
inverse permutation of the merge, the reverse all_to_all, and a
deterministic per-Gaussian sum of the window rows on the owning rank
(`ops/pallas_blend.py::per_gaussian_rows`): no gather is differentiated by
autograd, whose CUDA backward would add with atomics.

`raster_strip_core` and `make_strip_raster_fn` follow the shard_map
convention of the train steps: every rank computes the same replicated loss
from the gathered image, pre-scaled by 1/n_shards, and each collective's
backward sums the copies. `rasterize_sharded` is the whole-array entry:
every rank passes the whole scene and gets the whole image, and a loss of
it differentiates as the single-device `rasterize` does.
"""
from __future__ import annotations

import torch

from mygauhuman_torch.ops.binning import bin_gaussians, tile_dims
from mygauhuman_torch.ops.pallas_blend import (
    HDR,
    attr_matrix,
    blend_instances,
    blend_instances_planar,
    finish_planar,
    finish_tiles,
    per_gaussian_rows,
    row_mode_supported,
)
from mygauhuman_torch.ops.projection import preprocess
from mygauhuman_torch.ops.rasterize import RasterizeOutput, RasterizerConfig
from mygauhuman_torch.parallel.mesh import (
    RASTER_AXES,
    Group,
    Mesh,
    all_gather,
    all_to_all,
    all_to_all_raw,
    gather_raw,
)


def mesh_shard_count(mesh: Mesh) -> int:
    """The ranks over the raster axes: the Gaussian shards."""
    return mesh.size(RASTER_AXES)


def strip_planar_ok(t_strip: int, tiles_x: int, tile_w: int, tile_h: int) -> bool:
    """True when the strips cover whole tile rows and the TPU row kernel
    supports the geometry: the planar layout applies (the JAX rule, so that
    both packages pick the same layout)."""
    return t_strip % tiles_x == 0 and row_mode_supported(t_strip, tiles_x, tile_w,
                                                         tile_h) > 0


class _WindowRows(torch.autograd.Function):
    """attrs [D, n] (id order) -> windows [S_n, D, I_ex]: column (s, i) is
    the instance at position pos[s, i] of the K-capped rank list `crank`
    (zeros where not valid). Backward: each valid window row to its list
    position (positions are distinct), then summed per Gaussian in a fixed
    order (per_gaussian_rows: a Gaussian has at most S list entries)."""

    @staticmethod
    def forward(ctx, attrs, order, rank, crank, pos, valid, S):
        ids = order.long()[crank.long()[pos.long()]]                 # [S_n, I_ex]
        data = attrs[:, ids].permute(1, 0, 2)                        # [S_n, D, I_ex]
        data = torch.where(valid[:, None, :], data, torch.zeros_like(data))
        ctx.save_for_backward(rank, crank, pos, valid)
        ctx.S = S
        return data.contiguous()

    @staticmethod
    def backward(ctx, g):
        rank, crank, pos, valid = ctx.saved_tensors
        ns = crank.shape[0]
        D = g.shape[1]
        rows = g.new_zeros((ns + 1, D))
        # invalid entries write the spare row ns, which is dropped
        dest = torch.where(valid, pos, torch.full_like(pos, ns)).reshape(-1).long()
        rows[dest] = g.permute(0, 2, 1).reshape(-1, D)
        per_g = per_gaussian_rows(rows[:ns], crank, rank, rank.shape[0], ctx.S)
        return (per_g.T,) + (None,) * 6


class _Permute(torch.autograd.Function):
    """x[:, perm] for a permutation perm; backward through its inverse."""

    @staticmethod
    def forward(ctx, x, perm):
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(perm.shape[0], device=perm.device, dtype=perm.dtype)
        ctx.save_for_backward(inv)
        return x[:, perm]

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return g[:, inv], None


def _stable_argsort(*keys):
    """Indices that order the entries by keys[0], then keys[1], ... (stable
    sorts from the last key to the first)."""
    perm = None
    for key in reversed(keys):
        k = key if perm is None else key[perm]
        p = torch.sort(k, stable=True).indices
        perm = p if perm is None else perm[p]
    return perm


def raster_strip_core(means3d, cov3d6, opacities, features, m2d_off, alive, w2c, full_proj,
                      *, group: Group, width: int, height: int, tan_fovx: float,
                      tan_fovy: float, config: RasterizerConfig, exchange_capacity: int):
    """One rank's part of the strip rasterizer (the module docstring's four
    stages) on its capacity slice. Returns (strip output: planar [C+3,
    rows tile_h, W] or tile-major [T_strip, C+3, P], radii, means2d,
    visible, (overflow_tiles, overflow_gauss, overflow_inst) summed over
    the group)."""
    n_shards = group.size
    shard = group.index
    dev = means3d.device
    n_local = means3d.shape[0]
    n_channels = features.shape[-1]
    tile_w, tile_h = config.tile_w, config.tile_h
    tw, th = tile_dims(width, height, tile_w, tile_h)
    T = tw * th
    T_strip = -(-T // n_shards)
    S = config.max_tiles_per_gaussian
    K = config.tile_capacity
    ns = n_local * S
    I_ex = min(exchange_capacity, ns)
    i32 = torch.int32

    # ---- stage 1: local geometry (no communication)
    proj = preprocess(means3d, cov3d6, w2c, full_proj, width, height, tan_fovx, tan_fovy)
    means2d = proj.means2d + m2d_off
    visible = proj.visible & alive
    bins = bin_gaussians(means2d.detach(), proj.radii, proj.depths.detach(), visible,
                         width=width, height=height, tile_w=tile_w, tile_h=tile_h,
                         max_tiles_per_gaussian=S, tile_capacity=K)

    # ---- stage 2: per-strip windows of the K-capped local list. The kept
    # (first K of each tile) entries are compacted in tile-major order by a
    # stable sort on their destination; dropped ones sort past the end.
    counts = torch.clamp(bins.counts, max=K)
    bounds = torch.cat([torch.zeros(1, dtype=i32, device=dev),
                        torch.cumsum(counts, dim=0, dtype=i32)])          # [T + 1]
    starts_ext = torch.cat([bins.starts, (bins.starts[-1] + bins.counts[-1])[None]])
    pos = torch.arange(ns, dtype=i32, device=dev)
    in_tile = pos - starts_ext[bins.sorted_tile.long()]
    keep = (bins.sorted_tile < T) & (in_tile < K)
    dest = torch.where(keep, bounds[bins.sorted_tile.long()] + in_tile,
                       torch.full_like(pos, ns))
    p = torch.sort(dest, stable=True).indices
    crank = bins.sorted_rank[p]
    ctile = torch.where(keep[p], bins.sorted_tile[p], torch.full_like(pos, T))

    strip_lo = torch.tensor([min(s * T_strip, T) for s in range(n_shards + 1)],
                            dtype=torch.long, device=dev)
    lo = bounds[strip_lo[:-1]].long()
    wlen = bounds[strip_lo[1:]].long() - lo
    exch_drop = torch.clamp(wlen - I_ex, min=0).sum().to(i32)
    lane = torch.arange(I_ex, device=dev)
    valid_w = lane[None, :] < torch.clamp(wlen, max=I_ex)[:, None]
    pos_w = torch.clamp(lo[:, None] + lane[None, :], max=ns - 1)
    tile_w_ids = torch.where(valid_w, ctile[pos_w], torch.full_like(pos_w, T, dtype=i32))
    gid_w = shard * n_local + crank[pos_w].long()

    attrs = attr_matrix(means2d.float(), proj.conics.float(), opacities.float(),
                        proj.depths.float(), features.float())            # [D, n_local]
    data_w = _WindowRows.apply(attrs, bins.order, bins.rank, crank, pos_w, valid_w, S)

    # ---- stage 3: the exchange (strip s's windows -> its owner)
    recv_data = all_to_all(data_w, group)                                 # [S_n, D, I_ex]
    recv_tile = all_to_all_raw(group, tile_w_ids)
    recv_gid = all_to_all_raw(group, gid_w)

    # ---- stage 4: merge by (tile, depth, global id), blend the own strip
    E = n_shards * I_ex
    D = recv_data.shape[1]
    rdata = recv_data.permute(1, 0, 2).reshape(D, E)
    rtile = recv_tile.reshape(E)
    perm = _stable_argsort(rtile, rdata[HDR - 2].detach(), recv_gid.reshape(E))
    data_sorted = _Permute.apply(rdata, perm)
    srt_tile = rtile[perm].contiguous()

    t0 = shard * T_strip
    tiles_local = t0 + torch.arange(T_strip, dtype=i32, device=dev)
    lstarts = torch.searchsorted(srt_tile, tiles_local, side="left").to(i32)
    lends = torch.searchsorted(srt_tile, tiles_local + 1, side="left").to(i32)
    # tiles past the grid (the last strip of a grid that does not split
    # evenly) are empty; the exchange's padding carries tile id T
    real = tiles_local < T
    lcounts = torch.where(real, torch.clamp(lends - lstarts, max=K), torch.zeros_like(lends))
    strip_overflow = torch.where(real, torch.clamp(lends - lstarts - K, min=0),
                                 torch.zeros_like(lends)).sum().to(i32)

    blend = (blend_instances_planar if strip_planar_ok(T_strip, tw, tile_w, tile_h)
             else blend_instances)
    tiles_out = blend(data_sorted, lstarts, lcounts, t0, T_strip, tw, n_channels,
                      tile_w, tile_h)

    radii = torch.where(visible, proj.radii, torch.zeros_like(proj.radii))
    counters = torch.stack([bins.overflow_tiles + strip_overflow, bins.overflow_gauss,
                            exch_drop]).to(i32)
    counters = gather_raw(group, counters, "counters").sum(dim=0)
    return tiles_out, radii, means2d, visible, tuple(counters.unbind())


def _finish(gathered, planar, bg, n_channels, width, height, config, T):
    if planar:
        return finish_planar(gathered, bg, n_channels=n_channels, width=width, height=height)
    return finish_tiles(gathered[:T], bg, n_channels=n_channels, width=width, height=height,
                        tile_w=config.tile_w, tile_h=config.tile_h)


def make_strip_raster_fn(group: Group, exchange_capacity: int):
    """A `rasterize`-compatible raster_fn over the rank's capacity slice
    (`render_frame(..., raster_fn=...)`): the strip pipeline, then an
    all_gather of the strips so that every rank holds the whole image. The
    loss computed from it is replicated on every rank; pre-scale it by
    1/group.size (the all_gather's backward sums the copies)."""

    def fn(means3d, cov3d6, opacities, features, w2c, full_proj, bg, *, width, height,
           tan_fovx, tan_fovy, config=RasterizerConfig(), means2d_offset=None, alive=None):
        n_local = means3d.shape[0]
        if means2d_offset is None:
            means2d_offset = torch.zeros((n_local, 2), device=means3d.device)
        if alive is None:
            alive = torch.ones((n_local,), dtype=torch.bool, device=means3d.device)
        tiles_out, radii, means2d, visible, counters = raster_strip_core(
            means3d, cov3d6, opacities, features, means2d_offset, alive, w2c, full_proj,
            group=group, width=width, height=height, tan_fovx=tan_fovx, tan_fovy=tan_fovy,
            config=config, exchange_capacity=exchange_capacity)
        tw, th = tile_dims(width, height, config.tile_w, config.tile_h)
        T_strip = -(-(tw * th) // group.size)
        planar = strip_planar_ok(T_strip, tw, config.tile_w, config.tile_h)
        gathered = all_gather(tiles_out, group, dim=1 if planar else 0)
        image, alpha, depth, final_t = _finish(gathered, planar, bg.float(),
                                               features.shape[-1], width, height, config,
                                               tw * th)
        return RasterizeOutput(image=image, alpha=alpha, depth=depth, final_t=final_t,
                               radii=radii, means2d=means2d, visible=visible,
                               overflow_tiles=counters[0], overflow_gauss=counters[1],
                               overflow_inst=counters[2])

    return fn


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the cotangent times `scale` backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _ReplicatedSlice(torch.autograd.Function):
    """x[lo:hi] of a replicated whole array; backward: the ranks' slices of
    the gradient gathered, so every rank holds the whole gradient."""

    @staticmethod
    def forward(ctx, x, group, lo, hi):
        ctx.group = group
        return x[lo:hi]

    @staticmethod
    def backward(ctx, g):
        return torch.cat(tuple(gather_raw(ctx.group, g.contiguous(), "grad_gather"))), \
            None, None, None


def rasterize_sharded(means3d, cov3d6, opacities, features, w2c, full_proj, bg, *,
                      mesh: Mesh, width: int, height: int, tan_fovx: float, tan_fovy: float,
                      config: RasterizerConfig = RasterizerConfig(),
                      exchange_capacity: int | None = None,
                      means2d_offset=None, alive=None) -> RasterizeOutput:
    """Multi-rank `rasterize`: every rank passes the whole scene (N
    divisible by the shard count) and gets the whole RasterizeOutput; a loss
    of it, the same on every rank, differentiates as the single-device one
    (every rank gets the whole gradient).

    exchange_capacity bounds the instance window per (source rank, strip);
    what it drops is counted in overflow_inst. None: the rank's whole local
    list (exact, sized for the worst case)."""
    group = mesh.group(RASTER_AXES)
    n = means3d.shape[0]
    n_shards = mesh_shard_count(mesh)
    if n % n_shards:
        raise ValueError(f"{n} Gaussians do not split over {n_shards} ranks")
    n_local = n // n_shards
    lo, hi = group.index * n_local, (group.index + 1) * n_local
    ns_local = n_local * config.max_tiles_per_gaussian
    I_ex = ns_local if exchange_capacity is None else min(exchange_capacity, ns_local)
    if means2d_offset is None:
        means2d_offset = torch.zeros((n, 2), device=means3d.device)
    if alive is None:
        alive = torch.ones((n,), dtype=torch.bool, device=means3d.device)

    def local(x):
        return _ReplicatedSlice.apply(x, group, lo, hi) if x.requires_grad else x[lo:hi]

    out = make_strip_raster_fn(group, I_ex)(
        local(means3d), local(cov3d6), local(opacities), local(features), w2c, full_proj,
        bg, width=width, height=height, tan_fovx=tan_fovx, tan_fovy=tan_fovy,
        config=config, means2d_offset=local(means2d_offset), alive=alive[lo:hi])
    # the loss is replicated: 1/n_shards on the cotangent of the gathered
    # outputs turns the all_gather's sum of copies into one copy
    scale = 1.0 / n_shards
    rep = (lambda x: _ScaleGrad.apply(x, scale)) if n_shards > 1 else (lambda x: x)
    return out._replace(
        image=rep(out.image), alpha=rep(out.alpha), depth=rep(out.depth),
        final_t=rep(out.final_t),
        radii=torch.cat(tuple(gather_raw(group, out.radii, "outputs"))),
        means2d=rep(all_gather(out.means2d, group, 0)),
        visible=torch.cat(tuple(gather_raw(group, out.visible, "outputs"))))
