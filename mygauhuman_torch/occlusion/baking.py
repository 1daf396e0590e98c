"""Ambient-occlusion baking: per-voxel opacity cubemaps via the rasterizer
(port of occlusion/baking.py; reference `baking.py:136-309`, `bake_set`).

Voxelize the posed Gaussians into a res^3 occupancy grid; from each
occupied cell center render six 32x32 opacity-only views (fov 90) of all
Gaussians outside the cell; convert the opacity cubemap to a small lat-long
visibility map; every Gaussian inherits its cell's map, masked by the normal
hemisphere (dot(envdir, normal) > 0).

The cells are ranked occupied-first (a stable sort, so the windows hold the
JAX package's cells) and baked in windows of `max_cells` / `sweep_cells`
ranks; `bake_occlusion_full` sweeps every occupied cell. A sweep is the
JAX package's `_bake_sweep`: everything stays on the device (the window's
cell ids from the ranked order, the six face cameras of each cell built
from its center), and the window's cells are baked by one batched program
(`_bake_cells`) over all their faces at once, in `cell_groups` of cells
sized from the capacity so that a group's instance slots stay within
`GROUP_SLOTS`: the faces' projection with a leading face dimension (the
elementwise arithmetic of `ops/projection.py::preprocess`), one binning
of every face (`ops/binning.py::bin_faces`: each face's segment of the
sorted keys is the tile lists its own `rasterize` would build), one blend
of every face's tiles, and the nearest-texel lat-long lookup
written into the window's maps. A slot whose cell is not occupied emits
no instances, and the scatter masks its map out. On CUDA tensors the blend
is kernel C in tile-major mode over the stacked faces (`tiles_per_image`:
a 32-pixel face is not a whole number of the planar mode's 128-pixel
rows), and a sweep is one replay of a CUDA graph of the whole window's
program: one kernel C launch per group. The graph is captured once per
(device, capacity, lat-long size, max_cells, face_res, config), after one
eager run of the program, and kept for later bakes; the grid resolution is
not baked in (the program reads cell ids). The host syncs once per camera,
for `bake_occlusion_full`'s occupied-cell count, and the callers read
`out_of_budget` (a device tensor) once per bake. The per-cell program
(`_bake_cell`: the six faces, each one `rasterize` call under no_grad with
the bake's `RasterizerConfig`) is `eager=True`, the one the batched
program is held to bit for bit.

Deliberate differences from the JAX module:
  * on CPU tensors the batched program runs eagerly, on the slots whose
    cell is occupied only (reading the flags costs a CPU nothing; the
    others' maps are masked out), its blend the plain one
    (`ops/blend.py::blend` over the stacked faces' tiles);
  * a face's tile lists hold every Gaussian (`bake_config(capacity)`): the
    JAX module's lists of 256 per tile (`DEFAULT_BAKE_CONFIG`) dropped most
    of what a face sees through a trained body (26,470 Gaussians: ~94% of
    the instances of sampled faces, up to ~56,000 of one face, and texels
    off by up to 255 of 255), where the reference rasterizer keeps every
    one. Nothing is truncated: a face has 4 tiles, each Gaussian emits at
    most one instance per tile.

Spans and counters (utils/profiling.py): `mgh.pbr.sweep` around each
`_bake_sweep` call; `COUNTERS["mgh.pbr.sweeps"]` and
`COUNTERS["mgh.pbr.faces"]` count the sweeps and the faces they rasterize
(every slot of the window on the card, the occupied ones on the CPU), and
`COUNTERS["mgh.pbr.face_batches"]` the blend launches they take (one per
group; 6 per cell in the per-cell program).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mygauhuman_torch.data.camera import projection_from_fov
from mygauhuman_torch.device import device_constant
from mygauhuman_torch.ops import cuda_lib
from mygauhuman_torch.ops.binning import bin_faces, tile_dims
from mygauhuman_torch.ops.blend import blend
from mygauhuman_torch.ops.pallas_blend import attr_matrix, blend_instances_cuda
from mygauhuman_torch.ops.projection import ProjectedGaussians, cov2d_from_view, screen_space
from mygauhuman_torch.ops.rasterize import RasterizerConfig, rasterize
from mygauhuman_torch.pbr.cubemap import dir_to_cube_uv, latlong_dirs
from mygauhuman_torch.utils.profiling import COUNTERS, annotate


class VoxelGrid(NamedTuple):
    cell_of_point: torch.Tensor   # [N] int64 flat cell index
    centers: torch.Tensor         # [res^3, 3] cell centers
    occupied: torch.Tensor        # [res^3] bool


def pc_to_grid(points: torch.Tensor, alive: torch.Tensor, res: int = 10) -> VoxelGrid:
    """Voxelize points into a res^3 grid over the alive points' bounding box.

    Parity: pc_to_grid (baking.py:104-134) — floor((p - min)/cell), clamped."""
    a = alive[:, None]
    lo = torch.where(a, points, torch.inf).min(dim=0).values
    hi = torch.where(a, points, -torch.inf).max(dim=0).values
    cell = (hi - lo) / res
    idx = torch.clamp(torch.floor((points - lo) / torch.clamp(cell, min=1e-12)).long(),
                      0, res - 1)
    flat = idx[:, 0] * res * res + idx[:, 1] * res + idx[:, 2]
    flat = torch.where(alive, flat, res ** 3 - 1)
    r = torch.arange(res, device=points.device)
    ijk = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)
    centers = lo[None, :] + (ijk + 0.5) * cell[None, :]
    # index_fill_, not an indexed assignment: on the card that copies its
    # value from the host and waits
    occupied = torch.zeros(res ** 3 + 1, dtype=torch.bool, device=points.device)
    occupied.index_fill_(0, torch.where(alive, flat, res ** 3), True)
    return VoxelGrid(cell_of_point=flat, centers=centers, occupied=occupied[:res ** 3])


def _face_camera_axes(face: int):
    """c2w axes (right, down, forward) so the rendered image is the cubemap
    face in the sampling convention of pbr/cubemap.py's cube_to_dir: right =
    d(dir)/d(gx), down = d(dir)/d(gy), forward = dir(0, 0)."""
    table = {  # numpy mirror of cube_to_dir
        0: lambda gx, gy: np.array([1.0, -gy, -gx]),
        1: lambda gx, gy: np.array([-1.0, -gy, gx]),
        2: lambda gx, gy: np.array([gx, 1.0, gy]),
        3: lambda gx, gy: np.array([gx, -1.0, -gy]),
        4: lambda gx, gy: np.array([gx, -gy, 1.0]),
        5: lambda gx, gy: np.array([-gx, -gy, -1.0]),
    }
    d = table[face]
    fwd = d(0.0, 0.0)
    right = d(1.0, 0.0) - fwd
    down = d(0.0, 1.0) - fwd
    return right, down, fwd


def face_cameras(centers: np.ndarray) -> np.ndarray:
    """[n, 6, 2, 4, 4] float32: (w2c, proj @ w2c) of the six fov-90 face
    cameras at each center [n, 3], built as the JAX sweep builds them."""
    proj = projection_from_fov(0.01, 100.0, math.pi / 2, math.pi / 2)
    out = np.zeros((len(centers), 6, 2, 4, 4), np.float32)
    for s in range(6):
        R = np.stack([a.astype(np.float32) for a in _face_camera_axes(s)], axis=1)
        for i, c in enumerate(np.asarray(centers, np.float32)):
            w2c = np.zeros((4, 4), np.float32)
            w2c[:3, :3] = R.T
            w2c[:3, 3] = -(R.T @ c)
            w2c[3, 3] = 1.0
            out[i, s, 0] = w2c
            out[i, s, 1] = proj @ w2c
    return out


def face_cameras_torch(centers: torch.Tensor) -> torch.Tensor:
    """`face_cameras` of centers [n, 3] with device ops, on their device.
    The same numbers: each row of R^T holds one +-1, so R^T c is a signed
    permutation of c, and each entry of proj @ w2c sums at most one rounded
    product and one exact term."""
    dev = centers.device
    axes = device_constant("bake_face_axes", np.stack([
        np.stack([a.astype(np.float32) for a in _face_camera_axes(s)], axis=1)
        for s in range(6)]), dev)                                  # [6, 3, 3] c2w
    proj = device_constant("bake_face_proj",
                           projection_from_fov(0.01, 100.0, math.pi / 2, math.pi / 2), dev)
    rt = axes.transpose(1, 2)
    w2c = centers.new_zeros((centers.shape[0], 6, 4, 4))
    w2c[:, :, :3, :3] = rt
    w2c[:, :, :3, 3] = -(rt[None] * centers[:, None, None, :]).sum(-1)
    w2c[:, :, 3, 3] = 1.0
    full = (proj[:, :, None] * w2c[:, :, None]).sum(-2)             # sum_k P[i,k] w2c[k,j]
    return torch.stack([w2c, full], dim=2)


def count_occupied(points: torch.Tensor, alive: torch.Tensor, grid_res: int = 10) -> int:
    """Number of occupied voxels: the sweep count of `bake_occlusion_full`
    (the reference's per-nonempty-cell loop bound, baking.py:145)."""
    return int(pc_to_grid(points, alive, grid_res).occupied.sum())


def rank_cells(occupied: torch.Tensor) -> torch.Tensor:
    """Cell ids, occupied first, each group in id order (a stable sort, as
    `jnp.argsort(~occupied)`)."""
    return torch.argsort((~occupied).to(torch.int8), stable=True)


class _Window(NamedTuple):
    """The bake programs' inputs for one sweep."""

    means3d: torch.Tensor         # [cap, 3]
    cov3d6: torch.Tensor          # [cap, 6]
    opacities: torch.Tensor       # [cap]
    alive: torch.Tensor           # [cap] bool
    cell_of_point: torch.Tensor   # [cap] int64
    cells: torch.Tensor           # [max_cells] int64: the window's cell ids
    cell_live: torch.Tensor       # [max_cells] bool: whether each is occupied
    cams: torch.Tensor            # [max_cells, 6, 2, 4, 4]: their face cameras


def _latlong_lookup(height: int, width: int, face_res: int, device):
    """(face, yi, xi) [H, W]: the nearest texel of each lat-long direction
    (baking.py:290-298 filter "nearest")."""
    face, gx, gy = dir_to_cube_uv(latlong_dirs(height, width, device))
    r = face_res
    return (face, torch.clamp(((gy + 1.0) * 0.5 * r).long(), 0, r - 1),
            torch.clamp(((gx + 1.0) * 0.5 * r).long(), 0, r - 1))


def _bake_cell(win: _Window, lookup, envs: torch.Tensor, slot: torch.Tensor, *,
               face_res: int, config: RasterizerConfig) -> None:
    """The cell program: the opacity cubemap of the cell in window slot
    `slot` ([1] int64 on the device) of every alive Gaussian outside it,
    as its nearest-texel lat-long map in envs[slot] ([max_cells, H, W])."""
    cap = win.means3d.shape[0]
    with torch.no_grad():
        mask = win.alive & (win.cell_of_point != win.cells.index_select(0, slot))
        cams = win.cams.index_select(0, slot)[0]
        features = win.means3d.new_zeros((cap, 1))
        bg = win.means3d.new_zeros((1,))
        faces = torch.stack([
            rasterize(win.means3d, win.cov3d6, win.opacities, features, cams[s, 0], cams[s, 1],
                      bg, width=face_res, height=face_res, tan_fovx=1.0, tan_fovy=1.0,
                      config=config, alive=mask).alpha
            for s in range(6)])
        face, yi, xi = lookup
        envs.index_copy_(0, slot, faces[face, yi, xi][None])


#: instance slots (6 faces x `capacity` Gaussians x `max_tiles_per_gaussian`
#: a cell) one group of a sweep's cells may hold: at the pbr start's 32,768
#: slots, 42 cells, so a sweep of 128 runs as 4 groups of 32 (the instance
#: matrix alone is 36 bytes a slot)
GROUP_SLOTS = 1 << 25


def cell_groups(n_cells: int, capacity: int, config: RasterizerConfig) -> list:
    """Ranges of equal size (the last one shorter) covering n_cells slots,
    as few as keep each group's instance slots within GROUP_SLOTS."""
    per_group = max(1, GROUP_SLOTS // (6 * capacity * config.max_tiles_per_gaussian))
    n_groups = -(-n_cells // per_group)
    size = -(-n_cells // n_groups) if n_cells else 1
    return [range(g, min(g + size, n_cells)) for g in range(0, n_cells, size)]


def _project_faces(means3d: torch.Tensor, cov3d6: torch.Tensor, cams: torch.Tensor,
                   face_res: int) -> ProjectedGaussians:
    """`ops/projection.py::preprocess` of every face camera cams [F, 2, 4,
    4] (fov 90) at once: its outputs with a leading [F]. The same
    elementwise operations; each product of the points with a face camera's
    matrix sums one rounded product and exact zeros (`face_cameras_torch`),
    so a batched product gives the per-face bits."""
    w2c, full = cams[:, 0], cams[:, 1]

    def view(m, rows):   # means3d @ m[rows, :3].T + m[rows, 3] per face: [F, N, len(rows)]
        return torch.matmul(means3d, m[:, rows, :3].transpose(1, 2)) + m[:, None, rows, 3]

    tan = 1.0                                                       # fov 90
    focal = face_res / (2.0 * tan)
    p_ndc = view(full, slice(0, 3)) / (view(full, slice(3, 4)) + 1e-7)
    W = w2c[:, :3, :3].permute(1, 2, 0)[..., None]                  # [3, 3, F, 1]
    cov2d = cov2d_from_view(view(w2c, slice(0, 3)), cov3d6, W, focal, focal, tan, tan)
    return screen_space(view(w2c, slice(2, 3))[..., 0], p_ndc, cov2d, face_res, face_res)


def _bake_cells(win: _Window, lookup, envs: torch.Tensor, slots: torch.Tensor, *,
                face_res: int, config: RasterizerConfig) -> None:
    """The batched program: for the cells in window slots `slots` ([n]
    int64), the opacity cubemap of every alive Gaussian outside the cell
    (none for a cell that is not occupied), as its nearest-texel lat-long
    map in envs[slots]. Its F = 6 n faces run stacked, each exactly as
    `_bake_cell` renders it: one projection, one binning of every face
    (`ops/binning.py::bin_faces`: each face's segment is its own sorted
    list), then one blend of all F faces' tiles (kernel C on the card, the
    plain blend on the CPU)."""
    n, cap, dev = slots.shape[0], win.means3d.shape[0], win.means3d.device
    F, K = 6 * n, config.tile_capacity
    tw, th = tile_dims(face_res, face_res, config.tile_w, config.tile_h)
    if config.instance_capacity is not None:
        raise ValueError("the batched bake keeps every instance: instance_capacity must be None")
    proj = _project_faces(win.means3d, win.cov3d6,
                          win.cams.index_select(0, slots).reshape(F, 2, 4, 4), face_res)
    mask = (win.alive & (win.cell_of_point != win.cells.index_select(0, slots)[:, None])
            & win.cell_live.index_select(0, slots)[:, None])
    visible = proj.visible & mask[:, None].expand(n, 6, cap).reshape(F, cap)
    lists = bin_faces(proj.means2d, proj.radii, proj.depths, visible, width=face_res,
                      height=face_res, tile_w=config.tile_w, tile_h=config.tile_h,
                      max_tiles_per_gaussian=config.max_tiles_per_gaussian)

    means2d, conics = proj.means2d.reshape(F * cap, 2), proj.conics.reshape(F * cap, 3)
    opacities = win.opacities.expand(F, cap).reshape(-1)
    depths = proj.depths.reshape(-1)
    zeros = depths.new_zeros((F * cap, 1))       # the one feature channel
    if dev.type == "cuda":
        data = attr_matrix(means2d, conics, opacities, depths, zeros, pad=False)
        out = blend_instances_cuda(data.index_select(1, lists.src), lists.starts.to(torch.int32),
                                   torch.clamp(lists.counts, max=K).to(torch.int32), 0,
                                   n_tiles=F * tw * th, tiles_x=tw, n_channels=1,
                                   tile_w=config.tile_w, tile_h=config.tile_h,
                                   tiles_per_image=tw * th)
        alpha = out[:, 1].reshape(F, th, tw, config.tile_h, config.tile_w)
        alpha = alpha.permute(0, 1, 3, 2, 4).reshape(F, th * config.tile_h, tw * config.tile_w)
        alpha = alpha[:, :face_res, :face_res]
    else:
        k = torch.arange(K, device=dev)[None, :]
        pos = torch.clamp(lists.starts[:, None] + k, 0, lists.src.shape[0] - 1)
        alpha = blend(lists.src[pos], k < lists.counts[:, None], means2d, conics, opacities,
                      zeros, depths, depths.new_zeros((1,)), width=face_res, height=face_res,
                      tile_w=config.tile_w, tile_h=config.tile_h,
                      chunk_tiles=config.chunk_tiles, images=F).alpha
    face_of, yi, xi = lookup
    envs.index_copy_(0, slots, alpha.reshape(n, 6, face_res, face_res)[:, face_of, yi, xi])


class _SweepGraph:
    """The batched program of one key captured on the card, over every slot
    of a window in `cell_groups`: static copies of a sweep's inputs, its
    maps, and the launches a replay makes."""

    def __init__(self, win: _Window, lookup, envs: torch.Tensor, *, face_res: int,
                 config: RasterizerConfig):
        self.win = _Window(*(x.clone() for x in win))
        self.lookup, self.envs = lookup, envs
        self.groups = cell_groups(envs.shape[0], win.means3d.shape[0], config)

        def program():
            for g in self.groups:
                _bake_cells(self.win, self.lookup, self.envs,
                            torch.arange(g.start, g.stop, device=self.envs.device),
                            face_res=face_res, config=config)

        self.graph, _, self.launches = cuda_lib.capture_graph(
            program, program, torch.cuda.Stream(envs.device), torch.cuda.graph_pool_handle())

    def run(self, win: _Window) -> torch.Tensor:
        """Every slot of the window, in one replay -> the maps."""
        for dst, src in zip(self.win, win):
            dst.copy_(src)
        self.graph.replay()
        cuda_lib.count_replay(self.launches)
        return self.envs


_SWEEP_GRAPHS: dict = {}   # key -> _SweepGraph, kept as jax.jit keeps its programs


def _bake_sweep(means3d, cov3d6, opacities, alive, vis_carry, offset: int, *, height: int,
                width: int, grid_res: int, max_cells: int, face_res: int,
                config: RasterizerConfig, eager: bool = False):
    """Bake the cells ranked [offset, offset + max_cells) and merge their
    visibility maps into `vis_carry` [cap, H, W, 1] (un-masked: `_finalize`
    applies the hemisphere and alive masks once). Returns (vis, n_uncovered):
    n_uncovered (a device tensor) counts alive Gaussians whose cell ranks
    past the window end. The window runs as the batched program (`_bake_cells`,
    in `cell_groups`): on CUDA tensors one graph replay over every slot, on
    CPU tensors eagerly over the occupied ones; `eager` runs the per-cell
    program (`_bake_cell`) slot by slot on the occupied ones instead."""
    dev = means3d.device
    COUNTERS["mgh.pbr.sweeps"] += 1
    grid = pc_to_grid(means3d, alive, grid_res)
    res3 = grid_res ** 3
    order = rank_cells(grid.occupied)
    rank = torch.empty(res3, dtype=torch.int64, device=dev).scatter_(
        0, order, torch.arange(res3, device=dev))
    off = max(min(int(offset), res3 - max_cells), 0)
    cells = order[off:off + max_cells]
    cell_live = grid.occupied[cells]
    win = _Window(means3d, cov3d6, opacities, alive, grid.cell_of_point, cells, cell_live,
                  face_cameras_torch(grid.centers[cells]))
    if means3d.is_cuda and not eager:
        key = (dev, means3d.shape[0], height, width, max_cells, face_res, config)
        if key not in _SWEEP_GRAPHS:
            _SWEEP_GRAPHS[key] = _SweepGraph(
                win, _latlong_lookup(height, width, face_res, dev),
                torch.zeros((max_cells, height, width), dtype=torch.float32, device=dev),
                face_res=face_res, config=config)
        opacity_envs = _SWEEP_GRAPHS[key].run(win)
        COUNTERS["mgh.pbr.faces"] += 6 * max_cells
        COUNTERS["mgh.pbr.face_batches"] += len(_SWEEP_GRAPHS[key].groups)
    else:
        lookup = _latlong_lookup(height, width, face_res, dev)
        opacity_envs = torch.zeros((max_cells, height, width), dtype=torch.float32, device=dev)
        slots = torch.nonzero(cell_live).reshape(-1)
        COUNTERS["mgh.pbr.faces"] += 6 * slots.shape[0]
        if eager:
            COUNTERS["mgh.pbr.face_batches"] += 6 * slots.shape[0]
            for k in slots.tolist():
                _bake_cell(win, lookup, opacity_envs,
                           torch.full((1,), k, dtype=torch.int64, device=dev),
                           face_res=face_res, config=config)
        else:
            groups = cell_groups(slots.shape[0], means3d.shape[0], config)
            COUNTERS["mgh.pbr.face_batches"] += len(groups)
            for g in groups:
                _bake_cells(win, lookup, opacity_envs, slots[g.start:g.stop],
                            face_res=face_res, config=config)

    # every gaussian in a window cell inherits its cell's map
    g_rank = rank[grid.cell_of_point]
    local = torch.clamp(g_rank - off, 0, max_cells - 1)
    in_window = (g_rank >= off) & (g_rank < off + max_cells) & cell_live[local]
    vis = torch.where(in_window[:, None, None, None], 1.0 - opacity_envs[local][..., None],
                      vis_carry)
    # alive Gaussians always map to occupied (low-ranked) cells, so anything
    # ranking past the window end is still uncovered
    return vis, (alive & (g_rank >= off + max_cells)).sum()


def _finalize(vis, world_normals, alive, height: int, width: int):
    """Normal-hemisphere mask (dot_map, reference baking.py:232,307) and
    alive mask, applied once after all sweeps."""
    env_dirs = latlong_dirs(height, width, vis.device)
    dot_mask = torch.einsum("hwc,nc->nhw", env_dirs, world_normals)[..., None] > 0
    return torch.where(dot_mask, vis, torch.zeros_like(vis)) * alive[:, None, None, None]


def bake_config(capacity: int) -> RasterizerConfig:
    """The bake's rasterizer settings for `capacity` Gaussian slots: tile
    lists that hold every Gaussian (the module docstring says why)."""
    return RasterizerConfig(tile_capacity=capacity, chunk_tiles=4, max_tiles_per_gaussian=4)


#: the JAX module's bake lists, 256 instances a tile: the kernel tests' cap
DEFAULT_BAKE_CONFIG = bake_config(256)


def bake_occlusion(means3d, cov3d6, opacities, world_normals, alive, *, height: int = 16,
                   width: int = 32, grid_res: int = 10, max_cells: int = 128,
                   face_res: int = 32, config: RasterizerConfig | None = None):
    """Single-sweep bake: per-Gaussian [cap, H, W, 1] visibility (1 - occluder
    opacity), masked by the normal hemisphere, and `out_of_budget`: alive
    Gaussians whose voxel fell beyond the max_cells budget and kept full
    visibility 1.0 (counted, never silent; a 0-d device tensor).
    `bake_occlusion_full` covers every cell. Runs without grad (the
    reference bakes under no_grad, baking.py:230). `config` defaults to
    `bake_config` of the capacity."""
    max_cells = min(max_cells, grid_res ** 3)
    cap = means3d.shape[0]
    config = config or bake_config(cap)
    vis0 = torch.ones((cap, height, width, 1), dtype=torch.float32, device=means3d.device)
    with torch.no_grad(), annotate("mgh.pbr.sweep"):
        vis, oob = _bake_sweep(means3d, cov3d6, opacities, alive, vis0, 0, height=height,
                               width=width, grid_res=grid_res, max_cells=max_cells,
                               face_res=face_res, config=config)
        return _finalize(vis, world_normals, alive, height, width), oob


def bake_occlusion_full(means3d, cov3d6, opacities, world_normals, alive, *, height: int = 16,
                        width: int = 32, grid_res: int = 10, sweep_cells: int = 128,
                        face_res: int = 32, config: RasterizerConfig | None = None):
    """Full-coverage bake (reference parity: every occupied voxel gets an
    opacity cubemap, baking.py:145-202): sweeps the ranked cell order in
    `sweep_cells`-sized windows until every occupied cell is baked. Returns
    (vis, out_of_budget, n_sweeps); out_of_budget (a 0-d device tensor) is 0
    by construction. `config` defaults to `bake_config` of the capacity."""
    sweep_cells = min(sweep_cells, grid_res ** 3)
    cap = means3d.shape[0]
    config = config or bake_config(cap)
    with torch.no_grad():
        n_occ = count_occupied(means3d, alive, grid_res)
        vis = torch.ones((cap, height, width, 1), dtype=torch.float32, device=means3d.device)
        n_sweeps = max(1, -(-n_occ // sweep_cells))
        for s in range(n_sweeps):
            with annotate("mgh.pbr.sweep"):
                vis, oob = _bake_sweep(means3d, cov3d6, opacities, alive, vis, s * sweep_cells,
                                       height=height, width=width, grid_res=grid_res,
                                       max_cells=sweep_cells, face_res=face_res, config=config)
        return _finalize(vis, world_normals, alive, height, width), oob, n_sweeps


def occlusion_color(occlusion: torch.Tensor, envmap: torch.Tensor | None = None) -> torch.Tensor:
    """Reduce a per-Gaussian occlusion envmap [cap, H, W, 1] to the
    3-channel color fed to the rasterizer's occlusion channels
    (gaussian_renderer/__init__.py:152-165); `envmap` [H, W, 1 or 3] is a
    grayscale light."""
    if envmap is None:
        s = occlusion.sum(dim=(1, 2))
    else:
        occ = torch.clamp(occlusion, 0.0, 1.0) * envmap[None]
        s = torch.clamp(occ.sum(dim=(1, 2)), 0.0, 3.0)
        s = torch.clamp(s.mean(dim=-1, keepdim=True), 0.0, 1.0)
    return s.repeat(1, 3)
