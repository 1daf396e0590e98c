"""Process groups and collectives for the tile-sharded multi-device path
(port of parallel/mesh.py).

One process per rank. A `Mesh` lays the ranks out on named axes, row-major
as `np.reshape` lays out devices: ("data", "gauss", "tiles") from
`make_hybrid_mesh`, where "data" spans hosts (views in parallel; its only
collective is a once-per-step gradient sum) and the raster axes ("gauss",
"tiles") stay inside a host (the instance exchange and the strip gather of
every frame). `Mesh.group(axes)` is the process group over any subset of
the axes, one per combination of the other axes' coordinates.

Backend rule: ranks that share a device run a gloo group (NCCL refuses two
ranks on one card), ranks on distinct devices run NCCL. A failed NCCL
initialisation raises; nothing switches to gloo.

A gloo group carries every collective through host memory, always: the
wrapper copies a device tensor to the host, runs the collective there and
copies the result back. (Gloo's CUDA support differs between collectives
and releases; one path for all of them keeps the results identical.)

The collectives, each with its autograd (the JAX shard_map transposes):
  * `all_to_all`: split the leading axis over the group's ranks; its
    backward is the reverse all_to_all;
  * `all_gather`: concatenate the ranks' tensors along an axis; its
    backward sums the cotangent copies over the ranks and keeps the rank's
    slice (a reduce-scatter);
  * `psum` / `pmean`: sum (mean) over the group; the backward is a psum;
  * `pmax` (no gradient).
Every sum over ranks gathers the ranks' tensors and adds them in rank
order on every rank, so all ranks hold the same bits and a rerun repeats
them: no float atomics, no all-reduce whose order the library picks.

`STATS` counts each collective kind's calls, bytes handed over by this
rank, and seconds (wall clock; with `TIMED[0]` set, the device is
synchronised before and after each call so that the seconds are the
collective's own).
"""
from __future__ import annotations

import itertools
import math
import os
import time
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from mygauhuman_torch.device import resolve_device
from mygauhuman_torch.train.optim import is_gaussian_path, tree_map_with_path

AXES = ("data", "gauss", "tiles")
RASTER_AXES = AXES[1:]      # the Gaussian shards and the strips of a frame
STATS: dict = {}
TIMED = [False]


class Runtime(NamedTuple):
    rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    device: torch.device
    backend: str | None        # None: one process, no process group


_RUNTIME: list = [None]


def backend_for(device: torch.device, local_world_size: int) -> str:
    """gloo where ranks share a device (or run on the CPU), NCCL where each
    rank of a host has a card of its own."""
    if device.type != "cuda":
        return "gloo"
    return "gloo" if local_world_size > torch.cuda.device_count() else "nccl"


def init_distributed(init_method: str | None = None, *, rank: int | None = None,
                     world_size: int | None = None, local_rank: int | None = None,
                     local_world_size: int | None = None,
                     device: str | torch.device = "cuda") -> Runtime:
    """Join the process group of a multi-process run.

    Ranks and sizes come from the arguments, else from the launcher's
    environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`;
    `torch.distributed.run` sets them with `MASTER_ADDR` / `MASTER_PORT`,
    read by the default `env://` init); tests pass a `file://` store.
    Each rank's device is cuda:{LOCAL_RANK % device_count} (or the CPU).
    On one process with no launcher and no init_method it does nothing
    and returns the single-process runtime; once a group is up it returns
    that group's runtime."""
    if dist.is_initialized():
        return _RUNTIME[0]
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(env.get("RANK", 0)) if rank is None else rank
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    if local_world_size is None:
        local_world_size = int(env.get("LOCAL_WORLD_SIZE", world_size))
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if world_size == 1 and init_method is None:
        _RUNTIME[0] = Runtime(0, 1, 0, 1, dev, None)
        return _RUNTIME[0]
    backend = backend_for(dev, local_world_size)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size)
    _RUNTIME[0] = Runtime(rank, world_size, local_rank, local_world_size, dev, backend)
    if rank == 0:
        print(f"[mesh] backend {backend}: {world_size} ranks, {local_world_size} per host, "
              f"rank 0 on {dev}", flush=True)
    return _RUNTIME[0]


def runtime(device: str | torch.device = "cuda") -> Runtime:
    """The runtime init_distributed set up (the single process when it was
    not called)."""
    if _RUNTIME[0] is None:
        return init_distributed(device=device)
    return _RUNTIME[0]


class Group:
    """One process group of a Mesh, as seen by one of its ranks: the global
    ranks in axis order, this rank's index among them."""

    def __init__(self, ranks, me, pg, backend):
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(me)
        self.pg = pg
        self.staged = backend == "gloo"

    def __repr__(self):
        return f"Group(ranks={self.ranks}, index={self.index})"


class Mesh:
    """Ranks on named axes (row-major) and the process group of every
    subset of the axes. Every rank builds the same Mesh: process groups are
    created collectively, in the same order on every rank."""

    def __init__(self, shape, axis_names=AXES, rt: Runtime | None = None):
        rt = rt or runtime()
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} for axes {axis_names}")
        if math.prod(shape) != rt.world_size:
            raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the run has "
                             f"{rt.world_size}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.rank = rt.rank
        self.backend = rt.backend
        self.rank_coords = dict(zip(self.axis_names,
                                    (int(c) for c in np.unravel_index(rt.rank, shape))))
        grid = np.arange(rt.world_size).reshape(shape)
        self._groups = {}
        for r in range(1, len(shape) + 1):
            for axes in itertools.combinations(self.axis_names, r):
                self._groups[axes] = self._make_group(grid, axes)

    def _make_group(self, grid, axes) -> Group:
        keep = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(grid.ndim) if i not in keep]
        rows = np.transpose(grid, rest + keep).reshape(-1, math.prod(grid.shape[i]
                                                                     for i in keep))
        mine = None
        for row in rows:
            pg = None
            if len(row) > 1:
                pg = (dist.group.WORLD if len(row) == grid.size
                      else dist.new_group([int(r) for r in row]))
            if self.rank in row:
                mine = Group(row, self.rank, pg, self.backend)
        return mine

    def _axes(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes) -> Group:
        return self._groups[self._axes(axes)]

    def size(self, axes) -> int:
        return self.group(axes).size

    def index(self, axes) -> int:
        """This rank's index over the axes (row-major), JAX's axis_index."""
        return self.group(axes).index

    def __repr__(self):
        return f"Mesh({self.shape}, backend={self.backend})"


def make_mesh(n_data: int | None = None, n_gauss: int | None = None,
              rt: Runtime | None = None) -> Mesh:
    """A ("data", "gauss") mesh over every rank."""
    rt = rt or runtime()
    n = rt.world_size
    if n_data is None and n_gauss is None:
        n_data, n_gauss = 1, n
    elif n_data is None:
        n_data = n // n_gauss
    elif n_gauss is None:
        n_gauss = n // n_data
    if n_data * n_gauss != n:
        raise ValueError(f"mesh ({n_data}, {n_gauss}) over {n} ranks")
    return Mesh((n_data, n_gauss), ("data", "gauss"), rt)


def make_hybrid_mesh(rt: Runtime | None = None) -> Mesh:
    """("data", "gauss", "tiles") with "data" across hosts
    (WORLD_SIZE / LOCAL_WORLD_SIZE of them) and the raster axes inside a
    host: the local ranks split evenly between "gauss" and "tiles"
    (2 -> (1, 1, 2), 4 -> (1, 2, 2), 8 -> (1, 2, 4)), as the JAX mesh."""
    rt = rt or runtime()
    return Mesh(hybrid_mesh_shape(rt.world_size, rt.local_world_size), AXES, rt)


def hybrid_mesh_shape(world_size: int, local_world_size: int) -> tuple:
    """make_hybrid_mesh's (data, gauss, tiles) sizes."""
    if world_size % local_world_size:
        raise ValueError(f"{world_size} ranks are not whole hosts of {local_world_size}")
    n_hosts = world_size // local_world_size
    g = 1
    while local_world_size % (g * 2) == 0 and g * 2 <= local_world_size // (g * 2):
        g *= 2
    return (n_hosts, g, local_world_size // g)


# ---- the collectives -------------------------------------------------------------

def reset_stats() -> None:
    STATS.clear()


def _record(kind, nbytes, seconds):
    s = STATS.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
    s["calls"] += 1
    s["bytes"] += int(nbytes)
    s["seconds"] += seconds


def _sync(x):
    if TIMED[0] and x.is_cuda:
        torch.cuda.synchronize(x.device)


def _stage(group, x):
    x = x.detach()
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return (x.cpu() if group.staged else x).contiguous()


def _unstage(y, like):
    y = y.to(like.device)
    return y.bool() if like.dtype == torch.bool else y


def gather_raw(group: Group, x: torch.Tensor, kind: str = "all_gather") -> torch.Tensor:
    """[n, *x.shape]: every rank's x, in group order (no gradient)."""
    if group.size == 1:
        return x.detach()[None]
    _sync(x)
    t0 = time.perf_counter()
    src = _stage(group, x)
    parts = [torch.empty_like(src) for _ in range(group.size)]
    dist.all_gather(parts, src, group=group.pg)
    out = _unstage(torch.stack(parts), x)
    _sync(out)
    _record(kind, src.numel() * src.element_size(), time.perf_counter() - t0)
    return out


def all_to_all_raw(group: Group, x: torch.Tensor, kind: str = "all_to_all") -> torch.Tensor:
    """Chunk i of the leading axis [n, ...] goes to rank i; chunk j of the
    result came from rank j (no gradient)."""
    if x.shape[0] != group.size:
        raise ValueError(f"all_to_all of {x.shape[0]} chunks over {group.size} ranks")
    if group.size == 1:
        return x.detach()
    _sync(x)
    t0 = time.perf_counter()
    src = _stage(group, x)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group.pg)
    out = _unstage(out, x)
    _sync(out)
    _record(kind, src.numel() * src.element_size(), time.perf_counter() - t0)
    return out


def _ordered_sum(parts: torch.Tensor) -> torch.Tensor:
    acc = parts[0].clone()
    for p in parts[1:]:
        acc = acc + p
    return acc


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all_raw(group, x)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_raw(ctx.group, g.contiguous(), "all_to_all_bwd"), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, kind):
        ctx.group, ctx.dim, ctx.kind = group, dim, kind
        return torch.cat(tuple(gather_raw(group, x, kind)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.group, ctx.dim
        chunks = torch.stack(torch.chunk(g, group.size, dim=dim))
        return (_ordered_sum(all_to_all_raw(group, chunks, f"{ctx.kind}_bwd")), None, None,
                None)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ordered_sum(gather_raw(group, x, "psum"))

    @staticmethod
    def backward(ctx, g):
        return _ordered_sum(gather_raw(ctx.group, g, "psum_bwd")), None


def all_to_all(x: torch.Tensor, group: Group) -> torch.Tensor:
    """all_to_all_raw with its autograd (backward: the reverse exchange)."""
    return _AllToAll.apply(x, group) if group.size > 1 else x


def all_gather(x: torch.Tensor, group: Group, dim: int = 0,
               kind: str = "all_gather") -> torch.Tensor:
    """The ranks' x concatenated along dim, in group order (backward: the
    cotangent copies summed over the ranks, this rank's slice kept),
    recorded in STATS as `kind` (and `{kind}_bwd`)."""
    return _AllGather.apply(x, group, dim, kind) if group.size > 1 else x


def psum(x: torch.Tensor, group: Group) -> torch.Tensor:
    return _Psum.apply(x, group) if group.size > 1 else x


def pmean(x: torch.Tensor, group: Group) -> torch.Tensor:
    return psum(x, group) / group.size


def pmax(x: torch.Tensor, group: Group) -> torch.Tensor:
    return gather_raw(group, x, "pmax").amax(dim=0) if group.size > 1 else x


# ---- the sharded state ----------------------------------------------------------

class Sharded(NamedTuple):
    """A rank's share of a state tree (the port of a JAX tree placed by
    state_sharding and shard_tree): `local` is the tree with every
    per-Gaussian leaf cut to this rank's capacity slice, c = capacity / n
    rows of n ranks, and every other leaf whole; `capacity` is the whole
    tree's. The capacity is carried, never read off a leaf: on a share,
    `GaussianState.capacity` (alive's rows) is c."""
    local: Any
    capacity: int


def _per_gaussian(tree, rows):
    """The rule of the JAX state_sharding: a leaf is per-Gaussian when its
    leading dimension is `rows` (the capacity of a whole tree, a slice's
    rows in a share) and its path runs through the per-Gaussian subtree
    (every such leaf of a bare GaussianState or GaussianParams tree, which
    has no such ancestor). An MLP layer as wide as `rows` is not one."""
    paths = []
    tree_map_with_path(lambda p, x: paths.append(p), tree)
    bare = not any(is_gaussian_path(p) for p in paths)

    def per_g(path, x):
        if not (bare or is_gaussian_path(path)):
            return False
        if x.dim() >= 1 and x.shape[0] == rows:
            return True
        if not bare:
            raise ValueError(f"leaf {path} of shape {tuple(x.shape)} on a per-Gaussian path "
                             f"does not have {rows} rows")
        return False

    return per_g


def state_slice(tree: Any, capacity: int, index: int, count: int) -> Any:
    """This rank's capacity slice [index c, (index + 1) c), c = capacity /
    count, of every per-Gaussian leaf, copied (the whole leaf's storage is
    not kept); the other leaves as they are."""
    if capacity % count:
        raise ValueError(f"capacity {capacity} does not split over {count} ranks")
    c = capacity // count
    per_g = _per_gaussian(tree, capacity)
    return tree_map_with_path(
        lambda p, x: x[index * c:(index + 1) * c].clone() if per_g(p, x) else x, tree)


def per_gaussian_nbytes(tree: Any, rows: int) -> int:
    """Bytes of the tree's per-Gaussian leaves of `rows` rows."""
    per_g = _per_gaussian(tree, rows)
    total = [0]

    def add(p, x):
        if per_g(p, x):
            total[0] += x.numel() * x.element_size()

    tree_map_with_path(add, tree)
    return total[0]


class StateSharding:
    """The port of state_sharding + shard_tree: per-Gaussian leaves split
    over `group`'s ranks in group order, every other leaf replicated.

    `shard` cuts a whole tree into this rank's `Sharded` share and `gather`
    puts the whole tree together again on every rank: one all_gather of
    the share's per-Gaussian leaves, packed bit for bit into one byte
    matrix, recorded as `state_gather` in STATS. Every rank of the group
    must join each gather. `num_alive` is the whole state's alive count
    (a psum of the shares')."""

    def __init__(self, group: Group):
        self.group = group

    def rows(self, capacity: int) -> int:
        n = self.group.size
        if capacity % n:
            raise ValueError(f"capacity {capacity} does not split over {n} ranks")
        return capacity // n

    def shard(self, tree: Any, capacity: int) -> Sharded:
        return Sharded(state_slice(tree, capacity, self.group.index, self.group.size),
                       int(capacity))

    def gather(self, sh: Sharded) -> Any:
        if not isinstance(sh, Sharded):
            raise TypeError(f"gather takes a Sharded share, got {type(sh).__name__}")
        rows = self.rows(sh.capacity)
        per_g = _per_gaussian(sh.local, rows)
        leaves = []
        tree_map_with_path(lambda p, x: leaves.append(x) if per_g(p, x) else None, sh.local)
        if not leaves:
            return sh.local
        # each leaf's rows as raw bytes: any dtype, every bit kept
        cols = [x.contiguous().reshape(rows, math.prod(x.shape[1:])).view(torch.uint8)
                for x in leaves]
        flat = torch.cat(cols, dim=1)
        flat = gather_raw(self.group, flat, "state_gather").reshape(sh.capacity, -1)
        whole, col = [], 0
        for x, c in zip(leaves, cols):
            shape = (sh.capacity,) + tuple(x.shape[1:])
            if c.shape[1] == 0:     # no columns (features_rest at SH degree 0)
                whole.append(x.new_empty(shape))
                continue
            part = flat[:, col:col + c.shape[1]].contiguous().view(x.dtype)
            whole.append(part.reshape(shape))
            col += c.shape[1]
        it = iter(whole)
        return tree_map_with_path(lambda p, x: next(it) if per_g(p, x) else x, sh.local)

    def num_alive(self, sh: Sharded) -> int:
        n = sh.local.gauss.alive.sum().reshape(1)
        return int(gather_raw(self.group, n, "psum").sum())
