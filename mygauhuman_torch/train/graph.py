"""Train from captured CUDA graphs of the branch-A step: the port's
counterpart of the JAX trainer's donated, jitted step and its chunk program.

The JAX package jits the step with the state donated (its buffers are
updated in place), and `step.chunk` runs up to K iterations as one device
program: a `fori_loop` of the step over an index vector into a `[V, ...]`
stack of the views. On a CUDA stream the counterpart is a
`torch.cuda.CUDAGraph` of the whole step (forward, `autograd.grad`, the
freeze mask, Adam, the densify statistics): `GraphedTrainStep` captures it
once per key and replays it, so an iteration costs the host a few staging
copies and one graph launch instead of the ~3,700 launches of an eager
step, and `chunk` replays it once per iteration of the chunk with no host
sync in between.

The state. The graphs read the state from tensors the graphed step owns
and, at the end of each step, copy the new state into them: the state a
call returns is consumed by the next call, as a donated JAX state is. A
call whose state is not those tensors (the first one, or one after a
densify event or an opacity reset made new tensors) copies it in first,
leaf by leaf. A state of other shapes (a capacity growth) gets new tensors,
and every graph, which read the old ones, is released.

Staged inputs. Before each replay the step's view is copied into the key's
static batch tensors (in `chunk`, from the `[V, ...]` stack of
`stack_views`), and the row of Adam's scalars for this update
(train/optim.py::Adam.staged_rows: each group's bias corrections and lr)
into the key's static row; a chunk's rows reach the card in one copy from
pinned memory. The metrics are stacked inside the graph, one vector per
dtype, and copied to the chunk's `[pad_to, ...]` buffers after each replay:
the graphs share one memory pool, so the next replay may overwrite them.

Keys. A graph bakes in what the step computes on the host: the image size,
the fovs (through the focal lengths), the capacities, the SH degree and
whether the geometry is frozen. So graphs are keyed by (width, height,
tan_fovx, tan_fovy, Gaussian capacity, instance capacity, SH degree,
frozen, staged shapes): one per camera fov, capacity and SH degree.

Before each capture one eager step runs on the capture's side stream on
the staged inputs, its results discarded (the state does not advance): it
builds the kernels' libraries, sizes the cuDNN and cuBLAS workspaces and
runs autograd's backward on that stream. A capture or replay that fails
raises; there is no eager fallback on the card. On CPU tensors the same
staging runs and the step runs eagerly, its result copied into the state's
tensors as a replay's is.

Branch B's step (train/pbr.py::GraphedPbrStep) is this class with another
state: the graphs own (TrainState, PbrState, knn3, prefilter weights), and
the hooks `_staged_rows`, `_train_state` and `_advanced` give its staged
rows (both optimisers'), its TrainState and its host values after k steps.

`cuda_lib.LAUNCHES` counts the wrappers' Python calls, which a replay does
not make: the launches a capture recorded are kept per key (`launches`)
and added on every replay; the capture itself (which runs nothing) adds
none, and the warm-up step (which runs) adds its own.

Spans (utils/profiling.py), host code only: `mgh.train.adopt` (the state
copied in, or new tensors), `mgh.train.rows` (the Adam rows' pinned copy),
per step `mgh.train.stage` (the view's and Adam row's copies) and
`mgh.train.replay` (the replay, or the eager step on the CPU, and the
metric row's copy), and `mgh.train.capture[<key>]` (warm-up and capture;
`captures` and `capture_s` count them).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple

import torch

from mygauhuman_torch.ops import cuda_lib
from mygauhuman_torch.train.optim import tree_leaves, tree_map
from mygauhuman_torch.utils.profiling import annotate


class StepKey(NamedTuple):
    width: int
    height: int
    tan_fovx: float
    tan_fovy: float
    capacity: int              # Gaussian slots
    instance_capacity: int | None
    active_sh_degree: int
    frozen: bool               # geometry frozen (past pbr_iteration)
    shapes: tuple              # the staged batch tensors' shapes


class ViewStack(NamedTuple):
    """The training views for `GraphedTrainStep.chunk`, each a TrainBatch
    of rows of one [V, ...] tensor per leaf, with its own camera fovs and
    size (`views`), and its tensor leaves in `tree_leaves` order
    (`leaves`)."""

    views: tuple
    leaves: tuple


def _with_camera(batch, camera):
    """`batch` with the camera's host values (fovs, size) of `camera`."""
    return batch._replace(camera=dataclasses.replace(
        batch.camera, tan_fovx=camera.tan_fovx, tan_fovy=camera.tan_fovy,
        width=camera.width, height=camera.height))


def _empty_as(x: torch.Tensor, rows: int | None = None, device=None) -> torch.Tensor:
    """An uninitialised tensor with x's shape, dtype and strides (those of a
    contiguous one where x overlaps itself), or `rows` of them stacked on a
    new first dimension, each with x's strides. On the card the kernels a
    step launches on an input, and so its bits, can depend on its strides
    (a planar image, a column slice), so staged copies keep them."""
    stride = x.stride() if all(st > 0 for st, n in zip(x.stride(), x.shape) if n > 1) \
        else x.contiguous().stride()
    device = x.device if device is None else device
    if rows is None:
        return torch.empty_strided(x.shape, stride, dtype=x.dtype, device=device)
    span = 1 + sum((n - 1) * st for n, st in zip(x.shape, stride))
    return torch.empty_strided((rows, *x.shape), (span, *stride), dtype=x.dtype, device=device)


def _stack(xs) -> torch.Tensor:
    out = _empty_as(xs[0], len(xs))
    for row, x in zip(out, xs):
        row.copy_(x)
    return out


def stack_views(batches: list) -> ViewStack:
    """One [V, ...] device stack of the training views (the JAX loop's
    `views`), each view's camera host values kept beside it, each row with
    its view's strides (`_empty_as`). Raises ValueError if the views' tensors
    differ in shape."""
    first = batches[0].camera
    try:
        stacked = tree_map(lambda *xs: _stack(xs), *[_with_camera(b, first)
                                                     for b in batches])
    except (RuntimeError, ValueError) as e:
        raise ValueError("the views do not stack into one [V, ...] tensor per leaf (other "
                         "shapes or host values); train them with scan_chunk=1") from e
    views = tuple(_with_camera(tree_map(lambda x, v=v: x[v], stacked), b.camera)
                  for v, b in enumerate(batches))
    return ViewStack(views, tuple(tree_leaves(v) for v in views))


class _Slot:
    """One key's static inputs (a TrainBatch of static tensors with the
    key's host values, the Adam row) and, on CUDA, its graph, its stacked
    metric outputs and the launches its capture recorded."""

    def __init__(self, batch, adam_row: torch.Tensor):
        self.batch = batch
        self.leaves = tree_leaves(batch)
        self.adam_row = adam_row
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out: dict | None = None
        self.launches: dict[str, int] = {}


class GraphedTrainStep:
    """The branch-A step served from captured CUDA graphs on the card (run
    eagerly on the CPU): `step(ts, batch, deg)` and `step.chunk(ts, views,
    idx, deg, pad_to)`. See the module docstring.

    `apply(ts, batch, deg, staged=, frozen=)` is the functional step
    (train/trainer.py::make_train_step's) with Adam's scalars read from
    `staged`; `tx` the Adam whose staged rows it reads; `frozen_from` the
    iteration from which the geometry is frozen (cfg.pbr_iteration)."""

    def __init__(self, apply: Callable, tx, *, frozen_from: int,
                 instance_capacity: int | None):
        self.apply = apply
        self.tx = tx
        self.frozen_from = frozen_from
        self.instance_capacity = instance_capacity
        self.state = None                  # the TrainState over `leaves`
        self.leaves: list[torch.Tensor] = []
        self.device: torch.device | None = None
        self.slots: dict[StepKey, _Slot] = {}
        self.captures = 0                  # graphs captured so far (released ones too)
        self.released = 0                  # graphs released by capacity changes
        self.capture_s = 0.0               # seconds of warm-ups and captures
        self.pool = None
        self.stream = None

    @property
    def graphed(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    @property
    def launches(self) -> dict[StepKey, dict[str, int]]:
        """Kernel launches per replay of each live captured key."""
        return {k: dict(s.launches) for k, s in self.slots.items() if s.graph is not None}

    def record(self) -> dict:
        """What the graphs cost: captures (each after one eager warm-up
        step), graphs released, seconds of warm-ups and captures, and the
        launches per replay of each live key."""
        return {"captures": self.captures, "released": self.released,
                "capture_s": self.capture_s,
                "launches_per_replay": [dict(k._asdict(), launches=v)
                                        for k, v in self.launches.items()]}

    def __call__(self, ts, batch, active_sh_degree: int):
        """One step -> (new ts, metrics: 0-d tensors of this call's own)."""
        ts, (mseq, _) = self._run(ts, [(batch, tree_leaves(batch))], active_sh_degree, 1)
        return ts, {k: v[0] for k, v in mseq.items()}

    def chunk(self, ts, views: ViewStack, idx, active_sh_degree: int, pad_to: int = 0):
        """len(idx) steps on views `idx` of the stack -> (ts, (metrics
        stacked [max(pad_to, len(idx))] with the first len(idx) rows live,
        len(idx))), as the JAX chunk program."""
        items = [(views.views[i], views.leaves[i]) for i in idx]
        return self._run(ts, items, active_sh_degree, max(pad_to, len(items)))

    # ---- the state ---------------------------------------------------------

    def _adopt(self, ts) -> None:
        """Make the graph's tensors hold `ts` (see the module docstring)."""
        leaves = tree_leaves(ts)
        same = (self.state is not None and len(leaves) == len(self.leaves) and all(
            a.shape == b.shape and a.dtype == b.dtype and a.device == b.device
            for a, b in zip(leaves, self.leaves)))
        if same:
            for dst, src in zip(self.leaves, leaves):
                if src is not dst:
                    dst.copy_(src)
        else:
            self._release()
            self.leaves = [x.detach().clone() for x in leaves]
            self.device = leaves[0].device
        it = iter(self.leaves)
        self.state = tree_map(lambda _: next(it), ts)

    def _release(self) -> None:
        """Drop every graph: they read the tensors being replaced."""
        for slot in self.slots.values():
            if slot.graph is not None:
                slot.graph.reset()
                self.released += 1
        self.slots.clear()
        self.pool = None

    # ---- a run of steps ------------------------------------------------------

    def _run(self, ts, items: list, deg: int, pad_to: int):
        with annotate("mgh.train.adopt"):
            self._adopt(ts)
        k = len(items)
        dev = self.device
        with annotate("mgh.train.rows"):
            rows = torch.from_numpy(self._staged_rows(ts, k))
            if self.graphed:
                # one copy per run; the pinned block is not reused before it lands
                rows = rows.pin_memory().to(dev, non_blocking=True)
        step = self._train_state(ts).step
        bufs: dict = {}
        for t, (batch, leaves) in enumerate(items):
            with annotate("mgh.train.stage"):
                slot, key = self._slot(batch, leaves, deg, step + t >= self.frozen_from,
                                       tuple(rows.shape[1:]))
                for dst, src in zip(slot.leaves, leaves):
                    dst.copy_(src)
                slot.adam_row.copy_(rows[t])
            if self.graphed and slot.graph is None:
                self._capture(slot, key)
            with annotate("mgh.train.replay"):
                if not self.graphed:
                    out = self._program(slot, key, write=True)
                else:
                    slot.graph.replay()
                    cuda_lib.count_replay(slot.launches)
                    out = slot.out
                for dtype, (names, vec) in out.items():
                    if dtype not in bufs:
                        bufs[dtype] = (names, torch.zeros((pad_to, len(names)), dtype=dtype,
                                                          device=dev))
                    bufs[dtype][1][t].copy_(vec)
        mseq = {name: buf[:, j] for names, buf in bufs.values() for j, name in enumerate(names)}
        self.state = self._advanced(self.state, k)
        return self.state, (mseq, k)

    # ---- what a subclass with another state changes --------------------------

    def _staged_rows(self, state, k: int):
        """[k, rows, len(STAGED)] float32: the staged rows of k steps."""
        return self.tx.staged_rows(state.opt_state.count, k)

    @staticmethod
    def _train_state(state):
        """The TrainState of the adopted state."""
        return state

    def _advanced(self, state, k: int):
        """The state's host values after k steps (tensors unchanged)."""
        count = {g: c + k for g, c in state.opt_state.count.items()}
        return state._replace(step=state.step + k,
                              opt_state=state.opt_state._replace(count=count))

    def _slot(self, batch, leaves: list, deg: int, frozen: bool, row_shape: tuple
              ) -> tuple[_Slot, StepKey]:
        cam = batch.camera
        key = StepKey(int(cam.width), int(cam.height), float(cam.tan_fovx),
                      float(cam.tan_fovy), self._train_state(self.state).gauss.capacity,
                      self.instance_capacity, int(deg), bool(frozen),
                      tuple(tuple(x.shape) for x in leaves))
        slot = self.slots.get(key)
        if slot is None:
            static = tree_map(lambda x: _empty_as(x, device=self.device), batch)
            slot = self.slots[key] = _Slot(static, torch.empty(row_shape, dtype=torch.float32,
                                                               device=self.device))
        return slot, key

    def _program(self, slot: _Slot, key: StepKey, write: bool) -> dict:
        """The captured program: the step on the static inputs, its new state
        copied into the graph's tensors (write=True), its metrics stacked per
        dtype -> {dtype: (names, [M] tensor)}."""
        new, metrics = self.apply(self.state, slot.batch, key.active_sh_degree,
                                  staged=slot.adam_row, frozen=key.frozen)
        if write:
            for dst, src in zip(self.leaves, tree_leaves(new)):
                if src is not dst:
                    dst.copy_(src)
        groups: dict = {}
        for name, v in metrics.items():
            names, vals = groups.setdefault(v.dtype, ([], []))
            names.append(name)
            vals.append(v)
        return {dtype: (names, torch.stack(vals)) for dtype, (names, vals) in groups.items()}

    def _capture(self, slot: _Slot, key: StepKey) -> None:
        """Warm up on the side stream (results discarded), then capture one
        step on it."""
        t0 = time.perf_counter()
        with annotate(f"mgh.train.capture[{key.width}x{key.height} fov "
                      f"{key.tan_fovx:.4f},{key.tan_fovy:.4f}]"):
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            if self.stream is None:
                self.stream = torch.cuda.Stream(self.device)
            slot.graph, slot.out, slot.launches = cuda_lib.capture_graph(
                lambda: self._program(slot, key, write=False),
                lambda: self._program(slot, key, write=True), self.stream, self.pool)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
