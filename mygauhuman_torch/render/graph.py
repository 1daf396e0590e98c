"""Serve frames from captured CUDA graphs: one captured program per camera
size and branch, replayed for every request.

The JAX package jits `render_frame` with the camera's matrices as traced
inputs and its width and height static, so one compiled program serves
every camera of one size, and `cli.render` / `bench.py` time a jitted loop
of frames. On a CUDA stream the counterpart is a `torch.cuda.CUDAGraph`:
`GraphedRenderer` captures `render_frame` once per key and replays it, so a
frame costs a few copies and one graph launch from the host instead of the
hundreds of launches an eager frame sends.

Each request copies its inputs into static buffers with stream-ordered
`copy_` (the camera's `w2c`, `full_proj` and `cam_center`, the frame's SMPL
and big-pose parameters and big-pose vertices, the replay `transforms` and
`translation`, and a 0-d fp32 opacity epsilon that the frame adds to the
opacity logits), then replays. The result's tensors are the graph's static
outputs: the next call overwrites them, so a caller consumes (or clones)
each result before it asks for the next.

A graph bakes in everything its frame computes on the host: the image size,
the fovs (through the focal lengths), the capacities, the SH degree and the
branch. So graphs are keyed by (branch, width, height, tan_fovx, tan_fovy,
Gaussian capacity, instance capacity, active_sh_degree, the input shapes);
a key miss captures a new graph, and a graph never serves a camera it was
not captured for. The graphs of one renderer share one memory pool, which
is safe because every graph runs on one stream and every result is dead by
the next call.

Before each capture one eager frame runs on the capture's side stream: it
builds the kernels' libraries and sizes the library workspaces, as
PyTorch's notes on CUDA graphs prescribe. A capture or replay that fails
raises; there is no eager fallback on the card. On CPU tensors the same
staging runs and the frame runs eagerly, as every op follows its inputs'
device.

`cuda_lib.LAUNCHES` counts the wrappers' Python calls, which a replay does
not make: the launches a capture records are kept per key (`launches`) and
added on every replay, and the capture itself (which runs nothing) adds
none.

Spans (utils/profiling.py), host code only: `mgh.render.stage`,
`mgh.render.capture` (on a key miss) and `mgh.render.replay` (the replay,
or the eager frame on the CPU). A caller that wants a frame's device time
records a pair of CUDA events around the call, as `cli.render` does.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from mygauhuman_torch.data.camera import Camera
from mygauhuman_torch.models.gaussians import GaussianState
from mygauhuman_torch.models.smpl import SMPLModel
from mygauhuman_torch.ops import cuda_lib
from mygauhuman_torch.ops.rasterize import RasterizerConfig
from mygauhuman_torch.render.renderer import FrameInputs, RenderResult, render_frame
from mygauhuman_torch.utils.profiling import annotate


class GraphKey(NamedTuple):
    branch: str               # "deform" or "replay"
    width: int
    height: int
    tan_fovx: float
    tan_fovy: float
    capacity: int             # Gaussian slots
    instance_capacity: int | None
    active_sh_degree: int
    shapes: tuple             # (name, shape) of every staged input


class _Slot:
    """One key's static inputs and, on CUDA, its graph, static outputs and
    the launches its capture recorded."""

    def __init__(self, inputs: dict):
        self.inputs = inputs
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out: RenderResult | None = None
        self.launches: dict[str, int] = {}


def _request(camera: Camera, frame: FrameInputs, transforms, translation, opacity_eps):
    """The request's tensors by staged name (flat, sorted)."""
    req = {"cam.w2c": camera.w2c, "cam.full_proj": camera.full_proj,
           "cam.cam_center": camera.cam_center, "opacity_eps": opacity_eps}
    for k, v in frame.smpl_param.items():
        req[f"smpl_param.{k}"] = v
    for k, v in frame.big_pose_param.items():
        req[f"big_pose_param.{k}"] = v
    req["big_pose_verts"] = frame.big_pose_verts
    if transforms is not None and translation is not None:
        req["transforms"] = transforms
        req["translation"] = translation
    return dict(sorted(req.items()))


class GraphedRenderer:
    """`render_frame` of one Gaussian state, served from captured CUDA
    graphs on the card (eagerly on the CPU). See the module docstring."""

    def __init__(self, state: GaussianState, smpl_model: SMPLModel, *, bg: torch.Tensor,
                 active_sh_degree: int, config: RasterizerConfig = RasterizerConfig(),
                 mlp_params: dict | None = None):
        self.state = state
        self.smpl_model = smpl_model
        self.bg = bg
        self.active_sh_degree = int(active_sh_degree)
        self.config = config
        self.mlp_params = mlp_params
        self.device = state.alive.device
        self.graphed = self.device.type == "cuda"
        self.slots: dict[GraphKey, _Slot] = {}
        if self.graphed:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)

    @property
    def launches(self) -> dict[GraphKey, dict[str, int]]:
        """Kernel launches per replay of each captured key."""
        return {k: dict(s.launches) for k, s in self.slots.items() if s.graph is not None}

    @property
    def captures(self) -> int:
        """Graphs captured so far (0 on the CPU)."""
        return sum(s.graph is not None for s in self.slots.values())

    def _key(self, camera: Camera, request: dict) -> GraphKey:
        shapes = tuple((n, tuple(t.shape) if isinstance(t, torch.Tensor) else ())
                       for n, t in request.items())
        return GraphKey("replay" if "transforms" in request else "deform",
                        int(camera.width), int(camera.height), float(camera.tan_fovx),
                        float(camera.tan_fovy), self.state.capacity,
                        self.config.instance_capacity, self.active_sh_degree, shapes)

    def __call__(self, camera: Camera, frame: FrameInputs, *,
                 transforms: torch.Tensor | None = None,
                 translation: torch.Tensor | None = None,
                 opacity_eps: Any = 0.0) -> RenderResult:
        """Render one view. The returned tensors are overwritten by the
        next call on CUDA: consume or clone them first."""
        request = _request(camera, frame, transforms, translation, opacity_eps)
        key = self._key(camera, request)
        slot = self.slots.get(key)
        if slot is None:
            slot = self.slots[key] = _Slot({
                n: (torch.empty((), dtype=torch.float32, device=self.device)
                    if n == "opacity_eps" else torch.empty_like(t, device=self.device))
                for n, t in request.items()})
        with annotate("mgh.render.stage"):
            self._stage(slot, request)
        if self.graphed and slot.graph is None:
            with annotate("mgh.render.capture"):
                self._capture(slot, key)
        with annotate("mgh.render.replay"):
            if not self.graphed:
                with torch.no_grad():
                    return self._frame(slot.inputs, key)
            slot.graph.replay()
            cuda_lib.count_replay(slot.launches)
        return slot.out

    @staticmethod
    def _stage(slot: _Slot, request: dict) -> None:
        for name, src in request.items():
            dst = slot.inputs[name]
            if isinstance(src, torch.Tensor):
                dst.copy_(src)
            else:
                dst.fill_(float(src))    # a host number: a fill, not a host copy

    def _frame(self, inp: dict, key: GraphKey) -> RenderResult:
        """The captured program: render_frame on the static inputs."""
        p = self.state.params
        state = self.state._replace(params=p._replace(opacity=p.opacity + inp["opacity_eps"]))
        camera = Camera(w2c=inp["cam.w2c"], full_proj=inp["cam.full_proj"],
                        cam_center=inp["cam.cam_center"], tan_fovx=key.tan_fovx,
                        tan_fovy=key.tan_fovy, width=key.width, height=key.height)

        def group(prefix):
            return {n[len(prefix):]: t for n, t in inp.items() if n.startswith(prefix)}

        frame = FrameInputs(smpl_param=group("smpl_param."),
                            big_pose_param=group("big_pose_param."),
                            big_pose_verts=inp["big_pose_verts"])
        replay = {}
        if key.branch == "replay":
            replay = dict(transforms=inp["transforms"], translation=inp["translation"])
        return render_frame(state, camera, frame, self.smpl_model, bg=self.bg,
                            active_sh_degree=self.active_sh_degree,
                            mlp_params=self.mlp_params, config=self.config, **replay)

    def _capture(self, slot: _Slot, key: GraphKey) -> None:
        """Warm up on the side stream, then capture one frame on it."""
        def frame():
            with torch.no_grad():
                return self._frame(slot.inputs, key)

        slot.graph, slot.out, slot.launches = cuda_lib.capture_graph(frame, frame, self.stream,
                                                                     self.pool)
