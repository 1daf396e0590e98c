"""The `serve` mixes: one viewer animating a trained avatar, a closed loop
with one client, through the port's `GraphedRenderer` (one captured graph:
one camera size and fov, one branch).

Request i is the next frame: the camera at orbit position i mod `orbit`
(the test camera's intrinsics), and either the motion's frame i (the
deform branch) or test pose i mod `poses` with its cached transforms (the
replay branch, which the benchmark makes with its own plain LBS), each
with `bench_torch.py`'s opacity epsilon 1e-12 i in float32 so that every
frame is new work. The request's image (RGB and alpha) is copied into host
memory before the next one is sent: that copy is the frame a viewer
shows. A request's latency runs from its sending to its image in host
memory; `render_fps` counts the frames whose image arrived inside the
window.

In a traced run `trace_frames` more requests follow the window under the
profiler. A seeded reservoir keeps `check_frames` of the window's frames. After the
window the program is freed and the reference renders each kept request;
the numbers compared are the largest absolute gap over their pixels of the
RGB image and of the alpha.
"""
from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from port_bench.counts import step as FL
from port_bench.harness import inputs as I
from port_bench.harness import program as P
from port_bench.harness.record import Run, median_work
from port_bench.harness.trace import Trace
from port_bench.reference import render as RR
from port_bench.reference.deform import deform
from port_bench.reference.precision import precision


def frame_eps(i: int) -> float:
    """`bench_torch.py::frame_eps`: 1e-12 * float32(i), in float32."""
    return float(np.float32(1e-12) * np.float32(i))


class Requests:
    """The traffic as device tensors, made in set-up: the orbit's cameras,
    the motion's poses or the test poses with their cached transforms."""

    def __init__(self, cfg: dict, traffic: dict, scene: I.Scene, model: dict, seed: int,
                 device):
        self.branch = traffic["branch"]
        cams = cfg["cameras"]
        W, H = cfg["frame"]["width"], cfg["frame"]["height"]
        focal = cams["focal_px"] * cams["test_focal_scale"]
        n = traffic["orbit"]
        self.cameras = [I.camera(I.B.orbit_eye(scene.center, cams["radius_m"],
                                               2 * math.pi * k / n),
                                 scene.center, W, H, focal, device) for k in range(n)]
        self.scene = scene
        self.shapes = torch.zeros(scene.n_shape, device=device)
        if self.branch == "deform":
            self.poses = torch.as_tensor(I.motion(cfg, traffic, seed, traffic["motion"]["frames"]),
                                         device=device)
            self.cached = None
        else:
            prng = I.host_rng(cfg["capture_seed"], 8)
            poses = [I.seeded_pose(prng, scene.kind, cfg["poses"]["sigma_rad"])
                     for _ in range(cfg["poses"]["test"])]
            self.poses = torch.as_tensor(np.stack([p for p, _ in poses]), device=device)
            self.cached = []
            with torch.no_grad(), precision():
                for k in range(self.poses.shape[0]):
                    _, _, tf, tr = deform(scene.body, model["params"]["xyz"],
                                          model["params"]["normal"], self.frame_ref(k),
                                          scene.big, scene.big_verts, model["mlps"])
                    keep = model["alive"][:, None]
                    self.cached.append((torch.where(keep[..., None], tf, 0.0).contiguous(),
                                        torch.where(keep, tr, 0.0).contiguous()))

    def pose_index(self, i: int) -> int:
        return i % self.poses.shape[0]

    def frame_ref(self, k: int) -> dict:
        return self.scene.frame(self.poses[k], self.shapes)

    def request(self, i: int) -> dict:
        k = self.pose_index(i)
        req = {"camera": self.cameras[i % len(self.cameras)], "frame": self.frame_ref(k),
               "eps": frame_eps(i)}
        if self.cached is not None:
            req["transforms"], req["translation"] = self.cached[k]
        return req


def reference_frame(cfg: dict, scene: I.Scene, model: dict, reqs: Requests, i: int,
                    tf32: bool = False):
    """The reference's frame of request i (in TF32 for the control)."""
    rq = reqs.request(i)
    with torch.no_grad(), precision(tf32):
        return RR.render(model["params"], model["alive"], rq["camera"], rq["frame"],
                         scene.body, sh_degree=cfg["sh_degree"],
                         mlp=model["mlps"] if reqs.branch == "deform" else None,
                         raster=model["raster"], bg=torch.zeros(3, device=model["alive"].device),
                         transforms=rq.get("transforms"), translation=rq.get("translation"),
                         opacity_eps=rq["eps"])


def gaps(f, rgb, alpha) -> tuple[float, float]:
    """The largest absolute gaps of a served image and alpha to the
    reference's frame `f`."""
    return (float((f.render.cpu() - rgb.cpu()).abs().max()),
            float((f.alpha.cpu() - alpha.cpu()).abs().max()))


def run(cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool, device,
        t_process: float) -> tuple[Run, dict]:
    cuda = device.type == "cuda"
    scene = I.Scene(cfg, seed, device)
    model = I.served_model(cfg, scene, seed, device)
    reqs = Requests(cfg, traffic, scene, model, seed, device)
    if cuda:
        P.cuda_lib.build()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    server = P.renderer(model, scene.body, cfg["sh_degree"], reqs.branch)
    cams = [P.camera(c) for c in reqs.cameras]
    frames = [P.frame(reqs.frame_ref(k)) for k in range(reqs.poses.shape[0])]
    H, W = cfg["frame"]["height"], cfg["frame"]["width"]
    pin = dict(pin_memory=True) if cuda else {}
    rgb_host = torch.empty((H, W, 3), **pin)
    alpha_host = torch.empty((H, W), **pin)
    trace = Trace() if traced else None

    def serve(i: int) -> tuple[float, float]:
        """One request -> (seconds inside the renderer's call, latency)."""
        k = reqs.pose_index(i)
        extra = {}
        if reqs.cached is not None:
            extra = dict(zip(("transforms", "translation"), reqs.cached[k]))
        t0 = time.perf_counter()
        out = server(cams[i % len(cams)], frames[k], opacity_eps=frame_eps(i), **extra)
        t1 = time.perf_counter()
        rgb_host.copy_(out.render, non_blocking=cuda)
        alpha_host.copy_(out.render_alpha, non_blocking=cuda)
        if cuda:
            torch.cuda.current_stream(device).synchronize()
        return t1 - t0, time.perf_counter() - t0

    with torch.no_grad():
        for i in range(traffic["warmup_frames"]):
            serve(i)
        rng = np.random.default_rng([int(seed) % (2 ** 63), 9])
        K = traffic["check_frames"]
        kept: list = []
        lat, call = [], []
        t_start = time.perf_counter()
        deadline = t_start + seconds
        i = done = 0
        while True:
            c, l_ = serve(i)
            now = time.perf_counter()
            call.append(c)
            lat.append(l_)
            if now <= deadline:
                done += 1
            slot = i if i < K else int(rng.integers(0, i + 1))
            if slot < K:
                item = (i, rgb_host.numpy().copy(), alpha_host.numpy().copy())
                if len(kept) < K:
                    kept.append(item)
                else:
                    kept[slot] = item
            i += 1
            if now >= deadline:
                break
        attempted = i
        if trace is not None:
            # the traced stretch follows the window, so that the profiler
            # costs the window nothing
            trace.start()
            for j in range(i, i + traffic["trace_frames"]):
                with Trace.span("request"):
                    serve(j)
            trace.stop()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del server, cams, frames
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference renders each kept request
    gaps_rgb, gaps_alpha, work = [], [], []
    for i, rgb, alpha in sorted(kept, key=lambda x: x[0]):
        f = reference_frame(cfg, scene, model, reqs, i)
        g_rgb, g_alpha = gaps(f, torch.from_numpy(rgb), torch.from_numpy(alpha))
        gaps_rgb.append(g_rgb)
        gaps_alpha.append(g_alpha)
        print(f"[check] request {i}: rgb gap {g_rgb:.3e}, alpha gap {g_alpha:.3e}, "
              f"overflow {f.work['overflow']}", file=sys.stderr)
        work.append(f.work)
    numbers = {"rgb_gap": max(gaps_rgb), "alpha_gap": max(gaps_alpha)}
    run_ = Run(kind="serve", seconds=seconds, setup_s=t_start - t_process, units=done,
               latencies_s=lat, call_host_s=call,
               trace=trace if trace is not None and trace.window_s > 0 else None,
               traced_units=traffic["trace_frames"], work=work,
               live=int(model["alive"].sum()), vertices=cfg["body"]["vertices"])
    run_.extra.update(peak_bytes=peak, attempted=attempted)
    run_.flops_per_unit = FL.render_frame(work=median_work(work), n=run_.live,
                                          vertices=run_.vertices,
                                          joints=len(scene.body["parents"]),
                                          branch=reqs.branch)
    return run_, numbers


def readings(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """`control.py`'s readings of one seed, each put in the program's place
    and judged by the run's comparison against the reference's frames of
    `check_frames` seeded requests of a window's range: `tf32` (the
    reference in TF32, the control), `stale` (each request answered with
    the frame of the request before it) and `pixel` (one pixel of each
    frame altered by 0.25 where it is produced)."""
    scene = I.Scene(cfg, seed, device)
    model = I.served_model(cfg, scene, seed, device)
    reqs = Requests(cfg, traffic, scene, model, seed, device)
    rng = np.random.default_rng([int(seed) % (2 ** 63), 11])
    picks = sorted(int(i) for i in rng.choice(20000, traffic["check_frames"], replace=False))
    out = {k: {"rgb_gap": 0.0, "alpha_gap": 0.0} for k in ("tf32", "stale", "pixel")}
    for i in picks:
        f = reference_frame(cfg, scene, model, reqs, i)
        bad = f.render.clone()
        bad[bad.shape[0] // 2, bad.shape[1] // 2, 0] += 0.25
        tf = reference_frame(cfg, scene, model, reqs, i, tf32=True)
        st = reference_frame(cfg, scene, model, reqs, i - 1)
        for k, (rgb, alpha) in {"tf32": (tf.render, tf.alpha), "stale": (st.render, st.alpha),
                                "pixel": (bad, f.alpha)}.items():
            g_rgb, g_alpha = gaps(f, rgb, alpha)
            out[k]["rgb_gap"] = max(out[k]["rgb_gap"], g_rgb)
            out[k]["alpha_gap"] = max(out[k]["alpha_gap"], g_alpha)
    return out
