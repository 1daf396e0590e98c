#!/usr/bin/env python3
"""Benchmark the PyTorch/CUDA port: render frames/s at 512x512 on the
articulated-human model, at bench.py's point and by its method.

    python3 bench_torch.py                     # on a CUDA card
    python3 bench_torch.py --device cpu --frames 4 --size 64 --verts 300

The point (bench.py:38-71): the synthetic scene at 512^2 with 6,890 SMPL
vertices as Gaussians at capacity 8,192, 4 views, tile capacity 1,024,
instance capacity 4 x 8,192, SH degree 0, a zero background, and the replay
branch with per-view transforms from one deform render of each view (the
path the reference's "up to 189 FPS" measures).

The method (bench.py:73-99): F = 512 frames back to back, cycling the
views, each adding its own opacity epsilon (1e-12 x i in float32) so that
every frame is new work; one warm-up sweep, then the best of 3 timed
sweeps, each consuming one pixel of every frame. bench.py times one jitted
loop, so no per-frame dispatch is counted; here every frame replays a
captured CUDA graph (`mygauhuman_torch/render/graph.py::GraphedRenderer`),
the port's counterpart of that compiled program.

Before it times anything it holds a graphed frame of each view, on both
branches, bit-equal to the eager `render_frame` of the same request, and
exits non-zero if one differs. Earlier lines give the card's name and power
limit, ms/frame by CUDA events and by the host clock, and the deform
branch's frames/s at the same point; the last line is bench.py's:
{"metric": "render_fps_512", "value", "unit": "frames/s", "vs_baseline"}.
It imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

BASELINE_FPS = 189.0
VIEWS = 4
SWEEPS = 3
FIELDS = ("render", "render_depth", "render_alpha", "normal", "world_normal", "albedo",
          "occlusion", "roughness", "render_axis", "radii", "transforms", "translation")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="render_fps_512 on the PyTorch/CUDA port")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a card) "
                   "or cpu")
    p.add_argument("--frames", type=int, default=512)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--verts", type=int, default=6890)
    # the capacities are bench.py's; a CPU run cuts them, as its plain blend
    # costs in proportion to the tile capacity
    p.add_argument("--capacity", type=int, default=8192)
    p.add_argument("--tile_capacity", type=int, default=1024)
    return p


def card_line(dev) -> str:
    """nvidia-smi's name and power limit of the card (the CPU: "cpu")."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[dev.index or 0]


def frame_eps(i: int) -> float:
    """bench.py's per-frame epsilon, 1e-12 * float32(i), in float32."""
    return float(np.float32(1e-12) * np.float32(i))


def main(argv=None) -> dict:
    """Run the benchmark; returns its numbers, the sweep checksums and the
    scene (for the tests)."""
    args = build_parser().parse_args(argv)

    import torch

    from mygauhuman_torch.data.synthetic import make_synthetic_scene
    from mygauhuman_torch.device import resolve_device
    from mygauhuman_torch.ops.rasterize import RasterizerConfig
    from mygauhuman_torch.render import render_frame
    from mygauhuman_torch.render.graph import GraphedRenderer

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    card = card_line(dev)
    print(f"[bench_torch] card: {card}", flush=True)
    cfg = RasterizerConfig(tile_capacity=args.tile_capacity, chunk_tiles=64,
                           instance_capacity=4 * args.capacity)
    scene = make_synthetic_scene(n_views=VIEWS, width=args.size, height=args.size,
                                 n_verts=args.verts, capacity=args.capacity,
                                 raster_config=cfg, device=dev)
    state, model = scene.gt_state, scene.smpl_model
    bg = torch.zeros(3, device=dev)
    kw = dict(bg=bg, active_sh_degree=0, config=cfg)
    V = len(scene.batches)
    with torch.no_grad():
        views = []
        for b in scene.batches:
            full = render_frame(state, b.camera, b.frame, model, **kw)
            views.append(dict(transforms=full.transforms, translation=full.translation))
    renderer = GraphedRenderer(state, model, **kw)

    def eager(i, replay):
        p = state.params
        st = state._replace(params=p._replace(opacity=p.opacity + frame_eps(i)))
        b = scene.batches[i % V]
        return render_frame(st, b.camera, b.frame, model, **kw,
                            **(views[i % V] if replay else {}))

    def graphed(i, replay):
        b = scene.batches[i % V]
        return renderer(b.camera, b.frame, opacity_eps=frame_eps(i),
                        **(views[i % V] if replay else {}))

    # graphed frames against eager ones, bit for bit, before any timing
    bad = []
    with torch.no_grad():
        for replay in (True, False):
            for i in range(V):
                want = eager(i, replay)
                got = graphed(i, replay)
                bad += [f"{'replay' if replay else 'deform'} view {i} {f}" for f in FIELDS
                        if not torch.equal(getattr(got, f), getattr(want, f))]
    if bad:
        raise SystemExit(f"bench_torch: graphed frames differ from eager ones: {bad}")
    print(f"[bench_torch] graphed frames bit-equal to eager frames on {V} views of both "
          f"branches; {renderer.captures} graphs captured", flush=True)

    def sweep(replay, image_sum=False):
        acc = torch.zeros((), device=dev)
        img = torch.zeros((), device=dev)
        for i in range(args.frames):
            out = graphed(i, replay)
            acc = acc + out.render[0, 0, 0]     # consume one pixel (bench.py's anti-DCE)
            if image_sum:
                img = img + out.render.sum()
        return acc, img

    def timed(replay):
        """(checksums of the warm-up sweep, best host s, its CUDA-event s)"""
        with torch.no_grad():
            first = [float(x) for x in sweep(replay, image_sum=True)]
            best = best_ev = float("inf")
            for _ in range(SWEEPS):
                if cuda:
                    torch.cuda.synchronize(dev)
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    ev[0].record()
                t0 = time.perf_counter()
                float(sweep(replay)[0])
                host = time.perf_counter() - t0
                if cuda:
                    ev[1].record()
                    torch.cuda.synchronize(dev)
                    best_ev = min(best_ev, ev[0].elapsed_time(ev[1]) / 1e3)
                best = min(best, host)
        return first, best, (best_ev if cuda else None)

    (checksum, image_checksum), best, best_ev = timed(True)
    fps = args.frames / best
    ev_ms = "not measured" if best_ev is None else f"{1e3 * best_ev / args.frames:.4f}"
    print(f"[bench_torch] replay branch: {1e3 * best / args.frames:.4f} ms/frame host clock, "
          f"{ev_ms} ms/frame CUDA events, {fps:.2f} frames/s over {args.frames} frames "
          f"(best of {SWEEPS}; {args.size}x{args.size}, {args.verts} vertices, "
          f"capacity {args.capacity}) ({card})", flush=True)
    (d_checksum, d_image_checksum), d_best, d_best_ev = timed(False)
    d_ev_ms = "not measured" if d_best_ev is None else f"{1e3 * d_best_ev / args.frames:.4f}"
    print(f"[bench_torch] deform branch: {1e3 * d_best / args.frames:.4f} ms/frame host "
          f"clock, {d_ev_ms} ms/frame CUDA events, {args.frames / d_best:.2f} frames/s "
          f"({card})", flush=True)
    print(json.dumps({"metric": "render_fps_512", "value": round(fps, 2), "unit": "frames/s",
                      "vs_baseline": round(fps / BASELINE_FPS, 3)}), flush=True)
    return dict(fps=fps, ms_host=1e3 * best / args.frames,
                ms_events=None if best_ev is None else 1e3 * best_ev / args.frames,
                deform_fps=args.frames / d_best, deform_ms_host=1e3 * d_best / args.frames,
                deform_ms_events=None if d_best_ev is None else 1e3 * d_best_ev / args.frames,
                checksum=checksum, image_checksum=image_checksum, deform_checksum=d_checksum,
                deform_image_checksum=d_image_checksum, launches=renderer.launches,
                card=card, scene=scene, views=views, config=cfg)


if __name__ == "__main__":
    main(sys.argv[1:])
