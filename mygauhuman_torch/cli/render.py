"""Rendering/eval CLI — the reference `render.py` driver on the PyTorch port
(port of cli/render.py).

    python -m mygauhuman_torch.cli.render -m <model_path> [--use_replay_cache]
        [--synthetic --synthetic_size N --synthetic_verts V] [--device cpu]

Loads `point_cloud_<it>.ply` (written by either package), repacks it to a
tight capacity, renders the test views (the cached per-pose LBS transforms
with `--use_replay_cache`, skipping the MLPs like render.py:169-195; the
deform branch without), writes a PNG per view and `results.json`
(PSNR/SSIM/LPIPS, `fps` / `fps_wall` over the wall-clock loop, and
`fps_device`: 128 back-to-back frames on the card, each with its own
opacity epsilon so no frame repeats another, best of two, after a warm-up).
Every view is served through `render/graph.py::GraphedRenderer`: on the
card each frame replays a captured CUDA graph (one per camera size and
branch), so `fps_device` times graph replays, as the JAX CLI times one
jitted loop over the views.

`--relight <latlong>` (a `.npy` array, such as the `envmap_<it>.npy` that
`cli.train` writes past `--pbr_iteration`, or a PNG) lifts the lat-long
light to a 32^2 cubemap, prefilters it (`pbr/light.py::build_mips`) and
split-sum shades each view's G-buffers (`shade_gbuffers`); the images and
metrics are then the relit ones. With `--synthetic` the scene's
ground-truth state is shaded under the same light as well (the relight
oracle, `relight_gt_<view>.png`): PSNR / SSIM / LPIPS are measured against
it, with `relight_oracle` true and the relit-vs-original-light numbers as
`psnr_drift` / `ssim_drift`; on real data `relight_oracle` is false. The
`fps_device` sweep renders unlit frames, as the JAX CLI's.

`-s` takes the human sources `cli.train` trains on (ZJU-MoCap, MonoCap,
render/mixamo, DNA-Rendering `.smc` with the SMPL-X body); their test
split is what is rendered.

Deliberate difference from the JAX CLI: `--synthetic` builds the train
CLI's synthetic scene (`--synthetic_verts`, `--synthetic_views`, the same
capacity rule and rasterizer settings) where the JAX CLI always builds 400
vertices and 4 views; the defaults are those, so they render the same scene.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

FPS_FRAMES = 128


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="mygauhuman_torch renderer")
    p.add_argument("--model_path", "-m", type=str, required=True)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--source_path", "-s", type=str, default="")
    p.add_argument("--smpl_model_path", type=str,
                   default="assets/SMPL_NEUTRAL_renderpeople.pkl")
    p.add_argument("--smpl_type", type=str, default="smpl",
                   help="smpl, or smplx (the 55-joint SMPL-X; an .smc source "
                        "implies it)")
    p.add_argument("--white_background", action="store_true")
    p.add_argument("--skip_train", action="store_true", default=True)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_size", type=int, default=128)
    p.add_argument("--synthetic_verts", type=int, default=400,
                   help="the synthetic scene's vertex count, as trained with "
                        "cli.train --synthetic_verts")
    p.add_argument("--synthetic_views", type=int, default=4)
    p.add_argument("--use_replay_cache", action="store_true",
                   help="replay cached LBS transforms (skip MLPs)")
    p.add_argument("--relight", type=str, default="",
                   help="lat-long envmap (.npy or PNG) for PBR relighting")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def load_relight(path: str, device):
    """(CubemapLight, BRDF LUT) of a lat-long envmap file: `.npy` (float
    radiance) or a PNG (8-bit, scaled to [0, 1]); render.py:74-94."""
    import torch

    from mygauhuman_torch.pbr.cubemap import latlong_to_cubemap
    from mygauhuman_torch.pbr.light import build_mips
    from mygauhuman_torch.pbr.shade import get_brdf_lut
    from mygauhuman_torch.utils.image_io import read_png

    if path.endswith(".npy"):
        latlong = np.load(path).astype(np.float32)
    else:
        latlong = read_png(path).astype(np.float32)
        if latlong.max() > 2.0:
            latlong = latlong / 255.0
    with torch.no_grad():
        base = latlong_to_cubemap(torch.as_tensor(latlong[..., :3], device=device), 32)
        return build_mips({"base": base}), get_brdf_lut(device)


def shade_gbuffers(out, camera, light, brdf_lut):
    """Split-sum shade one rendered view's G-buffers [H, W, 3] (the shading
    of the branch-B loss, on the planar form)."""
    import torch

    from mygauhuman_torch.pbr.shade import pbr_shading_planar
    from mygauhuman_torch.train.pbr import R_MAX, R_MIN, canonical_view_dirs

    planes = lambda im: tuple(im[..., c] for c in range(3))   # noqa: E731
    rgb = pbr_shading_planar(
        light=light, normals=tuple(p * 2.0 - 1.0 for p in planes(out.world_normal)),
        view_dirs=planes(canonical_view_dirs(camera)), albedo=planes(out.albedo),
        roughness=out.roughness * (R_MAX - R_MIN) + R_MIN, mask=out.render_alpha,
        occlusion=out.occlusion[..., 0], brdf_lut=brdf_lut)["render_rgb"]
    return torch.stack(rgb, dim=-1)


def main(argv=None) -> dict:
    """Render; returns the results.json metrics, plus the rendered views
    ([H, W, 3] tensors, relit with --relight) under `renders`, which
    results.json does not hold."""
    args = build_parser().parse_args(argv)

    import torch

    from mygauhuman_torch.cli.train import load_body_model, synthetic_scene
    from mygauhuman_torch.device import resolve_device
    from mygauhuman_torch.eval.metrics import evaluate_images
    from mygauhuman_torch.models.gaussians import compact_state
    from mygauhuman_torch.models.io import load_ply
    from mygauhuman_torch.ops.rasterize import RasterizerConfig
    from mygauhuman_torch.render import render_frame
    from mygauhuman_torch.render.graph import GraphedRenderer
    from mygauhuman_torch.train.checkpoint import latest_step, load_eval_cache
    from mygauhuman_torch.utils.image_io import write_png

    dev = resolve_device(args.device)
    it = args.iteration
    if it < 0:
        it = latest_step(args.model_path) or 0

    if args.synthetic:
        scene = synthetic_scene(args.synthetic_views, args.synthetic_size,
                                args.synthetic_verts, dev)
        smpl_model = scene.smpl_model
        batches = scene.batches
        raster_cfg = scene.raster_config
        pose_ids = list(range(len(batches)))
        gt_scene_state = scene.gt_state    # known materials: the relight oracle
    else:
        from mygauhuman_torch.data.readers import camera_info_to_batch, load_scene_info

        smpl_model = load_body_model(args.smpl_type, args.smpl_model_path,
                                     args.source_path, dev)
        info = load_scene_info(args.source_path, args.white_background,
                               os.path.basename(args.model_path), True,
                               smpl_model)
        batches = [camera_info_to_batch(c, dev) for c in info.test_cameras]
        pose_ids = [c.pose_id for c in info.test_cameras]
        raster_cfg = RasterizerConfig()
        gt_scene_state = None              # real data: no known-material oracle

    ply_path = os.path.join(args.model_path, f"point_cloud_{it}.ply")
    # Serving-time repack: drop the training headroom (sort/preprocess cost
    # scales with capacity, alive or dead) and size the instance list to it.
    state = compact_state(load_ply(ply_path, device=dev))
    raster_cfg = raster_cfg._replace(instance_capacity=4 * state.capacity)

    cache = None
    cache_path = os.path.join(args.model_path, f"smpl_rot_{it}.npz")
    if args.use_replay_cache and os.path.exists(cache_path):
        cache = load_eval_cache(cache_path)

    out_dir = os.path.join(args.model_path, f"renders_{it}")
    os.makedirs(out_dir, exist_ok=True)
    bg = torch.ones(3, device=dev) if args.white_background else torch.zeros(3, device=dev)

    def fit(a):
        """Cached rows (alive-compacted, PLY order) padded with zeros to the
        capacity (dead slots are masked by `alive`), or cut to it."""
        out = np.zeros((state.capacity,) + a.shape[1:], np.float32)
        n = min(a.shape[0], state.capacity)
        out[:n] = a[:n]
        return torch.as_tensor(out, device=dev)

    relight = load_relight(args.relight, dev) if args.relight else None
    renderer = GraphedRenderer(state, smpl_model, bg=bg, active_sh_degree=3, config=raster_cfg)

    renders, gts = [], []
    oracle_gts: list = []         # relit ground truth (synthetic oracle)
    replay_kwargs = []            # per-view replay transforms (if cached)
    start = time.time()
    for bi, batch in enumerate(batches):
        kwargs = {}
        # keyed by pose_id only (train.py:548-552 keys smpl_rot by pose)
        ck = str(pose_ids[bi])
        if cache is not None and ck in cache:
            kwargs = {"transforms": fit(cache[ck]["transforms"]),
                      "translation": fit(cache[ck]["translation"])}
        replay_kwargs.append(kwargs)
        with torch.no_grad():
            # the renderer's outputs live until its next call: shade or copy now
            out = renderer(batch.camera, batch.frame, **kwargs)
            img = out.render.clone()
            if relight is not None:
                img = shade_gbuffers(out, batch.camera, *relight)
                if gt_scene_state is not None:
                    # the synthetic scene's materials and the novel light are
                    # both known: its ground-truth G-buffers shaded under the
                    # same light are the true relit reference
                    gt_out = render_frame(gt_scene_state, batch.camera, batch.frame,
                                          smpl_model, bg=bg, active_sh_degree=0,
                                          config=raster_cfg)
                    gt_relit = shade_gbuffers(gt_out, batch.camera, *relight)
                    oracle_gts.append(gt_relit)
                    write_png(os.path.join(out_dir, f"relight_gt_{bi:05d}.png"),
                              (np.clip(gt_relit.cpu().numpy(), 0, 1) * 255).astype(np.uint8))
        renders.append(img)
        gts.append(batch.gt_image)
        write_png(os.path.join(out_dir, f"{bi:05d}.png"),
                  (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.time() - start
    fps_wall = len(batches) / max(elapsed, 1e-9)

    # Device-throughput FPS (bench.py methodology): frames back to back,
    # each with its own opacity epsilon (defeats request memoization), the
    # replay transforms where every view has them (the cached path is what
    # the reference's "up to 189 FPS" measures); the card's whole sweep of
    # graph replays, best of two after a warm-up. The CUDA-event time of the
    # same sweep is kept.
    fps_device, events_ms = fps_wall, None
    if len(batches) > 1:
        V = len(batches)
        use_replay = all("transforms" in k for k in replay_kwargs)
        n_frames = FPS_FRAMES if dev.type == "cuda" else V

        def sweep():
            acc = torch.zeros((), device=dev)
            for i in range(n_frames):
                b = batches[i % V]
                kw = replay_kwargs[i % V] if use_replay else {}
                out = renderer(b.camera, b.frame, opacity_eps=1e-12 * i, **kw)
                acc = acc + out.render[0, 0, 0]
            return acc

        with torch.no_grad():
            sweep()
            best = float("inf")
            for _ in range(2):
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    ev[0].record()
                t0 = time.perf_counter()
                sweep().cpu()
                best = min(best, time.perf_counter() - t0)
                if dev.type == "cuda":
                    ev[1].record()
                    torch.cuda.synchronize()
                    ms = ev[0].elapsed_time(ev[1]) / n_frames
                    events_ms = ms if events_ms is None else min(events_ms, ms)
        fps_device = n_frames / best

    if oracle_gts:
        # the headline metrics measure relighting (render vs the relit
        # known-material reference); against the original-light ground truth
        # they are the *_drift keys
        metrics = evaluate_images(renders, oracle_gts)
        drift = evaluate_images(renders, gts)
        metrics.update(relight_oracle=True, psnr_drift=drift["psnr"], ssim_drift=drift["ssim"])
    else:
        metrics = evaluate_images(renders, gts)
        if relight is not None:
            # real data: no known-material reference, the numbers measure
            # drift from the original-light ground truth
            metrics["relight_oracle"] = False
    # "fps" keeps the reference's wall-clock meaning; "fps_wall" is its
    # alias, "fps_device" the back-to-back sweep
    metrics["fps"] = fps_wall
    metrics["fps_wall"] = fps_wall
    metrics["fps_device"] = fps_device
    if events_ms is not None:
        metrics["ms_per_frame_events"] = events_ms
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    lkey = "lpips" if "lpips" in metrics else "lpips_rand"
    events = "" if events_ms is None else f", CUDA events {events_ms:.3f} ms/frame"
    print(f"rendered {len(batches)} views at {fps_device:.1f} FPS "
          f"(device throughput{events}; wall incl. IO {fps_wall:.1f}) | "
          f"PSNR {metrics['psnr']:.2f} SSIM {metrics['ssim']:.3f} "
          f"{lkey.upper()} {metrics[lkey]:.3f}")
    return dict(metrics, renders=renders)


if __name__ == "__main__":
    main()
