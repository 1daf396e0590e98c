"""Training CLI — the reference `train.py` driver on the PyTorch port
(port of cli/train.py, the branch-A path).

Usage:
  python -m mygauhuman_torch.cli.train --source_path data/zju_mocap_refine/my_377 \\
      --exp_name zju_377 --iterations 1200 --motion_offset_flag --smpl_type smpl
  python -m mygauhuman_torch.cli.train --synthetic       # no-dataset demo run
  ... --device cpu                                      # the plain PyTorch path

Flow parity (train.py:128-434): scene load -> Gaussian init from the SMPL
cloud -> loss-branch-A optimization with densify/prune/opacity-reset
schedules and SH-degree ramp -> periodic eval (L1/PSNR/SSIM/LPIPS, render
galleries, the per-pose replay cache) -> checkpoint + PLY export; past
`--pbr_iteration` (below `--iterations`), branch B: occlusion baked per
camera, materials and a cubemap light learned (`train/pbr.py`), with
`envmap_<it>.npy` (64 x 128 lat-long) beside each save for
`cli.render --relight`. The output directory holds what the JAX package's
CLI writes (`cfg_args.json`, `metrics.jsonl`, `point_cloud_<it>.ply`,
`smpl_rot_<it>.npz`, `eval_<it>/`, `envmap_<it>.npy`), with `chkpnt<it>/`
in the port's torch.save format (a branch-B save holds (TrainState,
PbrState)).

The parser is the reference's, plus `--device` (default cuda: without a
card it raises; nothing falls back to the CPU). `--smpl_type smplx` (or an
`.smc` / `dna_rendering` source) loads the 55-joint SMPL-X body
(`models/smplx.py`); the MLPs, the deform chain and the replay cache size
themselves from its joint count. `--gui` serves the SIBR live viewer
(`utils/network_gui.py`) between iterations with frames from
`render_frame`. `--multichip` trains with the tile-sharded steps
(`parallel/train.py`) over the ranks of a `torch.distributed.run` launch:

  python -m torch.distributed.run --nproc_per_node 2 \
      -m mygauhuman_torch.cli.train --multichip --synthetic ...

on the mesh of `parallel/mesh.py::make_hybrid_mesh` (gloo where ranks
share a card, NCCL where each has its own), both branches, the exchange
window `--exchange_capacity`. Each rank holds its capacity slice of the
per-Gaussian state (`parallel/mesh.py::StateSharding`, as the JAX step's
sharding over the raster axes) and runs the same schedule; the whole state
is gathered, every rank joining, only for the densify events, the bakes,
the eval and save iterations, the viewer (every iteration with `--gui`)
and the returned state. Only rank 0 evaluates and writes files. Each rank
prints its per-Gaussian state bytes against the whole state's at the start
and at the end. On one process it runs the single-device step, as the JAX
CLI does with one device.
Both branches train with the donated step, as the JAX CLI does: on the
card a captured CUDA graph of the step replayed in chunks of `--scan_chunk`
iterations (1 under `--gui`), each ending at every test, save and logged
iteration and, in branch A, at every densify, reset or SH-ramp boundary
(`train/graph.py`, `train/pbr.py::GraphedPbrStep`); on the CPU the same
staging around the eager step. Branch B's chunks read each iteration's
baked occlusion from a uint8 buffer on the device of at most
`--occ_budget_mb` megabytes (at least one camera), and end early where
their views would need more cameras than it holds; each bake sweep is
graph replays too (`occlusion/baking.py`). `--multichip` on several ranks
keeps the eager sharded steps, one per call (their gloo collectives stage
through host memory, which a graph cannot capture).
Accepted as no-ops: `--precompile` (there is no XLA cache to warm: the
command returns at once without training), `--use_pallas` (the device
picks the kernels).

Deliberate difference from the JAX CLI: on `--synthetic` the test split is
every view (there: the first), so the replay cache covers every view that
`cli.render --synthetic` draws.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="mygauhuman_torch trainer")
    p.add_argument("--source_path", "-s", type=str, default="")
    p.add_argument("--model_path", "-m", type=str, default="")
    p.add_argument("--exp_name", type=str, default="default")
    p.add_argument("--smpl_model_path", type=str,
                   default="assets/SMPL_NEUTRAL_renderpeople.pkl")
    p.add_argument("--smpl_type", type=str, default="smpl",
                   help="smpl, or smplx (the 55-joint SMPL-X, loaded from "
                        "--smpl_model_path; an .smc source implies it)")
    p.add_argument("--white_background", action="store_true")
    p.add_argument("--motion_offset_flag", action="store_true", default=True)
    p.add_argument("--eval", action="store_true", default=True)
    p.add_argument("--iterations", type=int, default=1200)
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--test_iterations", type=int, nargs="+", default=[1200])
    p.add_argument("--save_iterations", type=int, nargs="+", default=[1200])
    p.add_argument("--pbr_iteration", type=int, default=30_000,
                   help="branch B (PBR) runs from here to --iterations")
    p.add_argument("--use_kl_densify", action="store_true")
    # densify schedule (reference OptimizationParams,
    # arguments/__init__.py:91-96)
    p.add_argument("--densification_interval", type=int, default=100)
    p.add_argument("--densify_from_iter", type=int, default=400)
    p.add_argument("--densify_until_iter", type=int, default=2000)
    p.add_argument("--densify_grad_threshold", type=float, default=2e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--start_checkpoint", type=str, default="",
                   help="resume from <dir>/chkpnt<iter> "
                        "(reference --start_checkpoint, train.py:136-138)")
    p.add_argument("--lpips_weights", type=str, default="",
                   help=".npz VGG16+lin weights for LPIPS; without it a "
                        "deterministic random backbone is used")
    p.add_argument("--disable_lpips", action="store_true",
                   help="drop the 0.01*lpips training term and eval metric")
    p.add_argument("--gui", action="store_true",
                   help="serve the SIBR live viewer between iterations")
    p.add_argument("--gui_host", type=str, default="127.0.0.1",
                   help="read only with --gui")
    p.add_argument("--gui_port", type=int, default=6009, help="read only with --gui")
    p.add_argument("--skip_galleries", action="store_true",
                   help="do not save eval render galleries at test iters")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the built-in synthetic scene (no dataset)")
    p.add_argument("--synthetic_size", type=int, default=128)
    p.add_argument("--synthetic_verts", type=int, default=400,
                   help="synthetic-scene Gaussian count (6890 = the ZJU "
                        "SMPL-vertex-cloud scale)")
    p.add_argument("--synthetic_views", type=int, default=4)
    p.add_argument("--capacity", type=int, default=0,
                   help="initial Gaussian capacity (0 = auto); it doubles when "
                        "densification runs out of free slots")
    p.add_argument("--use_pallas", action="store_true", default=None,
                   help="accepted, no effect: CUDA tensors run the CUDA kernels, "
                        "CPU tensors their plain versions")
    p.add_argument("--scan_chunk", type=int, default=100,
                   help="iterations per replayed chunk of the captured step, both branches "
                        "(1 under --gui); the schedule is the same with any chunk")
    p.add_argument("--multichip", action="store_true",
                   help="the tile-sharded steps over the ranks of a torch.distributed.run "
                        "launch (one process: the single-device step)")
    p.add_argument("--bake_cells", type=int, default=128,
                   help="voxel cells per occlusion-bake sweep (branch B)")
    p.add_argument("--bake_single_sweep", action="store_true",
                   help="bake one sweep of --bake_cells cells per camera; the rest "
                        "keep visibility 1, counted as bake_out_of_budget")
    p.add_argument("--occ_budget_mb", type=float, default=1024.0,
                   help="device megabytes of branch B's baked-occlusion buffer (uint8, "
                        "one slot per camera, at least one); a chunk that would need "
                        "more cameras ends early")
    p.add_argument("--exchange_capacity", type=int, default=16384,
                   help="multichip exchange window; read only with --multichip")
    p.add_argument("--precompile", action="store_true",
                   help="accepted, no effect but to return at once without "
                        "training: there is no compile cache to warm (the CUDA "
                        "kernels build at their first launch)")
    p.add_argument("--precompile_max_cap", type=int, default=65536,
                   help="read only by --precompile, which has nothing to warm")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu (the "
                        "plain PyTorch path)")
    return p


class _NoLogger:
    """MetricLogger's interface, writing nothing (the ranks past 0)."""

    def log(self, *args, **kwargs):
        pass

    log_image = log
    close = log


def _is_smplx_source(smpl_type: str, source_path: str) -> bool:
    return (smpl_type == "smplx" or source_path.endswith(".smc")
            or "dna_rendering" in source_path.lower())


def synthetic_scene(n_views: int, size: int, n_verts: int, device, capacity: int = 0):
    """The built-in synthetic scene as `--synthetic` trains on it: capacity
    `capacity` (1,024 when 0) doubled until it holds twice the Gaussians,
    and 4 instance slots per capacity slot (real frames peak at ~4 instances
    per alive Gaussian; truncation is counted in overflow_inst)."""
    from mygauhuman_torch.data.synthetic import make_synthetic_scene
    from mygauhuman_torch.ops.rasterize import RasterizerConfig

    cap = capacity or 1024
    while cap < 2 * n_verts:
        cap *= 2
    return make_synthetic_scene(
        n_views=n_views, width=size, height=size, n_verts=n_verts, capacity=cap,
        raster_config=RasterizerConfig(instance_capacity=4 * cap), device=device)


def load_body_model(smpl_type: str, model_path: str, source_path: str, device):
    """--smpl_type dispatch (reference arguments/__init__.py smpl_type + scene
    dispatch): 'smplx' (or an .smc / dna_rendering source) loads the 55-joint
    SMPL-X into the common SMPLModel, else SMPL (24 joints)."""
    if _is_smplx_source(smpl_type, source_path):
        from mygauhuman_torch.models.smplx import load_smplx

        return load_smplx(model_path, device=device)
    from mygauhuman_torch.models.smpl import load_smpl

    return load_smpl(model_path, device=device)


def main(argv=None) -> dict:
    """Train; returns {elapsed_s, final_loss, test_psnr, out_dir} as the JAX
    CLI does, plus the run's record: the first / last iteration it ran,
    the branch-A graphs (`graph`: `GraphedTrainStep.record()`, else None
    under --multichip on several ranks), Gaussians alive
    and capacity at the end, the densify events' counters, `phases`: the
    run's `utils/profiling.py::PHASES` (eval, saves, state gathers,
    densify events, `mgh.train.densify`, and branch B's camera bakes,
    `mgh.pbr.bake`), the
    final TrainState (`state`, whole on every rank), and
    with branch B its PbrState (`pbr_state`) and `pbr` {iterations,
    elapsed_s, bake_out_of_budget, graph: its `record()`, else None under
    --multichip on several ranks} (else None); under --multichip on
    several ranks, `state_bytes`: this rank's per-Gaussian bytes against
    the whole state's at the start and the end (else None)."""
    args = build_parser().parse_args(argv)

    import torch

    from mygauhuman_torch.config import Config, OptimizationConfig
    from mygauhuman_torch.device import exact_convs, resolve_device
    from mygauhuman_torch.models import gaussians as G
    from mygauhuman_torch.models.io import save_ply
    from mygauhuman_torch.models.mlps import init_lbs_offset, init_pose_refiner
    from mygauhuman_torch.ops.rasterize import RasterizerConfig
    from mygauhuman_torch.render import render_frame
    from mygauhuman_torch.train import losses as L
    from mygauhuman_torch.train.checkpoint import save_checkpoint, save_eval_cache
    from mygauhuman_torch.train.trainer import (
        create_train_state,
        make_train_step,
        scene_lpips_crop,
        train_loop,
    )
    from mygauhuman_torch.utils.image_io import write_png
    from mygauhuman_torch.utils.logging import MetricLogger
    from mygauhuman_torch.utils.profiling import PHASES

    dev = resolve_device(args.device)
    mesh = None
    is_main = True
    if args.multichip:
        from mygauhuman_torch.parallel.mesh import init_distributed, make_hybrid_mesh

        rt = init_distributed(device=dev)
        dev, is_main = rt.device, rt.rank == 0
        if rt.world_size > 1:
            mesh = make_hybrid_mesh(rt=rt)
        if is_main:
            print(f"multichip mesh: {mesh.shape if mesh else dict(data=1, gauss=1, tiles=1)} "
                  f"({rt.world_size} rank{'s' if rt.world_size > 1 else ''}, backend "
                  f"{rt.backend or 'none: the single-device step'})", flush=True)
    sharding = None
    if mesh is not None:
        from mygauhuman_torch.parallel.mesh import RASTER_AXES, StateSharding

        sharding = StateSharding(mesh.group(RASTER_AXES))
    out_dir = args.model_path or os.path.join("output", args.exp_name)
    if is_main:
        os.makedirs(out_dir, exist_ok=True)
    if args.precompile:
        print("precompile: nothing to warm (no compile cache; the CUDA kernels build at "
              "their first launch) — run without --precompile to train")
        return {"elapsed_s": 0.0, "precompiled": True, "final_loss": 0.0,
                "test_psnr": 0.0, "out_dir": out_dir}

    cfg = OptimizationConfig(
        iterations=args.iterations,
        pbr_iteration=args.pbr_iteration,
        use_kl_densify=args.use_kl_densify,
        densification_interval=args.densification_interval,
        densify_from_iter=args.densify_from_iter,
        densify_until_iter=args.densify_until_iter,
        densify_grad_threshold=args.densify_grad_threshold,
    )

    if args.synthetic:
        scene = synthetic_scene(args.synthetic_views, args.synthetic_size,
                                args.synthetic_verts, dev, args.capacity)
        smpl_model = scene.smpl_model
        train_batches = scene.batches
        # every view (the JAX CLI: the first), so that the replay cache
        # covers every view cli.render draws
        test_batches = scene.batches
        state = scene.init_state
        extent = scene.extent
        smpl_vertices = scene.big_pose_verts
        raster_cfg = scene.raster_config
        test_pose_ids = list(range(len(test_batches)))
    else:
        from mygauhuman_torch.data.readers import (
            camera_info_to_batch,
            load_scene_info,
            zju_normal_reencode,
        )

        smpl_model = load_body_model(args.smpl_type, args.smpl_model_path,
                                     args.source_path, dev)
        info = load_scene_info(
            args.source_path, args.white_background, args.exp_name,
            args.eval, smpl_model,
        )
        is_zju = "zju" in args.source_path.lower()

        def to_batch(ci):
            b = camera_info_to_batch(ci, dev)
            if is_zju and ci.normal is not None:
                b = b._replace(gt_normal=torch.as_tensor(zju_normal_reencode(ci.normal),
                                                         device=dev))
            return b

        train_batches = [to_batch(c) for c in info.train_cameras]
        test_batches = [to_batch(c) for c in info.test_cameras]
        test_pose_ids = [c.pose_id for c in info.test_cameras]
        pcd = info.point_cloud
        state = G.create_from_pcd(
            pcd.points, pcd.colors, pcd.normals, sh_degree=args.sh_degree,
            capacity=args.capacity or None, device=dev,
        )
        extent = info.nerf_normalization["radius"]
        smpl_vertices = torch.as_tensor(info.train_cameras[0].big_pose_world_vertex,
                                        device=dev)
        # as the synthetic branch: 4 instance slots per capacity slot
        raster_cfg = RasterizerConfig(instance_capacity=4 * state.capacity)

    n_joints = smpl_model.j_regressor.shape[0]
    ts, tx = create_train_state(
        cfg, state,
        init_pose_refiner(torch.Generator().manual_seed(args.seed), total_bones=n_joints,
                          device=dev),
        init_lbs_offset(torch.Generator().manual_seed(args.seed + 1), total_bones=n_joints,
                        device=dev),
    )

    # --start_checkpoint resume (reference train.py:136-138 ->
    # gaussians.restore): shape-tolerant restore into the fresh state, then
    # continue the iteration schedule where the checkpoint left off.
    start_iteration = 0
    if args.start_checkpoint:
        from mygauhuman_torch.train.checkpoint import restore_checkpoint_like

        ckpt_dir, base = os.path.split(args.start_checkpoint.rstrip("/"))
        if not base.startswith("chkpnt"):
            raise ValueError(
                f"--start_checkpoint must point at <dir>/chkpnt<iter>, "
                f"got {args.start_checkpoint}")
        start_iteration = int(base[len("chkpnt"):])
        ts = restore_checkpoint_like(ckpt_dir, start_iteration, ts)
        print(f"resumed from {args.start_checkpoint} "
              f"(iteration {start_iteration})")

    state_bytes = None
    if sharding is not None:
        from mygauhuman_torch.parallel.mesh import per_gaussian_nbytes

        def report_bytes(when, rank_bytes, whole):
            state_bytes[when] = {"rank": rank_bytes, "whole": per_gaussian_nbytes(
                whole, whole.gauss.capacity), "capacity": whole.gauss.capacity}
            print(f"[state] rank {sharding.group.index} of {sharding.group.size} at the "
                  f"{when}: per-Gaussian leaves {rank_bytes / 1e6:.3f} MB, the whole state's "
                  f"{state_bytes[when]['whole'] / 1e6:.3f} MB (capacity "
                  f"{whole.gauss.capacity})", flush=True)

        # from here this rank holds its capacity slice (the whole snapshot,
        # when resuming, was loaded and is sliced here)
        state_bytes = {}
        cap = ts.gauss.capacity
        shard = sharding.shard(ts, cap)
        report_bytes("start", per_gaussian_nbytes(shard.local, sharding.rows(cap)), ts)
        ts = shard

    # LPIPS: active by default, both in the 0.01*lpips training term
    # (train.py:287) and the eval report (train.py:539). Without a weights
    # file the backbone is a deterministic random VGG; --lpips_weights
    # restores published-number parity.
    lpips_obj = None
    if not args.disable_lpips:
        from mygauhuman_torch.eval.lpips import LPIPS

        lpips_obj = LPIPS(weights_file=args.lpips_weights or None, device=dev)

    bg = torch.ones(3, device=dev) if args.white_background else torch.zeros(3, device=dev)
    # static LPIPS window sized to the scene's largest subject bbox
    lpips_crop = scene_lpips_crop([b.bound_mask for b in train_batches])
    if mesh is not None:
        from mygauhuman_torch.parallel.train import (
            make_tile_sharded_train_step,
            stack_batches,
        )

        # one view per iteration, stacked to the step's batch of one
        base_step = make_tile_sharded_train_step(
            smpl_model, tx, cfg, raster_cfg, bg=bg, mesh=mesh,
            exchange_capacity=args.exchange_capacity, lpips_fn=lpips_obj,
            lpips_crop=lpips_crop)

        def step_fn(ts, batch, deg):
            return base_step(ts, stack_batches([batch]), deg)
    else:
        # the state is donated to the captured step, as the JAX CLI donates it
        step_fn = make_train_step(smpl_model, tx, cfg, raster_cfg, bg=bg, lpips_fn=lpips_obj,
                                  lpips_crop=lpips_crop, donate=True)
    scan_chunk = 1 if args.gui else max(1, args.scan_chunk)
    # only rank 0 writes: the other ranks log nowhere
    logger = MetricLogger(out_dir) if is_main else _NoLogger()
    # the program's own phases: eval, saves and state gathers here, densify
    # events in the loop
    timer = PHASES
    timer.reset()
    eval_cache: dict = {}
    gui = None
    if args.gui and is_main:
        from mygauhuman_torch.utils.network_gui import NetworkGUI

        gui = NetworkGUI(args.gui_host, args.gui_port)

    def eval_metrics(render, gt) -> dict:
        m = {"l1": L.l1_loss(render, gt), "psnr": L.psnr(render, gt),
             "ssim": L.ssim(render, gt)}
        if lpips_obj is not None:
            # key is "lpips_rand" for the random-VGG fallback (not comparable
            # to published LPIPS without pretrained weights)
            m[lpips_obj.metric_name] = lpips_obj(render, gt)
        return m

    def num_alive(ts) -> int:
        return int(ts.gauss.num_alive) if sharding is None else sharding.num_alive(ts)

    def whole_at(it, ts, viewer=False):
        """The whole state where iteration `it` reads it (eval, save, the
        viewer), else None. Every rank joins the gather."""
        if not (viewer or it in args.test_iterations or it in args.save_iterations):
            return None
        if sharding is None:
            return ts
        with timer.phase("state_gather"):
            return sharding.gather(ts)

    def run_eval(it, ts):
        """Test-iteration report parity (train.py:458-556): L1/PSNR/SSIM/
        LPIPS on the test split + a train sample, render galleries, and the
        per-pose LBS replay cache."""
        splits = {
            "test": list(zip(test_pose_ids, test_batches)),
            "train": list(enumerate(train_batches[:4])),
        }
        test_psnr = 0.0
        alive_idx = torch.nonzero(ts.gauss.alive).reshape(-1)
        n_alive = int(alive_idx.numel())
        for split, items in splits.items():
            if not items:
                continue
            rows: dict = {}
            gdir = os.path.join(out_dir, f"eval_{it}", split)
            if not args.skip_galleries:
                os.makedirs(gdir, exist_ok=True)
            for pose_id, batch in items:
                with torch.no_grad(), exact_convs():
                    out = render_frame(
                        ts.gauss, batch.camera, batch.frame, smpl_model, bg=bg,
                        active_sh_degree=min(it // 1000, args.sh_degree),
                        mlp_params={"pose_refiner": ts.pose_refiner,
                                    "lbs_offset": ts.lbs_offset},
                        config=raster_cfg)
                    m = eval_metrics(out.render, batch.gt_image)
                vals = torch.stack([v.float() for v in m.values()]).cpu().tolist()
                for k, v in zip(m, vals):
                    rows.setdefault(k, []).append(v)
                if split == "test":
                    # keyed by pose_id (reference keys smpl_rot by pose,
                    # train.py:548-552); rows in alive-compacted order, the
                    # order save_ply writes, so the replay stays aligned with
                    # a load_ply / compact_state'd state
                    eval_cache[str(pose_id)] = {
                        "transforms": out.transforms[alive_idx].cpu().numpy(),
                        "translation": out.translation[alive_idx].cpu().numpy(),
                    }
                if not args.skip_galleries:
                    pair = torch.cat([out.render, batch.gt_image], dim=1).cpu().numpy()
                    write_png(os.path.join(gdir, f"{pose_id:03d}.png"),
                              (np.clip(pair, 0, 1) * 255).astype(np.uint8))
                    logger.log_image(it, f"{split}/render_{pose_id}", pair)
            means = {k: float(np.mean(v)) for k, v in rows.items() if v}
            logger.log(it, means, prefix=split)
            print(f"[iter {it}] {split}: " + "  ".join(
                f"{k} {v:.4f}" for k, v in means.items()
            ) + f"  ({n_alive} gaussians)")
            if split == "test":
                test_psnr = means["psnr"]
        return test_psnr

    start = time.time()
    last_psnr = 0.0
    seen = {"first": None, "last": None, "densify": []}

    def poll_gui(it, ts):
        """train.py:180-193: answer viewer frames between iterations."""
        if gui is None or not gui.try_connect():
            return
        import math

        from mygauhuman_torch.data.camera import Camera

        try:
            while True:
                cam, _, keep_alive, scaling_mod = gui.receive()
                img = None
                if cam is not None:
                    w2c = np.asarray(cam.w2c, np.float32)
                    c2w = np.linalg.inv(w2c.astype(np.float64))
                    camera = Camera(
                        w2c=torch.as_tensor(w2c, device=dev),
                        full_proj=torch.as_tensor(np.asarray(cam.full_proj, np.float32),
                                                  device=dev),
                        cam_center=torch.as_tensor(c2w[:3, 3].astype(np.float32), device=dev),
                        tan_fovx=math.tan(cam.fovx / 2), tan_fovy=math.tan(cam.fovy / 2),
                        width=cam.width, height=cam.height)
                    with torch.no_grad():
                        out = render_frame(
                            ts.gauss, camera, train_batches[0].frame, smpl_model, bg=bg,
                            active_sh_degree=min(it // 1000, args.sh_degree),
                            mlp_params={"pose_refiner": ts.pose_refiner,
                                        "lbs_offset": ts.lbs_offset},
                            config=raster_cfg, scaling_modifier=scaling_mod)
                    img = out.render.cpu().numpy()
                gui.send_image(img, out_dir)
                if not keep_alive:
                    break
        except (ConnectionError, OSError):
            gui.drop_connection()

    def callback(it, ts, metrics):
        nonlocal last_psnr
        if it % 100 == 0 or it == 1:
            logger.log(it, metrics)
            logger.log(it, {"n_gaussians": num_alive(ts)}, prefix="scene")
        ts = whole_at(it, ts, viewer=args.gui)
        if args.gui:
            poll_gui(it, ts)
        if "capacity" in metrics:       # a densify event ran at this iteration
            seen["densify"].append({"iteration": it, "capacity": metrics["capacity"],
                                    **{k[len("densify_"):]: v for k, v in metrics.items()
                                       if k.startswith("densify_")}})
        if it in args.test_iterations and is_main:
            with timer.phase("eval"):
                last_psnr = run_eval(it, ts)
        if it in args.save_iterations and is_main:
            with timer.phase("save"):
                save_checkpoint(out_dir, it, ts, Config(optim=cfg))
                save_ply(ts.gauss, os.path.join(out_dir, f"point_cloud_{it}.ply"))
                save_eval_cache(os.path.join(out_dir, f"smpl_rot_{it}.npz"), eval_cache)

    phase_a_iters = min(cfg.iterations, cfg.pbr_iteration)
    metrics: dict = {}
    if phase_a_iters > start_iteration:
        ts, metrics = train_loop(
            ts, tx, step_fn, train_batches, cfg,
            extent=extent, smpl_vertices=smpl_vertices,
            max_sh_degree=args.sh_degree, seed=args.seed, callback=callback,
            num_iterations=phase_a_iters, start_iteration=start_iteration,
            sharding=sharding, scan_chunk=scan_chunk,
            # the test and save iterations, and the logged ones, so that
            # metrics.jsonl holds the rows of an unchunked run
            callback_iters=tuple(sorted(set(args.test_iterations) | set(args.save_iterations)
                                        | {1, *range(100, phase_a_iters + 1, 100)})),
        )
        # the iterations the loop ran (chunked, its callbacks skip some)
        seen["first"], seen["last"] = start_iteration + 1, phase_a_iters
    graph = step_fn.record() if hasattr(step_fn, "record") else None
    if graph is not None and is_main:
        print(f"branch A graphs: {graph['captures']} captured ({graph['released']} released "
              f"by capacity growth) in {graph['capture_s']:.1f}s of warm-ups and captures, "
              f"chunks of {scan_chunk}")

    pbr_state, pbr_record = None, None
    if cfg.iterations > cfg.pbr_iteration:
        # branch B (train.py:294-363): bake occlusion per camera, learn the
        # materials and the cubemap light
        from mygauhuman_torch.pbr.light import export_envmap
        from mygauhuman_torch.train.pbr import (
            create_pbr_state,
            make_pbr_train_step,
            train_loop_pbr,
        )

        pbr_state, light_tx = create_pbr_state(cfg, device=dev)
        if mesh is not None:
            from mygauhuman_torch.parallel.train import make_tile_sharded_pbr_step

            base_pbr = make_tile_sharded_pbr_step(
                smpl_model, tx, light_tx, cfg, raster_cfg, bg=bg, mesh=mesh,
                exchange_capacity=args.exchange_capacity, lpips_fn=lpips_obj)

            def pbr_step(ts2, pbr2, batch, knn3, occ_col, pw, deg):
                return base_pbr(ts2, pbr2, stack_batches([batch]), knn3, occ_col[None], pw,
                                deg)
        else:
            # the states are donated to the captured step, as in branch A
            pbr_step = make_pbr_train_step(smpl_model, tx, light_tx, cfg, raster_cfg, bg=bg,
                                           lpips_fn=lpips_obj, donate=True)

        def pbr_callback(it, ts2, pbr2, m):
            nonlocal last_psnr
            seen["first"] = seen["first"] or it
            seen["last"] = it
            if it % 100 == 0 or it == 1:    # the phase-A cadence
                logger.log(it, m, prefix="pbr")
            ts2 = whole_at(it, ts2)
            if it in args.test_iterations and is_main:
                with timer.phase("eval"):
                    last_psnr = run_eval(it, ts2)
            if it in args.save_iterations and is_main:
                with timer.phase("save"):
                    save_checkpoint(out_dir, it, (ts2, pbr2), Config(optim=cfg))
                    save_ply(ts2.gauss, os.path.join(out_dir, f"point_cloud_{it}.ply"))
                    save_eval_cache(os.path.join(out_dir, f"smpl_rot_{it}.npz"), eval_cache)
                    # the learned light, for cli.render --relight
                    with torch.no_grad():
                        env = export_envmap(pbr2.light, 64, 128)
                    np.save(os.path.join(out_dir, f"envmap_{it}.npy"), env.cpu().numpy())

        pbr_start = max(start_iteration, phase_a_iters)
        t_pbr = time.time()
        ts, pbr_state, metrics = train_loop_pbr(
            ts, pbr_state, pbr_step, train_batches, smpl_model, cfg,
            start_iteration=pbr_start, num_iterations=cfg.iterations - pbr_start,
            max_sh_degree=args.sh_degree, seed=args.seed, callback=pbr_callback,
            bake_max_cells=args.bake_cells, bake_full_coverage=not args.bake_single_sweep,
            scan_chunk=scan_chunk, occ_budget_mb=args.occ_budget_mb,
            # as branch A's: the test, save and logged iterations end chunks
            callback_iters=tuple(sorted(set(args.test_iterations) | set(args.save_iterations)
                                        | set(range(100, cfg.iterations + 1, 100)))),
            sharding=sharding)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        pbr_record = {"iterations": cfg.iterations - pbr_start,
                      "elapsed_s": time.time() - t_pbr,
                      "bake_out_of_budget": metrics.get("bake_out_of_budget", 0),
                      "graph": pbr_step.record() if hasattr(pbr_step, "record") else None}
        print(f"branch B: {pbr_record['iterations']} iterations in "
              f"{pbr_record['elapsed_s']:.1f}s (bake_out_of_budget "
              f"{pbr_record['bake_out_of_budget']})")
        graph_b = pbr_record["graph"]
        if graph_b is not None and is_main:
            print(f"branch B graphs: {graph_b['captures']} captured ({graph_b['released']} "
                  f"released) in {graph_b['capture_s']:.1f}s of warm-ups and captures, chunks "
                  f"of {scan_chunk}, launches per replay "
                  f"{[k['launches'] for k in graph_b['launches_per_replay']]}")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.time() - start
    if sharding is not None:
        rank_bytes = per_gaussian_nbytes(ts.local, sharding.rows(ts.capacity))
        ts = sharding.gather(ts)
        report_bytes("end", rank_bytes, ts)
    n_alive = int(ts.gauss.num_alive)
    print(f"training done: {cfg.iterations} iters in {elapsed:.1f}s "
          f"({n_alive} gaussians)")
    if gui is not None:
        gui.close()
    logger.close()
    return {"elapsed_s": elapsed,
            "final_loss": float(metrics.get("loss", 0.0)),
            "test_psnr": last_psnr, "out_dir": out_dir,
            "first_iteration": seen["first"], "last_iteration": seen["last"], "graph": graph,
            "n_gaussians": n_alive, "capacity": ts.gauss.capacity,
            "densify": seen["densify"], "phases": timer.summary(), "state": ts,
            "pbr_state": pbr_state, "pbr": pbr_record,
            "mesh": mesh.shape if mesh is not None else None, "state_bytes": state_bytes}


if __name__ == "__main__":
    main()
