#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mygauhuman_torch) on one CUDA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --mc-ab <checkout>   # phase 9 (c)'s 2-rank run there
                                               # and here, held equal bit for bit

Phases, each of which must pass (any failure exits non-zero):
  1. setup: the card's name and power limit, the kernels' build (one nvcc per
     source, in parallel) and its time, TF32 off;
  2. kernels A, B, C against their plain PyTorch versions on the card, on
     the inputs the serving render gives them, captured from real calls, with
     kernel, plain and library times and each kernel's bound; each kernel's
     time twice: CUDA events around back-to-back wrapper calls (host
     included) and its own device time from torch.profiler; kernel A also
     at the 16,384 queries of the training loop after densify, with its warps
     per SM; kernel C's busy tiles and longest tile, and its checkpoint mode
     (a differentiated forward) against D1 bit for bit and against the plain
     checkpoints;
  3. the serving render at the bench point (512^2, 6,890 SMPL vertices,
     capacity 8,192 -> PLY -> load -> compact 6,912, instance capacity
     32,768): 4 views through the deform branch, then through the replay
     branch with the returned transforms; checks, launch counts; the GPU
     render against the CPU (plain) render of the same inputs; then the
     graphed serving frame (render/graph.py::GraphedRenderer, this slice's
     main path, its launch counts reset before it and read after): 5
     requests per branch, views and opacity epsilons interleaved, each
     bit-equal to the eager frame of the same request in render, depth,
     alpha, normal, world normal, albedo, roughness, transforms and
     translation; each branch's first call (warm-up, capture, replay) under
     torch.cuda.set_sync_debug_mode("error"); the launches a replay adds,
     read from the captures, and the path's counts equal to them; eager and
     graphed sweeps side by side (ms/frame by CUDA events and the host
     clock, device busy share under torch.profiler, top eager kernels);
     bench_torch.py's run at its own point, its JSON line tagged;
  4. the served size: 45,000 Gaussians (compacted capacity 45,056), 4 views
     through the deform branch, frames/s;
  5. branch-A training: kernel C at the inputs a training step's forward
     gives it (checkpoint mode, as in phase 2), and kernel D against its plain
     version on the inputs its backward gives it (bench point and 208x144),
     and kernel B's backward on the deform call of the same step, bit for bit
     against its plain version and within 1e-5 of autograd of the plain
     forward:
     the step's D1s + D2 on kernel C's checkpoints, the standalone three
     launches, and each launch (D1 T checkpoints, D1s chunk sums, D2 rows)
     against its own plain version; one step on the card against the same step on the
     CPU (128^2, capacity 1,024, LPIPS on); the same step twice at the bench
     point, bit-equal; ms/step over 100 steps at the bench point (capacity
     8,192, LPIPS on); a profile of 8 steps (launches per step, kernels B's
     backward, C and D's device time; no D1 launch; one kernel B backward per
     step, with no plain-op storm under its autograd node); a 60-iteration
     train_loop (one kernel B backward per iteration) with
     densify events at 20 and 40 and an opacity reset at 50; the trained
     views' PSNR / SSIM / LPIPS; then the graphed train step
     (train/graph.py, make_train_step(..., donate=True)), this slice's main
     path at the bench point: from one state, a 120-iteration train_loop
     with the eager step (scan_chunk 1) against the graphed one (scan_chunk
     100) across densify events at 20, 40, 60 and 80 (one of them growing
     the capacity) and an opacity reset at 100, every state leaf (both Adam
     moments and the densify statistics too) and every iteration's metrics
     bit for bit, every chunk under torch.cuda.set_sync_debug_mode("error"),
     the path's launches (one kernel B backward per iteration and per
     capture's warm-up); both loops' wall, then the steady state (CUDA
     events, host clock, device busy share) and the launches per replay;
  6. the entry points a user runs, under build/cli_run/: `cli.train` at full
     width and the full branch-A budget (512^2, 6,890 Gaussians, 4 views,
     1,200 iterations, densify every 100 from 400, eval at 1,200, saves at
     600 and 1,200; the CLI's default: the donated step as captured CUDA
     graphs, chunks of 100): wall time, ms per iteration, the graphs'
     captures, seconds and launches per replay, peak device memory, test
     PSNR, Gaussians and capacity, densify counters, each kernel's launches
     in the run (A, B, B's backward once per iteration and per capture's
     warm-up, C in checkpoint mode, D1s and D2 each launched, D1 never);
     the saved snapshot loaded back bit-equal to the live state, and a resume
     from it (--start_checkpoint) that starts at iteration 1,201; every
     kernel (A, B and its backward, C in checkpoint mode, D) against its
     plain version, with its times and bound, on the inputs of the run's
     step at chkpnt600 (capacity 16,384) and chkpnt1200 (capacity 32,768),
     under the CLI's raster config; `cli.render` on the run through the
     deform branch and the replay cache (fps_device, fps_wall, PSNR / SSIM /
     LPIPS; the cached rows bit-equal to the eval's deform transforms, the
     replay images (graphed, as cli.render serves every view) bit-equal to
     an eager replay of them, and within 1e-3 of a
     deform render but at a few pixels, none beyond 1e-2); `cli.metrics` on
     the rendered PNGs against the scene's ground truth as PNGs, its PSNR
     within 1e-4 of the same metric on those 8-bit images in memory and
     within 0.05 dB (8-bit quantisation) of results.json's;
  7. branch B and relighting through the entry points, under build/cli_run/:
     `cli.train` resumes phase 6's chkpnt1200 for 300 branch-B iterations
     (--iterations 1500 --pbr_iteration 1200; 4 occlusion bakes at capacity
     32,768; the CLI's default: the donated step as captured CUDA graphs in
     chunks of 100, each bake sweep as graph replays of one cell program,
     this slice's main path, its launch counts reset before it and read
     after): wall time and ms per iteration, the graphs' captures, seconds
     and launches per replay, each bake's seconds, launches, sweeps and
     bake_out_of_budget (0), the run's launches (kernel B's backward and D1
     never; one differentiated forward and backward per iteration and per
     capture's warm-up), relit PSNR at 1,201 and 1,500; finite losses, a
     light >= 0, geometry and MLPs bit-equal to chkpnt1200, albedo and
     roughness learned, chkpnt1500 loaded back bit-equal; kernel C tile-major
     on a bake group's launch against its plain version; a branch-B step at chkpnt1200:
     kernels A, B, C (checkpoint mode) and D against their plain versions, no
     kernel B backward, the same step twice bit-equal; the step on the card
     against the CPU at 128^2; `cli.render --relight envmap_1500.npy`
     (relight_oracle PSNR, psnr_drift), CUDA-event ms per relit frame beside
     the unlit one, GPU vs CPU shading within 1e-5; the first camera's bake
     redone on the CPU in a process of its own while the card trains, its
     uint8 maps within one step of the card's; from chkpnt1200, 40
     iterations of train_loop_pbr with the eager step against the graphed
     one (chunks of 16 and one ending at an observed iteration) and against
     a starved occlusion budget (one camera's slot, so a chunk per camera
     change), every state leaf (materials, light, volumes, both optimisers'
     moments) and every iteration's metrics bit for bit, every chunk past
     the capture under torch.cuda.set_sync_debug_mode("error"), the bakes
     reused from the CLI run; ms/iteration of 40 replays in one chunk
     against 10 eager steps (CUDA events, host clock), the busy share of
     each, launches per replay; one bake sweep (128 cells) as graph
     replays against the same cell program run eagerly, bit for bit, with
     the seconds of each;
  8. the 55-joint SMPL-X body on a DNA-Rendering capture through the entry
     points, under build/cli_run/dna/: a capture written for the port's DNA
     reader (6 Camera_5mp cameras x 4 frames at the rig's 2448x2048, ground
     truth rendered by render_frame from a seeded Gaussian state on the
     synthetic SMPL-X body at 10,475 vertices; an .smc file with h5py where
     it is installed, else the port's SMCReader accessors over the same
     arrays in memory) and its SMPL-X npz; `cli.train --smpl_type smplx` for
     500 iterations (frames 1224x1024, kernel C tile-major in checkpoint
     mode in the step, graphed as in phase 6: a graph per training camera's
     fov; saves at 250 and 500, eval at 500): wall time, ms per iteration,
     the graphs as in phase 6, Gaussians, launches (no planar blend, no D1,
     one kernel B backward per iteration and per warm-up), the overflow
     counters of each logged step,
     test PSNR; every kernel against its plain version on the inputs of the
     CLI's own step at chkpnt500 (A at the state's capacity x 10,475 refs,
     B forward and backward bit-equal, C tile-major with its checkpoints
     against D1's, D1s + D2), the graphed step twice bit-equal and the
     profiles of a replay and of the eager step; a
     branch-A step on a 128^2 SMPL-X scene (1,000 Gaussians) on the card
     against the CPU; `cli.render` on both branches (the replay cache
     bit-equal to the eval's deform transforms, the replay image bit-equal
     to a replay of them) and `cli.metrics` (within 1e-4 of the same metric
     in memory);
  9. the tile-sharded multi-device path on 2 ranks started by
     `python -m torch.distributed.run` (this script with `--mc-worker`): on
     one card both ranks run on cuda:0 over gloo (NCCL refuses two ranks
     on one device), on two or more cards on distinct cards over NCCL;
     each rank holds its capacity slice of the per-Gaussian state;
     (a) rasterize_sharded at the bench point against the single-device
     rasterize on the same card (image, alpha, final_t within 2e-5, depth
     1e-4, radii equal, no exchange overflow, opacity and feature
     gradients within rtol 1e-4 + atol 1e-5); (b) in turns, one rank at a
     time, every kernel on the rank's own inputs of the sharded step:
     kernel C planar in checkpoint mode at the rank's strip tile_base
     (0 / 512 at 512^2) against its plain version and D1's checkpoints,
     D1s + D2 on its backward, A and B (and B's backward) on the rank's
     capacity slice, kernel C tile-major in checkpoint mode on a 1224x1024
     frame's strip (tile_base 0 / 2,464); (d) the sharded branch-B step
     for 20 iterations on phase 7's state and an occlusion baked for it
     (passed through a file) against the single-device step: after one
     step the materials within 1e-4 of the largest value (roughness but
     at 1% of its entries, within 1e-3), over the 20 iterations the losses
     and the light within 1e-3, the geometry bit-equal; (c) cli.train
     --multichip for 600 iterations on 2 ranks against 1 rank (the
     single-device step, graphed; both with --scan_chunk 1, so that every
     iteration's loss is seen): the same densify iterations and capacities,
     iteration 1's loss within 1e-5, the losses of iterations 1-20 within
     2e-3 relative (the JAX loop test's bound, where the runs differ by
     rounding alone), and past them fixed ceilings on the drift that 600
     iterations of training make of that rounding: the losses of
     iterations 1-100 within 5e-3 relative, the alive counts at the densify
     events within 0.5%, the PSNR at 600 within 0.5 dB; ms/iteration of both, the
     exchange bytes, the collectives' time per step, the sharded step
     twice bit-equal, each rank's launches; per rank, its per-Gaussian
     bytes against the whole state's at the start and at 600, and the
     state gathers (calls, bytes) over the run: none inside a step and
     none in an iteration without a densify event, eval or save;
 10. each kernel's time lost on the main paths from its device time, the
     script's own seconds (`[total]`), a `kernels` JSON line (kernels A, B,
     C planar and tile-major, D1s and D2: `launches` from phase 7's graphed
     cli.train branch-B run, every number from phase 7's checks on a
     branch-B step at chkpnt1200, C tile-major at a bake group; B's backward
     and D1, which branch B never launches: rank 0's launches in the 2-rank
     cli.train --multichip run, every number measured on rank 1's inputs of
     the sharded step; `launches_path` and `measured_on` name them; the
     other paths' launches in `launches_by_path`, phase 5's graphed loop as
     `loop_graph`, phase 7's graphed loop check as `pbr_graph`),
     the card line, and as the last line {"ok": true, "device": {...}}.
It needs one card and imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

FP32_OPS_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
BYTES_PER_S = 3.35e12      # H100 SXM HBM3
RENDER_ATOL = 1e-3         # the image tolerance of tests/test_torch_render.py
BENCH = dict(width=512, height=512, n_verts=6890, capacity=8192, views=4, seed=0)
SERVED_GAUSSIANS = 45_000
FPS_FRAMES = 64
PROFILE_FRAMES = 8
TRAIN_STEPS = 100          # timed steps at the bench point
LOOP_ITERS = 60            # the train_loop: densify at 20 and 40, opacity reset at 50
GRAPH_LOOP_ITERS = 120     # eager vs graphed train_loop from one state (phase 5)
GRAPH_CHUNK = 100          # cli.train's default --scan_chunk
# densify at 20, 40, 60 and 80 with a low threshold, so that the free slots
# run out and a later event grows the capacity; an opacity reset at 100
GRAPH_LOOP = dict(densify_from_iter=20, densify_until_iter=100, densification_interval=20,
                  opacity_reset_interval=100, densify_grad_threshold=2e-5)
GRAPH_TIMED_STEPS = 100    # graphed replays timed in one chunk
GRAPH_EAGER_STEPS = 20     # eager steps timed beside them
GRAD_RTOL = 1e-3           # GPU vs CPU step: each gradient leaf within GRAD_RTOL max|CPU|
KERNEL_D_RTOL = 1e-4       # kernel D vs plain: each component within 1e-4 max|plain| + 1e-6
CKPT_RTOL = 1e-4           # D1 vs plain: T, T_final relative, chunk sums over the largest
                           # (the plain T is exp of a fp32 cumsum of up to 1,024 log terms)
DEFORM_BWD_RTOL = 1e-5     # kernel B's backward vs autograd of the plain forward: each
                           # gradient within 1e-5 max + 1e-6 (another order of the same sums)
# fp32 operations per Gaussian of kernel B, counted from the plain versions'
# elementwise operations (the backward recomputes the chain; the scalars'
# gradient adds its 93 shares and the 36 of the target-pose point and
# translation, which only those shares read)
DEFORM_FWD_OPS, DEFORM_BWD_OPS, DEFORM_SCALAR_OPS = 297, 669, 129
CLI_DIR = Path(__file__).resolve().parent / "build" / "cli_run"
CLI_ITERS = 1200           # the branch-A budget (train_zju_mocap_refine.sh:4)
CLI_MID = 600              # the run's other save, at capacity 16,384
CLI_SCENE = dict(size=512, verts=6890, views=4)     # the bench point's widths
METRICS_ATOL = 1e-4        # cli.metrics vs the same metric in memory (PSNR, dB)
QUANT_PSNR_DB = 0.05       # cli.metrics (8-bit PNGs) vs results.json (float images), dB
REPLAY_PIXELS = 8          # cli.render's replay vs a deform render of the trained model:
REPLAY_ATOL = 1e-2         # pixels beyond RENDER_ATOL, and the largest difference
PBR_ITERS = 300            # branch B from chkpnt1200: --iterations 1500 --pbr_iteration 1200
SHADE_ATOL = 1e-5          # GPU vs CPU shading of the same G-buffers
BAKE_U8_STEP = 1           # GPU vs CPU bake of one camera: uint8 maps differ by at most 1
RELIGHT_FRAMES = 32        # CUDA-event frames per relit / unlit timing
PBR_GRAPH_ITERS = 40       # eager vs graphed branch-B loop from chkpnt1200 (phase 7)
PBR_GRAPH_CHUNK = 16       # its chunks: 16, 9 (the observed iteration ends one), 15
PBR_GRAPH_OBSERVED = (CLI_ITERS + 25,)
PBR_STARVED_MB = 17.0      # one camera's 32,768 x 16 x 32 uint8 maps (16.8 MB): k_max = 1
PBR_TIMED_ITERS = 40       # graphed branch-B replays timed in one chunk
PBR_EAGER_ITERS = 10       # eager branch-B steps timed beside them
CPU_BAKE_THREADS = 6       # the CPU bake's process, beside the card's own host thread
DNA_DIR = CLI_DIR / "dna"
# the DNA-Rendering capture: the 5 MP rig's frame size (the reader halves it
# to 1224 x 1024), the real SMPL-X vertex count, 6 cameras x 4 frames
DNA = dict(cams=6, frames=4, width=2448, height=2048, verts=10475, dist=3.0, seed=0,
           gt_scale=0.006)
DNA_ITERS = 500            # cut from the 1,200-iteration budget for the script's time
DNA_MID = 250              # the run's other save
DNA_SMALL = dict(size=128, verts=1000)    # its GPU vs CPU step
MC_RANKS = 2               # the multichip phase's ranks (on one card: both on cuda:0)
MC_DIR = CLI_DIR / "multichip"
MC_ITERS = 600             # cli.train --multichip: densify at 400, 500 and 600
MC_EXACT_ITERS = 20        # iterations whose losses are held to MC_LOSS_RTOL (1 rank vs 2)
MC_LOSS_RTOL = 2e-3        # tests/test_determinism_multichip.py:254-255
# ceilings on the drift of 1 rank vs 2 over MC_ITERS: another order of the
# same float32 sums, amplified by Adam and the densify thresholds (two 1-rank
# runs one float32 step apart in xyz drifted 4.9e-3 / 0.22% / 0.43 dB on an
# H100, PERF.md 6.1)
MC_LOSS_ITERS = 100        # iterations whose losses are held to MC_LOSS_CEIL
MC_LOSS_CEIL = 5e-3        # relative
MC_ALIVE_CEIL = 5e-3       # relative, the alive counts at each densify event
MC_PSNR_CEIL = 0.5         # dB, the test PSNR at MC_ITERS
MC_PBR_ITERS = 20          # the sharded branch-B step's iterations
MC_PBR_DEGREE = 1          # the SH degree at iteration 1,200 and past it
KINK_SHARE = 0.01          # roughness entries past 1e-4 after a step (2 of 150 alive there)
MC_WIDE = (1224, 1024)     # a frame whose strips are not whole planar tile rows
MC_EXCHANGE = 16384        # cli.train's default --exchange_capacity
MC_TIMED_STEPS = 10        # sharded steps timed with the card synchronised per collective
RASTER_ATOL = 2e-5         # tests/test_raster_sharded.py:80-96 (depth 1e-4)
RASTER_DEPTH_ATOL = 1e-4
RASTER_GRAD_RTOL = 1e-4    # the JAX planar test's gradient tolerance
RASTER_GRAD_ATOL = 1e-5
# each kernel's own CUDA kernels, by name, for its device time
KERNEL_KEYS = {
    "knn": ("knn_kernel",),
    "deform": ("deform_fwd_kernel",),
    "deform_bwd": ("deform_bwd",),
    "blend_fwd": ("blend_fwd_kernel",),
    "blend_bwd": ("blend_bwd_sums_kernel", "blend_bwd_rows_kernel"),
    "blend_bwd_ckpt": ("blend_bwd_ckpt_kernel",),
    "blend_bwd_sums": ("blend_bwd_sums_kernel",),
    "blend_bwd_rows": ("blend_bwd_rows_kernel",),
}


def require(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=2):
    """Mean milliseconds of fn() on the card (CUDA events, after warm-up)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, name, reps=20, warmup=2, per_call=1):
    """Device milliseconds per fn() of kernel `name`'s own CUDA kernels
    (KERNEL_KEYS; `per_call` kernels of distinct names per call): the sum,
    over those names, of the median duration of the name's kernel events in
    a torch.profiler trace of `reps` calls. The profiler has been seen to
    drop most kernel events from some traces (the durations of the rest are
    right), so a median is taken and a short trace is noted; a trace with
    no event of some name is taken again, four times at most, then None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        durations: dict = {}
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and any(k in e.name for k in KERNEL_KEYS[name])):
                durations.setdefault(e.name, []).append(e.time_range.elapsed_us())
        found = sum(len(d) for d in durations.values())
        if found != reps * per_call:
            print(f"[profiler] {name}: {found} of {reps * per_call} kernel events in the trace",
                  flush=True)
        if len(durations) == per_call:
            return sum(float(np.median(d)) for d in durations.values()) / 1e3
    return None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.5f} ms"


def node_ops(prof, node):
    """How often the autograd node `node` was evaluated under the profiler,
    and the aten ops (name -> count) that ran inside those evaluations."""
    counts: dict = {}

    def walk(e):
        for ch in e.cpu_children:
            if ch.name.startswith("aten::"):
                counts[ch.name] = counts.get(ch.name, 0) + 1
            walk(ch)

    evals = [e for e in prof.events()
             if e.name.startswith("autograd::engine::evaluate_function") and e.name.endswith(node)]
    for e in evals:
        walk(e)
    return len(evals), counts


@contextlib.contextmanager
def capture(module, name, store):
    """Record the arguments of module.name's calls (the last one wins)."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        store[name] = (args, kwargs)
        return orig(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, orig)


def to_dev(x, dev):
    """A copy of a tree of tensors (NamedTuples, dataclasses, dicts, lists) on dev."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: to_dev(v, dev) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: to_dev(getattr(x, f.name), dev)
                                         for f in dataclasses.fields(x)})
    if hasattr(x, "_fields"):
        return type(x)(*(to_dev(v, dev) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_dev(v, dev) for v in x)
    return x


def device_us(e, total=False):
    """A profiler event's device time (its own, or with its children)."""
    return e.device_time_total if total else e.self_device_time_total


def bound(ops, nbytes):
    t_ops = ops / FP32_OPS_PER_S * 1e3
    t_bytes = nbytes / BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def make_trainer(scene, cfg, dev, lpips=True):
    """A fresh training state on `scene` (init state, seeded MLPs sized to
    the body's joints) and its train step with the default
    OptimizationConfig, LPIPS on, cropped to the scene's bound masks."""
    import torch

    from mygauhuman_torch.config import OptimizationConfig
    from mygauhuman_torch.eval.lpips import LPIPS
    from mygauhuman_torch.models.mlps import init_lbs_offset, init_pose_refiner
    from mygauhuman_torch.train import trainer as TT

    gen = torch.Generator().manual_seed(0)
    opt = OptimizationConfig()
    joints = scene.smpl_model.j_regressor.shape[0]
    ts, tx = TT.create_train_state(
        opt, scene.init_state, init_pose_refiner(gen, total_bones=joints, device=dev),
        init_lbs_offset(gen, total_bones=joints, device=dev))
    lp = LPIPS(device=dev) if lpips else None
    crop = TT.scene_lpips_crop([b.bound_mask for b in scene.batches])
    step = TT.make_train_step(scene.smpl_model, tx, opt, cfg, bg=torch.zeros(3, device=dev),
                              lpips_fn=lp, lpips_crop=crop)
    return dict(ts=ts, tx=tx, step=step, opt=opt, lpips=lp, crop=crop)


def narrow_batch(scene, cam, b0, cfg, masks):
    """A training view through `cam`: ground truth rendered from the scene's
    optimum, as make_synthetic_scene renders its views."""
    import torch

    from mygauhuman_torch.render import render_frame
    from mygauhuman_torch.train.trainer import TrainBatch

    with torch.no_grad():
        out = render_frame(scene.gt_state, cam, b0.frame, scene.smpl_model,
                           bg=torch.zeros(3, device=cam.w2c.device), active_sh_degree=0,
                           config=cfg)
    bkgd, bnd = masks(out.render_alpha, cam.width, cam.height)
    return TrainBatch(camera=cam, frame=b0.frame, gt_image=out.render, gt_normal=out.normal,
                      bkgd_mask=bkgd, bound_mask=bnd)


def row_errors(got, want):
    """Per-component max abs error of [NS, D] rows, and the worst one over
    its tolerance KERNEL_D_RTOL max|want| + 1e-6."""
    err_rows = (got - want).abs().max(dim=0).values
    tol = KERNEL_D_RTOL * want.abs().max(dim=0).values + 1e-6
    return err_rows, tol, float((err_rows / tol).max())


def check_kernel_a(label, q, r, k, excl, n_sm, report=None):
    """Kernel A against its plain version on one set of queries: bit for
    bit, its times against the plain version's and cdist + topk's, its bound."""
    import torch

    from mygauhuman_torch.ops.pallas_knn import (
        KERNEL_QUERIES_PER_BLOCK,
        KERNEL_WARPS_PER_BLOCK,
        knn_small_refs_cuda,
        knn_small_refs_plain,
    )

    d_k, i_k = knn_small_refs_cuda(q, r, k, exclude_self=excl)
    d_p, i_p = knn_small_refs_plain(q, r, k, exclude_self=excl)
    torch.cuda.synchronize()
    # -fmad=false and the plain version's operation order: bit-equal
    require(torch.equal(i_k, i_p) and torch.equal(d_k, d_p),
            f"KNN {label}: {int((i_k != i_p).sum())} indices and "
            f"{int((d_k != d_p).sum())} distances differ from the plain version")
    err = float((d_k - d_p).abs().max())
    ms = cuda_ms(lambda: knn_small_refs_cuda(q, r, k, exclude_self=excl))
    dms = device_ms(lambda: knn_small_refs_cuda(q, r, k, exclude_self=excl), "knn")
    plain_ms = cuda_ms(lambda: knn_small_refs_plain(q, r, k, exclude_self=excl), reps=5)
    lib_ms = cuda_ms(lambda: torch.cdist(q, r).topk(k, dim=1, largest=False), reps=5)
    blocks = -(-q.shape[0] // KERNEL_QUERIES_PER_BLOCK)
    Q, R = q.shape[0], r.shape[0]   # ~11 fp32 ops per pair (csrc/knn.cu)
    b_ms, b_by = bound(11.0 * Q * R, 12 * (Q + R) + 8 * Q * k)
    print(f"[kernel A knn] {label}: Q={q.shape[0]} R={r.shape[0]} k={k} "
          f"bit-equal to the plain version (max abs d2 err {err:.3e}), "
          f"kernel {ms:.4f} ms (device {fmt_ms(dms)}), plain {plain_ms:.4f} ms, cdist+topk "
          f"{lib_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by}); "
          f"{blocks} blocks, {blocks * KERNEL_WARPS_PER_BLOCK / n_sm:.1f} warps per SM "
          f"on {n_sm} SMs", flush=True)
    require(ms < lib_ms, f"KNN {label}: kernel {ms} ms not faster than cdist+topk")
    if report is not None:
        report["knn"] = dict(name="knn", route="cuda", source="mygauhuman_torch/csrc/knn.cu",
                             replaces="mygauhuman_tpu/ops/pallas_knn.py:32",
                             max_abs_err=err, ms=ms, device_ms=dms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def check_kernel_b(label, args, n_sm, report=None):
    """Kernel B's forward against its plain version on one call: bit for
    bit, its times and bound."""
    import torch

    from mygauhuman_torch.ops import cuda_lib
    from mygauhuman_torch.ops.pallas_deform import deform_rows_cuda, deform_rows_plain

    args = [a.detach().contiguous() for a in args]
    N = args[0].shape[1]
    got = deform_rows_cuda(*args)
    want = deform_rows_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # -fmad=false and the plain version's operation order: bit-equal
    require(bool(torch.isfinite(got).all()) and torch.equal(got, want),
            f"deform {label}: {int((got != want).sum())} values differ from the plain "
            f"version (max abs err {err})")
    ms = cuda_ms(lambda: deform_rows_cuda(*args), reps=50)
    dms = device_ms(lambda: deform_rows_cuda(*args), "deform", reps=50)
    plain_ms = cuda_ms(lambda: deform_rows_plain(*args), reps=10)
    threads = cuda_lib.library("deform").deform_threads()
    blocks = -(-N // threads)
    # 216 B per Gaussian (33 floats in, 21 out)
    b_ms, b_by = bound(DEFORM_FWD_OPS * N, (12 + 12 + 9 + 21) * 4 * N + 32 * 4)
    print(f"[kernel B deform] {label}: N={N} bit-equal to the plain version, "
          f"kernel {ms:.4f} ms (device {fmt_ms(dms)}), plain {plain_ms:.4f} ms; bound "
          f"{b_ms:.5f} ms ({b_by}); {blocks} blocks of {threads} on {n_sm} SMs", flush=True)
    if report is not None:
        report["deform"] = dict(name="deform", route="cuda",
                                source="mygauhuman_torch/csrc/deform.cu",
                                replaces="mygauhuman_tpu/ops/pallas_deform.py:139",
                                max_abs_err=err, ms=ms, device_ms=dms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_kernel_c(label, data, starts, counts, tile_base, kw, pb, pbb, report=None,
                   ckpt_report=False, name="blend_fwd"):
    """Kernel C against its plain version on one captured call, its time and
    bound, and its checkpoint mode: the same output, the checkpoints equal
    to D1's bit for bit and to the plain ones within CKPT_RTOL. A launch of
    several images (`tiles_per_image` in kw: the bake's stacked faces) has
    no checkpoint mode on the path, and D1 blends one image: its checkpoints
    are not checked. The report entry is `name`'s, with the TPU kernel of
    its layout."""
    import torch

    kw = {k: v for k, v in kw.items() if k != "checkpoints"}
    planar = kw["planar"]
    one_image = kw.get("tiles_per_image") is None
    args = (data, starts, counts, tile_base)
    got = pb.blend_instances_cuda(*args, **kw)
    want = pb.blend_instances_plain(*args, **kw)
    got_ck, ck = pb.blend_instances_cuda(*args, checkpoints=True, **kw)
    torch.cuda.synchronize()
    C = kw["n_channels"]
    # [C+3, H, W] or [T, C+3, P]: move the row axis first
    err_rows = (got - want).abs().movedim(0 if planar else 1, 0).reshape(C + 3, -1)
    err_depth = float(err_rows[C + 1].max())
    err = float(torch.cat([err_rows[:C + 1], err_rows[C + 2:]]).max())
    require(torch.isfinite(got).all() and err <= 1e-4 and err_depth <= 1e-3,
            f"blend {label}: max abs err {err} (depth row {err_depth})")
    require(torch.equal(got, got_ck), f"blend {label}: checkpoint mode changes the output")
    # the checkpoints: against D1 (the same serial product, bit for bit) and
    # against the plain version (the plain T is exp of a fp32 cumsum)
    n_tiles, tiles_x, tw_, th_ = kw["n_tiles"], kw["tiles_x"], kw["tile_w"], kw["tile_h"]
    P = tw_ * th_
    tiles = dict(n_tiles=n_tiles, tiles_x=tiles_x, tile_w=tw_, tile_h=th_)
    cot = torch.zeros((n_tiles, P, data.shape[0] - pb.HDR + 3), device=data.device)
    ms_d1, mism, e = None, {}, {}
    if one_image:
        ck_d1 = pbb.blend_bwd_ckpt_cuda(*args, cot, **tiles)
        ck_plain = pb.blend_fwd_checkpoints_plain(*args, **tiles)
        torch.cuda.synchronize()
        mism = pbb.checkpoint_mismatches(ck, ck_d1, counts)
        require(not any(mism.values()), f"blend {label}: checkpoints differ from D1's: {mism}")
        e = pbb.checkpoint_errors(ck._replace(chunk_sum=ck_plain.chunk_sum), ck_plain, counts)
        require(e["n_chunks_equal"] and e["map_equal"] and e["stop_mismatch"] == 0
                and max(e["t_rel"], e["t_final_rel"]) <= CKPT_RTOL,
                f"blend {label}: checkpoints vs plain {e}")
        ms_d1 = cuda_ms(lambda: pbb.blend_bwd_ckpt_cuda(*args, cot, **tiles))
    ms = cuda_ms(lambda: pb.blend_instances_cuda(*args, **kw))
    ms_ck = cuda_ms(lambda: pb.blend_instances_cuda(*args, checkpoints=True, **kw))
    dms = device_ms(lambda: pb.blend_instances_cuda(*args, **kw), "blend_fwd")
    dms_ck = device_ms(lambda: pb.blend_instances_cuda(*args, checkpoints=True, **kw),
                       "blend_fwd")
    plain_ms = cuda_ms(lambda: pb.blend_instances_plain(*args, **kw), reps=3, warmup=1)
    if ckpt_report:   # checkpoint mode's plain version: the blend and the checkpoints
        plain_ms = cuda_ms(lambda: (pb.blend_instances_plain(*args, **kw),
                                    pb.blend_fwd_checkpoints_plain(*args, **tiles)),
                           reps=3, warmup=1)
    n_busy = int((counts > 0).sum())
    n_chunks = int(ck.n_chunks)
    d1 = f"; D1 on the same inputs {ms_d1:.4f} ms" if one_image else ""
    print(f"[kernel C blend_fwd] {label}: tiles {n_tiles} ({n_busy} with instances, longest "
          f"{int(counts.max())}), instances {int(counts.sum())}, C={C}, max abs err {err:.3e} "
          f"(depth row {err_depth:.3e}), kernel {ms:.4f} ms (device {fmt_ms(dms)}), checkpoint "
          f"mode {ms_ck:.4f} ms (device {fmt_ms(dms_ck)}{d1}), "
          f"plain{' with the checkpoints' if ckpt_report else ''} {plain_ms:.4f} ms", flush=True)
    # the work these inputs need: pairs evaluated before each pixel stops,
    # ~20 fp32 ops each, plus 2 (C + 2) + 4 per included pair; the 7 + C
    # rows the kernel loads (x .. depth, features) of the instances some
    # pixel evaluates, starts and counts, and the output; checkpoint mode
    # adds T per (chunk, pixel), stop and T_final per pixel of the busy tiles
    # and the slot map
    _, n_eval, n_incl, n_read = pb._blend_instances_plain(
        *args, n_tiles=n_tiles, tiles_x=tiles_x, n_channels=C, tile_w=tw_, tile_h=th_,
        tiles_per_image=kw.get("tiles_per_image"))
    ops = 20.0 * n_eval + (2.0 * (C + 2) + 4.0) * n_incl
    nbytes = (7 + C) * 4 * n_read + 8 * n_tiles + got.numel() * 4
    b_ms, b_by = bound(ops, nbytes)
    b_ck = bound(ops, nbytes + 4 * (n_chunks + 2 * n_busy) * P + 8 * n_chunks)
    checked = (f"checkpoints vs D1: {sum(mism.values())} values differ; vs plain: stop "
               f"mismatches off near-ties {e['stop_mismatch']}, near-ties {e['near_ties']}, "
               f"T rel {e['t_rel']:.3e}, T_final rel {e['t_final_rel']:.3e}" if one_image
               else "checkpoints not checked (several images)")
    print(f"[kernel C blend_fwd] {label} work: {n_eval} (pixel, instance) pairs "
          f"evaluated, {n_incl} included, {n_read} instances read, "
          f"{ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB, bound {b_ms:.5f} ms ({b_by}); "
          f"checkpoint mode {n_chunks} chunk slots, bound {b_ck[0]:.5f} ms ({b_ck[1]}); "
          f"{checked}", flush=True)
    if report is not None:
        # ckpt_report: the checkpoint mode's time and bound (a training
        # step's forward) in place of the plain mode's
        report[name] = dict(
            name=name, route="cuda", source="mygauhuman_torch/csrc/blend_fwd.cu",
            replaces="mygauhuman_tpu/ops/pallas_blend.py:" + ("362" if planar else "288"),
            max_abs_err=max(err, err_depth), ms=ms_ck if ckpt_report else ms,
            device_ms=dms_ck if ckpt_report else dms, plain_ms=plain_ms,
            bound_ms=(b_ck if ckpt_report else (b_ms, b_by))[0],
            bound_by=(b_ck if ckpt_report else (b_ms, b_by))[1], library_ms=None)
    return dms_ck, b_ck[0]


def check_kernel_d(label, call, C, report, pb, pbb, main):
    """Kernel D and its launches against their plain versions on one
    captured backward call of a blend with C feature channels: the step's
    D1s + D2 on kernel C's checkpoints, and the standalone D1, D1s, D2."""
    import torch

    (data, starts, counts, tile_base, cot, ck_c), kw = call
    args = (data, starts, counts, tile_base, cot)
    want = pbb.blend_tiles_bwd_plain(*args, **kw)
    got = pbb.blend_tiles_bwd_from_ckpt_cuda(*args, ck_c, **kw)
    got_d = pbb.blend_tiles_bwd_cuda(*args, **kw)
    torch.cuda.synchronize()
    err_rows, tol, worst = row_errors(got, want)
    err = float(err_rows.max())
    require(bool(torch.isfinite(got).all()) and worst <= 1.0,
            f"blend_bwd {label}: component errors {err_rows.tolist()} over {tol.tolist()}")
    err_d_rows, tol_d, worst_d = row_errors(got_d, want)
    require(bool(torch.isfinite(got_d).all()) and worst_d <= 1.0,
            f"blend_bwd {label} (D1, D1s, D2): component errors {err_d_rows.tolist()} over "
            f"{tol_d.tolist()}")
    # D1 + D1s against their plain version; D1s and D2 against theirs on
    # the kernels' checkpoints
    ck = pbb.blend_bwd_checkpoints_cuda(*args, **kw)
    ck_want = pbb.blend_bwd_checkpoints_plain(*args, **kw)
    sums_want = pbb.blend_bwd_sums_plain(*args, ck, **kw)
    torch.cuda.synchronize()
    e1 = pbb.checkpoint_errors(ck, ck_want, counts)
    require(e1["n_chunks_equal"] and e1["map_equal"] and e1["stop_mismatch"] == 0
            and max(e1["t_rel"], e1["t_final_rel"], e1["sum_rel"]) <= CKPT_RTOL,
            f"blend_bwd_ckpt {label}: {e1}")
    mism = pbb.checkpoint_mismatches(ck_c, ck, counts)
    require(not any(mism.values()), f"blend_bwd {label}: kernel C's checkpoints differ "
            f"from D1's: {mism}")
    n_chunks = int(ck.n_chunks)
    sums_err = float((ck.chunk_sum[:n_chunks] - sums_want[:n_chunks]).abs().max())
    sums_rel = sums_err / float(sums_want[:n_chunks].abs().max())
    require(sums_rel <= CKPT_RTOL, f"blend_bwd_sums {label}: {sums_rel} of the largest sum")
    rows = pbb.blend_bwd_rows_cuda(*args, ck, **kw)
    rows_want = pbb.blend_bwd_rows_plain(*args, ck, **kw)
    torch.cuda.synchronize()
    err2_rows, tol2, worst2 = row_errors(rows, rows_want)
    require(bool(torch.isfinite(rows).all()) and worst2 <= 1.0,
            f"blend_bwd_rows {label}: component errors {err2_rows.tolist()} over "
            f"{tol2.tolist()}")
    ms = cuda_ms(lambda: pbb.blend_tiles_bwd_from_ckpt_cuda(*args, ck_c, **kw))
    ms_d = cuda_ms(lambda: pbb.blend_tiles_bwd_cuda(*args, **kw))
    ms1 = cuda_ms(lambda: pbb.blend_bwd_ckpt_cuda(*args, **kw))
    ms1s = cuda_ms(lambda: pbb.blend_bwd_sums_cuda(*args, ck, **kw))
    ms2 = cuda_ms(lambda: pbb.blend_bwd_rows_cuda(*args, ck, **kw))
    dms = device_ms(lambda: pbb.blend_tiles_bwd_from_ckpt_cuda(*args, ck_c, **kw), "blend_bwd",
                    per_call=2)
    dms1 = device_ms(lambda: pbb.blend_bwd_ckpt_cuda(*args, **kw), "blend_bwd_ckpt")
    dms1s = device_ms(lambda: pbb.blend_bwd_sums_cuda(*args, ck, **kw), "blend_bwd_sums")
    dms2 = device_ms(lambda: pbb.blend_bwd_rows_cuda(*args, ck, **kw), "blend_bwd_rows")
    plain_ms = cuda_ms(lambda: pbb.blend_tiles_bwd_plain(*args, **kw), reps=2, warmup=1)
    # D1's plain version computes the sums too (blend_bwd_checkpoints_plain)
    plain1 = cuda_ms(lambda: pbb.blend_bwd_checkpoints_plain(*args, **kw), reps=2, warmup=1)
    plain1s = cuda_ms(lambda: pbb.blend_bwd_sums_plain(*args, ck, **kw), reps=2, warmup=1)
    plain2 = cuda_ms(lambda: pbb.blend_bwd_rows_plain(*args, ck, **kw), reps=2, warmup=1)
    cf = data.shape[0] - pb.HDR
    require(cf == -(-C // 8) * 8, f"blend_bwd {label}: {cf} feature rows for C={C}")
    n_tiles = kw["n_tiles"]
    P = kw["tile_w"] * kw["tile_h"]
    # the work these inputs need, at the C channels that carry data (not the
    # zero pad to Cf): both passes evaluate the pairs before each pixel stops
    # (~20 fp32 ops each), the included pairs add the gradient arithmetic
    # (~3 C + 30); the 7 + C rows of the instances some pixel evaluates are
    # read, with the C + 3 cotangent columns of the tiles that hold an
    # instance and starts / counts, and their 7 + C gradient rows written
    _, n_eval, n_incl, n_read = pb._blend_instances_plain(
        data, starts, counts, tile_base, n_tiles=n_tiles, tiles_x=kw["tiles_x"],
        n_channels=cf, tile_w=kw["tile_w"], tile_h=kw["tile_h"])
    n_busy = int((counts > 0).sum())
    ops = 40.0 * n_eval + (3.0 * C + 30.0) * n_incl
    nbytes = 2 * (7 + C) * 4 * n_read + n_busy * P * (C + 3) * 4 + 8 * n_tiles
    b_ms, b_by = bound(ops, nbytes)
    # D1: one pass over the pairs (~20 ops) and the T step of the included
    # ones; reads 6 rows of the instances, writes T per (chunk, pixel) and
    # stop, T_final per pixel of the busy tiles
    ckpt_bytes = 4 * (2 * n_chunks * P + 2 * n_busy * P)
    b1 = bound(20.0 * n_eval + 2.0 * n_incl,
               6 * 4 * n_read + 8 * n_tiles + 4 * (n_chunks + 2 * n_busy) * P)
    # D1s: the pairs before each stop again and w q of the included ones
    # (2 C + 6); reads the 7 + C rows, C + 2 cotangent columns, T and stop,
    # writes the sums
    b1s = bound(20.0 * n_eval + (2.0 * C + 6.0) * n_incl,
                (7 + C) * 4 * n_read + n_busy * P * (C + 2) * 4 + 8 * n_tiles
                + 4 * (2 * n_chunks + n_busy) * P)
    # D2: the same pairs again with the gradient arithmetic of the included
    # ones; reads the rows, C + 3 cotangent columns and the checkpoints,
    # writes the 7 + C gradient rows
    ops2 = 20.0 * n_eval + (3.0 * C + 30.0) * n_incl
    b2 = bound(ops2, 2 * (7 + C) * 4 * n_read + n_busy * P * (C + 3) * 4 + 8 * n_tiles
               + ckpt_bytes)
    print(f"[kernel D blend_bwd] {label}: tiles {n_tiles} ({n_busy} with instances), "
          f"instances {int(counts.sum())} (longest tile {int(counts.max())}), C={C} (Cf={cf}), "
          f"the step's D1s + D2 on kernel C's checkpoints: max abs err {err:.3e} (worst "
          f"component at {worst:.3f} of its tolerance), {ms:.4f} ms (device {fmt_ms(dms)}); "
          f"standalone D1 + D1s + "
          f"D2: max abs err {float(err_d_rows.max()):.3e}, {ms_d:.4f} ms; plain "
          f"{plain_ms:.4f} ms; work: {n_eval} pairs evaluated, "
          f"{n_incl} included, {n_read} instances read, {ops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB, bound {b_ms:.5f} ms ({b_by})", flush=True)
    print(f"[kernel D blend_bwd] {label}: D1 T checkpoints {ms1:.4f} ms (device "
          f"{fmt_ms(dms1)}; plain, with the sums, {plain1:.4f} ms; bound {b1[0]:.5f} ms, {b1[1]}; "
          f"{n_busy} blocks), D1s chunk sums {ms1s:.4f} ms (device {fmt_ms(dms1s)}; plain "
          f"{plain1s:.4f} ms, bound {b1s[0]:.5f} ms, {b1s[1]}; {n_chunks} working blocks), D2 "
          f"rows {ms2:.4f} ms (device {fmt_ms(dms2)}; plain "
          f"{plain2:.4f} ms, bound {b2[0]:.5f} ms, {b2[1]}; {n_chunks} working blocks of "
          f"{ck.t_start.shape[0]} launched); D1 vs plain: stop mismatches off near-ties "
          f"{e1['stop_mismatch']}, near-ties {e1['near_ties']}, T rel {e1['t_rel']:.3e}, "
          f"T_final rel {e1['t_final_rel']:.3e}, chunk sums {e1['sum_rel']:.3e} of the "
          f"largest; kernel C's checkpoints vs D1's: {sum(mism.values())} values differ; "
          f"D1s vs plain: {sums_rel:.3e} of the largest sum; D2 vs plain: max abs err "
          f"{float(err2_rows.max()):.3e} (worst component at {worst2:.3f} of its tolerance)",
          flush=True)
    if main:
        src = "mygauhuman_torch/csrc/blend_bwd.cu"
        tpu = "mygauhuman_tpu/ops/pallas_blend_bwd.py:51"
        # the step's kernel D: D1s + D2 on kernel C's checkpoints
        report["blend_bwd"] = dict(
            name="blend_bwd", route="cuda", source=src, replaces=tpu, max_abs_err=err, ms=ms,
            device_ms=dms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        # D1's error: the largest relative error of T against the plain T
        report["blend_bwd_ckpt"] = dict(
            name="blend_bwd_ckpt", route="cuda", source=src, replaces=tpu,
            max_abs_err=max(e1["t_rel"], e1["t_final_rel"]), ms=ms1, device_ms=dms1,
            plain_ms=plain1, bound_ms=b1[0], bound_by=b1[1], library_ms=None)
        report["blend_bwd_sums"] = dict(
            name="blend_bwd_sums", route="cuda", source=src, replaces=tpu,
            max_abs_err=sums_err, ms=ms1s, device_ms=dms1s, plain_ms=plain1s,
            bound_ms=b1s[0], bound_by=b1s[1], library_ms=None)
        report["blend_bwd_rows"] = dict(
            name="blend_bwd_rows", route="cuda", source=src, replaces=tpu,
            max_abs_err=float(err2_rows.max()), ms=ms2, device_ms=dms2, plain_ms=plain2,
            bound_ms=b2[0], bound_by=b2[1], library_ms=None)


def check_kernel_b_bwd(call, report, label="training step"):
    """Kernel B's backward on one captured backward call of a training step:
    bit for bit against its plain version (with the gradients the step asks
    for, and with all four, the scalars' two-pass sum included), and within
    DEFORM_BWD_RTOL of autograd of the plain forward; its times and bound."""
    import torch

    from mygauhuman_torch.ops import pallas_deform as pd

    args, kw = call
    args = [t.detach() for t in args]
    needs = tuple(kw.get("needs", (True,) * 4))
    names = ("abig", "asrc", "packed", "scalars")
    N = args[0].shape[1]
    want = pd.deform_rows_bwd_plain(*args)
    got = pd.deform_rows_bwd_cuda(*args, needs=needs)
    full = pd.deform_rows_bwd_cuda(*args)
    again = pd.deform_rows_bwd_cuda(*args)
    torch.cuda.synchronize()
    for name, x, y, need in zip(names, got, want, needs):
        require((x is None) != need, f"deform_bwd: d_{name} {'missing' if need else 'written'}")
        require(not need or torch.equal(x, y), f"deform_bwd: d_{name} differs from the plain "
                f"version in {0 if x is None else int((x != y).sum())} values")
    for name, x, y, z in zip(names, full, want, again):
        require(torch.equal(x, y), f"deform_bwd (all four): d_{name} differs from the plain "
                f"version in {int((x != y).sum())} values")
        require(torch.equal(x, z), f"deform_bwd: d_{name} differs between two runs")
    inputs = [t.detach().clone().requires_grad_(True) for t in args[:4]]
    ag = torch.autograd.grad(pd.deform_rows_plain(*inputs), inputs, args[4])
    errs = []
    for name, x, y in zip(names, full, ag):
        err, scale = float((x - y).abs().max()), float(y.abs().max())
        require(bool(torch.isfinite(x).all()) and err <= DEFORM_BWD_RTOL * scale + 1e-6,
                f"deform_bwd vs autograd: d_{name} err {err} (max {scale})")
        errs.append(err / (scale + 1e-30))

    step = lambda: pd.deform_rows_bwd_cuda(*args, needs=needs)   # noqa: E731
    ms = cuda_ms(step, reps=50)
    dms = device_ms(step, "deform_bwd", reps=50, per_call=1 + needs[3])
    plain_ms = cuda_ms(lambda: pd.deform_rows_bwd_plain(*args), reps=5, warmup=1)
    fwd_ms = cuda_ms(lambda: pd.deform_rows_cuda(*args[:4]), reps=50)
    fwd_dms = device_ms(lambda: pd.deform_rows_cuda(*args[:4]), "deform", reps=50)
    # reads the input rows and the 21 cotangent rows, writes the gradient
    # rows asked for (with the scalars: their [21, N / 32] partials and sum);
    # asrc's translation rows reach only the scalars' shares
    rows_out = 12 * needs[0] + 12 * needs[1] + 9 * needs[2]
    nbytes = (30 + 3 * needs[3] + 21 + rows_out) * 4 * N + 32 * 4
    ops = DEFORM_BWD_OPS * N
    if needs[3]:
        nbytes += 2 * 21 * 4 * -(-N // 32) + 32 * 4
        ops += DEFORM_SCALAR_OPS * N
    b_ms, b_by = bound(ops, nbytes)
    print(f"[kernel B deform_bwd] {label}: N={N}, gradients asked for "
          f"{[n for n, need in zip(names, needs) if need]}; bit-equal to the plain version "
          f"(asked, and all four), the same bits twice; vs autograd of the plain forward: "
          + ", ".join(f"d_{n} {e:.3e}" for n, e in zip(names, errs))
          + f" of the largest (tolerance {DEFORM_BWD_RTOL}); kernel {ms:.4f} ms (device "
          f"{fmt_ms(dms)}), plain {plain_ms:.4f} ms; {nbytes / 1e6:.2f} MB, {ops / 1e6:.2f} MFLOP, bound {b_ms:.5f} ms "
          f"({b_by}); the forward at this N {fwd_ms:.4f} ms (device {fmt_ms(fwd_dms)})",
          flush=True)
    # what the loop runs: the forward at the training N
    report["deform"].update(loop_device_ms=fwd_dms, loop_bound_ms=bound(
        DEFORM_FWD_OPS * N, (12 + 12 + 9 + 21) * 4 * N + 32 * 4)[0])
    report["deform_bwd"] = dict(
        name="deform_bwd", route="cuda", source="mygauhuman_torch/csrc/deform.cu",
        replaces="mygauhuman_tpu/ops/pallas_deform.py:204",
        max_abs_err=max(float((x - y).abs().max()) for x, y in zip(full, ag)), ms=ms,
        device_ms=dms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)


def small_scene_config():
    """The GPU vs CPU steps' raster config (capacity 1,024)."""
    from mygauhuman_torch.ops.rasterize import RasterizerConfig

    return RasterizerConfig(tile_capacity=1024, instance_capacity=4 * 1024)


def train_gpu_vs_cpu(dev, scene=None, label="128^2"):
    """One train step's loss, metrics and every gradient leaf on the card
    against the same step on the CPU (plain path), same inputs: on `scene`,
    by default the 24-joint synthetic scene at 128^2 (1,000 Gaussians)."""
    import torch

    from mygauhuman_torch.data.synthetic import make_synthetic_scene
    from mygauhuman_torch.eval.lpips import LPIPS
    from mygauhuman_torch.train import trainer as TT
    from mygauhuman_torch.train.optim import tree_leaves

    cpu = torch.device("cpu")
    cfg = small_scene_config()
    if scene is None:
        scene = make_synthetic_scene(n_views=2, width=128, height=128, n_verts=1000,
                                     capacity=1024, seed=1, raster_config=cfg, device=dev)
    g = make_trainer(scene, cfg, dev)
    c_lpips = LPIPS(device=cpu)
    c_lpips.params = to_dev(g["lpips"].params, cpu)
    c_step = TT.make_train_step(to_dev(scene.smpl_model, cpu), g["tx"], g["opt"], cfg,
                                bg=torch.zeros(3), lpips_fn=c_lpips, lpips_crop=g["crop"])
    b = scene.batches[0]
    res_g = g["step"].loss_and_grads(g["ts"], b, 0)
    t0 = time.perf_counter()
    res_c = c_step.loss_and_grads(to_dev(g["ts"], cpu), to_dev(b, cpu), 0)
    cpu_s = time.perf_counter() - t0
    m_g, m_c = res_g[1], res_c[1]
    for k in ("loss", "l1", "mask", "normal", "axis", "ssim", "lpips_term", "tv", "psnr"):
        a, c = float(m_g[k]), float(m_c[k])
        require(abs(a - c) <= 1e-4 * abs(c) + 1e-6, f"GPU vs CPU step: {k} {a} vs {c}")
    leaves_g = tree_leaves(res_g[2]) + [res_g[3]]
    leaves_c = tree_leaves(res_c[2]) + [res_c[3]]
    worst = 0.0
    for i, (a, c) in enumerate(zip(leaves_g, leaves_c)):
        err = float((a.cpu() - c).abs().max())
        scale = float(c.abs().max())
        worst = max(worst, err / (scale + 1e-30) if scale > 0 else 0.0)
        require(err <= GRAD_RTOL * scale + 1e-8,
                f"GPU vs CPU step: gradient leaf {i} {tuple(c.shape)} err {err} (max {scale})")
    require(bool(torch.equal(res_g[4].cpu(), res_c[4])), "GPU vs CPU step: radii differ")
    print(f"[train] GPU vs CPU step at {label} (capacity 1,024, LPIPS on): loss "
          f"{float(m_g['loss']):.6f} vs {float(m_c['loss']):.6f}; {len(leaves_g)} gradient "
          f"leaves, worst max abs err {worst:.3e} of the leaf's max (tolerance {GRAD_RTOL}); "
          f"CPU step {cpu_s:.1f} s", flush=True)


def same_step_twice(step, ts, batch, deg, label):
    """The same train step twice from the same state: gradients, new
    parameters and densify statistics bit-equal."""
    import torch

    from mygauhuman_torch.train import trainer as TT
    from mygauhuman_torch.train.optim import tree_leaves, tree_map

    a = step.loss_and_grads(ts, batch, deg)
    b = step.loss_and_grads(ts, batch, deg)
    same_grads = all(torch.equal(x, y) for x, y in zip(tree_leaves(a[2]) + [a[3]],
                                                         tree_leaves(b[2]) + [b[3]]))
    # a graphed step returns its own tensors, which the next call rewrites
    s1 = tree_map(torch.clone, step(ts, batch, deg)[0])
    s2, _ = step(ts, batch, deg)
    same_params = all(torch.equal(x, y) for x, y in zip(tree_leaves(TT.trainable_params(s1)),
                                                         tree_leaves(TT.trainable_params(s2))))
    same_stats = torch.equal(s1.gauss.xyz_grad_accum, s2.gauss.xyz_grad_accum)
    print(f"[train] {label} twice: gradients bit-equal {same_grads}, new params "
          f"bit-equal {same_params}, densify stats bit-equal {same_stats}", flush=True)
    require(same_grads and same_params and same_stats, f"{label} twice differs")


def train_bench(scene, cfg, train, dev):
    """Determinism, ms/step, a profile and the 60-iteration loop at the bench point."""
    import torch

    from mygauhuman_torch.config import OptimizationConfig
    from mygauhuman_torch.eval.metrics import evaluate_images
    from mygauhuman_torch.ops import cuda_lib
    from mygauhuman_torch.render import render_frame
    from mygauhuman_torch.train import trainer as TT

    step, ts0, batches = train["step"], train["ts"], scene.batches
    same_step_twice(step, ts0, batches[0], 0, "the bench step")

    # ms/step over TRAIN_STEPS steps after warm-up
    ts = ts0
    for i in range(3):
        ts, m = step(ts, batches[i % 4], 0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(TRAIN_STEPS):
        ts, m = step(ts, batches[i % 4], 0)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    ms = start.elapsed_time(end) / TRAIN_STEPS
    require(bool(torch.isfinite(m["loss"])), "non-finite loss in the timed steps")
    print(f"[train] bench point ({scene.init_state.capacity} capacity, 512^2, LPIPS crop "
          f"{train['crop']}): {ms:.3f} ms/step over {TRAIN_STEPS} steps (host clock "
          f"{host_ms:.3f} ms/step); EXTRAPOLATION, not a measured run: 1,200 iterations x "
          f"{ms:.3f} ms = {1.2 * ms:.1f} s of steps", flush=True)

    # where a step's time goes
    from torch.profiler import ProfilerActivity, profile

    cuda_lib.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILE_FRAMES):
            ts, m = step(ts, batches[i % 4], 0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / PROFILE_FRAMES
    require(cuda_lib.LAUNCHES["deform_bwd"] == PROFILE_FRAMES,
            f"{cuda_lib.LAUNCHES['deform_bwd']} kernel B backward passes in {PROFILE_FRAMES} steps")
    # kernel B's backward node: the kernel, and no plain elementwise ops
    n_evals, b_ops = node_ops(prof, "_DeformRowsBackward")
    storm = sum(n for op, n in b_ops.items() if op in ("aten::mul", "aten::add", "aten::add_"))
    require(n_evals == PROFILE_FRAMES and storm == 0,
            f"kernel B's backward node: {n_evals} evaluations in {PROFILE_FRAMES} steps, ops {b_ops}")
    kernels_ = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(device_us(e) for e in kernels_) / PROFILE_FRAMES
    if busy_us <= 0:
        print("[profile] train step: device time not measured (no CUDA events)")
    else:
        launches_ = sum(e.count for e in kernels_) / PROFILE_FRAMES
        bwd_us = sum(device_us(e, total=True) for e in prof.events()
                     if e.name.startswith("autograd::engine::evaluate_function")) / PROFILE_FRAMES
        d_us = sum(device_us(e) for e in kernels_ if "blend_bwd" in e.key) / PROFILE_FRAMES
        c_us = sum(device_us(e) for e in kernels_ if "blend_fwd" in e.key) / PROFILE_FRAMES
        d1_steps = sum(e.count for e in kernels_ if "blend_bwd_ckpt" in e.key)
        require(d1_steps == 0, f"D1 was launched {d1_steps} times in the profiled steps")
        b_bwd = [e for e in kernels_ if "deform_bwd" in e.key]
        b_bwd_us = sum(device_us(e) for e in b_bwd) / PROFILE_FRAMES
        b_fwd_us = sum(device_us(e) for e in kernels_ if "deform_fwd" in e.key) / PROFILE_FRAMES
        # (the launch count is required above; the trace may drop events)
        b_bwd_n = sum(e.count for e in b_bwd)
        print(f"[profile] train step under the profiler: {wall_us:.0f} us/step wall, "
              f"{busy_us:.0f} us/step device busy ({100 * busy_us / wall_us:.1f}%), "
              f"{launches_:.0f} kernel launches/step (no D1); backward (autograd engine) "
              f"{bwd_us:.0f} us/step of device time, the rest {busy_us - bwd_us:.0f} us; "
              f"kernel D (D1s + D2) {d_us:.1f} us/step ({100 * d_us / busy_us:.2f}% of device "
              f"time); kernel C (checkpoint mode) {c_us:.1f} us/step; kernel B forward "
              f"{b_fwd_us:.2f} us/step, backward {b_bwd_us:.2f} us/step ({b_bwd_n} kernels in "
              f"the trace of {PROFILE_FRAMES} steps; "
              f"{sum(b_ops.values()) / PROFILE_FRAMES:.1f} aten ops per evaluation of its "
              f"autograd node: {dict(sorted(b_ops.items()))})")
        for e in sorted(kernels_, key=device_us, reverse=True)[:10]:
            print(f"[profile]   {device_us(e) / PROFILE_FRAMES:8.1f} us/step "
                  f"{e.count / PROFILE_FRAMES:5.1f}x  {e.key[:90]}")

    # the training main path: a train_loop from the init state
    opt = OptimizationConfig(iterations=LOOP_ITERS, densify_from_iter=20,
                             densify_until_iter=LOOP_ITERS, densification_interval=20,
                             opacity_reset_interval=50)
    step_l = TT.make_train_step(scene.smpl_model, train["tx"], opt, cfg,
                                bg=torch.zeros(3, device=dev), lpips_fn=train["lpips"],
                                lpips_crop=train["crop"])
    log = []

    def cb(it, ts, m):
        log.append((float(m["loss"]), float(m["psnr"])))
        if "densify_alive" in m:
            print(f"[train] densify event at iteration {it}: " + ", ".join(
                f"{k[8:]} {m[k]}" for k in m if k.startswith("densify_"))
                + f", capacity {m['capacity']}", flush=True)

    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    ts, m = TT.train_loop(ts0, train["tx"], step_l, batches, opt, extent=scene.extent,
                          smpl_vertices=scene.big_pose_verts, max_sh_degree=3, callback=cb)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = dict(cuda_lib.LAUNCHES)
    loss = np.array([x[0] for x in log])
    psnr = np.array([x[1] for x in log])
    windows = ((0, 1), (10, 20), (30, 40), (40, 50), (50, 60))
    print(f"[train] train_loop of {LOOP_ITERS} iterations in {loop_s:.1f} s; launches "
          f"{launches}; mean loss / PSNR over iterations " + ", ".join(
              f"{a + 1}-{b}: {loss[a:b].mean():.5f} / {psnr[a:b].mean():.3f}"
              for a, b in windows), flush=True)
    print(f"[train] loss per iteration {np.round(loss, 4).tolist()}")
    print(f"[train] PSNR per iteration {np.round(psnr, 3).tolist()}")
    # the loop's backward runs D1s and D2 on kernel C's checkpoints: no D1
    for name in ("knn", "deform", "deform_bwd", "blend_fwd", "blend_fwd_ckpt", "blend_bwd",
                 "blend_bwd_sums", "blend_bwd_rows"):
        require(launches[name] > 0, f"kernel {name} was not launched in the train loop")
    require(launches["deform_bwd"] == LOOP_ITERS,
            f"{launches['deform_bwd']} kernel B backward passes in {LOOP_ITERS} iterations")
    require(launches["blend_bwd_ckpt"] == 0, "D1 was launched in the train loop")
    require(launches["blend_fwd_ckpt"] == launches["blend_bwd"],
            "a differentiated forward without its backward, or the reverse")
    require(np.isfinite(loss[-1]), "the train loop ended with a non-finite loss")
    # learning is read on the last 10 iterations before the first event: each
    # densify event replaces Gaussians (PSNR dips) and the opacity reset at
    # 50 sets every opacity to 0.01, so the windows after them measure the
    # events, not the optimizer
    require(loss[10:20].mean() < loss[0], "loss did not fall before the first densify event")
    require(psnr[10:20].mean() > psnr[0], "PSNR did not rise before the first densify event")

    with torch.no_grad():
        renders = [render_frame(ts.gauss, b.camera, b.frame, scene.smpl_model,
                                bg=torch.zeros(3, device=dev), active_sh_degree=0,
                                mlp_params={"pose_refiner": ts.pose_refiner,
                                            "lbs_offset": ts.lbs_offset}, config=cfg).render
                   for b in batches]
    res = evaluate_images(renders, [b.gt_image for b in batches], lpips_model=train["lpips"])
    print(f"[train] trained views after the loop (capacity {ts.gauss.capacity}, "
          f"{int(ts.gauss.num_alive)} alive): PSNR {res['psnr']:.3f}, SSIM {res['ssim']:.4f}, "
          f"lpips_rand {res['lpips_rand']:.4f}", flush=True)
    return launches


def train_graph_phase(scene, cfg, train, dev, card):
    """Phase 5's graphed loop, this slice's main path at the bench point:
    from one state, train_loop with the eager step (scan_chunk=1) against
    the donated, graphed step (train/graph.py, scan_chunk=GRAPH_CHUNK) for
    GRAPH_LOOP_ITERS iterations across densify events (one of them growing
    the capacity) and an opacity reset: every state leaf (parameters, both
    Adam moments, the densify statistics) and every iteration's metrics bit
    for bit; every chunk under sync-debug "error"; the path's launches
    (counts reset before it, read after); the wall of both loops, then the
    steady state (CUDA events, the host clock, the device busy share under
    torch.profiler) and the launches per replay. Returns the graphed loop's
    launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mygauhuman_torch.config import OptimizationConfig
    from mygauhuman_torch.ops import cuda_lib
    from mygauhuman_torch.train import trainer as TT
    from mygauhuman_torch.train.graph import stack_views
    from mygauhuman_torch.train.optim import tree_leaves

    opt = OptimizationConfig(iterations=GRAPH_LOOP_ITERS, **GRAPH_LOOP)
    kw = dict(bg=torch.zeros(3, device=dev), lpips_fn=train["lpips"], lpips_crop=train["crop"])
    eager = TT.make_train_step(scene.smpl_model, train["tx"], opt, cfg, **kw)
    graphed = TT.make_train_step(scene.smpl_model, train["tx"], opt, cfg, donate=True, **kw)
    chunk = graphed.chunk
    ts0, batches = train["ts"], scene.batches
    runs = {}
    for mode in ("eager", "graphed"):
        per_it, events = [], []

        def cb(it, ts, m):
            if "capacity" in m:
                events.append((it, m["capacity"], m["densify_alive"]))

        if mode == "eager":
            def step_fn(ts, b, deg):
                ts, m = eager(ts, b, deg)
                per_it.append(m)
                return ts, m
        else:
            def checked_chunk(ts, views, idx, deg, pad_to=0):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = chunk(ts, views, idx, deg, pad_to)
                except RuntimeError as e:
                    require(False, f"a graphed chunk synchronised with the host: {e}")
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                mseq, n = out[1]
                per_it.extend({k: v[t] for k, v in mseq.items()} for t in range(n))
                return out

            step_fn = graphed
            graphed.chunk = checked_chunk
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        ts, _ = TT.train_loop(ts0, train["tx"], step_fn, batches, opt, extent=scene.extent,
                              smpl_vertices=scene.big_pose_verts, max_sh_degree=3,
                              callback=cb, scan_chunk=1 if mode == "eager" else GRAPH_CHUNK)
        torch.cuda.synchronize()
        runs[mode] = dict(ts=ts, per_it=per_it, events=events,
                          wall=time.perf_counter() - t0, launches=dict(cuda_lib.LAUNCHES),
                          peak_mb=torch.cuda.max_memory_allocated() / 1e6)
    graphed.chunk = chunk
    e, g = runs["eager"], runs["graphed"]
    leaves_e, leaves_g = tree_leaves(e["ts"]), tree_leaves(g["ts"])
    same_state = (len(leaves_e) == len(leaves_g) and e["ts"].step == g["ts"].step
                  and e["ts"].opt_state.count == g["ts"].opt_state.count
                  and all(torch.equal(a, b) for a, b in zip(leaves_e, leaves_g)))
    require(len(g["per_it"]) == len(e["per_it"]) == GRAPH_LOOP_ITERS,
            f"{len(g['per_it'])} graphed and {len(e['per_it'])} eager iterations' metrics")
    bad = [(t + 1, k) for t in range(GRAPH_LOOP_ITERS) for k in e["per_it"][t]
           if not torch.equal(e["per_it"][t][k], g["per_it"][t][k])]
    launches, captures = g["launches"], graphed.captures
    print(f"[train-graph] train_loop of {GRAPH_LOOP_ITERS} iterations at the bench point "
          f"from one state, eager (scan_chunk 1) | graphed (donate, scan_chunk {GRAPH_CHUNK}): "
          f"the final state bit-equal {same_state} ({len(leaves_g)} leaves: parameters, both "
          f"Adam moments, the densify statistics; step {g['ts'].step}, counts "
          f"{g['ts'].opt_state.count['xyz']}), every iteration's metrics bit-equal "
          f"{not bad} ({len(e['per_it'][0])} per iteration); densify events (iteration, "
          f"capacity, alive) {e['events']} | {g['events']}, opacity reset at "
          f"{opt.opacity_reset_interval}; every chunk under sync-debug \"error\" without a "
          f"host sync", flush=True)
    require(same_state and not bad, f"graphed loop differs from the eager one: state "
            f"{same_state}, metrics {bad[:10]}")
    require(e["events"] == g["events"] and any(c > ts0.gauss.capacity for _, c, _ in g["events"]),
            f"densify events {e['events']} | {g['events']}: none grew capacity "
            f"{ts0.gauss.capacity}")
    for name in ("knn", "deform", "deform_bwd", "blend_fwd", "blend_fwd_ckpt", "blend_bwd",
                 "blend_bwd_sums", "blend_bwd_rows"):
        require(launches[name] > 0, f"kernel {name} was not launched in the graphed loop")
    # each capture's warm-up step runs eagerly, each iteration replays
    require(launches["deform_bwd"] == GRAPH_LOOP_ITERS + captures
            and launches["blend_bwd_ckpt"] == 0
            and launches["blend_fwd_ckpt"] == launches["blend_bwd"],
            f"graphed loop launches {launches} ({captures} captures)")

    # the steady state from the final state: eager steps, graphed replays
    views = stack_views(batches)
    ts_g, ts_e = g["ts"], e["ts"]
    ts_g, _ = graphed.chunk(ts_g, views, [0, 1, 2, 3], 0)
    for i in range(3):
        ts_e, _ = eager(ts_e, batches[i % 4], 0)

    def timed(fn, n):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        fn(n)
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / n, (time.perf_counter() - t0) * 1e3 / n

    def run_eager(n):
        nonlocal ts_e
        for i in range(n):
            ts_e, _ = eager(ts_e, batches[i % 4], 0)

    def run_graphed(n):
        nonlocal ts_g
        ts_g, _ = graphed.chunk(ts_g, views, [i % 4 for i in range(n)], 0)

    res = {}
    for mode, fn, n in (("eager", run_eager, GRAPH_EAGER_STEPS),
                        ("graphed", run_graphed, GRAPH_TIMED_STEPS)):
        ev_ms, host_ms = timed(fn, n)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(PROFILE_FRAMES)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6 / PROFILE_FRAMES
        kernels_ = [k for k in prof.key_averages()
                    if k.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(device_us(k) for k in kernels_) / PROFILE_FRAMES
        res[mode] = dict(ev_ms=ev_ms, host_ms=host_ms, busy_us=busy_us, wall_us=wall_us,
                         n=sum(k.count for k in kernels_) / PROFILE_FRAMES, top=kernels_)

    def busy(r):
        if r["busy_us"] <= 0:
            return "device busy not measured (no CUDA events)"
        share = 100 * r["busy_us"] / (1e3 * r["ev_ms"])
        return (f"device busy {r['busy_us']:.0f} us/step, {share:.1f}% "
                f"of the unprofiled step, {100 * r['busy_us'] / r['wall_us']:.1f}% of the "
                f"{r['wall_us']:.0f} us under the profiler, {r['n']:.0f} device kernels/step")

    re_, rg = res["eager"], res["graphed"]
    print(f"[train-graph] loops' wall: eager {e['wall']:.3f} s "
          f"({1e3 * e['wall'] / GRAPH_LOOP_ITERS:.3f} ms/iteration), graphed {g['wall']:.3f} s ({1e3 * g['wall'] / GRAPH_LOOP_ITERS:.3f} "
          f"ms/iteration; {captures} captures, {graphed.released} released, "
          f"{graphed.capture_s:.3f} s of warm-ups and captures, "
          f"{1e3 * (g['wall'] - graphed.capture_s) / GRAPH_LOOP_ITERS:.3f} ms/iteration "
          f"without them); peak device memory eager {e['peak_mb']:.1f} MB, graphed "
          f"{g['peak_mb']:.1f} MB; graphed path launches {launches} ({card})", flush=True)
    print(f"[train-graph] steady state at capacity {ts_g.gauss.capacity}, eager "
          f"({GRAPH_EAGER_STEPS} steps) | graphed ({GRAPH_TIMED_STEPS} replays in one chunk): "
          f"CUDA events {re_['ev_ms']:.3f} | {rg['ev_ms']:.3f} ms/step, host clock "
          f"{re_['host_ms']:.3f} | {rg['host_ms']:.3f} ms/step; eager {busy(re_)}; graphed "
          f"{busy(rg)}; launches per replay "
          f"{ {k.capacity: v for k, v in graphed.launches.items()} } ({card})", flush=True)
    for k in sorted(rg["top"], key=device_us, reverse=True)[:8]:
        print(f"[profile]   graphed step {device_us(k) / PROFILE_FRAMES:8.1f} us/step "
              f"{k.count / PROFILE_FRAMES:5.1f}x  {k.key[:90]}")
    return launches


def cli_kernel_checks(out, step, template, b0, its, n_sm, run="cli.train"):
    """Every kernel of cli.train's step against its plain version on the
    inputs that step gives it (`step` on view `b0`), under the CLI's raster
    config (instance capacity 4 x the starting capacity), at the run's
    snapshots `its` (restored into `template`'s structure): for phase 6,
    chkpnt600 (capacity 16,384, the shape of iterations 1-1,000) and
    chkpnt1200 (capacity 32,768, iterations 1,001-1,200). Returns the
    report of the first, the shape of most of the run's launches."""
    import mygauhuman_torch.models.lbs as lbs_mod
    import mygauhuman_torch.ops.pallas_blend as pb
    import mygauhuman_torch.ops.pallas_blend_bwd as pbb
    import mygauhuman_torch.ops.pallas_deform as pd
    from mygauhuman_torch.train.checkpoint import restore_checkpoint_like
    from mygauhuman_torch.train.trainer import active_sh_degree_at

    reports = {}
    for it in its:
        ts = restore_checkpoint_like(str(out), it, template)
        seen: dict = {}
        with capture(lbs_mod, "knn", seen), capture(lbs_mod, "deform_rows", seen), \
                capture(pb, "blend_rows_raw", seen), capture(pb, "blend_tiles_raw", seen), \
                capture(pbb, "blend_tiles_bwd_from_ckpt_raw", seen), \
                capture(pd, "deform_rows_bwd_cuda", seen):
            step.loss_and_grads(ts, b0, active_sh_degree_at(it, 3))
        label = (f"{run} chkpnt{it} (capacity {ts.gauss.capacity}, "
                 f"{int(ts.gauss.num_alive)} alive)")
        report = reports[it] = {}
        (q, r), kw = seen["knn"]
        require(kw.get("k") == 1 and q.shape[0] == ts.gauss.capacity,
                f"{label}: unexpected KNN call")
        check_kernel_a(label, q.detach(), r.detach(), 1, False, n_sm, report)
        check_kernel_b(label, seen["deform_rows"][0], n_sm, report)
        planar = "blend_rows_raw" in seen
        (data, starts, counts, tile_base), kw = seen["blend_rows_raw" if planar
                                                     else "blend_tiles_raw"]
        require(kw.get("checkpoints") is True, f"{label}: no checkpoint mode")
        check_kernel_c(f"{label} {'planar' if planar else 'tile-major'}", data, starts, counts,
                       tile_base, dict(kw, planar=planar), pb, pbb, report=report,
                       ckpt_report=True, name="blend_fwd" if planar else "blend_fwd_tiles")
        check_kernel_d(label, seen["blend_tiles_bwd_from_ckpt_raw"], kw["n_channels"], report,
                       pb, pbb, main=True)
        check_kernel_b_bwd(seen["deform_rows_bwd_cuda"], report, label)
    return reports[its[0]]


def graph_line(res, iters, tag, peak_mb):
    """cli.train's branch-A graphs: captures, their seconds, launches per
    replay, peak device memory of the run. Requires that it ran graphed."""
    g = res["graph"]
    keys = [(k["width"], k["height"], round(k["tan_fovx"], 4), k["capacity"],
             k["active_sh_degree"]) for k in g["launches_per_replay"]]
    per = {tuple(sorted(k["launches"].items())) for k in g["launches_per_replay"]}
    print(f"{tag}: graphed, {g['captures']} captures ({g['released']} released by capacity "
          f"growth) in {g['capture_s']:.3f} s of warm-ups and captures "
          f"({g['capture_s'] / max(g['captures'], 1):.3f} s each); live keys (width, height, "
          f"tan_fovx, capacity, SH degree) {keys}; launches per replay {[dict(p) for p in per]}; "
          f"{iters} iterations, peak device memory allocated {peak_mb:.1f} MB", flush=True)
    require(g["captures"] > 0, f"{tag}: the branch-A loop did not run graphed")


def cli_phase(dev, n_sm):
    """The entry points: cli.train's 1,200 iterations, the snapshot reloaded
    and resumed, each kernel on the inputs of the run's step, cli.render on
    both branches, cli.metrics. Returns the launches of each run and the
    report of the kernels on the run's inputs."""
    import torch
    from torch.utils._pytree import tree_leaves

    from mygauhuman_torch.cli import metrics as cli_metrics
    from mygauhuman_torch.cli import render as cli_render
    from mygauhuman_torch.cli import train as cli_train
    from mygauhuman_torch.eval.metrics import evaluate_images
    from mygauhuman_torch.models.gaussians import compact_state
    from mygauhuman_torch.ops import cuda_lib
    from mygauhuman_torch.render import render_frame
    from mygauhuman_torch.train.checkpoint import load_checkpoint, load_eval_cache
    from mygauhuman_torch.utils.image_io import write_png

    synth = ["--synthetic", "--synthetic_size", str(CLI_SCENE["size"]), "--synthetic_verts",
             str(CLI_SCENE["verts"]), "--synthetic_views", str(CLI_SCENE["views"])]
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    out = CLI_DIR / "train"
    cuda_lib.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = cli_train.main(synth + [
        "--iterations", str(CLI_ITERS),
        "--test_iterations", str(CLI_ITERS), "--save_iterations", str(CLI_MID), str(CLI_ITERS),
        "--skip_galleries", "--model_path", str(out), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = dict(cuda_lib.LAUNCHES)
    graph_line(res, CLI_ITERS, "[cli] train", torch.cuda.max_memory_allocated() / 1e6)
    phases = res["phases"]
    side_s = sum(v["total_s"] for k, v in phases.items() if not k.startswith("mgh."))
    print(f"[cli] train: {CLI_ITERS} iterations in {res['elapsed_s']:.3f} s "
          f"({1e3 * res['elapsed_s'] / CLI_ITERS:.3f} ms/iteration; without the eval and "
          f"saves {1e3 * (res['elapsed_s'] - side_s) / CLI_ITERS:.3f} ms/iteration); "
          f"{wall:.3f} s wall for the whole command (scene, set-up); phases {phases}",
          flush=True)
    print(f"[cli] train: test PSNR {res['test_psnr']:.4f}, final loss "
          f"{res['final_loss']:.6f}, {res['n_gaussians']} Gaussians alive, capacity "
          f"{res['capacity']}, iterations {res['first_iteration']}-{res['last_iteration']}",
          flush=True)
    for e in res["densify"]:
        print(f"[cli] densify event: {e}")
    print(f"[cli] train: launches {train_launches}", flush=True)
    require(res["first_iteration"] == 1 and res["last_iteration"] == CLI_ITERS,
            "cli.train did not run the whole budget")
    require(np.isfinite(res["final_loss"]) and res["test_psnr"] > 0,
            "cli.train: non-finite loss or no test PSNR")
    require(len(res["densify"]) == 9, f"{len(res['densify'])} densify events, expected 9 "
            "(every 100 iterations from 400 to 1,200)")
    for name in ("knn", "deform", "deform_bwd", "blend_fwd", "blend_fwd_ckpt", "blend_bwd",
                 "blend_bwd_sums", "blend_bwd_rows"):
        require(train_launches[name] > 0, f"cli.train: kernel {name} was not launched")
    # one kernel B backward per iteration (replayed) and per capture's warm-up step
    require(train_launches["deform_bwd"] == CLI_ITERS + res["graph"]["captures"],
            f"{train_launches['deform_bwd']} kernel B backward passes in {CLI_ITERS} iterations "
            f"and {res['graph']['captures']} warm-ups")
    require(train_launches["blend_bwd_ckpt"] == 0, "cli.train launched D1")
    require(train_launches["blend_fwd_ckpt"] == train_launches["blend_bwd"],
            "cli.train: a differentiated forward without its backward, or the reverse")

    # the snapshot at 1,200 against the live state, bit for bit
    live = res["state"]
    back = load_checkpoint(str(out), CLI_ITERS, live)
    pairs = list(zip(tree_leaves(back), tree_leaves(live)))
    same = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in pairs)
    print(f"[cli] chkpnt{CLI_ITERS} loaded back: {len(pairs)} leaves, bit-equal {same}",
          flush=True)
    require(same, "the checkpoint differs from the live state")
    resumed = cli_train.main(synth + [
        "--iterations", str(CLI_ITERS + 10), "--skip_galleries",
        "--model_path", str(CLI_DIR / "resume"), "--device", "cuda",
        "--start_checkpoint", str(out / f"chkpnt{CLI_ITERS}")])
    print(f"[cli] resume: iterations {resumed['first_iteration']}-"
          f"{resumed['last_iteration']}, final loss {resumed['final_loss']:.6f}", flush=True)
    require(resumed["first_iteration"] == CLI_ITERS + 1
            and resumed["last_iteration"] == CLI_ITERS + 10
            and np.isfinite(resumed["final_loss"]), "the resume did not continue the run")

    # the scene cli.render builds (its ground truth renders run the deform
    # chain: set-up, not the render path)
    cuda_lib.reset_launches()
    scene = cli_train.synthetic_scene(CLI_SCENE["views"], CLI_SCENE["size"],
                                      CLI_SCENE["verts"], dev)
    torch.cuda.synchronize()
    setup = dict(cuda_lib.LAUNCHES)
    train = make_trainer(scene, scene.raster_config, dev)
    cli_report = cli_kernel_checks(out, train["step"], train["ts"], scene.batches[0],
                                   (CLI_MID, CLI_ITERS), n_sm)

    # cli.render: the deform branch, then the replay cache (the branch the
    # reference's 189 FPS measures; its PNGs stay in renders_1200/)
    base = ["--model_path", str(out), "--iteration", str(CLI_ITERS)] + synth + [
        "--device", "cuda"]
    renders, render_launches = {}, {}
    for branch, extra in (("deform", []), ("replay", ["--use_replay_cache"])):
        cuda_lib.reset_launches()
        m = cli_render.main(base + extra)
        torch.cuda.synchronize()
        render_launches[branch] = dict(cuda_lib.LAUNCHES)
        renders[branch] = m
        print(f"[cli] render {branch}: fps_device {m['fps_device']:.2f} (CUDA events "
              f"{m.get('ms_per_frame_events')} ms/frame), fps_wall {m['fps_wall']:.2f}, "
              f"{res['n_gaussians']} Gaussians, "
              f"PSNR {m['psnr']:.4f}, SSIM {m['ssim']:.4f}, lpips_rand {m['lpips_rand']:.4f}; "
              f"launches {render_launches[branch]}", flush=True)
        for name in ("knn", "deform", "blend_fwd") if branch == "deform" else ("blend_fwd",):
            require(render_launches[branch][name] > 0,
                    f"cli.render {branch}: kernel {name} was not launched")
        require(render_launches[branch]["blend_fwd_ckpt"] == 0
                and render_launches[branch]["deform_bwd"] == 0,
                f"cli.render {branch}: checkpoints written or kernel B's backward run")
    require(all(render_launches["replay"][k] == setup[k] for k in ("knn", "deform")),
            f"cli.render --use_replay_cache ran the deform chain beyond its scene's set-up "
            f"{setup}")
    # the replay cache end to end: the cached rows are, bit for bit, the
    # transforms of the eval's deform render (the trained state at its own
    # capacity, with the trained pose-refiner and LBS-offset MLPs), and
    # cli.render's replay images are, bit for bit, a replay render of the
    # compacted state with those rows. Replay against deform on one state is
    # phase 3's check (<= 1e-3 at the bench point); on the trained model the
    # two compute positions by different float expressions (kernel B's
    # chain, transforms @ x + translation), so rounding can flip a depth
    # order or a tile edge at a few pixels: at most REPLAY_PIXELS of them
    # beyond RENDER_ATOL, none beyond REPLAY_ATOL. cli.render's deform
    # branch runs without the MLPs (as the JAX CLI) and differs by them.
    cache = load_eval_cache(str(out / f"smpl_rot_{CLI_ITERS}.npz"))
    state = compact_state(back.gauss)
    alive = torch.nonzero(back.gauss.alive).reshape(-1)
    n = alive.numel()
    cfg = scene.raster_config._replace(instance_capacity=4 * state.capacity)
    kw = dict(bg=torch.zeros(3, device=dev), active_sh_degree=3, config=cfg)
    mlps = {"pose_refiner": back.pose_refiner, "lbs_offset": back.lbs_offset}
    cache_exact = replay_exact = True
    worst = mlp_effect = 0.0
    n_off = 0
    with torch.no_grad():
        for v, b in enumerate(scene.batches):
            deform = render_frame(back.gauss, b.camera, b.frame, scene.smpl_model,
                                  mlp_params=mlps, **kw)
            rows = {k: getattr(deform, k)[alive] for k in ("transforms", "translation")}
            cache_exact &= all(torch.equal(rows[k], torch.as_tensor(cache[str(v)][k],
                                                                    device=dev))
                               for k in rows)
            padded = {k: torch.cat([r, r.new_zeros((state.capacity - n,) + r.shape[1:])])
                      for k, r in rows.items()}
            replay = render_frame(state, b.camera, b.frame, scene.smpl_model, **padded,
                                  **kw).render
            got = renders["replay"]["renders"][v]
            replay_exact &= torch.equal(replay, got)
            d = (got - deform.render).abs()
            worst = max(worst, float(d.max()))
            n_off += int((d.amax(dim=-1) > RENDER_ATOL).sum())
            mlp_effect = max(mlp_effect, float((got - renders["deform"]["renders"][v])
                                               .abs().max()))
    px = len(scene.batches) * CLI_SCENE["size"] ** 2
    print(f"[cli] render: cached rows bit-equal to the eval's deform transforms {cache_exact}; "
          f"cli.render's replay images bit-equal to a replay of them {replay_exact}; replay "
          f"vs that deform render max abs {worst:.3e}, {n_off} of {px} pixels beyond "
          f"{RENDER_ATOL}; replay vs cli.render's deform branch (no MLPs) {mlp_effect:.3e}",
          flush=True)
    require(cache_exact and replay_exact, "the replay cache does not reproduce the eval's "
            "deform transforms, or cli.render does not replay them")
    require(n_off <= REPLAY_PIXELS and worst <= REPLAY_ATOL,
            f"cli.render's replay differs from the deform render at {n_off} pixels beyond "
            f"{RENDER_ATOL} (at most {REPLAY_PIXELS}), max abs {worst} (at most {REPLAY_ATOL})")

    # cli.metrics on the replay PNGs against the ground truth as PNGs
    gt_dir = CLI_DIR / "gt"
    gt_dir.mkdir(parents=True)
    q = lambda x: (np.clip(x.cpu().numpy(), 0, 1) * 255).astype(np.uint8)  # noqa: E731
    for v, b in enumerate(scene.batches):
        write_png(str(gt_dir / f"{v:05d}.png"), q(b.gt_image))
    got = cli_metrics.main(["-r", str(out / f"renders_{CLI_ITERS}"), "-g", str(gt_dir),
                            "-o", str(CLI_DIR / "metrics.json"), "--device", "cuda"])
    as8 = lambda x: torch.as_tensor(q(x).astype(np.float32) / 255.0, device=dev)  # noqa: E731
    mem = evaluate_images([as8(r) for r in renders["replay"]["renders"]],
                          [as8(b.gt_image) for b in scene.batches])
    with open(out / f"renders_{CLI_ITERS}" / "results.json") as f:
        res_json = json.load(f)
    print(f"[cli] metrics: PSNR {got['psnr']:.6f} from the PNGs, {mem['psnr']:.6f} on the "
          f"same 8-bit images in memory (tolerance {METRICS_ATOL}); results.json (float "
          f"renders vs float ground truth) {res_json['psnr']:.6f}, 8-bit quantisation moves "
          f"it {got['psnr'] - res_json['psnr']:+.6f} dB (at most {QUANT_PSNR_DB}); SSIM "
          f"{got['ssim']:.6f}", flush=True)
    require(abs(got["psnr"] - mem["psnr"]) <= METRICS_ATOL
            and abs(got["ssim"] - mem["ssim"]) <= METRICS_ATOL,
            "cli.metrics disagrees with the metrics of its images")
    require(abs(got["psnr"] - res_json["psnr"]) <= QUANT_PSNR_DB,
            "cli.metrics' PSNR is beyond 8-bit quantisation of results.json's")
    return {"cli_train": train_launches, "cli_render_deform": render_launches["deform"],
            "cli_render_replay": render_launches["replay"]}, cli_report


@contextlib.contextmanager
def patched(module, name, fn):
    """module.name replaced by fn(original) for the duration."""
    orig = getattr(module, name)
    setattr(module, name, fn(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def profile_calls(fn, n, label):
    """Print n calls of fn under torch.profiler: wall and device-busy us per
    call, the busy share, kernel launches per call, the top device kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / n
    kernels_ = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(device_us(e) for e in kernels_) / n
    if busy_us <= 0:
        print(f"[profile] {label}: device time not measured (no CUDA events)", flush=True)
        return
    print(f"[profile] {label}: {wall_us:.0f} us wall, {busy_us:.0f} us device busy "
          f"({100 * busy_us / wall_us:.1f}%), {sum(e.count for e in kernels_) / n:.0f} kernel "
          f"launches per call", flush=True)
    for e in sorted(kernels_, key=device_us, reverse=True)[:6]:
        print(f"[profile]   {device_us(e) / n:8.1f} us {e.count / n:5.1f}x  {e.key[:90]}")


def cpu_bake_worker(inputs_path, out_path, threads):
    """One camera's bake on the CPU (the plain versions), in its own process,
    on the inputs the card's bake was given."""
    import torch

    from mygauhuman_torch.occlusion import baking

    torch.set_num_threads(threads)
    a = torch.load(inputs_path, weights_only=True)
    t0 = time.perf_counter()
    occ, oob, n_sweeps = baking.bake_occlusion_full(
        *(a[k] for k in ("means", "cov6", "opacity", "normals", "alive")))
    torch.save({"occ": occ, "oob": oob, "n_sweeps": n_sweeps,
                "seconds": time.perf_counter() - t0}, out_path)


def pbr_step_checks(step_args, step, dev, n_sm, pb, pbb):
    """A branch-B step on cli.train's chkpnt1200 state: kernels A, B, C
    (checkpoint mode) and D against their plain versions on its inputs, no
    kernel B backward, and the same step twice bit-equal. Returns the report."""
    import torch
    from torch.utils._pytree import tree_leaves

    import mygauhuman_torch.models.lbs as lbs_mod
    from mygauhuman_torch.ops import cuda_lib

    ts = step_args[0]
    seen: dict = {}
    cuda_lib.reset_launches()
    with capture(lbs_mod, "knn", seen), capture(lbs_mod, "deform_rows", seen), \
            capture(pb, "blend_rows_raw", seen), capture(pb, "blend_tiles_raw", seen), \
            capture(pbb, "blend_tiles_bwd_from_ckpt_raw", seen):
        first = step(*step_args)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    print(f"[pbr] one branch-B step at chkpnt{CLI_ITERS} (capacity {ts.gauss.capacity}, "
          f"{int(ts.gauss.num_alive)} alive): launches {launches}", flush=True)
    require(launches["deform_bwd"] == 0, "the branch-B step ran kernel B's backward")
    require(launches["deform"] == 1 and launches["knn"] == 1 and launches["blend_fwd_ckpt"] == 1
            and launches["blend_bwd"] == 1 and launches["blend_bwd_ckpt"] == 0,
            f"the branch-B step's launches {launches}")
    again = step(*step_args)
    pairs = list(zip(tree_leaves(first), tree_leaves(again)))
    same = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b for a, b in pairs)
    print(f"[pbr] the same step twice: {len(pairs)} leaves (state, light, metrics), "
          f"bit-equal {same}", flush=True)
    require(same, "the same branch-B step twice differs")
    profile_calls(lambda: step(*step_args), PROFILE_FRAMES, "branch-B step")
    label = f"branch-B step chkpnt{CLI_ITERS}"
    report: dict = {}
    (q, r), kw = seen["knn"]
    check_kernel_a(label, q.detach(), r.detach(), 1, False, n_sm, report)
    check_kernel_b(label, seen["deform_rows"][0], n_sm, report)
    planar = "blend_rows_raw" in seen
    (data, starts, counts, tile_base), kw = seen["blend_rows_raw" if planar else "blend_tiles_raw"]
    require(kw.get("checkpoints") is True, f"{label}: no checkpoint mode")
    check_kernel_c(f"{label} {'planar' if planar else 'tile-major'}", data, starts, counts,
                   tile_base, dict(kw, planar=planar), pb, pbb, report=report, ckpt_report=True)
    check_kernel_d(label, seen["blend_tiles_bwd_from_ckpt_raw"], kw["n_channels"], report, pb,
                   pbb, main=True)
    return report


def pbr_gpu_vs_cpu(dev):
    """One branch-B step's loss, metrics and gradients (albedo, roughness,
    light) on the card against the same step on the CPU, at phase 5's small
    case (128^2, 1,000 Gaussians, LPIPS on)."""
    import torch

    from mygauhuman_torch.config import OptimizationConfig
    from mygauhuman_torch.data.synthetic import make_synthetic_scene
    from mygauhuman_torch.eval.lpips import LPIPS
    from mygauhuman_torch.ops.rasterize import RasterizerConfig
    from mygauhuman_torch.pbr.light import prefilter_weight_set
    from mygauhuman_torch.train.pbr import compute_knn3, create_pbr_state, make_pbr_train_step

    cpu = torch.device("cpu")
    cfg = RasterizerConfig(tile_capacity=1024, instance_capacity=4 * 1024)
    scene = make_synthetic_scene(n_views=2, width=128, height=128, n_verts=1000,
                                 capacity=1024, seed=1, raster_config=cfg, device=dev)
    g = make_trainer(scene, cfg, dev)
    opt = OptimizationConfig()
    pbr, ltx = create_pbr_state(opt, device=dev)
    c_lpips = LPIPS(device=cpu)
    c_lpips.params = to_dev(g["lpips"].params, cpu)
    step = make_pbr_train_step(scene.smpl_model, g["tx"], ltx, opt, cfg,
                               bg=torch.zeros(3, device=dev), lpips_fn=g["lpips"])
    c_step = make_pbr_train_step(to_dev(scene.smpl_model, cpu), g["tx"], ltx, opt, cfg,
                                 bg=torch.zeros(3), lpips_fn=c_lpips)
    knn3 = compute_knn3(g["ts"].gauss)
    occ = torch.rand((1024, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    pw = prefilter_weight_set(32, dev)
    args = (g["ts"], pbr, scene.batches[0], knn3, occ, pw, 0)
    res_g = step.loss_and_grads(*args)
    t0 = time.perf_counter()
    res_c = c_step.loss_and_grads(*to_dev(args, cpu))
    cpu_s = time.perf_counter() - t0
    for k in ("loss", "l1", "ssim", "lpips_term", "brdf_tv", "entropy", "smooth", "lamb",
              "env_tv", "psnr"):
        a, c = float(res_g[1][k]), float(res_c[1][k])
        require(abs(a - c) <= 1e-4 * abs(c) + 1e-6, f"GPU vs CPU branch-B step: {k} {a} vs {c}")
    worst = {}
    for name, a in res_g[2].items():
        c = res_c[2][name]
        err, scale = float((a.cpu() - c).abs().max()), float(c.abs().max())
        worst[name] = err / (scale + 1e-30)
        require(scale > 0 and err <= GRAD_RTOL * scale + 1e-8,
                f"GPU vs CPU branch-B step: d_{name} err {err} (max {scale})")
    print(f"[pbr] GPU vs CPU branch-B step at 128^2 (capacity 1,024, LPIPS on): loss "
          f"{float(res_g[1]['loss']):.6f} vs {float(res_c[1]['loss']):.6f}; gradients "
          + ", ".join(f"d_{k} {v:.3e}" for k, v in worst.items())
          + f" of the leaf's max (tolerance {GRAD_RTOL}); CPU step {cpu_s:.1f} s", flush=True)


def relight_checks(out_b, scene, dev, it):
    """CUDA-event ms per relit frame (render + shading) beside the unlit
    frame, on the replay branch as cli.render serves it, and the GPU shading
    against the CPU shading of the same G-buffers."""
    import torch

    from mygauhuman_torch.cli import render as cli_render
    from mygauhuman_torch.models.gaussians import compact_state
    from mygauhuman_torch.models.io import load_ply
    from mygauhuman_torch.render import render_frame
    from mygauhuman_torch.train.checkpoint import load_eval_cache

    state = compact_state(load_ply(str(out_b / f"point_cloud_{it}.ply"), device=dev))
    cfg = scene.raster_config._replace(instance_capacity=4 * state.capacity)
    cache = load_eval_cache(str(out_b / f"smpl_rot_{it}.npz"))
    light, lut = cli_render.load_relight(str(out_b / f"envmap_{it}.npy"), dev)

    def replay(v):
        rows = cache[str(v)]
        n = rows["transforms"].shape[0]
        return {k: torch.cat([torch.as_tensor(rows[k], device=dev),
                              torch.zeros((state.capacity - n,) + rows[k].shape[1:],
                                          device=dev)]) for k in ("transforms", "translation")}

    kws = [replay(v) for v in range(len(scene.batches))]

    def frame(i, relit):
        b = scene.batches[i % len(scene.batches)]
        out = render_frame(state, b.camera, b.frame, scene.smpl_model,
                           bg=torch.zeros(3, device=dev), active_sh_degree=3, config=cfg,
                           **kws[i % len(kws)])
        return cli_render.shade_gbuffers(out, b.camera, light, lut) if relit else out.render

    ms = {}
    with torch.no_grad():
        for relit in (False, True, False, True):
            ms.setdefault(relit, []).append(cuda_ms(lambda: [frame(i, relit)
                                                             for i in range(RELIGHT_FRAMES)],
                                                    reps=1, warmup=1) / RELIGHT_FRAMES)
        b = scene.batches[0]
        out = render_frame(state, b.camera, b.frame, scene.smpl_model,
                           bg=torch.zeros(3, device=dev), active_sh_degree=3, config=cfg,
                           **kws[0])
        profile_calls(lambda: frame(0, False), PROFILE_FRAMES, "unlit replay frame")
        profile_calls(lambda: frame(0, True), PROFILE_FRAMES, "relit replay frame")
        gpu = cli_render.shade_gbuffers(out, b.camera, light, lut)
        cpu = torch.device("cpu")
        ref = cli_render.shade_gbuffers(to_dev(out, cpu), to_dev(b.camera, cpu),
                                        to_dev(light, cpu), lut.cpu())
    err = float((gpu.cpu() - ref).abs().max())
    print(f"[relight] replay branch, {state.capacity} capacity: unlit "
          f"{', '.join(f'{x:.3f}' for x in ms[False])} ms/frame, relit (render + shading) "
          f"{', '.join(f'{x:.3f}' for x in ms[True])} ms/frame (CUDA events, "
          f"{RELIGHT_FRAMES} frames each, alternating); GPU vs CPU shading of view 0's "
          f"G-buffers max abs {err:.3e} (tolerance {SHADE_ATOL})", flush=True)
    require(err <= SHADE_ATOL, f"GPU shading differs from the CPU shading by {err}")
    return ms


def bake_key(args) -> str:
    """A bake's inputs by content (means and alive), for `pbr_graph_phase`'s
    reuse of the CLI run's bakes."""
    import hashlib

    return hashlib.sha1(args[0].cpu().numpy().tobytes()
                        + args[4].cpu().numpy().tobytes()).hexdigest()


def pbr_graph_phase(scene, train, dev, memo):
    """Branch B graphed against eager from chkpnt1200: PBR_GRAPH_ITERS
    iterations of train_loop_pbr with the eager step (scan_chunk 1), with the
    graphed step (chunks of PBR_GRAPH_CHUNK, one ending at the observed
    iteration) and with a starved occlusion budget (one camera's slot:
    chunks split at every camera change), every state leaf and every
    iteration's metrics bit for bit; every chunk past the first (the
    capture) under torch.cuda.set_sync_debug_mode("error"); the bakes are
    the CLI run's (`memo`, by content). Then the steady state: ms/iteration
    of graphed replays in one chunk against eager steps (CUDA events and the
    host clock), the device busy share of each, launches per replay and the
    captures. Returns the graphed path's launches."""
    import torch

    from mygauhuman_torch.config import OptimizationConfig
    from mygauhuman_torch.occlusion import baking
    from mygauhuman_torch.ops import cuda_lib
    from mygauhuman_torch.pbr.light import prefilter_weight_set
    from mygauhuman_torch.train import pbr as tpbr
    from mygauhuman_torch.train.checkpoint import restore_checkpoint_like
    from mygauhuman_torch.train.graph import stack_views
    from mygauhuman_torch.train.optim import tree_leaves

    opt = OptimizationConfig()
    start = restore_checkpoint_like(str(CLI_DIR / "train"), CLI_ITERS, train["ts"])
    bg = torch.zeros(3, device=dev)
    misses = []

    def memo_bake(orig):
        def run(*args, **kw):
            hit = memo.get(bake_key(args))
            if hit is None:
                misses.append(1)
                return orig(*args, **kw)
            return hit
        return run

    def make(donate):
        _, ltx = tpbr.create_pbr_state(opt, device=dev)
        return tpbr.make_pbr_train_step(scene.smpl_model, train["tx"], ltx, opt,
                                        scene.raster_config, bg=bg, lpips_fn=train["lpips"],
                                        donate=donate)

    def run(donate, scan_chunk, budget_mb):
        step, seen, chunks = make(donate), {}, []
        if donate:
            chunk = step.chunk

            def checked_chunk(*a, **kw):
                chunks.append(len(a[6]))
                if len(chunks) == 1:
                    return chunk(*a, **kw)
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return chunk(*a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(0)

            step.chunk = checked_chunk
        pbr0, _ = tpbr.create_pbr_state(opt, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with patched(baking, "bake_occlusion_full", memo_bake):
            ts, pbr, _ = tpbr.train_loop_pbr(
                start, pbr0, step, scene.batches, scene.smpl_model, opt,
                start_iteration=CLI_ITERS, num_iterations=PBR_GRAPH_ITERS, seed=0,
                scan_chunk=scan_chunk, callback_iters=PBR_GRAPH_OBSERVED,
                occ_budget_mb=budget_mb, callback=lambda it, ts, p, m: seen.__setitem__(it, m))
        torch.cuda.synchronize()
        return dict(step=step, ts=ts, pbr=pbr, seen=seen, chunks=chunks,
                    wall=time.perf_counter() - t0)

    eager = run(False, 1, 1024.0)
    cuda_lib.reset_launches()
    graphed = run(True, PBR_GRAPH_CHUNK, 1024.0)
    launches = dict(cuda_lib.LAUNCHES)
    starved = run(True, PBR_GRAPH_CHUNK, PBR_STARVED_MB)
    leaves = tree_leaves((eager["ts"], eager["pbr"]))
    for name, r in (("graphed", graphed), ("starved", starved)):
        got = tree_leaves((r["ts"], r["pbr"]))
        same = len(got) == len(leaves) and all(torch.equal(a, b) for a, b in zip(got, leaves))
        metrics = sorted(r["seen"]) == sorted(eager["seen"]) and all(
            torch.equal(torch.as_tensor(v), torch.as_tensor(r["seen"][it][k]))
            for it, m in eager["seen"].items() for k, v in m.items())
        counts = (r["ts"].step, r["ts"].opt_state.count, r["pbr"].opt_state.count) == (
            eager["ts"].step, eager["ts"].opt_state.count, eager["pbr"].opt_state.count)
        print(f"[pbr-graph] {name} (chunks {r['chunks']}) vs eager over iterations "
              f"{CLI_ITERS + 1}-{CLI_ITERS + PBR_GRAPH_ITERS}: {len(leaves)} state leaves "
              f"(materials, light, volumes, both optimisers' moments) bit-equal {same}, "
              f"{len(eager['seen'])} iterations x {len(eager['seen'][CLI_ITERS + 1])} metrics "
              f"bit-equal {metrics}, host counts equal {counts}; loop wall {r['wall']:.3f} s "
              f"against eager {eager['wall']:.3f} s", flush=True)
        require(same and metrics and counts, f"the {name} branch-B loop differs from the eager")
    require(len(graphed["chunks"]) >= 3 and max(starved["chunks"]) < PBR_GRAPH_CHUNK
            and len(starved["chunks"]) > len(graphed["chunks"]),
            f"chunks {graphed['chunks']} / {starved['chunks']}: no boundary or no split")
    require(not misses, f"{len(misses)} bakes of the check were not the CLI run's")
    rec = graphed["step"].record()
    per_replay = [k["launches"] for k in rec["launches_per_replay"]]
    print(f"[pbr-graph] captures {rec['captures']} ({rec['capture_s']:.3f} s), launches per "
          f"replay {per_replay}; the graphed loop's launches {launches}", flush=True)
    require(rec["captures"] == 1 and all(p.get("deform_bwd", 0) == 0 for p in per_replay),
            f"graph record {rec}")

    # the steady state, from the graphed loop's end
    step, ts, pbr = graphed["step"], graphed["ts"], graphed["pbr"]
    views = stack_views(scene.batches)
    # each camera's map from the CLI run's bakes
    occ_buf = torch.stack([torch.round(memo[bake_key(
        (*tpbr._pose_for_bake(start, b, scene.smpl_model), start.gauss.alive))][0] * 255.0
    ).to(torch.uint8) for b in scene.batches])
    knn3, pw = tpbr.compute_knn3(start.gauss), prefilter_weight_set(32, dev)
    deg = min(CLI_ITERS // 1000, 3)
    n_views = len(scene.batches)
    idx = [i % n_views for i in range(PBR_TIMED_ITERS)]
    eager_step = step.eager
    cols = [tpbr.baked_occlusion_color(occ_buf[v], pbr.light) for v in range(n_views)]
    state = [ts, pbr]

    def graphed_chunk(n=PBR_TIMED_ITERS):
        state[0], state[1], _ = step.chunk(state[0], state[1], views, occ_buf, knn3, pw,
                                           idx[:n], idx[:n], deg, pad_to=n)

    def eager_steps():
        for i in range(PBR_EAGER_ITERS):
            eager_step(ts, pbr, scene.batches[i % n_views], knn3, cols[i % n_views], pw, deg)

    ms = {}
    for name, fn, n in (("graphed", graphed_chunk, PBR_TIMED_ITERS),
                        ("eager", eager_steps, PBR_EAGER_ITERS)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev = cuda_ms(fn, reps=1, warmup=0)
        host = (time.perf_counter() - t0) * 1e3
        ms[name] = (ev / n, host / n)
    print(f"[pbr-graph] steady state at chkpnt{CLI_ITERS} (capacity {start.gauss.capacity}, "
          f"512^2, LPIPS on): graphed {ms['graphed'][0]:.3f} ms/iteration by CUDA events "
          f"({ms['graphed'][1]:.3f} host clock, {PBR_TIMED_ITERS} replays in one chunk), eager "
          f"{ms['eager'][0]:.3f} ({ms['eager'][1]:.3f}, {PBR_EAGER_ITERS} steps)", flush=True)
    profile_calls(lambda: graphed_chunk(4), 2, "graphed branch-B chunk of 4 iterations")
    profile_calls(lambda: eager_step(ts, pbr, scene.batches[0], knn3, cols[0], pw, deg), 4,
                  "eager branch-B step")
    return launches, ms


def bake_face_check(args, dev, report):
    """Kernel C tile-major as the bake launches it, at the main path's tile
    lists (every Gaussian): of the first camera's first sweep, the group of
    cells whose launch holds the most instances, its faces' tiles in one
    launch as `occlusion/baking.py::_bake_cells` builds it (captured from
    the eager run before a fresh graph capture), against its plain version
    (`check_kernel_c`, its time and bound into `report`)."""
    import torch

    import mygauhuman_torch.ops.pallas_blend as pb
    import mygauhuman_torch.ops.pallas_blend_bwd as pbb
    from mygauhuman_torch.occlusion import baking

    means, cov6, opac, _, alive = args
    calls: list = []

    def record(orig):
        def run(*a, **kw):
            if not torch.cuda.is_current_stream_capturing():
                total = int(a[2].sum())
                if not calls or total > calls[0][0]:
                    calls[:] = [(total, [x.clone() if torch.is_tensor(x) else x for x in a],
                                 dict(kw))]
            return orig(*a, **kw)
        return run

    kw = dict(height=16, width=32, grid_res=10, max_cells=128, face_res=32,
              config=baking.bake_config(means.shape[0]))
    vis0 = torch.ones((means.shape[0], 16, 32, 1), device=dev)
    with torch.no_grad(), patched(baking, "_SWEEP_GRAPHS", lambda _: {}), \
            patched(baking, "blend_instances_cuda", record):
        baking._bake_sweep(means, cov6, opac, alive, vis0, 0, **kw)
    torch.cuda.synchronize()
    groups = baking.cell_groups(128, means.shape[0], kw["config"])
    _, (data, starts, counts, tile_base), ckw = calls[0]
    n_faces = ckw["n_tiles"] // ckw["tiles_per_image"]
    require(ckw.get("checkpoints", False) is False and ckw["tiles_per_image"] == 4
            and n_faces == 6 * len(groups[0]) and ckw["n_channels"] == 1,
            f"unexpected bake launch {ckw}")
    check_kernel_c(f"bake group tile-major ({n_faces} faces of 32x32, {ckw['n_tiles']} tiles, "
                   f"{len(groups)} groups a sweep)", data, starts, counts, tile_base,
                   dict(ckw, planar=False), pb, pbb, report=report, name="blend_fwd_tiles")


def bake_graph_check(args, dev):
    """One sweep of the first camera's bake (the first window of 128 cells,
    tile lists of every Gaussian, as the main path bakes) as the replay of
    the batched program against the per-cell program run slot by slot: the
    maps bit for bit (else the uint8 texels that differ, at most one step),
    n_uncovered equal, and the seconds of each (host clock, synchronised)."""
    import torch

    from mygauhuman_torch.occlusion import baking
    from mygauhuman_torch.ops import cuda_lib

    means, cov6, opac, _, alive = args
    kw = dict(height=16, width=32, grid_res=10, max_cells=128, face_res=32,
              config=baking.bake_config(means.shape[0]))
    vis0 = torch.ones((means.shape[0], 16, 32, 1), device=dev)
    out, sec = {}, {}
    for eager in (True, False, False, True):
        cuda_lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            vis, n = baking._bake_sweep(means, cov6, opac, alive, vis0, 0, eager=eager, **kw)
        torch.cuda.synchronize()
        sec.setdefault(eager, []).append(time.perf_counter() - t0)
        out[eager] = (vis, int(n), cuda_lib.LAUNCHES["blend_fwd_tiles"])
    (ge, gn, g_l), (ee, en, e_l) = out[False], out[True]
    diff = (torch.round(ge * 255.0).to(torch.int16) - torch.round(ee * 255.0).to(torch.int16))
    n_diff, same = int((diff != 0).sum()), torch.equal(ge, ee)
    print(f"[bake-graph] one sweep of 128 cells (capacity {means.shape[0]}): graphed "
          f"{', '.join(f'{x:.4f}' for x in sec[False])} s ({g_l} tile-major launches, one "
          f"a group of cells), eager {', '.join(f'{x:.4f}' for x in sec[True])} s ({e_l} "
          f"launches, the occupied cells only); maps bit-equal {same}, {n_diff} of "
          f"{diff.numel()} uint8 texels differ (max {int(diff.abs().max())}); n_uncovered "
          f"{gn} vs {en}", flush=True)
    require(int(diff.abs().max()) <= BAKE_U8_STEP and gn == en,
            "the graphed sweep differs from the eager one")
    return sec


def pbr_phase(dev, n_sm):
    """Branch B through the entry points: cli.train resumes phase 6's
    chkpnt1200 for 300 branch-B iterations (4 bakes at capacity 32,768),
    then the run's checks, a branch-B step's kernels and bits, kernel C
    tile-major on a bake group's launch, one camera's bake on the card against the CPU
    (in a process of its own, beside the training), GPU vs CPU, and
    cli.render --relight with its timing. Returns (launches per path,
    report)."""
    import multiprocessing

    import torch
    from torch.utils._pytree import tree_leaves

    import mygauhuman_torch.ops.pallas_blend as pb
    import mygauhuman_torch.ops.pallas_blend_bwd as pbb
    import mygauhuman_torch.train.pbr as tpbr
    from mygauhuman_torch.cli import render as cli_render
    from mygauhuman_torch.cli import train as cli_train
    from mygauhuman_torch.config import OptimizationConfig
    from mygauhuman_torch.occlusion import baking
    from mygauhuman_torch.ops import cuda_lib
    from mygauhuman_torch.pbr.light import export_envmap, prefilter_weight_set
    from mygauhuman_torch.train.checkpoint import load_checkpoint, restore_checkpoint_like

    end = CLI_ITERS + PBR_ITERS
    synth = ["--synthetic", "--synthetic_size", str(CLI_SCENE["size"]), "--synthetic_verts",
             str(CLI_SCENE["verts"]), "--synthetic_views", str(CLI_SCENE["views"])]
    out_b = CLI_DIR / "pbr"
    bake_in, bake_out = CLI_DIR / "bake_inputs.pt", CLI_DIR / "bake_cpu.pt"
    ctx = multiprocessing.get_context("spawn")
    worker = ctx.Process(target=cpu_bake_worker,
                         args=(str(bake_in), str(bake_out), CPU_BAKE_THREADS))
    bakes, log, face, memo = [], [], {}, {}

    def timed_bake(orig):
        def run(*args, **kw):
            torch.cuda.synchronize()
            before = dict(cuda_lib.LAUNCHES)
            t0 = time.perf_counter()
            occ, oob, n_sweeps = orig(*args, **kw)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            if not bakes:   # the first camera's bake is redone on the CPU, meanwhile
                names = ("means", "cov6", "opacity", "normals", "alive")
                torch.save({k: a.detach().cpu() for k, a in zip(names, args)}, bake_in)
                worker.start()
                face.update(first_occ=occ, first_args=args)
            bakes.append(dict(seconds=sec, n_sweeps=n_sweeps, oob=int(oob), launches={
                k: cuda_lib.LAUNCHES[k] - before[k] for k in before if cuda_lib.LAUNCHES[k]
                - before[k]}, occupied=baking.count_occupied(args[0], args[4])))
            memo[bake_key(args)] = (occ, oob, n_sweeps)
            return occ, oob, n_sweeps
        return run

    def logged_loop(orig):
        def run(*args, callback=None, **kw):
            def cb(it, ts, pbr, m):
                log.append((it, m["loss"], m["psnr"]))
                callback(it, ts, pbr, m)
            return orig(*args, callback=cb, **kw)
        return run

    try:
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        with patched(baking, "bake_occlusion_full", timed_bake), \
                patched(tpbr, "train_loop_pbr", logged_loop):
            res = cli_train.main(synth + [
                "--iterations", str(end), "--pbr_iteration", str(CLI_ITERS),
                "--start_checkpoint", str(CLI_DIR / "train" / f"chkpnt{CLI_ITERS}"),
                "--test_iterations", str(end), "--save_iterations", str(end),
                "--skip_galleries", "--model_path", str(out_b), "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pbr_launches = dict(cuda_lib.LAUNCHES)
        rec = res["pbr"]
        print(f"[pbr] cli.train branch B: iterations {res['first_iteration']}-"
              f"{res['last_iteration']} in {rec['elapsed_s']:.3f} s "
              f"({1e3 * rec['elapsed_s'] / PBR_ITERS:.3f} ms/iteration, the bakes, eval and "
              f"save included; {wall:.3f} s wall for the command); launches {pbr_launches}",
              flush=True)
        for i, bk in enumerate(bakes):
            print(f"[pbr] bake {i}: {bk['seconds']:.3f} s, {bk['occupied']} occupied cells, "
                  f"n_sweeps {bk['n_sweeps']}, bake_out_of_budget {bk['oob']}, launches "
                  f"{bk['launches']}", flush=True)
        losses = torch.stack([x[1] for x in log]).cpu().numpy()
        psnr = torch.stack([x[2] for x in log]).cpu().numpy()
        bake_s = sum(b["seconds"] for b in bakes)
        print(f"[pbr] {len(bakes)} bakes in {bake_s:.3f} s; the steps without them "
              f"{1e3 * (rec['elapsed_s'] - bake_s) / PBR_ITERS:.3f} ms/iteration; relit "
              f"training-view PSNR at {log[0][0]} {psnr[0]:.4f}, at {log[-1][0]} "
              f"{psnr[-1]:.4f} (mean of the last 50 {psnr[-50:].mean():.4f}); loss "
              f"{losses[0]:.6f} -> {losses[-1]:.6f}; test PSNR (unlit eval) at {end} "
              f"{res['test_psnr']:.4f}", flush=True)
        require((res["first_iteration"], res["last_iteration"]) == (CLI_ITERS + 1, end)
                and len(log) == PBR_ITERS, "cli.train did not run the branch-B budget")
        require(np.isfinite(losses).all(), "a non-finite branch-B loss")
        require(len(bakes) == CLI_SCENE["views"] and all(b["oob"] == 0 for b in bakes)
                and rec["bake_out_of_budget"] == 0, "a bake left Gaussians out of budget")
        for name in ("knn", "deform", "blend_fwd", "blend_fwd_ckpt", "blend_fwd_tiles",
                     "blend_bwd", "blend_bwd_sums", "blend_bwd_rows"):
            require(pbr_launches[name] > 0, f"branch B: kernel {name} was not launched")
        require(pbr_launches["deform_bwd"] == 0, "branch B ran kernel B's backward")
        require(pbr_launches["blend_bwd_ckpt"] == 0, "branch B launched D1")
        # graphed by default: each capture's warm-up runs one eager step
        graph_b = rec["graph"]
        print(f"[pbr] cli.train branch B graphs: {graph_b['captures']} captured "
              f"({graph_b['released']} released) in {graph_b['capture_s']:.3f} s, launches per "
              f"replay {[k['launches'] for k in graph_b['launches_per_replay']]}; bakes "
              f"{', '.join(f'{b['seconds']:.3f}' for b in bakes)} s per camera", flush=True)
        require(graph_b["captures"] >= 1, "cli.train's branch B did not run graphed")
        require(pbr_launches["blend_fwd_ckpt"] == pbr_launches["blend_bwd"]
                == PBR_ITERS + graph_b["captures"],
                f"{pbr_launches['blend_fwd_ckpt']} differentiated forwards and "
                f"{pbr_launches['blend_bwd']} backward passes in {PBR_ITERS} iterations and "
                f"{graph_b['captures']} warm-ups")

        # the run against its start: geometry bit-equal, materials and light learned
        ts, pbr_state = res["state"], res["pbr_state"]
        start = restore_checkpoint_like(str(CLI_DIR / "train"), CLI_ITERS, ts)
        geometry = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
        frozen = all(torch.equal(getattr(ts.gauss.params, f), getattr(start.gauss.params, f))
                     for f in geometry) and torch.equal(ts.gauss.alive, start.gauss.alive) \
            and all(torch.equal(a, b) for a, b in zip(
                tree_leaves((ts.pose_refiner, ts.lbs_offset)),
                tree_leaves((start.pose_refiner, start.lbs_offset))))
        learned = {f: not torch.equal(getattr(ts.gauss.params, f), getattr(start.gauss.params, f))
                   for f in ("albedo", "roughness")}
        light_min = float(pbr_state.light["base"].min())
        back = load_checkpoint(str(out_b), end, (ts, pbr_state))
        saved = all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                       tree_leaves((ts, pbr_state)))
                    if isinstance(a, torch.Tensor))
        print(f"[pbr] geometry and MLPs bit-equal to chkpnt{CLI_ITERS} {frozen}; changed "
              f"{learned}; light min {light_min:.4g}, max "
              f"{float(pbr_state.light['base'].max()):.4g}; chkpnt{end} (state, light) loaded "
              f"back bit-equal {saved}", flush=True)
        require(frozen, "branch B moved the geometry")
        require(all(learned.values()), f"branch B left a material unchanged: {learned}")
        require(light_min >= 0.0, "a negative light texel")
        require(saved, f"chkpnt{end} differs from the live state")

        report: dict = {}
        bake_face_check(face["first_args"], dev, report)
        report["blend_fwd_tiles"]["launches_per_bake"] = [
            b["launches"].get("blend_fwd_tiles", 0) for b in bakes]

        # a branch-B step on the loaded state
        scene = cli_train.synthetic_scene(CLI_SCENE["views"], CLI_SCENE["size"],
                                          CLI_SCENE["verts"], dev)
        train = make_trainer(scene, scene.raster_config, dev)
        ts0 = restore_checkpoint_like(str(CLI_DIR / "train"), CLI_ITERS, train["ts"])
        opt = OptimizationConfig()
        pbr0, ltx = tpbr.create_pbr_state(opt, device=dev)
        step = tpbr.make_pbr_train_step(scene.smpl_model, train["tx"], ltx, opt,
                                        scene.raster_config, bg=torch.zeros(3, device=dev),
                                        lpips_fn=train["lpips"])
        first_view = [0, 1, 2, 3].pop(np.random.RandomState(7).randint(4))
        u8 = torch.round(face["first_occ"] * 255.0).to(torch.uint8)
        with torch.no_grad():
            env = export_envmap(pbr0.light, 16, 32).mean(dim=-1, keepdim=True)
            occ_col = baking.occlusion_color(u8.float() * (1.0 / 255.0), env)
        report.update(pbr_step_checks(
            (ts0, pbr0, scene.batches[first_view], tpbr.compute_knn3(ts0.gauss), occ_col,
             prefilter_weight_set(32, dev), min(CLI_ITERS // 1000, 3)), step, dev, n_sm, pb, pbb))
        pbr_gpu_vs_cpu(dev)

        # the graphed loop against the eager one, and a graphed bake sweep
        graph_launches, _ = pbr_graph_phase(scene, train, dev, memo)
        bake_graph_check(face["first_args"], dev)

        # cli.render --relight with the run's light
        cuda_lib.reset_launches()
        m = cli_render.main(["--model_path", str(out_b), "--iteration", str(end)] + synth + [
            "--use_replay_cache", "--relight", str(out_b / f"envmap_{end}.npy"),
            "--device", "cuda"])
        torch.cuda.synchronize()
        relight_launches = dict(cuda_lib.LAUNCHES)
        print(f"[relight] cli.render --relight envmap_{end}.npy: relight_oracle "
              f"{m['relight_oracle']}, PSNR {m['psnr']:.4f} vs the relit ground truth, "
              f"psnr_drift {m['psnr_drift']:.4f}, SSIM {m['ssim']:.4f}, ssim_drift "
              f"{m['ssim_drift']:.4f}, lpips_rand {m['lpips_rand']:.4f}; fps_device "
              f"{m['fps_device']:.2f} (unlit sweep); launches {relight_launches}", flush=True)
        require(m["relight_oracle"] is True and np.isfinite([m["psnr"], m["psnr_drift"]]).all(),
                "cli.render --relight gave no oracle or a non-finite PSNR")
        require(relight_launches["blend_fwd"] > 0 and relight_launches["blend_fwd_ckpt"] == 0,
                "cli.render --relight did not run kernel C, or wrote checkpoints")
        relight_checks(out_b, scene, dev, end)

        # the CPU bake of the first camera, against the card's
        worker.join()
        require(worker.exitcode == 0, f"the CPU bake process exited with {worker.exitcode}")
        cpu_bake = torch.load(bake_out, weights_only=True)
        gpu_occ = face["first_occ"].cpu()
        diff = (torch.round(gpu_occ * 255.0).to(torch.int16)
                - torch.round(cpu_bake["occ"] * 255.0).to(torch.int16)).abs()
        ferr = (gpu_occ - cpu_bake["occ"]).abs()
        print(f"[pbr] one camera's bake, card vs CPU: {int((diff > 0).sum())} of "
              f"{diff.numel()} uint8 texels differ (max {int(diff.max())}), float visibility "
              f"max abs {float(ferr.max()):.3e}, {int((ferr > RENDER_ATOL).sum())} texels beyond "
              f"{RENDER_ATOL}; n_sweeps {cpu_bake['n_sweeps']} vs {bakes[0]['n_sweeps']}; the "
              f"CPU bake took {cpu_bake['seconds']:.1f} s ({CPU_BAKE_THREADS} threads), the "
              f"card's {bakes[0]['seconds']:.3f} s", flush=True)
        require(int(diff.max()) <= BAKE_U8_STEP and cpu_bake["n_sweeps"] == bakes[0]["n_sweeps"],
                "the card's bake differs from the CPU's by more than one uint8 step")
    finally:
        if worker.is_alive():
            worker.terminate()
            worker.join()
    return ({"cli_train_pbr": pbr_launches, "pbr_graph": graph_launches,
             "cli_render_relight": relight_launches}, report, (ts, pbr_state))


class MemGroup(dict):
    """An in-memory tree of numpy arrays with h5py's group interface (`[]`,
    `in`, iteration, `.attrs`, `close`): what SMCReader reads."""

    def __init__(self, items=(), attrs=None):
        super().__init__(items)
        self.attrs = dict(attrs or {})

    def close(self):
        pass


def write_h5(group, node):
    """A MemGroup tree into an open h5py group."""
    group.attrs.update(node.attrs)
    for key, value in node.items():
        if isinstance(value, MemGroup):
            write_h5(group.create_group(key), value)
        else:
            group.create_dataset(key, data=value)


def make_smplx_scene(n_views, size, n_verts, seed, cfg, dev, radius=2.0):
    """A known Gaussian scene on the synthetic SMPL-X body (55 joints, a
    [486] pose basis, 20 shape dims), built as make_synthetic_scene builds
    one on SMPL: ground truth through render_frame at a seeded 165-dim pose
    and seeded betas + expression per view."""
    import torch

    from mygauhuman_torch.data.synthetic import SyntheticScene, _masks, look_at_camera
    from mygauhuman_torch.models import gaussians as G
    from mygauhuman_torch.models.smpl import smpl_forward
    from mygauhuman_torch.models.smplx import smplx_big_pose_params, synthetic_smplx
    from mygauhuman_torch.render import FrameInputs, render_frame
    from mygauhuman_torch.train.trainer import TrainBatch
    from mygauhuman_torch.utils.transforms import inverse_sigmoid

    rng = np.random.RandomState(seed)
    model = synthetic_smplx(num_vertices=n_verts, seed=seed, device=dev)
    big = smplx_big_pose_params(device=dev)
    with torch.no_grad():
        verts = smpl_forward(model, big["poses"], big["shapes"])[0]
    v = verts.cpu().numpy()
    normals = rng.randn(n_verts, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    gt = G.create_from_pcd(v, rng.rand(n_verts, 3).astype(np.float32), normals, device=dev)
    gt = gt._replace(params=gt.params._replace(opacity=torch.full_like(
        gt.params.opacity, inverse_sigmoid(0.9))))
    batches = []
    for i in range(n_views):
        theta = 2 * np.pi * i / n_views
        center = v.mean(0)
        cam = look_at_camera(center + radius * np.array([np.sin(theta), 0.0, np.cos(theta)]),
                             center, size, size, device=dev)
        pose = (0.1 * rng.randn(55, 3)).astype(np.float32)
        pose[0] = 0.0
        frame = FrameInputs(smpl_param={
            "poses": torch.as_tensor(pose.reshape(-1), device=dev),
            "shapes": torch.as_tensor((0.3 * rng.randn(20)).astype(np.float32), device=dev),
            "R": torch.eye(3, device=dev), "Th": torch.zeros(3, device=dev)},
            big_pose_param=big, big_pose_verts=verts)
        with torch.no_grad():
            out = render_frame(gt, cam, frame, model, bg=torch.zeros(3, device=dev),
                               active_sh_degree=0, config=cfg)
        bkgd, bound = _masks(out.render_alpha, size, size)
        batches.append(TrainBatch(camera=cam, frame=frame, gt_image=out.render,
                                  gt_normal=out.normal, bkgd_mask=bkgd, bound_mask=bound))
    init = G.create_from_pcd(v, np.full((n_verts, 3), 0.5, np.float32), normals, device=dev)
    return SyntheticScene(smpl_model=model, gt_state=gt, init_state=init, batches=batches,
                          big_pose_verts=verts, extent=float(np.ptp(v, axis=0).max()) * 0.5,
                          raster_config=cfg)


def make_dna_capture(dev):
    """A DNA-format capture on the synthetic SMPL-X body at the real vertex
    count, and its SMPL-X npz in the reference layout. DNA["cams"]
    Camera_5mp cameras on a ring at DNA["dist"] m around the posed bodies'
    centre, the focal length chosen so that the body spans about half the
    frame height; DNA["frames"] frames with per-frame fullpose [55, 3],
    expression and transl, and one row of betas; D = 0. The frames are
    ground truth from render_frame: a seeded Gaussian state on the big-pose
    body (6 mm, opacity 0.9), rendered at half the rig's size through the camera
    whose K is halved (what the reader's 0.5 scaling gives), with no
    instance dropped but at the 1,024-per-tile cap, stored 2x
    nearest-upsampled as raw uint8 BGR arrays with their masks (alpha >
    0.5), so the reader's INTER_AREA halving gives the rendered pixels
    back. Returns (the capture as a MemGroup tree, the npz path, the GT
    renders' overflow counters)."""
    import torch

    from mygauhuman_torch.data.camera import make_camera
    from mygauhuman_torch.models import gaussians as G
    from mygauhuman_torch.models.smpl import smpl_forward
    from mygauhuman_torch.models.smplx import smplx_big_pose_params, synthetic_smplx
    from mygauhuman_torch.ops.rasterize import RasterizerConfig
    from mygauhuman_torch.render import FrameInputs, render_frame
    from mygauhuman_torch.utils.transforms import inverse_sigmoid

    c = DNA
    rng = np.random.RandomState(c["seed"])
    model = synthetic_smplx(num_vertices=c["verts"], seed=c["seed"], device=dev)
    DNA_DIR.mkdir(parents=True, exist_ok=True)
    npz = DNA_DIR / "SMPLX_NEUTRAL.npz"
    np.savez(npz, v_template=model.v_template.cpu().numpy(),
             shapedirs=model.shapedirs.cpu().numpy(),        # [V, 3, 10 + 10]
             posedirs=model.posedirs.cpu().numpy(),          # [V, 3, 54 * 9]
             J_regressor=model.j_regressor.cpu().numpy(), weights=model.weights.cpu().numpy(),
             parents=np.asarray(model.parents, np.int64), f=np.zeros((0, 3), np.int64))
    F = c["frames"]
    fullpose = 0.1 * rng.randn(F, 55, 3)
    fullpose[:, 0] = 0.0                      # the root upright
    betas = 0.3 * rng.randn(1, 10)
    expression = 0.2 * rng.randn(F, 10)
    transl = 0.01 * rng.randn(F, 3)
    big = smplx_big_pose_params(device=dev)
    params = []
    with torch.no_grad():
        big_verts = smpl_forward(model, big["poses"], big["shapes"])[0]
        posed = []
        for f in range(F):
            p = {"poses": torch.as_tensor(fullpose[f].reshape(-1), dtype=torch.float32,
                                          device=dev),
                 "shapes": torch.as_tensor(np.concatenate([betas[0], expression[f]]),
                                           dtype=torch.float32, device=dev),
                 "R": torch.eye(3, device=dev),
                 "Th": torch.as_tensor(transl[f], dtype=torch.float32, device=dev)}
            params.append(p)
            posed.append(smpl_forward(model, p["poses"], p["shapes"])[0] + p["Th"])
    pts = torch.cat(posed).cpu().numpy()
    center = 0.5 * (pts.min(0) + pts.max(0))
    extent = float(np.ptp(pts, axis=0).max())
    W, H = c["width"], c["height"]
    focal = 0.5 * H * c["dist"] / extent
    K = np.array([[focal, 0.0, W / 2], [0.0, focal, H / 2], [0.0, 0.0, 1.0]])
    K_half = K.copy()
    K_half[:2] *= 0.5

    v = big_verts.cpu().numpy()
    normals = rng.randn(len(v), 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    gt = G.create_from_pcd(v, rng.rand(len(v), 3).astype(np.float32), normals, device=dev)
    # isotropic 6 mm Gaussians at opacity 0.9: small enough on screen that
    # none needs more than the 16 tiles a Gaussian may touch, rendered with
    # an exact instance list; only kernel C's 1,024-instance tile cap, which
    # training has too, applies. The training starts from the reader's cloud
    # at its KNN scales and must shrink them
    gt = gt._replace(params=gt.params._replace(
        opacity=torch.full_like(gt.params.opacity, inverse_sigmoid(0.9)),
        scaling=torch.full_like(gt.params.scaling, float(np.log(DNA["gt_scale"])))))
    cfg = RasterizerConfig(instance_capacity=None)

    def up2(a):
        return np.ascontiguousarray(np.repeat(np.repeat(a, 2, axis=0), 2, axis=1))

    color, masks, calib = MemGroup(), MemGroup(), MemGroup()
    overflow = np.zeros(3, np.int64)
    coverage = []
    for cid in range(c["cams"]):
        theta = 2 * np.pi * cid / c["cams"]
        eye = center + c["dist"] * np.array([np.sin(theta), 0.0, np.cos(theta)])
        fwd = (center - eye) / np.linalg.norm(center - eye)
        right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        R_c2w = np.stack([right, np.cross(fwd, right), fwd], axis=1)
        RT = np.eye(4)
        RT[:3, :3], RT[:3, 3] = R_c2w, eye          # camera to world, as the reader takes it
        calib[str(cid)] = MemGroup({"K": K, "D": np.zeros(5), "RT": RT})
        cam = make_camera(R=R_c2w, t=-R_c2w.T @ eye, width=W // 2, height=H // 2, K=K_half,
                          device=dev)
        color[str(cid)] = MemGroup({"color": MemGroup()})
        masks[str(cid)] = MemGroup({"mask": MemGroup()})
        for f in range(F):
            with torch.no_grad():
                out = render_frame(gt, cam, FrameInputs(smpl_param=params[f],
                                                        big_pose_param=big,
                                                        big_pose_verts=big_verts),
                                   model, bg=torch.zeros(3, device=dev), active_sh_degree=0,
                                   config=cfg)
            rgb = (torch.clamp(out.render, 0, 1) * 255.0).round().to(torch.uint8).cpu().numpy()
            alpha = out.render_alpha.cpu().numpy()
            overflow += [int(out.overflow_tiles), int(out.overflow_gauss), int(out.overflow_inst)]
            coverage.append(float((alpha > 0.5).mean()))
            color[str(cid)]["color"][str(f)] = up2(rgb[..., ::-1])            # BGR
            masks[str(cid)]["mask"][str(f)] = up2(((alpha > 0.5) * 255).astype(np.uint8))
    tree = MemGroup({
        "Camera_5mp": MemGroup(color, attrs={"num_device": c["cams"], "num_frame": F,
                                             "resolution": np.array([W, H])}),
        "Mask": masks, "Camera_Parameter": calib,
        "SMPLx": MemGroup({"betas": betas, "expression": expression, "fullpose": fullpose,
                           "transl": transl, "scale": np.float64(1.0)}),
    }, attrs={"actor_id": 0, "performance_id": 0, "gender": "neutral"})
    print(f"[dna] capture: {c['cams']} Camera_5mp cameras x {F} frames at {W}x{H} (raw uint8 "
          f"BGR, 2x nearest-upsampled renders), focal {focal:.1f} px, cameras {c['dist']} m "
          f"from the body ({extent:.3f} m across), person mask coverage "
          f"{min(coverage):.3f}-{max(coverage):.3f} of the frame; ground truth {len(v)} "
          f"Gaussians, overflow tiles/gauss/inst {overflow.tolist()}", flush=True)
    require(min(coverage) > 0.02, f"the body covers {min(coverage)} of a frame")
    require(overflow[1] == overflow[2] == 0,
            f"the ground truth renders dropped instances beyond the tile cap: {overflow}")
    return tree, npz, overflow


@contextlib.contextmanager
def dna_source(tree, src):
    """The capture at `src` for the port's DNA reader: an .smc file written
    with h5py where h5py is installed; else (the card's machine has no h5py)
    `SMCReader` in `mygauhuman_torch.data.dna_rendering` replaced by a
    subclass that reads the same tree from memory through the port's own
    accessors. Yields "h5py" or "memory"."""
    import importlib.util

    import mygauhuman_torch.data.dna_rendering as dna_mod
    from mygauhuman_torch.data.smc_reader import SMCReader

    if importlib.util.find_spec("h5py") is not None:
        import h5py

        with h5py.File(src, "w") as f:
            write_h5(f, tree)
        yield "h5py"
        return

    class MemSMCReader(SMCReader):
        def __init__(self, file_path):
            require(os.path.abspath(file_path) == os.path.abspath(src),
                    f"the DNA reader opened {file_path}, not the capture {src}")
            self._attach(tree)

    with patched(dna_mod, "SMCReader", lambda orig: MemSMCReader):
        yield "memory"


def dna_phase(dev, n_sm, card):
    """The SMPL-X body on a DNA-Rendering capture through the entry points:
    cli.train --smpl_type smplx on a capture at the 5 MP rig's size (frames
    1224x1024 after the reader's 0.5 scaling: kernel C tile-major, in
    checkpoint mode in the step), every kernel against its plain version on
    the inputs of the CLI's own step at its last snapshot, the same step
    twice, a small SMPL-X step on the card against the CPU, cli.render on
    both branches and cli.metrics. Returns (launches per path, report)."""
    import torch

    from mygauhuman_torch.cli import metrics as cli_metrics
    from mygauhuman_torch.cli import render as cli_render
    from mygauhuman_torch.cli import train as cli_train
    from mygauhuman_torch.data import readers
    from mygauhuman_torch.data.readers import camera_info_to_batch
    from mygauhuman_torch.device import exact_convs
    from mygauhuman_torch.eval.metrics import evaluate_images
    from mygauhuman_torch.models.gaussians import compact_state
    from mygauhuman_torch.ops import cuda_lib
    from mygauhuman_torch.ops.rasterize import RasterizerConfig
    from mygauhuman_torch.render import render_frame
    from mygauhuman_torch.train import losses as L
    from mygauhuman_torch.train import trainer as TT
    from mygauhuman_torch.train.checkpoint import load_checkpoint, load_eval_cache
    from mygauhuman_torch.train.trainer import active_sh_degree_at
    from mygauhuman_torch.utils.image_io import write_png

    shutil.rmtree(DNA_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    tree, npz, _ = make_dna_capture(dev)
    torch.cuda.synchronize()
    print(f"[dna] capture built in {time.perf_counter() - t0:.1f} s", flush=True)
    # relative to the checkout: load_scene_info reads the path's words
    src = os.path.relpath(DNA_DIR / "capture_main.smc")
    require(not any(w in src.lower() for w in ("zju", "monocap", "render", "mixamo")),
            f"the capture path {src} would go to another reader")
    out = DNA_DIR / "train"
    body = ["-s", src, "--smpl_type", "smplx", "--smpl_model_path", str(npz)]
    made: dict = {}

    def keep(name):
        def wrap(orig):
            def run(*args, **kw):
                made.setdefault(name, (args, kw))
                result = orig(*args, **kw)
                made.setdefault(name + "_result", result)
                return result
            return run
        return wrap

    with dna_source(tree, src) as how:
        print(f"[dna] the capture is read from {how} ({card})", flush=True)
        cuda_lib.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with patched(TT, "make_train_step", keep("step")), \
                patched(TT, "train_loop", keep("loop")), \
                patched(readers, "load_scene_info", keep("info")):
            res = cli_train.main(body + [
                "--iterations", str(DNA_ITERS), "--test_iterations", str(DNA_ITERS),
                "--save_iterations", str(DNA_MID), str(DNA_ITERS), "--skip_galleries",
                "--model_path", str(out), "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cuda_lib.LAUNCHES)
        graph_line(res, DNA_ITERS, "[dna] cli.train --smpl_type smplx",
                   torch.cuda.max_memory_allocated() / 1e6)
        phases = res["phases"]
        side_s = sum(v["total_s"] for k, v in phases.items() if not k.startswith("mgh."))
        batches = made["loop"][0][3]
        b0 = batches[0]
        print(f"[dna] cli.train --smpl_type smplx: {DNA_ITERS} iterations in "
              f"{res['elapsed_s']:.3f} s ({1e3 * res['elapsed_s'] / DNA_ITERS:.3f} ms/iteration; "
              f"without the eval and saves {1e3 * (res['elapsed_s'] - side_s) / DNA_ITERS:.3f} "
              f"ms/iteration); {wall:.3f} s wall for the command (the reader included); "
              f"{len(batches)} training views at {b0.camera.width}x{b0.camera.height}; test "
              f"PSNR {res['test_psnr']:.4f}; {res['n_gaussians']} Gaussians alive, capacity "
              f"{res['capacity']}; launches {launches} ({card})", flush=True)
        for e in res["densify"]:
            print(f"[dna] densify event: {e}")
        with open(out / "metrics.jsonl") as f:
            rows = [json.loads(line) for line in f]
        logged = [(r["step"], [int(r[f"train/overflow_{k}"]) for k in ("tiles", "gauss", "inst")])
                  for r in rows if "train/overflow_inst" in r]
        print(f"[dna] overflow tiles (the 1,024-per-tile cap) / gauss / inst (instance capacity "
              f"4 x {made['loop'][0][0].gauss.capacity}) at the logged steps: {logged}",
              flush=True)
        require(res["first_iteration"] == 1 and res["last_iteration"] == DNA_ITERS,
                "cli.train did not run the SMPL-X budget")
        require(np.isfinite(res["final_loss"]) and res["test_psnr"] > 0,
                "cli.train on the capture: non-finite loss or no test PSNR")
        require(len(res["densify"]) >= 2, f"{len(res['densify'])} densify events")
        require((b0.camera.width, b0.camera.height) == (DNA["width"] // 2, DNA["height"] // 2)
                and len(batches) == (DNA["cams"] - 1) * DNA["frames"],
                "the reader did not give the rig's frames at half size")
        require(made["step"][0][0].j_regressor.shape[0] == 55, "the CLI did not load SMPL-X")
        for name in ("knn", "deform", "deform_bwd", "blend_fwd_tiles", "blend_fwd_ckpt",
                     "blend_bwd", "blend_bwd_sums", "blend_bwd_rows"):
            require(launches[name] > 0, f"cli.train on the capture: kernel {name} not launched")
        require(launches["blend_fwd"] == launches["blend_fwd_tiles"],
                "a 1224-wide frame took the planar layout")
        require(launches["deform_bwd"] == DNA_ITERS + res["graph"]["captures"]
                and launches["blend_bwd_ckpt"] == 0
                and launches["blend_fwd_ckpt"] == launches["blend_bwd"],
                f"cli.train on the capture: launches {launches}")

        # every kernel on the inputs of the CLI's own step at its last
        # snapshot (tile-major checkpoint mode at 1224x1024), and the step twice
        step = made["step_result"]
        report = cli_kernel_checks(out, step, res["state"], b0, (DNA_ITERS,), n_sm,
                                   run="cli.train smplx")
        ts_end = load_checkpoint(str(out), DNA_ITERS, res["state"])
        deg = active_sh_degree_at(DNA_ITERS, 3)
        same_step_twice(step, ts_end, b0, deg, f"the SMPL-X step at chkpnt{DNA_ITERS}")
        profile_calls(lambda: step(ts_end, b0, deg), PROFILE_FRAMES,
                      f"SMPL-X step at chkpnt{DNA_ITERS} (graphed: a copy of the state in, "
                      f"a replay), {b0.camera.width}x{b0.camera.height}")
        profile_calls(lambda: step.eager(ts_end, b0, deg), PROFILE_FRAMES,
                      f"SMPL-X step at chkpnt{DNA_ITERS} (eager), "
                      f"{b0.camera.width}x{b0.camera.height}")
        # the step's two image-sized loss terms alone, forward and backward,
        # on the frame: one of its two SSIM terms (the separable blur), and
        # its LPIPS pair on the crop the CLI sized (the VGG convolutions)
        img = b0.gt_image.flip(0).clone().requires_grad_(True)
        bm = b0.bound_mask.float()
        side = made["step"][1]["lpips_crop"]

        def ssim_term():
            with exact_convs():
                torch.autograd.grad(L.ssim(img, b0.gt_image, bm), img)

        def lpips_term():
            with exact_convs():
                m = bm[..., None]
                rendered, gt = TT._lpips_crop((torch.stack([img, img]) * m,
                                               torch.stack([b0.gt_image, b0.gt_normal]) * m),
                                              bm, side)
                lp = made["step"][1]["lpips_fn"](rendered, gt).sum()
                torch.autograd.grad(lp, img)

        profile_calls(ssim_term, PROFILE_FRAMES,
                      f"an SSIM term, forward + backward, {b0.camera.width}x{b0.camera.height}")
        profile_calls(lpips_term, PROFILE_FRAMES,
                      f"the LPIPS pair, forward + backward, crop {side}x{side}")

        # a small SMPL-X scene: the step on the card against the CPU
        train_gpu_vs_cpu(dev, make_smplx_scene(2, DNA_SMALL["size"], DNA_SMALL["verts"], 1,
                                               small_scene_config(), dev),
                         label=f"{DNA_SMALL['size']}^2 with the 55-joint SMPL-X")

        # cli.render on both branches, then cli.metrics
        base = ["--model_path", str(out), "--iteration", str(DNA_ITERS)] + body + [
            "--device", "cuda"]
        renders, render_launches = {}, {}
        for branch, extra in (("deform", []), ("replay", ["--use_replay_cache"])):
            cuda_lib.reset_launches()
            m = cli_render.main(base + extra)
            torch.cuda.synchronize()
            render_launches[branch] = dict(cuda_lib.LAUNCHES)
            renders[branch] = m
            print(f"[dna] cli.render {branch}: PSNR {m['psnr']:.4f}, SSIM {m['ssim']:.4f}, "
                  f"lpips_rand {m['lpips_rand']:.4f}, fps_wall {m['fps_wall']:.2f}; launches "
                  f"{render_launches[branch]} ({card})", flush=True)
            require(render_launches[branch]["blend_fwd_tiles"] > 0
                    and render_launches[branch]["blend_fwd_ckpt"] == 0
                    and render_launches[branch]["deform_bwd"] == 0,
                    f"cli.render {branch}: launches {render_launches[branch]}")
        require(render_launches["replay"]["knn"] == render_launches["replay"]["deform"] == 0,
                "cli.render --use_replay_cache ran the deform chain")

    # the replay cache: bit for bit the eval's deform transforms (the state at
    # chkpnt500 with its MLPs, on the test view), and cli.render's replay
    # image bit for bit a replay render of the compacted state with them
    model = made["step"][0][0]
    info = made["info_result"]
    require(len(info.test_cameras) == 1, f"{len(info.test_cameras)} test views")
    tb = camera_info_to_batch(info.test_cameras[0], dev)
    cache = load_eval_cache(str(out / f"smpl_rot_{DNA_ITERS}.npz"))
    state = compact_state(ts_end.gauss)
    alive = torch.nonzero(ts_end.gauss.alive).reshape(-1)
    cfg = RasterizerConfig()._replace(instance_capacity=4 * state.capacity)
    kw = dict(bg=torch.zeros(3, device=dev), active_sh_degree=3, config=cfg)
    with torch.no_grad():
        deform = render_frame(ts_end.gauss, tb.camera, tb.frame, model,
                              mlp_params={"pose_refiner": ts_end.pose_refiner,
                                          "lbs_offset": ts_end.lbs_offset}, **kw)
        rows = {k: getattr(deform, k)[alive] for k in ("transforms", "translation")}
        key = str(info.test_cameras[0].pose_id)
        cache_exact = sorted(cache) == [key] and all(
            torch.equal(rows[k], torch.as_tensor(cache[key][k], device=dev)) for k in rows)
        padded = {k: torch.cat([r, r.new_zeros((state.capacity - alive.numel(),) + r.shape[1:])])
                  for k, r in rows.items()}
        replay = render_frame(state, tb.camera, tb.frame, model, **padded, **kw)
        at_train_cfg = render_frame(state, tb.camera, tb.frame, model, **padded,
                                    **dict(kw, config=made["step"][0][3]))
    replay_exact = torch.equal(replay.render, renders["replay"]["renders"][0])
    overflow = lambda o: [int(o.overflow_tiles), int(o.overflow_gauss),  # noqa: E731
                          int(o.overflow_inst)]
    print(f"[dna] the replay cache (pose {key}, {alive.numel()} rows) bit-equal to the eval's "
          f"deform transforms {cache_exact}; cli.render's replay image bit-equal to a replay "
          f"of them {replay_exact}; its overflow tiles/gauss/inst {overflow(replay)} at "
          f"instance capacity {cfg.instance_capacity} (4 x the compacted {state.capacity}); "
          f"the same replay under the training config (instance capacity "
          f"{made['step'][0][3].instance_capacity}): overflow {overflow(at_train_cfg)}, "
          f"PSNR {float(evaluate_images([at_train_cfg.render], [tb.gt_image])['psnr']):.4f} "
          f"against cli.render's {renders['replay']['psnr']:.4f}", flush=True)
    require(cache_exact and replay_exact, "the SMPL-X replay cache does not reproduce the "
            "eval's deform transforms, or cli.render does not replay them")

    gt_dir = DNA_DIR / "gt"
    gt_dir.mkdir(parents=True)
    q = lambda x: (np.clip(x.cpu().numpy(), 0, 1) * 255).astype(np.uint8)  # noqa: E731
    write_png(str(gt_dir / "00000.png"), q(tb.gt_image))
    got = cli_metrics.main(["-r", str(out / f"renders_{DNA_ITERS}"), "-g", str(gt_dir),
                            "-o", str(DNA_DIR / "metrics.json"), "--device", "cuda"])
    as8 = lambda x: torch.as_tensor(q(x).astype(np.float32) / 255.0, device=dev)  # noqa: E731
    mem = evaluate_images([as8(renders["replay"]["renders"][0])], [as8(tb.gt_image)])
    print(f"[dna] cli.metrics: PSNR {got['psnr']:.6f} from the PNGs, {mem['psnr']:.6f} on the "
          f"same 8-bit images in memory, results.json {renders['replay']['psnr']:.6f}; SSIM "
          f"{got['ssim']:.6f} vs {mem['ssim']:.6f}", flush=True)
    require(abs(got["psnr"] - mem["psnr"]) <= METRICS_ATOL
            and abs(got["ssim"] - mem["ssim"]) <= METRICS_ATOL,
            "cli.metrics disagrees with the metrics of its images on the capture")
    require(abs(got["psnr"] - renders["replay"]["psnr"]) <= QUANT_PSNR_DB,
            "cli.metrics' PSNR is beyond 8-bit quantisation of results.json's")
    return {"smplx_dna": launches, "smplx_dna_render_deform": render_launches["deform"],
            "smplx_dna_render_replay": render_launches["replay"]}, report


# ---- phase 9: the tile-sharded multi-device path ------------------------------
# 2 ranks: on one card both run on cuda:0 over gloo (NCCL refuses two ranks
# on one device); with two or more cards, on distinct cards over NCCL


def torchrun(nproc, part, *extra, timeout=900, root=None):
    """Run the multichip worker `part` of this script (or of the checkout
    at `root`) on nproc ranks through torch.distributed.run, relay the
    ranks' report lines, fail on a non-zero exit; returns the launch's wall
    seconds and each rank's JSON."""
    import sys

    here = Path(__file__).resolve().parent
    root = here if root is None else Path(root).resolve()
    mc_dir = root / MC_DIR.relative_to(here)
    mc_dir.mkdir(parents=True, exist_ok=True)
    log = mc_dir / f"{part}-{nproc}.log"
    for f in mc_dir.glob(f"{part}-{nproc}-rank*.json"):
        f.unlink()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), str(root / "chip_smoke.py"), "--mc-worker", part,
           *extra]
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, cwd=str(root),
                                start_new_session=True)
        try:
            proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:   # the launcher and its ranks, all of them
                os.killpg(proc.pid, 9)
                proc.wait()
    wall = time.perf_counter() - t0
    text = log.read_text()
    for line in text.splitlines():
        if line.startswith("[") and not line.startswith("[W"):
            print(line, flush=True)
    require(proc.returncode == 0,
            f"multichip {part} on {nproc} ranks exited {proc.returncode}:\n{text[-6000:]}")
    return wall, [json.loads((mc_dir / f"{part}-{nproc}-rank{r}.json").read_text())
                  for r in range(nproc)]


def mc_scene(dev):
    """The bench point's scene (512^2, 6,890 SMPL vertices, capacity 8,192,
    seed 0), the CLI's raster config, and a fresh state with its optimizer."""
    from mygauhuman_torch.data.synthetic import make_synthetic_scene
    from mygauhuman_torch.ops.rasterize import RasterizerConfig

    cfg = RasterizerConfig(tile_capacity=1024, chunk_tiles=64,
                           instance_capacity=4 * BENCH["capacity"])
    scene = make_synthetic_scene(n_views=BENCH["views"], width=BENCH["width"],
                                 height=BENCH["height"], n_verts=BENCH["n_verts"],
                                 capacity=BENCH["capacity"], seed=BENCH["seed"],
                                 raster_config=cfg, device=dev)
    return scene, cfg


def in_turn(fn):
    """fn() on each rank in rank order (the ranks' lines do not interleave)."""
    import torch.distributed as dist

    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            fn()
        dist.barrier()


def mc_raster_check(mesh, scene, cfg, tag):
    """(a) rasterize_sharded against the single-device rasterize on the same
    card: outputs, counters and gradients of opacity and features."""
    import torch

    from mygauhuman_torch.models import gaussians as G
    from mygauhuman_torch.ops.rasterize import rasterize
    from mygauhuman_torch.parallel.raster import rasterize_sharded

    st = scene.gt_state
    p = st.params
    cam = scene.batches[0].camera
    geo = dict(width=cam.width, height=cam.height, tan_fovx=cam.tan_fovx,
               tan_fovy=cam.tan_fovy, config=cfg, alive=st.alive)
    means, cov6 = p.xyz.detach(), G.get_covariance6(p).detach()
    bg = torch.zeros(3, device=means.device)

    def run(sharded):
        op = G.get_opacity(p)[:, 0].detach().requires_grad_(True)
        ft = (p.features_dc[:, 0, :] * 0.28209479177387814 + 0.5).detach().requires_grad_(True)
        if sharded:
            out = rasterize_sharded(means, cov6, op, ft, cam.w2c, cam.full_proj, bg, mesh=mesh,
                                    exchange_capacity=MC_EXCHANGE, **geo)
        else:
            out = rasterize(means, cov6, op, ft, cam.w2c, cam.full_proj, bg, **geo)
        loss = (((out.image - 0.3) ** 2).sum() + (out.alpha ** 2).sum()
                + 0.1 * out.depth.sum())
        return out, torch.autograd.grad(loss, (op, ft))

    ref, g_ref = run(False)
    out, g = run(True)
    torch.cuda.synchronize()
    err = {k: float((getattr(out, k) - getattr(ref, k)).abs().max())
           for k in ("image", "alpha", "depth", "final_t")}
    radii_equal = bool(torch.equal(out.radii, ref.radii))
    g_err = [float(((a - b).abs() - RASTER_GRAD_RTOL * b.abs()).max()) for a, b in zip(g, g_ref)]
    ms_single = cuda_ms(lambda: run(False), reps=5, warmup=1)
    ms_sharded = cuda_ms(lambda: run(True), reps=5, warmup=1)
    in_turn(lambda: print(f"{tag} (a) rasterize_sharded vs rasterize at {cam.width}x{cam.height}: max abs err "
          f"{err}, radii equal {radii_equal}, overflow tiles/gauss/inst "
          f"{int(out.overflow_tiles)}/{int(out.overflow_gauss)}/{int(out.overflow_inst)} "
          f"(single {int(ref.overflow_tiles)}/{int(ref.overflow_gauss)}/"
          f"{int(ref.overflow_inst)}); gradient errors past rtol {RASTER_GRAD_RTOL}: opacity "
          f"{g_err[0]:.3e}, features {g_err[1]:.3e} (atol {RASTER_GRAD_ATOL}); forward + "
          f"backward {ms_sharded:.3f} ms sharded, {ms_single:.3f} ms single-device",
          flush=True))
    require(max(err["image"], err["alpha"], err["final_t"]) <= RASTER_ATOL
            and err["depth"] <= RASTER_DEPTH_ATOL and radii_equal,
            f"rasterize_sharded differs from rasterize: {err}, radii equal {radii_equal}")
    require(int(out.overflow_inst) == 0, f"exchange overflow {int(out.overflow_inst)}")
    require(max(g_err) <= RASTER_GRAD_ATOL, f"sharded gradients differ: {g_err}")
    return dict(err=err, grad_err=g_err, ms_sharded=ms_sharded, ms_single=ms_single)


def mc_checks(rt, mesh, pbr_inputs):
    """(a) the rasterizer, (b) every kernel on this rank's own inputs of the
    sharded step (in turns, one rank at a time, so that no rank's timing
    shares the card), (d) the sharded branch-B step for MC_PBR_ITERS
    iterations on phase 7's state."""
    import torch
    import torch.distributed as dist

    import mygauhuman_torch.models.lbs as lbs_mod
    import mygauhuman_torch.ops.pallas_blend as pb
    import mygauhuman_torch.ops.pallas_blend_bwd as pbb
    import mygauhuman_torch.ops.pallas_deform as pd
    from mygauhuman_torch.data.synthetic import look_at_camera
    from mygauhuman_torch.eval.lpips import LPIPS
    from mygauhuman_torch.models import gaussians as G
    from mygauhuman_torch.parallel.mesh import RASTER_AXES, StateSharding
    from mygauhuman_torch.parallel.raster import rasterize_sharded
    from mygauhuman_torch.parallel.train import (
        make_tile_sharded_pbr_step,
        make_tile_sharded_train_step,
        stack_batches,
    )

    dev, r = rt.device, rt.rank
    tag = f"[multichip r{r}]"
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    scene, cfg = mc_scene(dev)
    out = {"raster": mc_raster_check(mesh, scene, cfg, tag)}

    # (b) the sharded step's own calls: kernel C planar in checkpoint mode at
    # this rank's strip, D1s + D2 on its backward, A and B on its slice; and
    # kernel C tile-major on a 1224x1024 frame's strip
    train = make_trainer(scene, cfg, dev)
    step = make_tile_sharded_train_step(scene.smpl_model, train["tx"], train["opt"], cfg,
                                        bg=torch.zeros(3, device=dev), mesh=mesh,
                                        exchange_capacity=MC_EXCHANGE,
                                        lpips_fn=train["lpips"], lpips_crop=train["crop"])
    sharding = StateSharding(mesh.group(RASTER_AXES))
    share = sharding.shard(train["ts"], train["ts"].gauss.capacity)
    seen, wide = {}, {}
    with capture(lbs_mod, "knn", seen), capture(lbs_mod, "deform_rows", seen), \
            capture(pb, "blend_instances_cuda", seen), \
            capture(pbb, "blend_tiles_bwd_from_ckpt_raw", seen), \
            capture(pd, "deform_rows_bwd_cuda", seen):
        step.loss_and_grads(share, stack_batches([scene.batches[0]]), 0)
    b0 = scene.batches[0]
    cam = look_at_camera(b0.camera.cam_center.cpu().numpy(),
                         scene.big_pose_verts.mean(0).cpu().numpy(), *MC_WIDE, device=dev)
    p = scene.gt_state.params
    op = G.get_opacity(p)[:, 0].detach().requires_grad_(True)
    with capture(pb, "blend_instances_cuda", wide):
        o = rasterize_sharded(p.xyz, G.get_covariance6(p), op, p.features_dc[:, 0, :],
                              cam.w2c, cam.full_proj, torch.zeros(3, device=dev), mesh=mesh,
                              width=cam.width, height=cam.height, tan_fovx=cam.tan_fovx,
                              tan_fovy=cam.tan_fovy, config=cfg, alive=scene.gt_state.alive)
        o.image.sum().backward()
    report = {}
    for turn in range(rt.world_size):
        if turn == r:
            (data, starts, counts, tile_base), kw = seen["blend_instances_cuda"]
            require(kw["planar"] and kw["checkpoints"], f"{tag} the step's blend is not planar "
                    "in checkpoint mode")
            print(f"{tag} tile_base {tile_base}: strip of {kw['n_tiles']} tiles at 512x512, "
                  f"{int(counts.sum())} instances blended of the {data.shape[1]} exchange "
                  f"columns received", flush=True)
            check_kernel_c(f"r{r} strip tile_base {tile_base} planar", data, starts, counts,
                           tile_base, kw, pb, pbb, report=report, ckpt_report=True)
            check_kernel_d(f"r{r} strip tile_base {tile_base}",
                           seen["blend_tiles_bwd_from_ckpt_raw"], kw["n_channels"], report,
                           pb, pbb, main=True)
            (q, refs), kwa = seen["knn"]
            check_kernel_a(f"r{r} slice", q, refs, kwa.get("k", 1),
                           kwa.get("exclude_self", False), n_sm, report)
            check_kernel_b(f"r{r} slice", seen["deform_rows"][0], n_sm, report)
            check_kernel_b_bwd(seen["deform_rows_bwd_cuda"], report, label=f"r{r} slice")
            (data, starts, counts, tile_base), kw = wide["blend_instances_cuda"]
            require(not kw["planar"] and kw["checkpoints"],
                    f"{tag} the {MC_WIDE} strip is not tile-major in checkpoint mode")
            print(f"{tag} tile_base {tile_base}: strip of {kw['n_tiles']} tiles at "
                  f"{MC_WIDE[0]}x{MC_WIDE[1]}", flush=True)
            check_kernel_c(f"r{r} strip tile_base {tile_base} tile-major {MC_WIDE}", data,
                           starts, counts, tile_base, kw, pb, pbb, report=report,
                           ckpt_report=True, name="blend_fwd_tiles")
            out["tile_base"] = [int(seen["blend_instances_cuda"][0][3]), int(tile_base)]
        dist.barrier()

    # (d) branch B: the sharded step for MC_PBR_ITERS iterations on phase
    # 7's state and occlusion; rank 0 keeps the result for the comparison
    a = torch.load(pbr_inputs, weights_only=False)
    a = to_dev(a, dev)
    pstep = make_tile_sharded_pbr_step(a["smpl_model"], a["tx"], a["light_tx"], a["cfg"], cfg,
                                       bg=torch.zeros(3, device=dev), mesh=mesh,
                                       exchange_capacity=MC_EXCHANGE,
                                       lpips_fn=LPIPS(device=dev))
    # this rank's share of the state and of the occlusion colour
    cap = a["ts"].gauss.capacity
    sh, pbr = sharding.shard(a["ts"], cap), a["pbr_state"]
    occ = sharding.shard(a["occ"], cap).local[None]
    batch = stack_batches([a["batch"]])
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(MC_PBR_ITERS):
        sh, pbr, m = pstep(sh, pbr, batch, a["knn3"], occ, a["prefilter_w"], MC_PBR_DEGREE)
        losses.append(float(m["loss"]))
        if i == 0:      # every rank joins the gather
            first = to_dev(sharding.gather(sh).gauss.params, torch.device("cpu"))
    out["pbr_ms"] = 1e3 * (time.perf_counter() - t0) / MC_PBR_ITERS
    out["pbr_losses"] = losses
    in_turn(lambda: print(f"{tag} (d) sharded branch-B step: {MC_PBR_ITERS} iterations at "
                          f"capacity {sh.capacity} ({occ.shape[1]} rows on this rank), "
                          f"{out['pbr_ms']:.2f} ms/iteration (the loss read every iteration, "
                          f"the state gathered after the first), last loss {losses[-1]:.6f}",
                          flush=True))
    final = to_dev((sharding.gather(sh), pbr), torch.device("cpu"))
    if r == 0:
        torch.save(dict(first=first, final=final), MC_DIR / "pbr_sharded.pt")
    out["report"] = report
    return out


def mc_cli(rt, mesh, argv):
    """(c) cli.train on this launch's ranks: its launches, the losses of the
    first MC_LOSS_ITERS iterations, its densify events and PSNR; on more
    than one rank, this rank's per-Gaussian bytes against the whole state's
    (at the start and the end), the state gathers over the run, inside the
    steps and in each iteration, then the sharded step's collectives per
    step (timed, the card synchronised around each) and the same step twice
    from the trained state, bit for bit."""
    import torch

    from mygauhuman_torch.cli import train as cli_train
    from mygauhuman_torch.eval.lpips import LPIPS
    from mygauhuman_torch.ops import cuda_lib
    from mygauhuman_torch.parallel import mesh as pm
    from mygauhuman_torch.parallel import train as ptrain
    from mygauhuman_torch.parallel.train import make_tile_sharded_train_step, stack_batches
    from mygauhuman_torch.train import trainer as TT
    from mygauhuman_torch.train.optim import tree_leaves

    losses, by_it, in_steps, counted_so_far = {}, {}, [0], [0]

    def gathers():
        return pm.STATS.get("state_gather", {}).get("calls", 0)

    def logged(orig):
        def run(ts, *args, callback=None, **kw):
            def cb(it, ts, m):
                if it <= MC_LOSS_ITERS:
                    losses[it] = float(m["loss"])
                callback(it, ts, m)
                # the iteration's gathers: its step, its events, its callback
                by_it[it] = gathers() - counted_so_far[0]
                counted_so_far[0] = gathers()
            return orig(ts, *args, callback=cb, **kw)
        return run

    def counted(orig):
        def make(*args, **kw):
            step = orig(*args, **kw)

            def run(*a, **k):
                before = gathers()
                out = step(*a, **k)
                in_steps[0] += gathers() - before
                return out
            return run
        return make

    cuda_lib.reset_launches()
    pm.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    with patched(TT, "train_loop", logged), \
            patched(ptrain, "make_tile_sharded_train_step", counted):
        res = cli_train.main(argv)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    run_gathers = dict(pm.STATS.get("state_gather", {"calls": 0, "bytes": 0}))
    tag = f"[multichip r{rt.rank}/{rt.world_size}]"
    print(f"{tag} cli.train --multichip: {res['last_iteration']} iterations in "
          f"{res['elapsed_s']:.3f} s ({1e3 * res['elapsed_s'] / res['last_iteration']:.3f} "
          f"ms/iteration), mesh {res['mesh']}, test PSNR {res['test_psnr']:.4f}, "
          f"{res['n_gaussians']} Gaussians, capacity {res['capacity']}; peak device memory "
          f"allocated by this rank {peak_mb:.1f} MB; launches {launches}", flush=True)
    out = dict(losses=losses, densify=res["densify"], psnr=res["test_psnr"],
               elapsed_s=res["elapsed_s"], iterations=res["last_iteration"],
               launches=launches, mesh=res["mesh"], phases=res["phases"], peak_mb=peak_mb)
    if mesh is None:
        return out
    # the iterations that gather by design: densify events, eval and save
    events = {e["iteration"] for e in res["densify"]} | {MC_ITERS}
    quiet = [it for it in by_it if it not in events]
    out.update(state_bytes=res["state_bytes"], state_gather=run_gathers,
               gathers_in_steps=in_steps[0], quiet_iterations=len(quiet),
               gathers_quiet=sum(by_it[it] for it in quiet),
               gathers_at=[(it, by_it[it]) for it in sorted(events) if it in by_it])
    b = res["state_bytes"]
    print(f"{tag} state: per-Gaussian leaves {b['start']['rank'] / 1e6:.3f} MB of the whole "
          f"{b['start']['whole'] / 1e6:.3f} MB at the start (capacity "
          f"{b['start']['capacity']}), {b['end']['rank'] / 1e6:.3f} of "
          f"{b['end']['whole'] / 1e6:.3f} MB at {res['last_iteration']} (capacity "
          f"{b['end']['capacity']}); state_gather over the run {run_gathers['calls']} calls, "
          f"{run_gathers['bytes'] / 1e6:.3f} MB sent by this rank (calls per iteration "
          f"{out['gathers_at']} at the densify events and the eval and save at "
          f"{MC_ITERS}, and the returned state); inside the {len(by_it)} steps "
          f"{in_steps[0]} calls, in the {len(quiet)} iterations without an event "
          f"{out['gathers_quiet']} calls", flush=True)
    require(in_steps[0] == 0 and out["gathers_quiet"] == 0,
            f"{tag} the state was gathered inside a step ({in_steps[0]}) or between events "
            f"({out['gathers_quiet']})")
    require(all(2 * b[w]["rank"] == b[w]["whole"] for w in ("start", "end")),
            f"{tag} a rank holds more than its half of the state: {b}")
    dev = rt.device
    scene = cli_train.synthetic_scene(CLI_SCENE["views"], CLI_SCENE["size"],
                                      CLI_SCENE["verts"], dev)
    ts = res["state"]
    sharding = pm.StateSharding(mesh.group(pm.RASTER_AXES))
    sh = sharding.shard(ts, ts.gauss.capacity)
    step = make_tile_sharded_train_step(
        scene.smpl_model, TT.Adam(TT.OptimizationConfig()), TT.OptimizationConfig(),
        scene.raster_config, bg=torch.zeros(3, device=dev), mesh=mesh,
        exchange_capacity=MC_EXCHANGE, lpips_fn=LPIPS(device=dev),
        lpips_crop=TT.scene_lpips_crop([b.bound_mask for b in scene.batches]))
    batch = stack_batches([scene.batches[0]])
    torch.distributed.barrier()     # rank 0's eval at the last iteration is not timed
    pm.reset_stats()
    pm.TIMED[0] = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MC_TIMED_STEPS):
        s1, _ = step(sh, batch, 0)
    torch.cuda.synchronize()
    pm.TIMED[0] = False
    out["timed_ms"] = 1e3 * (time.perf_counter() - t0) / MC_TIMED_STEPS
    out["per_step"] = {k: {"calls": v["calls"] / MC_TIMED_STEPS,
                           "bytes": v["bytes"] / MC_TIMED_STEPS,
                           "ms": 1e3 * v["seconds"] / MC_TIMED_STEPS}
                       for k, v in pm.STATS.items()}
    coll_ms = sum(v["ms"] for v in out["per_step"].values())
    print(f"{tag} sharded step at capacity {sh.capacity} ({sharding.rows(sh.capacity)} rows "
          f"on this rank), {MC_TIMED_STEPS} steps with the card synchronised around each "
          f"collective: {out['timed_ms']:.3f} ms/step; per step: exchange "
          f"{out['per_step']['all_to_all']['bytes'] / 1e6:.3f} MB forward + "
          f"{out['per_step']['all_to_all_bwd']['bytes'] / 1e6:.3f} MB backward, collectives "
          f"{coll_ms:.3f} ms, state gather "
          f"{out['per_step'].get('state_gather', {}).get('calls', 0)} calls; by kind "
          f"{out['per_step']}", flush=True)
    require("state_gather" not in out["per_step"], f"{tag} the step gathers the state")
    s2, m2 = step(sh, batch, 0)
    s3, m3 = step(sh, batch, 0)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(s2.local), tree_leaves(s3.local))) \
        and float(m2["loss"]) == float(m3["loss"])
    print(f"{tag} the sharded step twice from the trained state: bit-equal {same}", flush=True)
    require(same, f"{tag} the sharded step twice differs")
    return out


def mc_worker(argv):
    """One rank of a torch.distributed.run launch of this script."""
    import torch

    from mygauhuman_torch.parallel.mesh import init_distributed, make_hybrid_mesh

    part, rest = argv[0], argv[1:]
    torch.backends.cudnn.allow_tf32 = False
    rt = init_distributed(device="cuda")
    mesh = make_hybrid_mesh(rt=rt) if rt.world_size > 1 else None
    if rt.rank == 0:
        print(f"[multichip] {part}: {rt.world_size} ranks, backend {rt.backend}, mesh "
              f"{mesh.shape if mesh else None}, {torch.cuda.device_count()} card(s), rank 0 on "
              f"{rt.device}", flush=True)
    out = mc_checks(rt, mesh, rest[0]) if part == "checks" else mc_cli(rt, mesh, rest)
    (MC_DIR / f"{part}-{rt.world_size}-rank{rt.rank}.json").write_text(json.dumps(out))
    if rt.world_size > 1:
        torch.distributed.destroy_process_group()


def mc_pbr_inputs(dev, pbr_final, scene):
    """(d)'s inputs, through a file: phase 7's final state and light, view
    0's occlusion baked on the card under that light, the KNN neighbours and
    the prefilter weights."""
    import torch

    from mygauhuman_torch.config import OptimizationConfig
    from mygauhuman_torch.occlusion import baking
    from mygauhuman_torch.pbr.light import export_envmap, prefilter_weight_set
    from mygauhuman_torch.train import pbr as tpbr
    from mygauhuman_torch.train.optim import Adam

    ts, pbr_state = pbr_final
    b0 = scene.batches[0]
    m, c6, op, wn = tpbr._pose_for_bake(ts, b0, scene.smpl_model)
    occ, _, _ = baking.bake_occlusion_full(m, c6, op, wn, ts.gauss.alive, height=16, width=32)
    with torch.no_grad():
        env = export_envmap(pbr_state.light, 16, 32)
        occ_col = baking.occlusion_color(torch.round(occ * 255.0) / 255.0,
                                         env.mean(dim=-1, keepdim=True))
    cfg = OptimizationConfig(iterations=CLI_ITERS + PBR_ITERS, pbr_iteration=CLI_ITERS)
    a = dict(ts=ts, pbr_state=pbr_state, batch=b0, knn3=tpbr.compute_knn3(ts.gauss),
             occ=occ_col, prefilter_w=prefilter_weight_set(pbr_state.light["base"].shape[1],
                                                           dev),
             smpl_model=scene.smpl_model, tx=Adam(cfg), light_tx=tpbr.LightAdam(cfg.opacity_lr),
             cfg=cfg)
    path = MC_DIR / "pbr_inputs.pt"
    MC_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(to_dev(a, torch.device("cpu")), path)
    return a, path


def multichip_phase(dev, n_sm, card, pbr_final):
    """(a)-(d) on MC_RANKS ranks (module docstring, phase 9). Returns the
    launches of the 2-rank cli.train run's ranks and rank 1's kernel report
    (its strip has the non-zero tile_base)."""
    import torch

    from mygauhuman_torch.cli import train as cli_train
    from mygauhuman_torch.eval.lpips import LPIPS
    from mygauhuman_torch.train import pbr as tpbr

    shutil.rmtree(MC_DIR, ignore_errors=True)
    scene = cli_train.synthetic_scene(CLI_SCENE["views"], CLI_SCENE["size"],
                                      CLI_SCENE["verts"], dev)
    a, pbr_path = mc_pbr_inputs(dev, pbr_final, scene)
    print(f"[multichip] {MC_RANKS} ranks on {torch.cuda.device_count()} card(s): backend "
          f"{'gloo (ranks share cuda:0)' if torch.cuda.device_count() < MC_RANKS else 'nccl'}; "
          f"{card}", flush=True)

    wall, checks = torchrun(MC_RANKS, "checks", str(pbr_path))
    print(f"[multichip] (a), (b), (d) launch: {wall:.1f} s wall; tile_base per rank "
          f"{[c['tile_base'] for c in checks]}", flush=True)

    # (d) the same iterations single-device, against rank 0's result
    step = tpbr.make_pbr_train_step(a["smpl_model"], a["tx"], a["light_tx"], a["cfg"],
                                    scene.raster_config, bg=torch.zeros(3, device=dev),
                                    lpips_fn=LPIPS(device=dev))
    ts, pbr = a["ts"], a["pbr_state"]
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(MC_PBR_ITERS):
        ts, pbr, m = step(ts, pbr, a["batch"], a["knn3"], a["occ"], a["prefilter_w"],
                          MC_PBR_DEGREE)
        losses.append(float(m["loss"]))
        if i == 0:
            first = ts.gauss.params
    pbr_ms = 1e3 * (time.perf_counter() - t0) / MC_PBR_ITERS
    got = to_dev(torch.load(MC_DIR / "pbr_sharded.pt", weights_only=False), dev)
    ts_s, pbr_s = got["final"]

    def err(x, y):
        """|x - y| over the largest |y|."""
        return (x - y).abs() / max(float(y.abs().max()), 1e-30)

    # tests/test_torch_pbr_train.py's bounds: after one step the materials
    # within 1e-4 of the largest value (roughness: but at KINK_SHARE of its
    # entries, where the BRDF LUT's bilinear slope jumps, and those within
    # 1e-3); the loop's losses and light within 1e-3
    e_alb = err(got["first"].albedo, first.albedo)
    e_rough = err(got["first"].roughness, first.roughness)
    n_kinks = int((e_rough > 1e-4).sum())
    e_loss = float(max(abs(a_ - b_) for a_, b_ in zip(checks[0]["pbr_losses"], losses))
                   / max(abs(x) for x in losses))
    e_light = float(err(pbr_s.light["base"], pbr.light["base"]).max())
    geometry = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
    frozen = all(torch.equal(getattr(ts_s.gauss.params, f), getattr(a["ts"].gauss.params, f))
                 for f in geometry)
    learned = not torch.equal(pbr_s.light["base"], a["pbr_state"].light["base"])
    print(f"[multichip] (d) branch B, sharded vs single-device: after one step albedo "
          f"{float(e_alb.max()):.3e}, roughness {float(e_rough.max()):.3e} of the largest "
          f"({n_kinks} of {e_rough.numel()} entries past 1e-4); over {MC_PBR_ITERS} iterations "
          f"losses {e_loss:.3e}, light {e_light:.3e} of the largest; geometry bit-equal to "
          f"the input {frozen}, light learned {learned}; single-device {pbr_ms:.2f} "
          f"ms/iteration, 2 ranks {checks[0]['pbr_ms']:.2f} ms/iteration", flush=True)
    require(float(e_alb.max()) <= 1e-4 and float(e_rough.max()) <= 1e-3
            and n_kinks <= KINK_SHARE * e_rough.numel() and max(e_loss, e_light) <= 1e-3
            and frozen and learned, "the sharded branch-B step differs from the single-device "
            "one")

    launches = mc_cli_compare()
    return launches, checks[-1]["report"]


def mc_cli_run(key, n, root=None):
    """(c)'s cli.train --multichip for MC_ITERS iterations on n ranks, in
    this checkout or the one at `root`; each rank's JSON."""
    argv = ["--synthetic", "--synthetic_size", str(CLI_SCENE["size"]), "--synthetic_verts",
            str(CLI_SCENE["verts"]), "--synthetic_views", str(CLI_SCENE["views"]),
            "--multichip", "--iterations", str(MC_ITERS), "--test_iterations", str(MC_ITERS),
            # one step per call, so that the callback sees every iteration's
            # loss (the 1-rank run's donated step would chunk by 100; the
            # sharded step has no chunk program)
            "--scan_chunk", "1",
            "--skip_galleries", "--model_path",
            str(MC_DIR.relative_to(Path(__file__).resolve().parent) / f"cli-{key}"),
            "--device", "cuda"]
    wall, res = torchrun(n, "cli", *argv, timeout=1200, root=root)
    print(f"[multichip] cli.train --multichip {key}: {n} rank(s), {wall:.1f} s wall"
          + (f" (checkout {root})" if root else ""), flush=True)
    return res


def mc_ab(other):
    """`python3 chip_smoke.py --mc-ab <checkout>`: (c)'s 2-rank cli.train
    --multichip in another checkout of the repo (the parent commit,
    unpacked with git archive into a directory .gitignore lists), then in
    this one, on the same card; rank 0's losses of iterations
    1-MC_LOSS_ITERS, its densify events (iteration, capacity, alive and
    the counters) and its test PSNR held equal bit for bit."""
    import torch

    require(torch.cuda.is_available(), "no CUDA device: this script runs on the GPU")
    print(f"[mc-ab] card: {card_line()}", flush=True)
    runs = {"other": mc_cli_run("two", MC_RANKS, root=other)[0],
            "this": mc_cli_run("two", MC_RANKS)[0]}
    a, b = runs["other"], runs["this"]
    same = {k: a[k] == b[k] for k in ("losses", "densify", "psnr")}
    ms = {k: f"{1e3 * r['elapsed_s'] / r['iterations']:.3f}" for k, r in runs.items()}
    print(f"[mc-ab] {other} vs this checkout, {MC_RANKS} ranks, {MC_ITERS} iterations: "
          f"equal bit for bit {same}; PSNR {a['psnr']!r} / {b['psnr']!r}; alive at the "
          f"densify events {[e['alive'] for e in a['densify']]} / "
          f"{[e['alive'] for e in b['densify']]}; loss at 1 and {MC_LOSS_ITERS} "
          f"{a['losses']['1']!r}, {a['losses'][str(MC_LOSS_ITERS)]!r} / "
          f"{b['losses']['1']!r}, {b['losses'][str(MC_LOSS_ITERS)]!r}; ms/iteration {ms}",
          flush=True)
    require(all(same.values()), f"the runs differ: {same}")
    print(card_line())


def mc_cli_compare():
    """(c): the 2-rank cli.train --multichip against the 1-rank run (the
    single-device step); returns the 2-rank run's launches per rank."""
    runs = {"one": mc_cli_run("one", 1), "two": mc_cli_run("two", MC_RANKS)}
    one, two = runs["one"][0], runs["two"][0]
    ev = lambda r: [(e["iteration"], e["capacity"]) for e in r["densify"]]  # noqa: E731
    loss_d = {int(k): abs(two["losses"][k] - one["losses"][k]) / abs(one["losses"][k])
              for k in one["losses"]}
    exact = max(loss_d[k] for k in range(1, MC_EXACT_ITERS + 1))
    late = max(loss_d[k] for k in range(1, MC_LOSS_ITERS + 1))
    past = [k for k in sorted(loss_d) if loss_d[k] > MC_LOSS_RTOL]
    alive = max(abs(b["alive"] - a["alive"]) / a["alive"]
                for a, b in zip(one["densify"], two["densify"]))
    psnr = abs(two["psnr"] - one["psnr"])
    print(f"[multichip] (c) {MC_ITERS} iterations: 1 rank {1e3 * one['elapsed_s'] / MC_ITERS:.3f}"
          f" ms/iteration, {MC_RANKS} ranks {1e3 * two['elapsed_s'] / MC_ITERS:.3f} ms/iteration "
          f"(ranks sharing one card over gloo: contention and host-staged collectives, not "
          f"scaling); densify events (iteration, capacity, alive) 1 rank "
          f"{[(e['iteration'], e['capacity'], e['alive']) for e in one['densify']]}, {MC_RANKS} "
          f"ranks {[e['alive'] for e in two['densify']]}; PSNR at {MC_ITERS} {one['psnr']:.4f} / "
          f"{two['psnr']:.4f} dB", flush=True)
    print(f"[multichip] (c) {MC_RANKS} ranks vs 1: loss relative difference at iteration 1 "
          f"{loss_d[1]:.3e}, at 1-{MC_EXACT_ITERS} at most {exact:.3e} (bound {MC_LOSS_RTOL}), "
          f"at 1-{MC_LOSS_ITERS} at most {late:.3e} (ceiling {MC_LOSS_CEIL}; first past "
          f"{MC_LOSS_RTOL} at iteration {past[0] if past else None}); by iteration "
          f"{[f'{loss_d[k]:.2e}' for k in range(1, MC_LOSS_ITERS + 1)]}; alive counts "
          f"{alive:.3e} apart (ceiling {MC_ALIVE_CEIL}), PSNR {psnr:.4f} dB (ceiling "
          f"{MC_PSNR_CEIL})", flush=True)
    require(ev(one) == ev(two) and len(ev(one)) > 0,
            "the densify events differ in iteration or capacity")
    require(loss_d[1] <= 1e-5, f"iteration 1's loss differs by {loss_d[1]} relative")
    require(exact <= MC_LOSS_RTOL,
            f"the losses of iterations 1-{MC_EXACT_ITERS} differ by {exact} relative")
    require(late <= MC_LOSS_CEIL and alive <= MC_ALIVE_CEIL and psnr <= MC_PSNR_CEIL,
            f"{MC_RANKS} ranks drift from 1 rank past the ceilings: loss {late}, alive "
            f"{alive}, PSNR {psnr} dB")
    for r, run in enumerate(runs["two"]):
        b, g = run["state_bytes"], run["state_gather"]
        print(f"[multichip] (c) rank {r} of {MC_RANKS}: per-Gaussian state {b['start']['rank']} "
              f"of the whole {b['start']['whole']} bytes at the start (capacity "
              f"{b['start']['capacity']}), {b['end']['rank']} of {b['end']['whole']} at "
              f"{MC_ITERS} (capacity {b['end']['capacity']}); state_gather over the run "
              f"{g['calls']} calls, {g['bytes']} bytes sent (by iteration "
              f"{run['gathers_at']}, then the returned state); per step between events 0: "
              f"{run['gathers_in_steps']} calls inside the {MC_ITERS} steps, "
              f"{run['gathers_quiet']} in the {run['quiet_iterations']} iterations without a "
              f"densify event, eval or save", flush=True)
    for r, run in enumerate(runs["two"]):
        ln = run["launches"]
        print(f"[multichip] rank {r} launches in the {MC_RANKS}-rank cli.train: {ln}",
              flush=True)
        for name in ("knn", "deform", "deform_bwd", "blend_fwd", "blend_fwd_ckpt", "blend_bwd",
                     "blend_bwd_sums", "blend_bwd_rows"):
            require(ln[name] > 0, f"rank {r}: kernel {name} was not launched")
        require(ln["blend_bwd_ckpt"] == 0 and ln["blend_fwd_ckpt"] == ln["blend_bwd"]
                and ln["deform_bwd"] == MC_ITERS,
                f"rank {r}: D1 launched, or a forward without its backward: {ln}")
    return {f"multichip_r{r}": run["launches"] for r, run in enumerate(runs["two"])}


GRAPH_REQUESTS = [(0, 0.0), (1, 1e-3), (0, 2e-12), (3, -1e-3), (2, 5e-4)]   # (view, epsilon)
GRAPH_FIELDS = ("render", "render_depth", "render_alpha", "normal", "world_normal", "albedo",
                "roughness", "transforms", "translation")


def clone_result(r):
    import torch

    return type(r)(*(x.clone() if isinstance(x, torch.Tensor) else x for x in r))


def graph_phase(state, scene, model, cfg, bg, deformed, card):
    """Phase 3's graphed serving frame (render/graph.py::GraphedRenderer),
    this slice's main path: interleaved requests on both branches held bit
    for bit to eager frames, each branch's capture under sync-debug "error",
    the launches a replay adds, the eager and graphed sweeps side by side
    (ms/frame by CUDA events and the host clock, device busy share), and
    bench_torch.py's run. Returns the main path's launches."""
    import contextlib
    import io

    import torch
    from torch.profiler import ProfilerActivity, profile

    import bench_torch
    from mygauhuman_torch.ops import cuda_lib
    from mygauhuman_torch.render import render_frame
    from mygauhuman_torch.render.graph import GraphedRenderer

    dev = bg.device
    V = len(scene.batches)
    kw = dict(bg=bg, active_sh_degree=3, config=cfg)
    rows = [dict(transforms=d.transforms, translation=d.translation) for d in deformed]

    def eager(v, eps, branch):
        st = state._replace(params=state.params._replace(opacity=state.params.opacity + eps))
        b = scene.batches[v]
        return render_frame(st, b.camera, b.frame, model, **kw,
                            **(rows[v] if branch == "replay" else {}))

    renderer = GraphedRenderer(state, model, **kw)

    def graphed(v, eps, branch):
        b = scene.batches[v]
        return renderer(b.camera, b.frame, opacity_eps=eps,
                        **(rows[v] if branch == "replay" else {}))

    branches = ("deform", "replay")
    with torch.no_grad():
        wants = {(br, n): clone_result(eager(v, eps, br))
                 for br in branches for n, (v, eps) in enumerate(GRAPH_REQUESTS)}
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    bad = []
    with torch.no_grad():
        for br in branches:
            for n, (v, eps) in enumerate(GRAPH_REQUESTS):
                if n == 0:   # warm-up, capture and first replay: no host sync allowed
                    torch.cuda.synchronize()
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        got = graphed(v, eps, br)
                    except RuntimeError as e:
                        require(False, f"the {br} capture synchronised with the host: {e}")
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                else:
                    got = graphed(v, eps, br)
                want = wants[(br, n)]
                bad += [f"{br} request {n} (view {v}, eps {eps}) {f}" for f in GRAPH_FIELDS
                        if not torch.equal(getattr(got, f), getattr(want, f))]
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    per_frame = {k.branch: v for k, v in renderer.launches.items()}
    # each capture's warm-up frame runs eagerly, each request replays
    want_launches = {}
    for br in branches:
        for name, c in per_frame.get(br, {}).items():
            want_launches[name] = want_launches.get(name, 0) + c * (len(GRAPH_REQUESTS) + 1)
    print(f"[graph] {len(GRAPH_REQUESTS)} interleaved requests per branch (views, epsilons "
          f"{GRAPH_REQUESTS}) on {V} views: graphed bit-equal to eager in {GRAPH_FIELDS}: "
          f"{not bad}; {renderer.captures} graphs captured, each under sync-debug \"error\" "
          f"without a host sync; graphed launches per frame {per_frame}; the path's launches "
          f"{launches}", flush=True)
    require(not bad, f"graphed frames differ from eager ones: {bad}")
    require(renderer.captures == 2, f"{renderer.captures} captures, expected one per branch")
    for name in ("knn", "deform", "blend_fwd"):
        require(launches[name] > 0, f"kernel {name} was not launched on the graphed path")
    require(launches["blend_fwd_ckpt"] == 0 and launches["deform_bwd"] == 0,
            "the graphed serving path wrote checkpoints or ran kernel B's backward")
    require({k: v for k, v in launches.items() if v} == want_launches,
            f"launch counts {launches} are not the captures' counts {want_launches} per "
            f"replay plus one eager warm-up per capture")

    # eager and graphed frames side by side: FPS_FRAMES back to back (CUDA
    # events and host clock), then PROFILE_FRAMES under torch.profiler for
    # the device busy share
    def sweep(fn, br, n):
        acc = torch.zeros((), device=dev)
        for i in range(n):
            acc = acc + fn(i % V, 1e-12 * i, br).render[0, 0, 0]
        return acc

    for br in branches:
        res = {}
        for mode, fn in (("eager", eager), ("graphed", graphed)):
            with torch.no_grad():
                sweep(fn, br, 4)
                torch.cuda.synchronize()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                t0 = time.perf_counter()
                ev[0].record()
                sweep(fn, br, FPS_FRAMES)
                ev[1].record()
                torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t0) * 1e3 / FPS_FRAMES
                ev_ms = ev[0].elapsed_time(ev[1]) / FPS_FRAMES
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    sweep(fn, br, PROFILE_FRAMES)
                    torch.cuda.synchronize()
                    wall_us = (time.perf_counter() - t0) * 1e6 / PROFILE_FRAMES
            kernels_ = [e for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA]
            busy_us = sum(device_us(e) for e in kernels_) / PROFILE_FRAMES
            res[mode] = dict(ev_ms=ev_ms, host_ms=host_ms, wall_us=wall_us, busy_us=busy_us,
                             n=sum(e.count for e in kernels_) / PROFILE_FRAMES, top=kernels_)

        def busy(r):
            # the profiler slows the host (its wall is not the frame's), so
            # the share is also given against the unprofiled sweep's frame
            if r["busy_us"] <= 0:
                return "device busy not measured (no CUDA events)"
            return (f"device busy {r['busy_us']:.0f} us/frame, "
                    f"{100 * r['busy_us'] / (1e3 * r['ev_ms']):.1f}% of the unprofiled frame, "
                    f"{100 * r['busy_us'] / r['wall_us']:.1f}% of the {r['wall_us']:.0f} us "
                    f"under the profiler, {r['n']:.0f} device kernels/frame")

        e, g = res["eager"], res["graphed"]
        print(f"[bench] {br} branch over {FPS_FRAMES} frames, eager | graphed: CUDA events "
              f"{e['ev_ms']:.4f} | {g['ev_ms']:.4f} ms/frame ({1e3 / e['ev_ms']:.1f} | "
              f"{1e3 / g['ev_ms']:.1f} frames/s), host clock {e['host_ms']:.4f} | "
              f"{g['host_ms']:.4f} ms/frame; eager {busy(e)}; graphed {busy(g)} ({card})",
              flush=True)
        for e_ in sorted(e["top"], key=device_us, reverse=True)[:8]:
            print(f"[profile]   eager {br} {device_us(e_) / PROFILE_FRAMES:8.1f} us/frame "
                  f"{e_.count / PROFILE_FRAMES:5.1f}x  {e_.key[:90]}")

    # bench_torch.py at its own point (bench.py's): its lines, its JSON line
    # tagged so that it is not mistaken for this script's own
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench = bench_torch.main([])
    for line in out.getvalue().splitlines():
        print(line if line.startswith("[") else f"[bench_torch] last line: {line}", flush=True)
    print(f"[bench_torch] took {time.perf_counter() - t0:.1f} s; graphed launches per frame "
          f"{ {k.branch: v for k, v in bench['launches'].items()} }", flush=True)
    require(bench["fps"] > 0 and bench["deform_fps"] > 0, "bench_torch measured nothing")
    return launches


def main() -> None:
    import torch

    require(torch.cuda.is_available(), "no CUDA device: this script runs on the GPU")
    t_script = time.perf_counter()
    import mygauhuman_torch.models.lbs as lbs_mod
    import mygauhuman_torch.ops.pallas_blend as pb
    import mygauhuman_torch.ops.pallas_blend_bwd as pbb
    from mygauhuman_torch.data.synthetic import _masks, look_at_camera, make_synthetic_scene
    from mygauhuman_torch.models import gaussians as G
    from mygauhuman_torch.models.io import load_ply, save_ply
    import mygauhuman_torch.ops.pallas_deform as pd
    from mygauhuman_torch.ops import cuda_lib
    from mygauhuman_torch.ops.rasterize import RasterizerConfig
    from mygauhuman_torch.render import render_frame
    from mygauhuman_torch.utils.transforms import inverse_sigmoid

    dev = torch.device("cuda")
    card = card_line()
    print(f"[setup] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"devices {torch.cuda.device_count()}", flush=True)

    # ---- phase 1: setup -------------------------------------------------
    require(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul is on")
    require(torch.get_float32_matmul_precision() == "highest", "fp32 matmul precision lowered")
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    secs = cuda_lib.build()
    print(f"[setup] kernels built in {time.perf_counter() - t0:.2f} s wall "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in secs.items())})", flush=True)
    for name, log in cuda_lib.BUILD_LOGS.items():
        entry = ""
        for line in log.splitlines():
            m = re.search(r"(?:entry )?function '([^']+)'", line)
            if m:
                entry = m.group(1)
            if "registers" in line or "spill" in line:
                print(f"[setup] ptxas {name} {entry}: {line.strip()}")

    cfg = RasterizerConfig(tile_capacity=1024, chunk_tiles=64,
                           instance_capacity=4 * BENCH["capacity"])
    t0 = time.perf_counter()
    scene = make_synthetic_scene(n_views=BENCH["views"], width=BENCH["width"],
                                 height=BENCH["height"], n_verts=BENCH["n_verts"],
                                 capacity=BENCH["capacity"], seed=BENCH["seed"],
                                 raster_config=cfg, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        save_ply(scene.gt_state, f"{tmp}/scene.ply")
        state = G.compact_state(load_ply(f"{tmp}/scene.ply", device=dev))
    want_cap = -(-BENCH["n_verts"] // 256) * 256          # 6,912
    require(state.capacity == want_cap, f"compacted capacity {state.capacity} != {want_cap}")
    model = scene.smpl_model
    bg = torch.zeros(3, device=dev)
    print(f"[setup] bench scene: {int(state.alive.sum())} Gaussians, capacity "
          f"{state.capacity}, {BENCH['width']}x{BENCH['height']}, instance capacity "
          f"{cfg.instance_capacity}, built in {time.perf_counter() - t0:.2f} s", flush=True)

    # ---- phase 2: each kernel vs its plain version on the card -----------
    seen: dict = {}
    b0 = scene.batches[0]
    with torch.no_grad(), capture(lbs_mod, "knn", seen), \
            capture(lbs_mod, "deform_rows", seen), capture(pb, "blend_rows_raw", seen):
        render_frame(state, b0.camera, b0.frame, model, bg=bg, active_sh_degree=3,
                     config=cfg)
    narrow_cam = look_at_camera(b0.camera.cam_center.cpu().numpy(),
                                scene.big_pose_verts.mean(0).cpu().numpy(), 208, 144,
                                device=dev)
    with torch.no_grad(), capture(pb, "blend_tiles_raw", seen):
        render_frame(state, narrow_cam, b0.frame, model, bg=bg, active_sh_degree=3,
                     config=cfg)
    report = {}

    # kernel A
    (q_main, r_main), kw = seen["knn"]
    require(kw.get("k") == 1 and q_main.shape[0] == state.capacity, "unexpected KNN call")
    # the training loop's queries after densify (capacity 16,384): the SMPL
    # vertices resampled with seeded jitter
    gen = torch.Generator(device=dev).manual_seed(0)
    pick = torch.randint(0, r_main.shape[0], (16384,), generator=gen, device=dev)
    q_loop = r_main[pick] + 0.01 * torch.randn((16384, 3), generator=gen, device=dev)
    knn_cases = [("main path", q_main, r_main, 1, False),
                 ("capacity x verts", scene.gt_state.params.xyz, r_main, 1, False),
                 ("init self, k=3", r_main, r_main, 3, True),
                 ("loop after densify", q_loop, r_main, 1, False)]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, q, r, k, excl in knn_cases:
        check_kernel_a(label, q, r, k, excl, n_sm, report if label == "main path" else None)

    # kernel B
    args_main, _ = seen["deform_rows"]
    n_main = args_main[0].shape[1]
    require(n_main == state.capacity, "unexpected deform call")
    odd = [a[:, :BENCH["n_verts"]] if a.shape[0] != 1 else a for a in args_main]
    for label, args in (("main path", args_main), ("odd N", odd)):
        check_kernel_b(label, args, n_sm, report if label == "main path" else None)

    # kernel C: planar at 512^2 (the main path), tile-major at 208x144
    for label, key, planar in ((f"serving {BENCH['width']}x{BENCH['height']} planar",
                                "blend_rows_raw", True),
                               ("serving 208x144 tile-major", "blend_tiles_raw", False)):
        (data, starts, counts, tile_base), kw = seen[key]
        check_kernel_c(label, data, starts, counts, tile_base, dict(kw, planar=planar), pb,
                       pbb, report=report if planar else None)

    # ---- phase 3: the serving render at the bench point -------------------
    cuda_lib.reset_launches()
    with torch.no_grad():
        deformed = [render_frame(state, b.camera, b.frame, model, bg=bg, active_sh_degree=3,
                                 config=cfg) for b in scene.batches]
        replayed = [render_frame(state, b.camera, b.frame, model, bg=bg, active_sh_degree=3,
                                 config=cfg, transforms=d.transforms,
                                 translation=d.translation)
                    for b, d in zip(scene.batches, deformed)]
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    print(f"[bench] launches on the main path (4 deform + 4 replay frames): {launches}")
    for name in ("knn", "deform", "blend_fwd"):
        require(launches[name] > 0, f"kernel {name} was not launched on the main path")
    require(launches["blend_fwd_ckpt"] == 0, "the no-grad serving forward wrote checkpoints")
    require(launches["deform_bwd"] == 0, "the no-grad serving path ran kernel B's backward")
    serving_launches = launches
    for v, (d, r) in enumerate(zip(deformed, replayed)):
        for out in (d, r):
            for f in ("render", "render_depth", "render_alpha", "normal", "albedo"):
                require(bool(torch.isfinite(getattr(out, f)).all()), f"view {v}: {f} not finite")
        cover = float((d.render_alpha > 0.01).float().mean())
        diff = float((r.render - d.render).abs().max())
        print(f"[bench] view {v}: alpha coverage {cover:.4f}, replay vs deform max abs "
              f"{diff:.3e}, overflow tiles/gauss/inst {int(d.overflow_tiles)}/"
              f"{int(d.overflow_gauss)}/{int(d.overflow_inst)}")
        require(cover > 0.01, f"view {v}: alpha coverage {cover}")
        require(diff <= RENDER_ATOL, f"view {v}: replay differs from deform by {diff}")

    # the same frame through the plain path on the CPU
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = render_frame(to_dev(state, cpu), to_dev(b0.camera, cpu), to_dev(b0.frame, cpu),
                           to_dev(model, cpu), bg=bg.cpu(), active_sh_degree=3, config=cfg)
    ref_err = float((deformed[0].render.cpu() - ref.render).abs().max())
    ref_err_alpha = float((deformed[0].render_alpha.cpu() - ref.render_alpha).abs().max())
    print(f"[bench] view 0 GPU vs CPU plain render: max abs rgb {ref_err:.3e}, alpha "
          f"{ref_err_alpha:.3e} (CPU took {time.perf_counter() - t0:.1f} s)", flush=True)
    require(max(ref_err, ref_err_alpha) <= RENDER_ATOL, "GPU render disagrees with the CPU one")

    # the graphed serving frame (render/graph.py), this slice's main path:
    # bit-equal to the eager frames, timed and profiled beside them
    graph_launches = graph_phase(state, scene, model, cfg, bg, deformed, card)

    # ---- phase 4: the served size ----------------------------------------
    rng = np.random.default_rng(0)
    verts = scene.big_pose_verts.cpu().numpy()
    pts = (verts[rng.integers(0, len(verts), SERVED_GAUSSIANS)]
           + rng.normal(0.0, 0.01, (SERVED_GAUSSIANS, 3))).astype(np.float32)
    cols = rng.random((SERVED_GAUSSIANS, 3)).astype(np.float32)
    nrm = rng.normal(size=(SERVED_GAUSSIANS, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    t0 = time.perf_counter()
    big = G.create_from_pcd(pts, cols, nrm, device=dev)
    big = big._replace(params=big.params._replace(opacity=torch.full_like(
        big.params.opacity, inverse_sigmoid(0.9))))
    big = G.compact_state(big)
    want_cap = -(-SERVED_GAUSSIANS // 256) * 256          # 45,056
    require(big.capacity == want_cap, f"served capacity {big.capacity} != {want_cap}")
    cfg_big = cfg._replace(instance_capacity=4 * big.capacity)
    print(f"[served] {SERVED_GAUSSIANS} Gaussians, capacity {big.capacity}, instance "
          f"capacity {cfg_big.instance_capacity}, built in {time.perf_counter() - t0:.2f} s")
    cuda_lib.reset_launches()
    with torch.no_grad():
        outs = [render_frame(big, b.camera, b.frame, model, bg=bg, active_sh_degree=3,
                             config=cfg_big) for b in scene.batches]
    torch.cuda.synchronize()
    served_launches = dict(cuda_lib.LAUNCHES)
    for name in ("knn", "deform", "blend_fwd"):
        require(served_launches[name] > 0, f"served size: kernel {name} not launched")
    require(served_launches["blend_fwd_ckpt"] == 0 and served_launches["deform_bwd"] == 0,
            "served size: checkpoints written or kernel B's backward run")
    for v, out in enumerate(outs):
        cover = float((out.render_alpha > 0.01).float().mean())
        require(bool(torch.isfinite(out.render).all()) and cover > 0.01,
                f"served view {v}: coverage {cover}")
        print(f"[served] view {v}: alpha coverage {cover:.4f}, overflow tiles/gauss/inst "
              f"{int(out.overflow_tiles)}/{int(out.overflow_gauss)}/{int(out.overflow_inst)}")
    with torch.no_grad():
        for i in range(2):
            b = scene.batches[i % 4]
            render_frame(big, b.camera, b.frame, model, bg=bg, active_sh_degree=3,
                         config=cfg_big)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(FPS_FRAMES):
            b = scene.batches[i % 4]
            st = big._replace(params=big.params._replace(
                opacity=big.params.opacity + 1e-12 * i))
            render_frame(st, b.camera, b.frame, model, bg=bg, active_sh_degree=3,
                         config=cfg_big)
        end.record()
        torch.cuda.synchronize()
    ms = start.elapsed_time(end) / FPS_FRAMES
    print(f"[served] deform branch: {ms:.3f} ms/frame, {1e3 / ms:.1f} frames/s over "
          f"{FPS_FRAMES} frames; launches in the 4-view check {served_launches}")

    # ---- phase 5: branch-A training ---------------------------------------
    # kernels C and D vs their plain versions on the inputs of a training
    # step's forward (checkpoint mode) and backward, at the bench point
    # (forward planar) and at 208x144 (forward tile-major); after the serving
    # phases, so that they are timed as before any training
    train = make_trainer(scene, cfg, dev)
    narrow = narrow_batch(scene, narrow_cam, b0, cfg, _masks)
    for label, batch in ((f"{BENCH['width']}x{BENCH['height']}", b0), ("208x144", narrow)):
        tseen: dict = {}
        with capture(pb, "blend_rows_raw", tseen), capture(pb, "blend_tiles_raw", tseen), \
                capture(pbb, "blend_tiles_bwd_from_ckpt_raw", tseen), \
                capture(pd, "deform_rows_bwd_cuda", tseen):
            train["step"].loss_and_grads(train["ts"], batch, 0)
        planar = "blend_rows_raw" in tseen
        (data, starts, counts, tile_base), kw = tseen["blend_rows_raw" if planar
                                                      else "blend_tiles_raw"]
        require(kw.get("checkpoints") is True, f"training {label}: no checkpoint mode")
        ck_dms, ck_bound = check_kernel_c(
            f"training {label} {'planar' if planar else 'tile-major'}", data, starts, counts,
            tile_base, dict(kw, planar=planar), pb, pbb)
        if batch is b0:   # what the loop runs: kernel C in checkpoint mode at this capture
            report["blend_fwd"].update(loop_device_ms=ck_dms, loop_bound_ms=ck_bound)
        check_kernel_d(label, tseen["blend_tiles_bwd_from_ckpt_raw"], kw["n_channels"],
                       report, pb, pbb, main=batch is b0)
        if batch is b0:
            check_kernel_b_bwd(tseen["deform_rows_bwd_cuda"], report)
    train_gpu_vs_cpu(dev)
    loop_launches = train_bench(scene, cfg, train, dev)
    t0 = time.perf_counter()
    train_graph_launches = train_graph_phase(scene, cfg, train, dev, card)
    print(f"[train-graph] took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 6: the entry points -------------------------------------------
    t0 = time.perf_counter()
    cli_launches, cli_report = cli_phase(dev, n_sm)
    print(f"[cli] phase took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 7: branch B and relighting through the entry points ---------
    t0 = time.perf_counter()
    pbr_launches, pbr_report, pbr_final = pbr_phase(dev, n_sm)
    print(f"[pbr] phase took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 8: the SMPL-X body on a DNA-Rendering capture -----------------
    t0 = time.perf_counter()
    dna_launches, dna_report = dna_phase(dev, n_sm, card)
    print(f"[dna] phase took {time.perf_counter() - t0:.1f} s ({card})", flush=True)

    # ---- phase 9: the tile-sharded multi-device path ------------------------
    t0 = time.perf_counter()
    mc_launches, mc_report = multichip_phase(dev, n_sm, card, pbr_final)
    print(f"[multichip] phase took {time.perf_counter() - t0:.1f} s ({card})", flush=True)

    # ---- phase 10: results -------------------------------------------------
    # time lost on the main paths, launches x (device ms - bound): the 4 + 4
    # serving frames of phase 3, the 60-iteration loop (kernels B and C: the
    # loop at the training step's capture), cli.train's 1,200 iterations
    # (each kernel at the inputs of the step at chkpnt600, kernel C in its
    # checkpoint mode), its 300 branch-B iterations (each kernel at the
    # inputs of a branch-B step at chkpnt1200, kernel C tile-major at a bake
    # face) and the SMPL-X run's 500 iterations (each kernel at the inputs of
    # its step at chkpnt500, kernel C tile-major in checkpoint mode)
    # `blend_fwd` counts every kernel C launch and `blend_fwd_tiles` the
    # tile-major ones; from here `blend_fwd` is the planar launches (the TPU
    # row kernel's), so each row counts its own layout
    for counts in (serving_launches, graph_launches, loop_launches, train_graph_launches,
                   *cli_launches.values(),
                   *pbr_launches.values(), *dna_launches.values(), *mc_launches.values()):
        counts["blend_fwd"] -= counts["blend_fwd_tiles"]
    cli_train_launches = cli_launches.pop("cli_train")
    pbr_train_launches = pbr_launches.pop("cli_train_pbr")
    dna_train_launches = dna_launches["smplx_dna"]

    def lost_ms(entry, n):
        return "n/a" if entry is None or entry["device_ms"] is None else \
            f"{n * (entry['device_ms'] - entry['bound_ms']):.4f}"

    mc_train_launches = mc_launches["multichip_r0"]
    lost = []
    for name in sorted(set(report) | set(pbr_report) | set(dna_report) | set(mc_report)):
        e = report.get(name)
        loop_e = e and dict(e, device_ms=e.get("loop_device_ms", e["device_ms"]),
                            bound_ms=e.get("loop_bound_ms", e["bound_ms"]))
        lost.append(f"{name} {lost_ms(e, serving_launches[name])} / "
                    f"{lost_ms(loop_e, loop_launches[name])} / "
                    f"{lost_ms(cli_report.get(name), cli_train_launches[name])} / "
                    f"{lost_ms(pbr_report.get(name), pbr_train_launches[name])} / "
                    f"{lost_ms(dna_report.get(name), dna_train_launches[name])} / "
                    f"{lost_ms(mc_report.get(name), mc_train_launches[name])} (launches "
                    f"{serving_launches[name]} / {loop_launches[name]} / "
                    f"{cli_train_launches[name]} / {pbr_train_launches[name]} / "
                    f"{dna_train_launches[name]} / {mc_train_launches[name]})")
    print("[lost] ms lost on the main paths from device time, serving / loop / cli.train / "
          "branch B / SMPL-X / multichip rank 0: " + "; ".join(lost), flush=True)
    # this slice's main path is branch B through cli.train, graphed (phase
    # 7): kernels A, B, C (planar in checkpoint mode, and tile-major at the
    # bake groups) and D (D1s + D2) take `launches` from its 300 iterations
    # and 4 bakes, and every number from phase 7's checks on the inputs of a
    # branch-B step at chkpnt1200 (C tile-major: a bake group's launch of the
    # first camera). Kernel B's backward, which branch B never launches, and D1
    # keep an earlier slice's main path, cli.train --multichip's 600
    # iterations on 2 ranks: rank 0's counts, each number measured on rank
    # 1's inputs of the sharded step. `launches_path` names the path of
    # `launches`, `measured_on` that of the numbers; every path's counts are
    # in `launches_by_path` (phase 3's graphed serving frame as
    # `serving_graph`, phase 5's graphed loop as `loop_graph`, phase 6's
    # `cli_train`, phase 7's graphed loop check as `pbr_graph`, phase 8's
    # `smplx_dna`)
    paths = {"serving": serving_launches, "serving_graph": graph_launches,
             "loop": loop_launches, "loop_graph": train_graph_launches,
             "cli_train": cli_train_launches, **cli_launches,
             "cli_train_pbr": pbr_train_launches, **pbr_launches, **dna_launches,
             **mc_launches}
    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms",
            "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    main_path = ("knn", "deform", "blend_fwd", "blend_fwd_tiles", "blend_bwd", "blend_bwd_sums",
                 "blend_bwd_rows")
    kernels = []
    for n in ("knn", "deform", "deform_bwd", "blend_fwd", "blend_fwd_tiles", "blend_bwd",
              "blend_bwd_ckpt", "blend_bwd_sums", "blend_bwd_rows"):
        on_main = n in main_path
        path = "cli_train_pbr" if on_main else "multichip_r0"
        kernels.append(dict(
            {k: (pbr_report if on_main else mc_report)[n][k] for k in keys},
            launches=paths[path][n], launches_path=path,
            measured_on=(f"a branch-B step at chkpnt{CLI_ITERS} (phase 7)" if on_main
                         else "rank 1's sharded step (phase 9)"),
            launches_by_path={p: c[n] for p, c in paths.items()}))
    for k in kernels:
        require(k["launches"] > 0 or k["name"] not in main_path,
                f"kernel {k['name']}: no launch on {k['launches_path']}")
    print(f"[total] the script took {time.perf_counter() - t_script:.1f} s ({card})",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card_line())   # name, power limit: nvidia-smi's own line
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    import sys

    if "--mc-worker" in sys.argv:
        mc_worker(sys.argv[sys.argv.index("--mc-worker") + 1:])
    elif "--mc-ab" in sys.argv:
        mc_ab(sys.argv[sys.argv.index("--mc-ab") + 1])
    else:
        main()
