#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mygauhuman_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
  1. setup: the card's name and power limit, the kernels' build (one nvcc per
     source, in parallel) and its time, TF32 off;
  2. kernels A, B, C against their plain PyTorch versions on the card, on
     the inputs the serving render gives them, captured from real calls, with
     kernel, plain and library times and each kernel's bound;
  3. the serving render at the bench point (512^2, 6,890 SMPL vertices,
     capacity 8,192 -> PLY -> load -> compact 6,912, instance capacity
     32,768): 4 views through the deform branch, then through the replay
     branch with the returned transforms; checks, launch counts, frames/s,
     a torch.profiler breakdown (device busy share, top kernels); plus the
     GPU render against the CPU (plain) render of the same inputs;
  4. the served size: 45,000 Gaussians (compacted capacity 45,056), 4 views
     through the deform branch, frames/s;
  5. branch-A training: kernel D against its plain version on the inputs a
     training step's backward gives it (bench point and 208x144), as in
     phase 2; one step on the card against the same step on the
     CPU (128^2, capacity 1,024, LPIPS on); the same step twice at the bench
     point, bit-equal; ms/step over 100 steps at the bench point (capacity
     8,192, LPIPS on); a profile of 8 steps; a 60-iteration train_loop with
     densify events at 20 and 40 and an opacity reset at 50; the trained
     views' PSNR / SSIM / LPIPS;
  6. a `kernels` JSON line, the card line, and as the last line
     {"ok": true, "device": {...}}.
It needs one card and imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import tempfile
import time

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
GRAD_RTOL = 1e-3           # GPU vs CPU step: each gradient leaf within GRAD_RTOL max|CPU|
KERNEL_D_RTOL = 1e-4       # kernel D vs plain: each component within 1e-4 max|plain| + 1e-6


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
    """A fresh training state on `scene` (init state, seeded MLPs) and its
    train step with the default OptimizationConfig, LPIPS on, cropped to
    the scene's bound masks."""
    import torch

    from mygauhuman_torch.config import OptimizationConfig
    from mygauhuman_torch.eval.lpips import LPIPS
    from mygauhuman_torch.models.mlps import init_lbs_offset, init_pose_refiner
    from mygauhuman_torch.train import trainer as TT

    gen = torch.Generator().manual_seed(0)
    opt = OptimizationConfig()
    ts, tx = TT.create_train_state(opt, scene.init_state, init_pose_refiner(gen, device=dev),
                                   init_lbs_offset(gen, device=dev))
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


def check_kernel_d(label, call, C, report, pb, pbb, main):
    """Kernel D against its plain version on one captured backward call of a
    blend with C feature channels."""
    import torch

    (data, starts, counts, tile_base, cot), kw = call
    got = pbb.blend_tiles_bwd_cuda(data, starts, counts, tile_base, cot, **kw)
    want = pbb.blend_tiles_bwd_plain(data, starts, counts, tile_base, cot, **kw)
    torch.cuda.synchronize()
    err_rows = (got - want).abs().max(dim=0).values            # per component
    tol = KERNEL_D_RTOL * want.abs().max(dim=0).values + 1e-6
    worst = float((err_rows / tol).max())
    err = float(err_rows.max())
    require(bool(torch.isfinite(got).all()) and worst <= 1.0,
            f"blend_bwd {label}: component errors {err_rows.tolist()} over {tol.tolist()}")
    ms = cuda_ms(lambda: pbb.blend_tiles_bwd_cuda(data, starts, counts, tile_base, cot, **kw))
    plain_ms = cuda_ms(lambda: pbb.blend_tiles_bwd_plain(data, starts, counts, tile_base, cot,
                                                         **kw), reps=2, warmup=1)
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
    print(f"[kernel D blend_bwd] {label}: tiles {n_tiles} ({n_busy} with instances), "
          f"instances {int(counts.sum())} (longest tile {int(counts.max())}), C={C} (Cf={cf}), "
          f"max abs err {err:.3e} (worst component at {worst:.3f} of its tolerance), "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; work: {n_eval} pairs evaluated, "
          f"{n_incl} included, {n_read} instances read, {ops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB, bound {b_ms:.5f} ms ({b_by})", flush=True)
    if main:
        report["blend_bwd"] = dict(
            name="blend_bwd", route="cuda", source="mygauhuman_torch/csrc/blend_bwd.cu",
            replaces="mygauhuman_tpu/ops/pallas_blend_bwd.py:51", max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)


def train_gpu_vs_cpu(dev):
    """One train step's loss, metrics and every gradient leaf on the card
    against the same step on the CPU (plain path), same inputs."""
    import torch

    from mygauhuman_torch.data.synthetic import make_synthetic_scene
    from mygauhuman_torch.eval.lpips import LPIPS
    from mygauhuman_torch.ops.rasterize import RasterizerConfig
    from mygauhuman_torch.train import trainer as TT
    from mygauhuman_torch.train.optim import tree_leaves

    cpu = torch.device("cpu")
    cfg = RasterizerConfig(tile_capacity=1024, instance_capacity=4 * 1024)
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
    print(f"[train] GPU vs CPU step at 128^2 (capacity 1,024, LPIPS on): loss "
          f"{float(m_g['loss']):.6f} vs {float(m_c['loss']):.6f}; {len(leaves_g)} gradient "
          f"leaves, worst max abs err {worst:.3e} of the leaf's max (tolerance {GRAD_RTOL}); "
          f"CPU step {cpu_s:.1f} s", flush=True)


def train_bench(scene, cfg, train, dev, report):
    """Determinism, ms/step, a profile and the 60-iteration loop at the bench point."""
    import torch

    from mygauhuman_torch.config import OptimizationConfig
    from mygauhuman_torch.eval.metrics import evaluate_images
    from mygauhuman_torch.ops import cuda_lib
    from mygauhuman_torch.render import render_frame
    from mygauhuman_torch.train import trainer as TT
    from mygauhuman_torch.train.optim import tree_leaves

    step, ts0, batches = train["step"], train["ts"], scene.batches

    # the same step twice from the same state: bit-equal
    a = step.loss_and_grads(ts0, batches[0], 0)
    b = step.loss_and_grads(ts0, batches[0], 0)
    same_grads = all(torch.equal(x, y) for x, y in zip(tree_leaves(a[2]) + [a[3]],
                                                         tree_leaves(b[2]) + [b[3]]))
    s1, _ = step(ts0, batches[0], 0)
    s2, _ = step(ts0, batches[0], 0)
    same_params = all(torch.equal(x, y) for x, y in zip(tree_leaves(TT.trainable_params(s1)),
                                                         tree_leaves(TT.trainable_params(s2))))
    same_stats = torch.equal(s1.gauss.xyz_grad_accum, s2.gauss.xyz_grad_accum)
    print(f"[train] the bench step twice: gradients bit-equal {same_grads}, new params "
          f"bit-equal {same_params}, densify stats bit-equal {same_stats}", flush=True)
    require(same_grads and same_params and same_stats, "the same step twice differs")

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

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILE_FRAMES):
            ts, m = step(ts, batches[i % 4], 0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / PROFILE_FRAMES
    kernels_ = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(device_us(e) for e in kernels_) / PROFILE_FRAMES
    if busy_us <= 0:
        print("[profile] train step: device time not measured (no CUDA events)")
    else:
        launches_ = sum(e.count for e in kernels_) / PROFILE_FRAMES
        bwd_us = sum(device_us(e, total=True) for e in prof.events()
                     if e.name.startswith("autograd::engine::evaluate_function")) / PROFILE_FRAMES
        print(f"[profile] train step under the profiler: {wall_us:.0f} us/step wall, "
              f"{busy_us:.0f} us/step device busy ({100 * busy_us / wall_us:.1f}%), "
              f"{launches_:.0f} kernel launches/step; backward (autograd engine) "
              f"{bwd_us:.0f} us/step of device time, the rest {busy_us - bwd_us:.0f} us")
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
    for name in ("knn", "deform", "blend_fwd", "blend_bwd"):
        require(launches[name] > 0, f"kernel {name} was not launched in the train loop")
    report["blend_bwd"]["launches"] = launches["blend_bwd"]
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


def main() -> None:
    import torch

    require(torch.cuda.is_available(), "no CUDA device: this script runs on the GPU")
    import mygauhuman_torch.models.lbs as lbs_mod
    import mygauhuman_torch.ops.pallas_blend as pb
    import mygauhuman_torch.ops.pallas_blend_bwd as pbb
    from mygauhuman_torch.data.synthetic import _masks, look_at_camera, make_synthetic_scene
    from mygauhuman_torch.models import gaussians as G
    from mygauhuman_torch.models.io import load_ply, save_ply
    from mygauhuman_torch.ops import cuda_lib
    from mygauhuman_torch.ops.pallas_deform import deform_rows_cuda, deform_rows_plain
    from mygauhuman_torch.ops.pallas_knn import knn_small_refs_cuda, knn_small_refs_plain
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[setup] ptxas {name}: {line.strip()}")

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
    knn_cases = [("main path", q_main, r_main, 1, False),
                 ("capacity x verts", scene.gt_state.params.xyz, r_main, 1, False),
                 ("init self, k=3", r_main, r_main, 3, True)]
    for label, q, r, k, excl in knn_cases:
        d_k, i_k = knn_small_refs_cuda(q, r, k, exclude_self=excl)
        d_p, i_p = knn_small_refs_plain(q, r, k, exclude_self=excl)
        torch.cuda.synchronize()
        diff = i_k != i_p
        # equal indices, except at near-ties, where the distances agree
        near_tie = (d_k - d_p).abs() <= 1e-6 * d_p.abs().clamp(min=1e-30)
        require(bool((~diff | near_tie).all()), f"KNN {label}: indices differ off ties")
        err = float((d_k - d_p).abs().max())
        ms = cuda_ms(lambda: knn_small_refs_cuda(q, r, k, exclude_self=excl))
        plain_ms = cuda_ms(lambda: knn_small_refs_plain(q, r, k, exclude_self=excl), reps=5)
        lib_ms = cuda_ms(lambda: torch.cdist(q, r).topk(k, dim=1, largest=False), reps=5)
        print(f"[kernel A knn] {label}: Q={q.shape[0]} R={r.shape[0]} k={k} "
              f"index mismatches {int(diff.sum())}, max abs d2 err {err:.3e}, "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cdist+topk {lib_ms:.4f} ms",
              flush=True)
        if label == "main path":
            Q, R = q.shape[0], r.shape[0]   # ~11 fp32 ops per pair (csrc/knn.cu)
            b_ms, b_by = bound(11.0 * Q * R, 12 * (Q + R) + 8 * Q * k)
            report["knn"] = dict(name="knn", route="cuda", source="mygauhuman_torch/csrc/knn.cu",
                                 replaces="mygauhuman_tpu/ops/pallas_knn.py:32",
                                 max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=lib_ms)

    # kernel B
    args_main, _ = seen["deform_rows"]
    n_main = args_main[0].shape[1]
    require(n_main == state.capacity, "unexpected deform call")
    odd = [a[:, :BENCH["n_verts"]] if a.shape[0] != 1 else a for a in args_main]
    for label, args in (("main path", args_main), ("odd N", odd)):
        args = [a.contiguous() for a in args]
        got = deform_rows_cuda(*args)
        want = deform_rows_plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(torch.isfinite(got).all() and err <= 1e-5 * float(want.abs().max()) + 1e-6,
                f"deform {label}: max abs err {err}")
        ms = cuda_ms(lambda: deform_rows_cuda(*args), reps=50)
        plain_ms = cuda_ms(lambda: deform_rows_plain(*args), reps=10)
        print(f"[kernel B deform] {label}: N={args[0].shape[1]} max abs err {err:.3e}, "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        if label == "main path":
            # ~310 fp32 ops and 216 B per Gaussian (csrc/deform.cu)
            b_ms, b_by = bound(310.0 * n_main, (12 + 12 + 9 + 21) * 4 * n_main + 32 * 4)
            report["deform"] = dict(name="deform", route="cuda",
                                    source="mygauhuman_torch/csrc/deform.cu",
                                    replaces="mygauhuman_tpu/ops/pallas_deform.py:139",
                                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=None)

    # kernel C: planar at 512^2 (the main path), tile-major at 208x144
    for label, key, planar in ((f"{BENCH['width']}x{BENCH['height']} planar",
                                "blend_rows_raw", True),
                               ("208x144 tile-major", "blend_tiles_raw", False)):
        (data, starts, counts, tile_base), kw = seen[key]
        kw = dict(kw, planar=planar)
        got = pb.blend_instances_cuda(data, starts, counts, tile_base, **kw)
        want = pb.blend_instances_plain(data, starts, counts, tile_base, **kw)
        torch.cuda.synchronize()
        C = kw["n_channels"]
        # [C+3, H, W] or [T, C+3, P]: move the row axis first
        err_rows = (got - want).abs().movedim(0 if planar else 1, 0).reshape(C + 3, -1)
        err_depth = float(err_rows[C + 1].max())
        err = float(torch.cat([err_rows[:C + 1], err_rows[C + 2:]]).max())
        require(torch.isfinite(got).all() and err <= 1e-4 and err_depth <= 1e-3,
                f"blend {label}: max abs err {err} (depth row {err_depth})")
        ms = cuda_ms(lambda: pb.blend_instances_cuda(data, starts, counts, tile_base, **kw))
        plain_ms = cuda_ms(lambda: pb.blend_instances_plain(data, starts, counts, tile_base,
                                                            **kw), reps=3, warmup=1)
        n_tiles = kw["n_tiles"]
        print(f"[kernel C blend_fwd] {label}: tiles {n_tiles}, instances "
              f"{int(counts.sum())}, C={C}, max abs err {err:.3e} (depth row "
              f"{err_depth:.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        # the work these inputs need: pairs evaluated before each pixel stops,
        # ~20 fp32 ops each, plus 2 (C + 2) + 4 per included pair; the 7 + C
        # rows the kernel loads (x .. depth, features) of the instances some
        # pixel evaluates, starts and counts, and the output
        _, n_eval, n_incl, n_read = pb._blend_instances_plain(
            data, starts, counts, tile_base, n_tiles=n_tiles, tiles_x=kw["tiles_x"],
            n_channels=C, tile_w=kw["tile_w"], tile_h=kw["tile_h"])
        ops = 20.0 * n_eval + (2.0 * (C + 2) + 4.0) * n_incl
        nbytes = (7 + C) * 4 * n_read + 8 * n_tiles + got.numel() * 4
        b_ms, b_by = bound(ops, nbytes)
        print(f"[kernel C blend_fwd] {label} work: {n_eval} (pixel, instance) pairs "
              f"evaluated, {n_incl} included, {n_read} instances read, "
              f"{ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB, bound {b_ms:.5f} ms ({b_by})")
        if planar:
            report["blend_fwd"] = dict(
                name="blend_fwd", route="cuda", source="mygauhuman_torch/csrc/blend_fwd.cu",
                replaces="mygauhuman_tpu/ops/pallas_blend.py:362",
                max_abs_err=max(err, err_depth), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)

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
        report[name]["launches"] = launches[name]
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

    def frame_fn(i, branch):
        b = scene.batches[i % len(scene.batches)]
        eps = 1e-12 * i      # unique work per frame
        st = state._replace(params=state.params._replace(opacity=state.params.opacity + eps))
        kw = {}
        if branch == "replay":
            d = deformed[i % len(deformed)]
            kw = dict(transforms=d.transforms, translation=d.translation)
        return render_frame(st, b.camera, b.frame, model, bg=bg, active_sh_degree=3,
                            config=cfg, **kw).render

    for branch in ("deform", "replay"):
        with torch.no_grad():
            for i in range(4):
                frame_fn(i, branch)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            acc = torch.zeros((), device=dev)
            for i in range(FPS_FRAMES):
                acc = acc + frame_fn(i, branch)[0, 0, 0]
            end.record()
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
        ms = start.elapsed_time(end) / FPS_FRAMES
        print(f"[bench] {branch} branch: {ms:.3f} ms/frame, {1e3 / ms:.1f} frames/s over "
              f"{FPS_FRAMES} frames (host clock {host_s / FPS_FRAMES * 1e3:.3f} ms/frame)",
              flush=True)

    # where a frame's time goes: device busy share and the top device kernels
    from torch.profiler import ProfilerActivity, profile

    for branch in ("deform", "replay"):
        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(PROFILE_FRAMES):
                frame_fn(i, branch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6 / PROFILE_FRAMES
        kernels_ = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(device_us(e) for e in kernels_) / PROFILE_FRAMES
        launches_ = sum(e.count for e in kernels_) / PROFILE_FRAMES
        if busy_us <= 0:
            print(f"[profile] {branch}: device time not measured (no CUDA events)")
            continue
        print(f"[profile] {branch} branch under the profiler: {wall_us:.0f} us/frame wall, "
              f"{busy_us:.0f} us/frame device busy ({100 * busy_us / wall_us:.1f}%), "
              f"{launches_:.0f} kernel launches/frame")
        for e in sorted(kernels_, key=device_us, reverse=True)[:8]:
            print(f"[profile]   {device_us(e) / PROFILE_FRAMES:8.1f} us/frame "
                  f"{e.count / PROFILE_FRAMES:5.1f}x  {e.key[:90]}")

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
    # kernel D vs its plain version on the inputs of a training step's
    # backward, at the bench point (forward planar) and at 208x144 (forward
    # tile-major); after the serving phases, so that they are timed as before
    # any training
    train = make_trainer(scene, cfg, dev)
    narrow = narrow_batch(scene, narrow_cam, b0, cfg, _masks)
    for label, batch in ((f"{BENCH['width']}x{BENCH['height']}", b0), ("208x144", narrow)):
        with capture(pb, "blend_pallas_raw", seen), capture(pbb, "blend_tiles_bwd_raw", seen):
            train["step"].loss_and_grads(train["ts"], batch, 0)
        C = seen.pop("blend_pallas_raw")[1]["n_channels"]
        check_kernel_d(label, seen.pop("blend_tiles_bwd_raw"), C, report, pb, pbb,
                       main=batch is b0)
    train_gpu_vs_cpu(dev)
    train_bench(scene, cfg, train, dev, report)

    # ---- phase 6: results --------------------------------------------------
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: report[n][k] for k in keys}
               for n in ("knn", "deform", "blend_fwd", "blend_bwd")]
    print(json.dumps({"kernels": kernels}))
    print(card_line())   # name, power limit: nvidia-smi's own line
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
