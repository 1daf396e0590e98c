"""Branch-A training: the train step, densify schedule and opacity resets
(port of train/trainer.py).

One step is render -> `compute_losses_a` -> backward -> per-group Adam ->
densification statistics. On CUDA the render runs kernels A, B and C and
the backward kernel D; on the CPU the plain versions. Densify, prune and
opacity-reset events run on the host's schedule between steps.

dL/dmeans2D for the densify statistics is the gradient of the explicit
`means2d_offset` input (zeros), scaled to the reference's NDC units by
`densify_grad_scale`, as the JAX package does for the reference's
`screenspace_points.grad`.

`make_train_step(..., donate=True)` is the JAX trainer's donated, jitted
step: on the card it replays a captured CUDA graph of the step, which
writes the new state into the state's own tensors (train/graph.py), and
`step.chunk` replays it for up to `scan_chunk` iterations from a `[V, ...]`
stack of the views, as the JAX chunk program runs them in one dispatch.
`train_loop(scan_chunk=K)` ends a chunk at every densify, opacity-reset or
SH-ramp boundary and at every iteration in `callback_iters`, so the
schedule is the one of `scan_chunk=1`; only the callback cadence changes.

Differences from the JAX trainer, by design: one graph per camera fov (a
JAX program takes the fovs as traced inputs), split noise from a
`torch.Generator`, and the step count is a host int.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from mygauhuman_torch.config import OptimizationConfig
from mygauhuman_torch.data.camera import Camera
from mygauhuman_torch.device import device_constant, exact_convs
from mygauhuman_torch.models import gaussians as G
from mygauhuman_torch.models.smpl import SMPLModel
from mygauhuman_torch.ops.rasterize import RasterizerConfig, densify_grad_scale
from mygauhuman_torch.render.renderer import FrameInputs, render_frame
from mygauhuman_torch.train import losses as L
from mygauhuman_torch.train.checkpoint import save_checkpoint
from mygauhuman_torch.train.graph import GraphedTrainStep, stack_views
from mygauhuman_torch.train.optim import (
    Adam,
    AdamState,
    TrainableParams,
    geometry_freeze_mask,
    grow_opt_state,
    reset_adam_slots,
    reset_opacity_moments,
    tree_leaves,
    tree_map,
)
from mygauhuman_torch.utils.profiling import PHASES, annotate


class TrainBatch(NamedTuple):
    """One training view: camera + ground truth + masks + SMPL frame."""

    camera: Camera
    frame: FrameInputs
    gt_image: torch.Tensor     # [H, W, 3]
    gt_normal: torch.Tensor    # [H, W, 3] in [0, 1] display encoding
    bkgd_mask: torch.Tensor    # [H, W] 1 = person
    bound_mask: torch.Tensor   # [H, W] 1 = inside projected SMPL bbox


class TrainState(NamedTuple):
    gauss: G.GaussianState
    pose_refiner: Any
    lbs_offset: Any
    opt_state: AdamState
    step: int


def trainable_params(ts: TrainState) -> TrainableParams:
    return TrainableParams(gaussians=ts.gauss.params, pose_refiner=ts.pose_refiner,
                           lbs_offset=ts.lbs_offset)


def create_train_state(cfg: OptimizationConfig, gauss: G.GaussianState, pose_refiner: Any,
                       lbs_offset: Any, spatial_lr_scale: float = 1.0
                       ) -> tuple[TrainState, Adam]:
    params = TrainableParams(gauss.params, pose_refiner, lbs_offset)
    tx = Adam(cfg, spatial_lr_scale)
    return TrainState(gauss=gauss, pose_refiner=pose_refiner, lbs_offset=lbs_offset,
                      opt_state=tx.init(params), step=0), tx


#: Side of the static LPIPS window: on ZJU-format data the subject's
#: bound-mask bbox fits inside 384 x 384 of the 512 x 512 frame.
LPIPS_CROP = 384


def scene_lpips_crop(bound_masks, pad: int = 8, align: int = 32) -> int:
    """Tightest static LPIPS window covering every view's bound-mask bbox
    (+ pad), rounded up to `align`. Returns the side length."""
    masks = [np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b) for b in bound_masks]
    ext = 1
    for bm in masks:
        bm = bm > 0
        if not bm.any():
            continue
        rows = np.nonzero(bm.any(axis=1))[0]
        cols = np.nonzero(bm.any(axis=0))[0]
        ext = max(ext, rows[-1] - rows[0] + 1, cols[-1] - cols[0] + 1)
    side = -(-(ext + 2 * pad) // align) * align
    return int(min(side, max(b.shape[0] for b in masks), max(b.shape[1] for b in masks)))


def _lpips_crop(stacks, bm: torch.Tensor, crop: int = LPIPS_CROP) -> tuple:
    """Crop each [K, H, W, 3] of `stacks` to one static window centred on
    the mask's bbox (the start is computed on the device: no host sync)."""
    H, W = bm.shape
    ch, cw = min(crop, H), min(crop, W)
    if (ch, cw) == (H, W):
        return tuple(stacks)
    on = bm > 0
    rows, cols = on.any(dim=1).int(), on.any(dim=0).int()
    y0, x0 = rows.argmax(), cols.argmax()
    y1, x1 = H - rows.flip(0).argmax(), W - cols.flip(0).argmax()
    ys = torch.clamp(torch.div(y0 + y1, 2, rounding_mode="floor") - ch // 2, 0, H - ch)
    xs = torch.clamp(torch.div(x0 + x1, 2, rounding_mode="floor") - cw // 2, 0, W - cw)
    iy = ys + torch.arange(ch, device=bm.device)
    ix = xs + torch.arange(cw, device=bm.device)
    return tuple(s[:, iy[:, None], ix[None, :]] for s in stacks)


def compute_losses_a(out, batch: TrainBatch, scaling_mean: torch.Tensor,
                     lpips_fn: Callable | None = None, lpips_crop: int = LPIPS_CROP
                     ) -> tuple[torch.Tensor, dict]:
    """Loss branch A (train.py:256-291):

    total = L1(bound) + 0.1 maskL2 + normalL1 + axisL1 + 0.01 lpips
            + 0.01 (1 - ssim) per ssim term + 0.01 normal_TV + mean(scaling)
    """
    bm = batch.bound_mask.float()
    ll1 = L.masked_l1(out.render, batch.gt_image, bm)
    mask_loss = L.masked_l2(out.render_alpha, batch.bkgd_mask.float(), bm)
    normal_loss = L.masked_l1(out.normal, batch.gt_normal, bm)
    axis_loss = L.masked_l1(out.render_axis, batch.gt_normal, bm)
    ssim_val = L.ssim(out.render, batch.gt_image, bm) + L.ssim(out.normal, batch.gt_normal, bm)
    if lpips_fn is not None:
        # zero outside the mask, then a static window centred on its bbox.
        # The ground truth is stacked apart from the renders, so autograd
        # records no backward for its half of the VGG trunk.
        bm3 = bm[..., None]
        rendered, gt = _lpips_crop((torch.stack([out.render * bm3, out.normal * bm3]),
                                    torch.stack([batch.gt_image * bm3, batch.gt_normal * bm3])),
                                   bm, lpips_crop)
        lpips_val = lpips_fn(rendered, gt).sum()
    else:
        lpips_val = torch.zeros((), device=bm.device)
    tv = L.masked_tv_loss(out.render_alpha, out.normal)
    total = (ll1 + 0.1 * mask_loss + normal_loss + axis_loss + 0.01 * lpips_val
             + 0.01 * (2.0 - ssim_val) + 0.01 * tv + scaling_mean)
    metrics = {
        "loss": total, "l1": ll1, "mask": mask_loss, "normal": normal_loss,
        "axis": axis_loss, "ssim": ssim_val,
        # the loss term, whatever backbone lpips_fn uses (random VGG by default)
        "lpips_term": lpips_val, "tv": tv, "scaling_mean": scaling_mean,
        "psnr": L.psnr(out.render, batch.gt_image),
    }
    return total, {k: v.detach() for k, v in metrics.items()}


def make_train_step(smpl_model: SMPLModel, tx: Adam, cfg: OptimizationConfig,
                    raster_config: RasterizerConfig, bg: torch.Tensor,
                    lpips_fn: Callable | None = None, lpips_crop: int = LPIPS_CROP,
                    donate: bool = False):
    """The train step: step(ts, batch, active_sh_degree) -> (new ts, metrics).

    The metrics are 0-d tensors on the state's device (reading them waits
    for the device). With donate=False the step is functional: the input
    state is not modified. With donate=True it is a
    `train/graph.GraphedTrainStep`: captured CUDA graphs on the card, the
    eager step with the same staging on the CPU; it writes the new state
    into the tensors of the state it returns, so the state passed in is
    consumed, and it has `step.chunk(ts, views, idx, deg, pad_to)`.
    `step.loss_and_grads(ts, batch, active_sh_degree)` is the first half:
    (loss, metrics, gradient TrainableParams, dL/dmeans2d_offset, radii);
    `step.eager` the functional step."""

    def loss_and_grads(ts: TrainState, batch: TrainBatch, active_sh_degree: int):
        params = tree_map(lambda x: x.detach().requires_grad_(True), trainable_params(ts))
        m2d_off = torch.zeros((ts.gauss.capacity, 2), device=ts.gauss.alive.device,
                              requires_grad=True)
        leaves = tree_leaves(params) + [m2d_off]
        with exact_convs():
            out = render_frame(ts.gauss._replace(params=params.gaussians), batch.camera,
                               batch.frame, smpl_model, bg=bg,
                               active_sh_degree=active_sh_degree,
                               mlp_params={"pose_refiner": params.pose_refiner,
                                           "lbs_offset": params.lbs_offset},
                               config=raster_config, means2d_offset=m2d_off)
            alive_f = ts.gauss.alive.float()
            scaling_mean = (G.get_scaling(params.gaussians) * alive_f[:, None]).sum() \
                / torch.clamp(alive_f.sum() * 3, min=1.0)
            total, metrics = compute_losses_a(out, batch, scaling_mean, lpips_fn, lpips_crop)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        g_it = iter(grads)
        gparams = tree_map(lambda _: next(g_it), params)
        metrics.update(overflow_tiles=out.overflow_tiles, overflow_gauss=out.overflow_gauss,
                       overflow_inst=out.overflow_inst)
        return total.detach(), metrics, gparams, grads[-1], out.radii

    def apply(ts: TrainState, batch: TrainBatch, active_sh_degree: int,
              staged: torch.Tensor | None = None, frozen: bool | None = None):
        """The functional step; Adam's scalars from `staged` when given (the
        graphed step's row), the geometry frozen per `frozen` (by default
        from ts.step)."""
        _, metrics, gparams, g_m2d, radii = loss_and_grads(ts, batch, active_sh_degree)
        frozen = ts.step >= cfg.pbr_iteration if frozen is None else frozen
        mask = geometry_freeze_mask(gparams, frozen)
        gparams = tree_map(lambda g, m: g * m, gparams, mask)
        new_params, opt_state = tx.step(trainable_params(ts), gparams, ts.opt_state,
                                        staged=staged)
        # kept per device: a captured step cannot copy it from the host
        w, h = batch.camera.width, batch.camera.height
        scale = device_constant(f"densify_grad_scale_{w}x{h}", densify_grad_scale(w, h),
                                g_m2d.device)
        gauss = ts.gauss._replace(params=new_params.gaussians)
        gauss = G.add_densification_stats(gauss, g_m2d * scale[None, :], radii)
        return TrainState(gauss=gauss, pose_refiner=new_params.pose_refiner,
                          lbs_offset=new_params.lbs_offset, opt_state=opt_state,
                          step=ts.step + 1), metrics

    def eager(ts: TrainState, batch: TrainBatch, active_sh_degree: int):
        return apply(ts, batch, active_sh_degree)

    step = eager
    if donate:
        step = GraphedTrainStep(apply, tx, frozen_from=cfg.pbr_iteration,
                                instance_capacity=raster_config.instance_capacity)
    step.loss_and_grads = loss_and_grads
    step.eager = eager
    return step


def densify_event(ts: TrainState, generator: torch.Generator | None, cfg: OptimizationConfig,
                  extent: float, smpl_vertices: torch.Tensor, iteration: int,
                  noise: torch.Tensor | None = None) -> tuple[TrainState, dict]:
    """One scheduled densify + prune, with the Adam moments of rewritten
    slots reset. Size threshold 20 only after iteration 3000 (train.py:401-412)."""
    gauss, written, info = G.densify_and_prune(
        ts.gauss, generator, max_grad=cfg.densify_grad_threshold, min_opacity=0.005,
        extent=extent, max_screen_size=20.0 if iteration > 3000 else 0.0,
        max_screen_size_on=iteration > 3000, kl_threshold=cfg.kl_threshold,
        smpl_vertices=smpl_vertices, use_kl=cfg.use_kl_densify,
        percent_dense=cfg.percent_dense, noise=noise)
    opt_state = reset_adam_slots(ts.opt_state, written, ts.gauss.capacity)
    return ts._replace(gauss=gauss, opt_state=opt_state), info


def maybe_grow_capacity(ts: TrainState, min_free: int | None = None) -> TrainState:
    """Double the capacity (every per-Gaussian leaf and Adam moment row)
    when free slots run low, so clones and splits are not dropped."""
    cap = ts.gauss.capacity
    min_free = min_free if min_free is not None else max(256, cap // 8)
    if cap - int(ts.gauss.num_alive) >= min_free:
        return ts
    return ts._replace(gauss=G.grow_capacity(ts.gauss, cap * 2),
                       opt_state=grow_opt_state(ts.opt_state, cap, cap * 2))


def active_sh_degree_at(step: int, max_degree: int) -> int:
    """SH degree ramps one level every 1000 iterations (train.py:205-206)."""
    return min(step // 1000, max_degree)


def _reset_opacity(ts: TrainState) -> TrainState:
    return ts._replace(gauss=G.reset_opacity(ts.gauss),
                       opt_state=reset_opacity_moments(ts.opt_state))


def train_loop(ts: TrainState, tx: Adam, step_fn, batches: list, cfg: OptimizationConfig, *,
               extent: float, smpl_vertices: torch.Tensor, max_sh_degree: int = 3,
               seed: int = 0, num_iterations: int | None = None, start_iteration: int = 0,
               callback: Callable | None = None, sharding=None, scan_chunk: int = 1,
               callback_iters: tuple = ()):
    """The host schedule: a shuffled stack of the views, refilled when
    exhausted (train.py:212-215, the JAX package's order for the same
    seed), densify events every densification_interval iterations inside
    [densify_from_iter, densify_until_iter), opacity resets every
    opacity_reset_interval. The loss is checked every 50 iterations (at
    every chunk's end when chunked); a non-finite one snapshots the state to
    output/diverged/chkpnt<it> and raises FloatingPointError.

    scan_chunk > 1 runs up to that many iterations per call of
    `step_fn.chunk` (make_train_step(..., donate=True)) on a [V, ...] stack
    of the views: a chunk never crosses a densify / reset / SH-ramp
    boundary or an iteration in `callback_iters`, so the schedule and the
    view order are those of scan_chunk=1; only the callback cadence changes
    (once per chunk, with that chunk's last metrics). A step_fn without
    `.chunk` runs one step per call.

    With `sharding` (parallel/mesh.py::StateSharding, a multi-rank run),
    `ts` is this rank's share of the state (a `Sharded`) in and out, as
    `step_fn` and `callback` take it: a densify event gathers the whole
    state, grows and densifies it as on one device (every rank draws the
    same split noise from the same seed) and shards the result; the opacity
    reset, elementwise, runs on the share.

    Spans (utils/profiling.py): `mgh.train.chunk` around each chunk's call,
    `mgh.train.loss_check` around the loss's read, where the host waits for
    the chunk, and `mgh.train.densify` around each event, counted in
    `PHASES`."""
    num_iterations = num_iterations or cfg.iterations
    host_rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    stack: list[int] = []
    metrics: dict = {}
    chunked = scan_chunk > 1 and hasattr(step_fn, "chunk")
    cb_set = {int(i) for i in callback_iters}
    views = stack_views(batches) if chunked else None

    def pick_index():
        nonlocal stack
        if not stack:
            stack = list(range(len(batches)))
        return stack.pop(host_rng.randint(len(stack)))

    def is_densify(it):
        return (cfg.densify_from_iter <= it < cfg.densify_until_iter
                and it % cfg.densification_interval == 0)

    def chunk_end(it):
        """Last iteration of the chunk from `it` (the JAX loop's rule): it
        may end on an event, an SH-degree change or an iteration the caller
        observes, never contain one before its end."""
        end = min(it + scan_chunk - 1, num_iterations)
        end = min(end, (it // 1000 + 1) * 1000 - 1)
        for e in range(it, end + 1):
            if is_densify(e) or e % cfg.opacity_reset_interval == 0 or e in cb_set:
                return e
        return end

    def whole(ts):
        return ts if sharding is None else sharding.gather(ts)

    it = start_iteration + 1
    while it <= num_iterations:
        deg = active_sh_degree_at(it, max_sh_degree)
        if chunked:
            end = chunk_end(it)
            idx = [pick_index() for _ in range(end - it + 1)]
            with annotate("mgh.train.chunk"):
                ts, (mseq, n) = step_fn.chunk(ts, views, idx, deg, pad_to=scan_chunk)
            metrics = {k: v[n - 1] for k, v in mseq.items()}
            it = end
        else:
            ts, metrics = step_fn(ts, batches[pick_index()], deg)
        if chunked or it % 50 == 0:
            # the host waits here for the chunk's last step
            with annotate("mgh.train.loss_check"):
                finite = np.isfinite(float(metrics["loss"]))
            if not finite:
                path = save_checkpoint("output/diverged", it, whole(ts))
                raise FloatingPointError(f"non-finite loss at iteration {it}; state snapshot "
                                         f"at {path}")
        if is_densify(it):
            with PHASES.phase("mgh.train.densify"):
                full = maybe_grow_capacity(whole(ts))
                full, dinfo = densify_event(full, gen, cfg, extent, smpl_vertices, it)
                metrics = dict(metrics)
                metrics.update({f"densify_{k}": int(v) for k, v in dinfo.items()})
                metrics["capacity"] = full.gauss.capacity
                ts = full if sharding is None else sharding.shard(full, full.gauss.capacity)
                del full    # a share's whole state is not kept through the next step
        if it % cfg.opacity_reset_interval == 0:
            ts = _reset_opacity(ts) if sharding is None else \
                ts._replace(local=_reset_opacity(ts.local))
        if callback is not None:
            callback(it, ts, metrics)
        it += 1
    return ts, metrics
