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

Differences from the JAX trainer, by design: no chunked multi-step program
(the JAX `_chunk` fori_loop only amortised per-dispatch latency; this loop
is plain Python), no state snapshot before raising on a non-finite loss
(it waits for the checkpoint port), split noise from a `torch.Generator`,
and the step count is a host int.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from mygauhuman_torch.config import OptimizationConfig
from mygauhuman_torch.data.camera import Camera
from mygauhuman_torch.device import exact_convs
from mygauhuman_torch.models import gaussians as G
from mygauhuman_torch.models.smpl import SMPLModel
from mygauhuman_torch.ops.rasterize import RasterizerConfig, densify_grad_scale
from mygauhuman_torch.render.renderer import FrameInputs, render_frame
from mygauhuman_torch.train import losses as L
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


def _lpips_crop(stack: torch.Tensor, bm: torch.Tensor, crop: int = LPIPS_CROP) -> torch.Tensor:
    """Crop [K, H, W, 3] to the static window centred on the mask's bbox
    (the start is computed on the device: no host sync)."""
    H, W = bm.shape
    ch, cw = min(crop, H), min(crop, W)
    if (ch, cw) == (H, W):
        return stack
    on = bm > 0
    rows, cols = on.any(dim=1).int(), on.any(dim=0).int()
    y0, x0 = rows.argmax(), cols.argmax()
    y1, x1 = H - rows.flip(0).argmax(), W - cols.flip(0).argmax()
    ys = torch.clamp(torch.div(y0 + y1, 2, rounding_mode="floor") - ch // 2, 0, H - ch)
    xs = torch.clamp(torch.div(x0 + x1, 2, rounding_mode="floor") - cw // 2, 0, W - cw)
    iy = ys + torch.arange(ch, device=bm.device)
    ix = xs + torch.arange(cw, device=bm.device)
    return stack[:, iy[:, None], ix[None, :]]


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
        # zero outside the mask, then a static window centred on its bbox;
        # both pairs ride one batched VGG pass
        bm3 = bm[..., None]
        stack = torch.stack([out.render * bm3, batch.gt_image * bm3,
                             out.normal * bm3, batch.gt_normal * bm3])
        crop = _lpips_crop(stack, bm, lpips_crop)
        lpips_val = lpips_fn(crop[0::2], crop[1::2]).sum()
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
                    lpips_fn: Callable | None = None, lpips_crop: int = LPIPS_CROP):
    """The train step: step(ts, batch, active_sh_degree) -> (new ts, metrics).

    The metrics are 0-d tensors on the state's device (reading them waits
    for the device). The input state is not modified.
    `step.loss_and_grads(ts, batch, active_sh_degree)` is its first half:
    (loss, metrics, gradient TrainableParams, dL/dmeans2d_offset, radii)."""

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

    def step(ts: TrainState, batch: TrainBatch, active_sh_degree: int):
        _, metrics, gparams, g_m2d, radii = loss_and_grads(ts, batch, active_sh_degree)
        mask = geometry_freeze_mask(gparams, ts.step >= cfg.pbr_iteration)
        gparams = tree_map(lambda g, m: g * m, gparams, mask)
        new_params, opt_state = tx.step(trainable_params(ts), gparams, ts.opt_state)
        scale = densify_grad_scale(batch.camera.width, batch.camera.height,
                                   device=g_m2d.device)
        gauss = ts.gauss._replace(params=new_params.gaussians)
        gauss = G.add_densification_stats(gauss, g_m2d * scale[None, :], radii)
        return TrainState(gauss=gauss, pose_refiner=new_params.pose_refiner,
                          lbs_offset=new_params.lbs_offset, opt_state=opt_state,
                          step=ts.step + 1), metrics

    step.loss_and_grads = loss_and_grads
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


def train_loop(ts: TrainState, tx: Adam, step_fn, batches: list, cfg: OptimizationConfig, *,
               extent: float, smpl_vertices: torch.Tensor, max_sh_degree: int = 3,
               seed: int = 0, num_iterations: int | None = None, start_iteration: int = 0,
               callback: Callable | None = None):
    """The host schedule: a shuffled stack of the views, refilled when
    exhausted (train.py:212-215, the JAX package's order for the same
    seed), densify events every densification_interval iterations inside
    [densify_from_iter, densify_until_iter), opacity resets every
    opacity_reset_interval. The loss is checked every 50 iterations; a
    non-finite one raises FloatingPointError."""
    num_iterations = num_iterations or cfg.iterations
    host_rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    stack: list[int] = []
    metrics: dict = {}

    def pick_batch():
        nonlocal stack
        if not stack:
            stack = list(range(len(batches)))
        return batches[stack.pop(host_rng.randint(len(stack)))]

    for it in range(start_iteration + 1, num_iterations + 1):
        ts, metrics = step_fn(ts, pick_batch(), active_sh_degree_at(it, max_sh_degree))
        if it % 50 == 0 and not np.isfinite(float(metrics["loss"])):
            raise FloatingPointError(f"non-finite loss at iteration {it}")
        if (cfg.densify_from_iter <= it < cfg.densify_until_iter
                and it % cfg.densification_interval == 0):
            ts = maybe_grow_capacity(ts)
            ts, dinfo = densify_event(ts, gen, cfg, extent, smpl_vertices, it)
            metrics = dict(metrics)
            metrics.update({f"densify_{k}": int(v) for k, v in dinfo.items()})
            metrics["capacity"] = ts.gauss.capacity
        if it % cfg.opacity_reset_interval == 0:
            ts = ts._replace(gauss=G.reset_opacity(ts.gauss),
                             opt_state=reset_opacity_moments(ts.opt_state))
        if callback is not None:
            callback(it, ts, metrics)
    return ts, metrics
