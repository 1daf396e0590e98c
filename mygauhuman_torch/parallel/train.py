"""Train steps over the mesh (port of parallel/train.py).

`make_tile_sharded_train_step` (branch A) and `make_tile_sharded_pbr_step`
(branch B): views split over the "data" axis, the per-Gaussian state over
the raster axes ("gauss", "tiles"), each rank rendering through the strip
rasterizer (`parallel/raster.py`). `make_batched_train_step`: views split
over "data", every Gaussian on every rank.

Each sharded step takes and returns this rank's share of the state
(`parallel/mesh.py::Sharded`: every per-Gaussian leaf, Adam moments and
densify statistics included, cut to the rank's capacity slice; the MLPs,
their moments and the counts whole), as the JAX step's in_specs and
out_specs shard the per-Gaussian leaves over the raster axes. A rank
renders its slice, and the collectives reduce the gradients as the JAX
step's do:
  * the replicated loss is pre-scaled by 1/(n_shards n_data) (each raster
    rank carries its copy through the strip all_gather, whose backward sums
    the copies; the data ranks' views are averaged);
  * per-Gaussian gradients sum over "data" only (a rank owns its slice's
    whole gradient); the MLPs', the light's and the volumes' sum over
    every axis;
  * the densify statistics undo the view mean (B_total) and sum over
    "data" (max_radii2d: max). The 1/n_shards needs no undoing: the
    all_gather's backward has summed the n_shards copies back to one. (The
    JAX step multiplies by n_shards B_total, so its xyz_grad_accum comes
    out n_shards times the single-device one: ROADMAP Queue 3.)
Adam then updates the slice. It is elementwise, so the slice holds the
bits a whole-state update would give its rows, and nothing per-Gaussian is
gathered inside a step. What the JAX package runs on global arrays gathers
the share first (`StateSharding.gather`, `state_gather` in mesh.STATS) and
slices the result again: `train/trainer.py::train_loop`'s densify event and
capacity growth, `train/pbr.py::train_loop_pbr`'s bake and KNN, and the
CLI's eval and snapshots.

Deliberate difference from the JAX module: in branch B the geometry and
MLP groups keep their parameters, moments and counts (as the port's
single-device branch-B step, ROADMAP Queue 3).
"""
from __future__ import annotations

from typing import Callable

import torch

from mygauhuman_torch.config import OptimizationConfig
from mygauhuman_torch.device import exact_convs
from mygauhuman_torch.models import gaussians as G
from mygauhuman_torch.models.smpl import SMPLModel
from mygauhuman_torch.ops.rasterize import RasterizerConfig, densify_grad_scale
from mygauhuman_torch.parallel.mesh import (
    AXES,
    RASTER_AXES,
    Mesh,
    Sharded,
    all_gather,
    gather_raw,
    pmax,
    pmean,
    psum,
)
from mygauhuman_torch.parallel.raster import make_strip_raster_fn
from mygauhuman_torch.render.renderer import render_frame
from mygauhuman_torch.train.optim import (
    Adam,
    TrainableParams,
    geometry_freeze_mask,
    tree_leaves,
    tree_map,
)
from mygauhuman_torch.train.trainer import (
    LPIPS_CROP,
    TrainBatch,
    TrainState,
    compute_losses_a,
    trainable_params,
)


def stack_batches(batches: list[TrainBatch]) -> TrainBatch:
    """Single-view TrainBatches -> one batch with a leading view axis on
    every tensor (camera sizes and fields of view must agree)."""
    return tree_map(lambda *xs: torch.stack(xs), *batches)


def index_batch(batch: TrainBatch, i: int) -> TrainBatch:
    """View i of a stacked batch."""
    return tree_map(lambda x: x[i], batch)


def _rank_views(batch: TrainBatch, group) -> list[TrainBatch]:
    """This rank's views of a stacked batch: the data rank's share of the
    leading axis."""
    B = batch.gt_image.shape[0]
    if B % group.size:
        raise ValueError(f"{B} views do not split over {group.size} data ranks")
    b = B // group.size
    return [index_batch(batch, group.index * b + i) for i in range(b)]


def _pack(leaves: list, rows: int) -> torch.Tensor:
    return torch.cat([x.reshape(rows, -1) for x in leaves], dim=1)


def _unpack(flat: torch.Tensor, like: list) -> list:
    out, col = [], 0
    for x in like:
        w = x[0].numel() if x.dim() else 1
        out.append(flat[:, col:col + w].reshape((flat.shape[0],) + tuple(x.shape[1:])))
        col += w
    return out


def _psum_tree(tree, group):
    """psum of every tensor leaf as one flat vector (one collective)."""
    leaves = tree_leaves(tree)
    if group.size == 1 or not leaves:
        return tree
    flat = psum(torch.cat([x.reshape(-1) for x in leaves]), group)
    it, col = iter(leaves), [0]

    def take(_):
        x = next(it)
        y = flat[col[0]:col[0] + x.numel()].reshape(x.shape)
        col[0] += x.numel()
        return y

    return tree_map(take, tree)


def _sum_over_data(local: list, dgroup) -> list:
    """Per-Gaussian tensors [c, ...] of this rank's slice summed over the
    data ranks (one collective)."""
    if dgroup.size == 1:
        return local
    return _unpack(psum(_pack(local, local[0].shape[0]), dgroup), local)


def _densify_increments(g_offs: list, radii: list, scale: torch.Tensor):
    """The densify statistics' increments of some views, as consecutive
    single-view steps would add them: the summed norms of the visible
    Gaussians' means2D gradients (times `scale`), the visible counts, and
    the largest radii."""
    zero = torch.zeros_like(g_offs[0][:, 0])
    stats, denom, max_r = zero, zero, zero
    for g_off, r in zip(g_offs, radii):
        gn = g_off * scale[None, :]
        vis = r > 0
        stats = stats + torch.where(vis, torch.sqrt((gn * gn).sum(dim=-1)), zero)
        denom = denom + vis.float()
        max_r = torch.maximum(max_r, torch.where(vis, r.float(), zero))
    return stats, denom, max_r


def _pmean_metrics(metrics: dict, group) -> dict:
    names = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32).reshape(())
                        for k in names])
    return dict(zip(names, pmean(vals, group).unbind()))


class _Groups:
    def __init__(self, mesh: Mesh):
        self.raster = mesh.group(RASTER_AXES)
        self.data = mesh.group("data")
        self.all = mesh.group(AXES)

    def local(self, sh: Sharded) -> tuple[int, int]:
        """(rows of this rank's slice, its index) of a share, checked
        against its stated capacity."""
        if not isinstance(sh, Sharded):
            raise TypeError(f"the sharded step takes this rank's Sharded share "
                            f"(parallel/mesh.py::StateSharding.shard), got {type(sh).__name__}")
        n = self.raster.size
        if sh.capacity % n:
            raise ValueError(f"capacity {sh.capacity} does not split over {n} raster ranks")
        c = sh.capacity // n
        if sh.local.gauss.alive.shape[0] != c:
            raise ValueError(f"a share of capacity {sh.capacity} on {n} ranks has {c} rows, "
                             f"this one {sh.local.gauss.alive.shape[0]}")
        return c, self.raster.index


def make_tile_sharded_train_step(smpl_model: SMPLModel, tx: Adam, cfg: OptimizationConfig,
                                 raster_config: RasterizerConfig, bg: torch.Tensor,
                                 mesh: Mesh, exchange_capacity: int = 4096,
                                 lpips_fn: Callable | None = None,
                                 lpips_crop: int | None = None):
    """step(sh, batch, active_sh_degree) -> (new sh, metrics): `sh` is this
    rank's share of a TrainState (a `Sharded`, module docstring), in and
    out, and `batch` stacked (stack_batches), its views split over "data".
    The losses and gradients are the single-device step's up to float
    rounding. `step.loss_and_grads(...)` is its first half: (loss, metrics,
    the gradient TrainableParams of the slice (its MLP gradients whole),
    the slice's densify increments (grad norm sum, visible count, radii
    max), this rank's radii per view)."""
    lpips_crop = LPIPS_CROP if lpips_crop is None else int(lpips_crop)
    groups = _Groups(mesh)
    raster_fn = make_strip_raster_fn(groups.raster, exchange_capacity)

    def loss_and_grads(sh: Sharded, batch: TrainBatch, active_sh_degree: int):
        n_shards, n_data = groups.raster.size, groups.data.size
        c, _ = groups.local(sh)
        ts = sh.local
        views = _rank_views(batch, groups.data)
        B_total = batch.gt_image.shape[0]
        gauss = ts.gauss
        params = tree_map(lambda x: x.detach().requires_grad_(True), trainable_params(ts))
        dev = gauss.alive.device
        offs = [torch.zeros((c, 2), device=dev, requires_grad=True) for _ in views]
        leaves = tree_leaves(params) + offs
        alive_f = gauss.alive.float()
        totals, radii, metrics, out = [], [], {}, None
        with exact_convs():
            for view, off in zip(views, offs):
                out = render_frame(gauss._replace(params=params.gaussians), view.camera,
                                   view.frame, smpl_model, bg=bg,
                                   active_sh_degree=active_sh_degree,
                                   mlp_params={"pose_refiner": params.pose_refiner,
                                               "lbs_offset": params.lbs_offset},
                                   config=raster_config, means2d_offset=off,
                                   raster_fn=raster_fn)
                # the mean over every alive Gaussian of the raster ranks
                s_sum = psum((G.get_scaling(params.gaussians) * alive_f[:, None]).sum(),
                             groups.raster)
                s_cnt = psum(alive_f.sum() * 3, groups.raster)
                total, metrics = compute_losses_a(out, view, s_sum / torch.clamp(s_cnt, min=1.0),
                                                  lpips_fn, lpips_crop)
                totals.append(total)
                radii.append(out.radii)
            local_mean = torch.stack(totals).mean()
            grads = torch.autograd.grad(local_mean / (n_shards * n_data), leaves,
                                        allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        n_p = len(grads) - len(offs)
        g_it = iter(grads[:n_p])
        gparams = tree_map(lambda _: next(g_it), params)

        with torch.no_grad():
            # dL/doffset of the objective is the per-view gradient over
            # B_total: the raster ranks' copies of 1/n_shards sum to one
            scale = densify_grad_scale(views[0].camera.width, views[0].camera.height,
                                       device=dev) * B_total
            stats, denom, max_r = _densify_increments(grads[n_p:], radii, scale)
            if n_data > 1:
                max_r = pmax(max_r, groups.data)
            g_leaves = list(gparams.gaussians)
            summed = _sum_over_data(g_leaves + [stats, denom], groups.data)
            gparams = TrainableParams(
                gaussians=type(gparams.gaussians)(*summed[:len(g_leaves)]),
                pose_refiner=_psum_tree(gparams.pose_refiner, groups.all),
                lbs_offset=_psum_tree(gparams.lbs_offset, groups.all))
            metrics = dict(metrics, loss=local_mean.detach())
            metrics = _pmean_metrics(metrics, groups.data)
            metrics.update(overflow_tiles=out.overflow_tiles,
                           overflow_gauss=out.overflow_gauss,
                           overflow_inst=out.overflow_inst)
        return (metrics["loss"], metrics, gparams, (summed[-2], summed[-1], max_r), radii)

    def step(sh: Sharded, batch: TrainBatch, active_sh_degree: int):
        _, metrics, gparams, (stats, denom, max_r), _ = loss_and_grads(sh, batch,
                                                                       active_sh_degree)
        ts = sh.local
        mask = geometry_freeze_mask(gparams, ts.step >= cfg.pbr_iteration)
        gparams = tree_map(lambda g, m: g * m, gparams, mask)
        new_params, opt_state = tx.step(trainable_params(ts), gparams, ts.opt_state)
        gauss = ts.gauss._replace(params=new_params.gaussians,
                                  xyz_grad_accum=ts.gauss.xyz_grad_accum + stats,
                                  denom=ts.gauss.denom + denom,
                                  max_radii2d=torch.maximum(ts.gauss.max_radii2d, max_r))
        return sh._replace(local=TrainState(
            gauss=gauss, pose_refiner=new_params.pose_refiner,
            lbs_offset=new_params.lbs_offset, opt_state=opt_state,
            step=ts.step + 1)), metrics

    step.loss_and_grads = loss_and_grads
    return step


def make_batched_train_step(smpl_model: SMPLModel, tx: Adam, cfg: OptimizationConfig,
                            raster_config: RasterizerConfig, bg: torch.Tensor,
                            mesh: Mesh | None = None,
                            lpips_fn: Callable | None = None,
                            lpips_crop: int | None = None):
    """step(ts, batch, active_sh_degree) over a stacked batch of B views:
    the mean loss over the views, one update, and densify statistics that
    sum the views' (as B sequential single-view iterations would add
    them). With a mesh, the views split over "data" and every rank holds
    every Gaussian; the gradients and statistics sum over the data ranks."""
    lpips_crop = LPIPS_CROP if lpips_crop is None else int(lpips_crop)

    def step(ts: TrainState, batch: TrainBatch, active_sh_degree: int):
        if mesh is None:
            views = [index_batch(batch, i) for i in range(batch.gt_image.shape[0])]
            dgroup = None
        else:
            dgroup = mesh.group("data")
            views = _rank_views(batch, dgroup)
        B_total = batch.gt_image.shape[0]
        n_data = B_total // len(views)
        params = tree_map(lambda x: x.detach().requires_grad_(True), trainable_params(ts))
        cap = ts.gauss.capacity
        dev = ts.gauss.alive.device
        offs = [torch.zeros((cap, 2), device=dev, requires_grad=True) for _ in views]
        leaves = tree_leaves(params) + offs
        alive_f = ts.gauss.alive.float()
        totals, radii, metrics = [], [], {}
        with exact_convs():
            for view, off in zip(views, offs):
                out = render_frame(ts.gauss._replace(params=params.gaussians), view.camera,
                                   view.frame, smpl_model, bg=bg,
                                   active_sh_degree=active_sh_degree,
                                   mlp_params={"pose_refiner": params.pose_refiner,
                                               "lbs_offset": params.lbs_offset},
                                   config=raster_config, means2d_offset=off)
                sm = (G.get_scaling(params.gaussians) * alive_f[:, None]).sum() \
                    / torch.clamp(alive_f.sum() * 3, min=1.0)
                total, metrics = compute_losses_a(out, view, sm, lpips_fn, lpips_crop)
                totals.append(total)
                radii.append(out.radii)
            local_mean = torch.stack(totals).mean()
            grads = torch.autograd.grad(local_mean / n_data, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        n_p = len(grads) - len(offs)
        g_it = iter(grads[:n_p])
        with torch.no_grad():
            gparams = tree_map(lambda _: next(g_it), params)
            scale = densify_grad_scale(views[0].camera.width, views[0].camera.height,
                                       device=dev) * B_total
            stats, denom, max_r = _densify_increments(grads[n_p:], radii, scale)
            metrics = dict(metrics, loss=local_mean.detach())
            if dgroup is not None and dgroup.size > 1:
                gparams = _psum_tree(gparams, dgroup)
                stats, denom = (psum(x, dgroup) for x in (stats, denom))
                max_r = pmax(max_r, dgroup)
                metrics = _pmean_metrics(metrics, dgroup)
        mask = geometry_freeze_mask(gparams, ts.step >= cfg.pbr_iteration)
        gparams = tree_map(lambda g, m: g * m, gparams, mask)
        new_params, opt_state = tx.step(trainable_params(ts), gparams, ts.opt_state)
        gauss = ts.gauss._replace(params=new_params.gaussians,
                                  xyz_grad_accum=ts.gauss.xyz_grad_accum + stats,
                                  denom=ts.gauss.denom + denom,
                                  max_radii2d=torch.maximum(ts.gauss.max_radii2d, max_r))
        return TrainState(gauss=gauss, pose_refiner=new_params.pose_refiner,
                          lbs_offset=new_params.lbs_offset, opt_state=opt_state,
                          step=ts.step + 1), metrics

    return step


def make_tile_sharded_pbr_step(smpl_model: SMPLModel, tx: Adam, light_tx, cfg: OptimizationConfig,
                               raster_config: RasterizerConfig, bg: torch.Tensor, mesh: Mesh,
                               exchange_capacity: int = 4096,
                               lpips_fn: Callable | None = None):
    """The sharded branch-B step: step(sh, pbr_state, batch, knn3,
    occlusion_color, prefilter_w, active_sh_degree) -> (new sh, new
    pbr_state, metrics), the mirror of train/pbr.py's make_pbr_train_step
    on this rank's share `sh` of a TrainState (a `Sharded`, in and out).
    `batch` is stacked and `occlusion_color` [B, c, 3] holds every view's
    rows of this rank's capacity slice (its views split over "data");
    `pbr_state`, `knn3` (global ids) and `prefilter_w` are whole on every
    rank. The G-buffers render through the strip rasterizer, the shading
    and losses run replicated on the gathered image, the KNN smoothness
    term all_gathers alive, albedo and roughness (cap x 5 floats), and the
    light's gradient sums over every axis. The material slices and their
    moments stay on their rank. `step.loss_and_grads(...)` (same arguments):
    (loss, metrics, the {"albedo", "roughness"} gradients of the slice and
    the whole {"light"} one)."""
    from mygauhuman_torch.pbr.shade import get_brdf_lut
    from mygauhuman_torch.train.pbr import (
        MATERIAL_GROUPS,
        PbrState,
        canonical_view_dirs,
        compute_losses_pbr,
    )

    groups = _Groups(mesh)
    raster_fn = make_strip_raster_fn(groups.raster, exchange_capacity)
    brdf_lut = get_brdf_lut(bg.device)

    def loss_and_grads(sh: Sharded, pbr_state, batch: TrainBatch, knn3: torch.Tensor,
                       occlusion_color: torch.Tensor, prefilter_w: dict,
                       active_sh_degree: int):
        n_shards, n_data = groups.raster.size, groups.data.size
        c, _ = groups.local(sh)
        ts = sh.local
        views = _rank_views(batch, groups.data)
        b = len(views)
        if occlusion_color.shape[1] != c:
            raise ValueError(f"occlusion_color has {occlusion_color.shape[1]} rows, the "
                             f"slice {c}")
        occ = occlusion_color[groups.data.index * b:(groups.data.index + 1) * b]
        gauss = ts.gauss
        g = gauss.params
        albedo = g.albedo.detach().requires_grad_(True)
        roughness = g.roughness.detach().requires_grad_(True)
        base = pbr_state.light["base"].detach().requires_grad_(True)
        params = G.GaussianParams(*(x.detach() for x in g))._replace(albedo=albedo,
                                                                     roughness=roughness)
        mlps = tree_map(torch.Tensor.detach, {"pose_refiner": ts.pose_refiner,
                                              "lbs_offset": ts.lbs_offset})
        # the smoothness term reads global neighbour ids: the whole
        # capacity's alive mask and materials, in slice order (`knn_gather`
        # in mesh.STATS)
        alive_all = torch.cat(tuple(gather_raw(groups.raster, gauss.alive,
                                               "knn_gather"))).float()
        totals, metrics = [], {}
        with exact_convs():
            for view, occ_one in zip(views, occ):
                out = render_frame(gauss._replace(params=params), view.camera, view.frame,
                                   smpl_model, bg=bg, active_sh_degree=active_sh_degree,
                                   mlp_params=mlps, config=raster_config,
                                   occlusion_color=occ_one, raster_fn=raster_fn)
                albedo_g = all_gather(G.get_albedo(params), groups.raster, 0, "knn_gather")
                rough_g = all_gather(G.get_roughness(params), groups.raster, 0, "knn_gather")
                total, metrics = compute_losses_pbr(
                    out, view, {"base": base}, albedo_g, rough_g, alive_all, knn3,
                    canonical_view_dirs(view.camera), brdf_lut, lpips_fn, prefilter_w)
                totals.append(total)
            local_mean = torch.stack(totals).mean()
            g_alb, g_rough, g_light = torch.autograd.grad(
                local_mean / (n_shards * n_data), (albedo, roughness, base))
        with torch.no_grad():
            g_alb, g_rough = _sum_over_data([g_alb, g_rough], groups.data)
            g_light = psum(g_light, groups.all)
            metrics = _pmean_metrics(dict(metrics, loss=local_mean.detach()), groups.data)
        return metrics["loss"], metrics, {"albedo": g_alb, "roughness": g_rough,
                                          "light": g_light}

    def step(sh: Sharded, pbr_state, batch: TrainBatch, knn3: torch.Tensor,
             occlusion_color: torch.Tensor, prefilter_w: dict, active_sh_degree: int):
        _, metrics, grads = loss_and_grads(sh, pbr_state, batch, knn3, occlusion_color,
                                           prefilter_w, active_sh_degree)
        ts = sh.local
        g = ts.gauss.params
        gauss_grads = G.GaussianParams(*(None for _ in g))._replace(
            normal=torch.zeros_like(g.normal), albedo=grads["albedo"],
            roughness=grads["roughness"])
        new_params, opt_state = tx.step(
            trainable_params(ts), TrainableParams(gauss_grads, None, None), ts.opt_state,
            groups=MATERIAL_GROUPS)
        vol = pbr_state.volumes.coefficients
        new_lv, light_state = light_tx.step(
            {"light": pbr_state.light, "volumes": vol},
            {"light": {"base": grads["light"]}, "volumes": torch.zeros_like(vol)},
            pbr_state.opt_state)
        new_pbr = PbrState(light={"base": torch.clamp(new_lv["light"]["base"], min=0.0)},
                           volumes=pbr_state.volumes._replace(coefficients=new_lv["volumes"]),
                           opt_state=light_state)
        new_ts = TrainState(gauss=ts.gauss._replace(params=new_params.gaussians),
                            pose_refiner=new_params.pose_refiner,
                            lbs_offset=new_params.lbs_offset, opt_state=opt_state,
                            step=ts.step + 1)
        return sh._replace(local=new_ts), new_pbr, metrics

    step.loss_and_grads = loss_and_grads
    return step
