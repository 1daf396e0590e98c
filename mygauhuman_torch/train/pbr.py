"""PBR training branch B (port of train/pbr.py; reference train.py loss
branch B, :294-363).

After `pbr_iteration` the geometry freezes and the optimization switches to
materials and light: split-sum shade the rendered G-buffers (world normal,
albedo, roughness, occlusion, alpha) against the ground truth, with BRDF TV,
KDE entropy, KNN material smoothness, lambertian and envmap-TV
regularizers. A second Adam (eps 1e-15, at opacity_lr) drives the cubemap
light and the irradiance volumes (train.py:155-164; the volumes are stepped
but unused by the loss, as in the reference).

The step differentiates only what the loss reads through live parameters:
albedo, roughness and the light. Every geometry leaf, the normals (the loss
reads the world-normal G-buffer under a stop-gradient, so their gradient is
zero) and both MLPs enter detached, so no projection, binning, LBS or MLP
backward is built: on CUDA the step launches kernel B's forward and never
its backward. The scene optimizer updates the material groups only:

  * albedo and roughness with their gradients, the normals with a zero
    gradient (as the JAX step, whose normal gradient is a structural zero);
  * the geometry groups keep their parameters, moments and counts. This is
    the reference's update_learning_rate freeze (lr 0, gaussian_model.py:
    289-307). The JAX step instead feeds those groups zero gradients, so
    their phase-A momentum keeps moving the geometry after pbr_iteration
    (ROADMAP Queue 3).

Deliberate differences from the JAX module: a per-step function (no chunk
program, as `train_loop` runs one step per call), the light's Adam is a
functional Adam as `train/optim.py`'s, and every gather whose gradient is
summed (the samplers, the KNN material smoothness) goes through
`pbr/cubemap.py::gather_rows`, whose backward sums in a fixed order.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from mygauhuman_torch.config import OptimizationConfig
from mygauhuman_torch.data.camera import Camera
from mygauhuman_torch.device import DEFAULT_DEVICE, exact_convs, resolve_device
from mygauhuman_torch.models import gaussians as G
from mygauhuman_torch.models.smpl import SMPLModel
from mygauhuman_torch.occlusion import baking
from mygauhuman_torch.occlusion.volumes import IrradianceVolumes, init_irradiance_volumes
from mygauhuman_torch.ops.knn import knn
from mygauhuman_torch.ops.rasterize import RasterizerConfig
from mygauhuman_torch.pbr.cubemap import gather_rows
from mygauhuman_torch.pbr.light import (
    build_mips,
    export_envmap,
    init_cubemap_light,
    prefilter_weight_set,
)
from mygauhuman_torch.pbr.shade import get_brdf_lut, pbr_shading_planar
from mygauhuman_torch.render import render_frame
from mygauhuman_torch.train import losses as L
from mygauhuman_torch.train.optim import Adam, TrainableParams, adam_leaf, tree_map
from mygauhuman_torch.train.trainer import TrainBatch, TrainState, trainable_params
from mygauhuman_torch.utils.transforms import rot_apply

R_MAX, R_MIN = 1.0, 0.04   # roughness remap (train.py:233-235)
LIGHT_ADAM_EPS = 1e-15     # optax.adam(opacity_lr, eps=1e-15) (train.py:155-164)
#: the scene optimizer's groups that branch B updates
MATERIAL_GROUPS = ("normal", "albedo", "roughness")


class LightAdamState(NamedTuple):
    count: int     # completed updates (host int)
    mu: dict       # {"light": {"base": ...}, "volumes": ...}
    nu: dict


class LightAdam(NamedTuple):
    """One Adam over the light and the volumes: optax.adam(lr, eps=1e-15)."""

    lr: float

    def init(self, params: dict) -> LightAdamState:
        return LightAdamState(count=0, mu=tree_map(torch.zeros_like, params),
                              nu=tree_map(torch.zeros_like, params))

    def step(self, params: dict, grads: dict, state: LightAdamState):
        count = state.count + 1
        out = tree_map(lambda p, g, m, v: adam_leaf(p, g, m, v, self.lr, count, LIGHT_ADAM_EPS),
                       params, grads, state.mu, state.nu)
        return _select(out, 0), LightAdamState(count=count, mu=_select(out, 1),
                                               nu=_select(out, 2))


def _select(tree, i):
    """The i-th entry of every (p, mu, nu) leaf of a dict tree."""
    if isinstance(tree, dict):
        return {k: _select(v, i) for k, v in tree.items()}
    return tree[i]


class PbrState(NamedTuple):
    light: dict                    # {"base": [6, R, R, 3]}
    volumes: IrradianceVolumes
    opt_state: LightAdamState


def create_pbr_state(cfg: OptimizationConfig, bound: float = 1.5, base_res: int = 32,
                     device: str | torch.device = DEFAULT_DEVICE
                     ) -> tuple[PbrState, LightAdam]:
    """Light + volumes with one Adam at opacity_lr (train.py:145-164)."""
    dev = resolve_device(device)
    light = init_cubemap_light(base_res, device=dev)
    volumes = init_irradiance_volumes([-bound, -bound, -bound, bound, bound, bound], device=dev)
    tx = LightAdam(cfg.opacity_lr)
    return PbrState(light=light, volumes=volumes,
                    opt_state=tx.init({"light": light, "volumes": volumes.coefficients})), tx


def canonical_view_dirs(camera: Camera) -> torch.Tensor:
    """Per-pixel world-space surface->camera directions [H, W, 3].

    Parity: get_canonical_rays (scene/__init__.py:129-161) + the train-loop
    transform (train.py:237-243): -(normalize(rays) @ c2w_rot rows)."""
    H, W = camera.height, camera.width
    dev = camera.w2c.device
    focal_x = W / (2.0 * camera.tan_fovx)
    focal_y = H / (2.0 * camera.tan_fovy)
    x = (torch.arange(W, dtype=torch.float32, device=dev) - W / 2 + 0.5) / focal_x
    y = (torch.arange(H, dtype=torch.float32, device=dev) - H / 2 + 0.5) / focal_y
    dirs = torch.stack([x[None, :].expand(H, W), y[:, None].expand(H, W),
                        torch.ones((H, W), dtype=torch.float32, device=dev)], dim=-1)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    R_c2w = camera.w2c[:3, :3].T
    return -torch.einsum("hwc,rc->hwr", dirs, R_c2w)


def compute_knn3(state: G.GaussianState) -> torch.Tensor:
    """[cap, 3] self-KNN neighbour ids among alive Gaussians, captured once at
    the PBR transition (reference get_knn_3, gaussian_model.py:175-177)."""
    far = torch.where(state.alive[:, None], state.params.xyz.detach(),
                      torch.full_like(state.params.xyz, 1e6))
    _, idx = knn(far, far, k=3, exclude_self=True)
    return idx.long()


def compute_losses_pbr(out, batch: TrainBatch, light_params: dict, albedo_pts: torch.Tensor,
                       rough_pts: torch.Tensor, alive_f: torch.Tensor, knn3: torch.Tensor,
                       view_dirs: torch.Tensor, brdf_lut: torch.Tensor,
                       lpips_fn: Callable | None = None, prefilter_w: dict | None = None):
    """Branch-B total loss and its metrics. Weights parity: train.py:316-363.

    albedo_pts / rough_pts are the activated per-point materials [cap, 3] /
    [cap, 1], alive_f the float alive mask, knn3 the neighbour ids."""
    light = build_mips(light_params, prefilter_w)
    roughness_img = out.roughness[..., None] * (R_MAX - R_MIN) + R_MIN

    planes = lambda img: tuple(img[..., c] for c in range(3))   # noqa: E731
    pbr = pbr_shading_planar(
        light=light,
        normals=tuple((p * 2.0 - 1.0).detach() for p in planes(out.world_normal)),
        view_dirs=planes(view_dirs),
        albedo=planes(out.albedo),
        roughness=out.roughness * (R_MAX - R_MIN) + R_MIN,
        mask=out.render_alpha,
        occlusion=out.occlusion[..., 0],
        brdf_lut=brdf_lut,
    )
    rgb = torch.stack(pbr["render_rgb"], dim=-1)

    bm = batch.bound_mask.float()
    ll1 = L.masked_l1(rgb, batch.gt_image, bm)
    ssim_val = L.ssim(rgb, batch.gt_image, bm)
    lpips_val = lpips_fn(rgb, batch.gt_image) if lpips_fn else torch.zeros((), device=rgb.device)

    brdf_img = torch.cat([out.albedo, roughness_img], dim=-1)
    brdf_tv = L.masked_tv_loss(out.render_alpha, brdf_img)
    entropy = L.gaussian_entropy(out.albedo) + L.gaussian_entropy(roughness_img)

    n1, n2 = knn3[:, 1], knn3[:, 2]
    smooth = (L.relative_smooth_loss(gather_rows(albedo_pts, n1),
                                     gather_rows(albedo_pts, n2)[:, None, :], alive_f)
              + L.relative_smooth_loss(gather_rows(rough_pts, n1),
                                       gather_rows(rough_pts, n2)[:, None, :], alive_f))

    covered = (out.render_alpha > 0).float()
    lamb = ((1.0 - roughness_img[..., 0]) * covered).sum() / torch.clamp(covered.sum(), min=1.0)

    env_tv = L.tv_loss(export_envmap(light_params, 64, 128))

    total = (ll1 + 0.01 * (1.0 - ssim_val) + 0.01 * lpips_val + 1.0 * brdf_tv
             + 5.0e-5 * entropy + 0.1 * smooth + 0.001 * lamb + 0.01 * env_tv)
    metrics = {
        "loss": total, "l1": ll1, "ssim": ssim_val,
        "lpips_term": lpips_val,   # the loss term, whatever backbone lpips_fn uses
        "brdf_tv": brdf_tv, "entropy": entropy, "smooth": smooth, "lamb": lamb,
        "env_tv": env_tv, "psnr": L.psnr(rgb, batch.gt_image),
    }
    return total, {k: v.detach() for k, v in metrics.items()}


def make_pbr_train_step(smpl_model: SMPLModel, tx: Adam, light_tx: LightAdam,
                        cfg: OptimizationConfig, raster_config: RasterizerConfig,
                        bg: torch.Tensor, lpips_fn: Callable | None = None):
    """The branch-B step:
    step(ts, pbr_state, batch, knn3, occlusion_color, prefilter_w,
    active_sh_degree) -> (new ts, new pbr_state, metrics). The inputs are not
    modified. `step.loss_and_grads(...)` (same arguments) is its first half:
    (loss, metrics, {"albedo", "roughness", "light"} gradients)."""
    brdf_lut = get_brdf_lut(bg.device)

    def loss_and_grads(ts: TrainState, pbr_state: PbrState, batch: TrainBatch,
                       knn3: torch.Tensor, occlusion_color: torch.Tensor, prefilter_w: dict,
                       active_sh_degree: int):
        g = ts.gauss.params
        albedo = g.albedo.detach().requires_grad_(True)
        roughness = g.roughness.detach().requires_grad_(True)
        base = pbr_state.light["base"].detach().requires_grad_(True)
        params = G.GaussianParams(*(x.detach() for x in g))._replace(albedo=albedo,
                                                                     roughness=roughness)
        mlps = tree_map(torch.Tensor.detach, {"pose_refiner": ts.pose_refiner,
                                              "lbs_offset": ts.lbs_offset})
        with exact_convs():
            out = render_frame(ts.gauss._replace(params=params), batch.camera, batch.frame,
                               smpl_model, bg=bg, active_sh_degree=active_sh_degree,
                               mlp_params=mlps, config=raster_config,
                               occlusion_color=occlusion_color)
            total, metrics = compute_losses_pbr(
                out, batch, {"base": base}, G.get_albedo(params), G.get_roughness(params),
                ts.gauss.alive.float(), knn3, canonical_view_dirs(batch.camera), brdf_lut,
                lpips_fn, prefilter_w)
            grads = torch.autograd.grad(total, (albedo, roughness, base))
        return total.detach(), metrics, dict(zip(("albedo", "roughness", "light"), grads))

    def step(ts: TrainState, pbr_state: PbrState, batch: TrainBatch, knn3: torch.Tensor,
             occlusion_color: torch.Tensor, prefilter_w: dict, active_sh_degree: int):
        _, metrics, grads = loss_and_grads(ts, pbr_state, batch, knn3, occlusion_color,
                                           prefilter_w, active_sh_degree)
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
        # clamp_ parity (train.py:423): the light stays non-negative
        new_pbr = PbrState(light={"base": torch.clamp(new_lv["light"]["base"], min=0.0)},
                           volumes=pbr_state.volumes._replace(coefficients=new_lv["volumes"]),
                           opt_state=light_state)
        new_ts = TrainState(gauss=ts.gauss._replace(params=new_params.gaussians),
                            pose_refiner=new_params.pose_refiner,
                            lbs_offset=new_params.lbs_offset, opt_state=opt_state,
                            step=ts.step + 1)
        return new_ts, new_pbr, metrics

    step.loss_and_grads = loss_and_grads
    return step


def _pose_for_bake(ts: TrainState, batch: TrainBatch, smpl_model: SMPLModel):
    """The bake's inputs for one camera's frame: posed means, covariances,
    opacities and world normals. Geometry is frozen in branch B, so these
    are per-camera constants."""
    p = ts.gauss.params
    with torch.no_grad():
        out = render_frame(ts.gauss, batch.camera, batch.frame, smpl_model,
                           bg=torch.zeros(3, device=p.xyz.device), active_sh_degree=0,
                           mlp_params={"pose_refiner": ts.pose_refiner,
                                       "lbs_offset": ts.lbs_offset})
        return (rot_apply(out.transforms, p.xyz) + out.translation,
                G.get_covariance6(p, 1.0, out.transforms), G.get_opacity(p)[:, 0],
                rot_apply(out.transforms, p.normal))


def train_loop_pbr(ts: TrainState, pbr_state: PbrState, step_fn, batches: list,
                   smpl_model: SMPLModel, cfg: OptimizationConfig, *, start_iteration: int,
                   num_iterations: int, max_sh_degree: int = 3, seed: int = 0,
                   bake_height: int = 16, bake_width: int = 32, bake_max_cells: int = 128,
                   bake_full_coverage: bool = True, callback: Callable | None = None,
                   sharding=None):
    """The branch-B loop (train.py iter > pbr_iteration), the JAX loop's
    non-chunked branch: views in the order of np.random.RandomState(seed + 7);
    each camera's per-Gaussian occlusion maps are baked on its first visit
    (view.set_occlusion parity, gaussian_renderer/__init__.py:152-160) and
    cached as uint8 (round half to even; 1/255 steps, below the blend's own
    alpha cutoff), then modulated by the current grayscale envmap each step
    (train.py:196-198).

    bake_full_coverage (default) sweeps every occupied voxel in
    `bake_max_cells` windows (reference parity, baking.py:145-202), so
    bake_out_of_budget stays 0; False bakes one window and counts the
    Gaussians it leaves out. callback(it, ts, pbr_state, metrics) runs after
    every iteration; metrics carry `bake_out_of_budget`, summed over bakes.
    Returns (ts, pbr_state, metrics).

    With `sharding` (parallel/mesh.py::StateSharding, a multi-rank run),
    `ts` is this rank's share of the state (a `Sharded`) in and out, as
    `step_fn` and `callback` take it: the KNN neighbours and each bake read
    the gathered whole state, and a bake's cache keeps this rank's rows, so
    `step_fn` gets the occlusion colour of its capacity slice."""
    host_rng = np.random.RandomState(seed + 7)
    dev = pbr_state.light["base"].device
    prefilter_w = prefilter_weight_set(pbr_state.light["base"].shape[1], dev)

    def whole(ts):
        return ts if sharding is None else sharding.gather(ts)

    knn3 = compute_knn3(whole(ts).gauss)
    stack: list = []
    metrics: dict = {}
    bake_oob_total = 0
    occ_cache: dict = {}          # camera index -> uint8 [cap or c, H, W, 1]

    def ensure_baked(bi):
        nonlocal bake_oob_total
        if bi in occ_cache:
            return
        w = whole(ts)
        m, c6, op, wn = _pose_for_bake(w, batches[bi], smpl_model)
        kw = dict(height=bake_height, width=bake_width)
        if bake_full_coverage:
            occ, oob, _ = baking.bake_occlusion_full(m, c6, op, wn, w.gauss.alive,
                                                     sweep_cells=bake_max_cells, **kw)
        else:
            occ, oob = baking.bake_occlusion(m, c6, op, wn, w.gauss.alive,
                                             max_cells=bake_max_cells, **kw)
        bake_oob_total += int(oob)
        occ = torch.round(occ * 255.0).to(torch.uint8)
        occ_cache[bi] = occ if sharding is None else \
            sharding.shard(occ, w.gauss.capacity).local

    def pick_index():
        nonlocal stack
        if not stack:
            stack = list(range(len(batches)))
        return stack.pop(host_rng.randint(len(stack)))

    for it in range(start_iteration + 1, start_iteration + num_iterations + 1):
        deg = min(it // 1000, max_sh_degree)
        bi = pick_index()
        ensure_baked(bi)
        with torch.no_grad():
            env = export_envmap(pbr_state.light, bake_height, bake_width)
            occ_col = baking.occlusion_color(occ_cache[bi].float() * (1.0 / 255.0),
                                             env.mean(dim=-1, keepdim=True))
        ts, pbr_state, metrics = step_fn(ts, pbr_state, batches[bi], knn3, occ_col,
                                         prefilter_w, deg)
        metrics = dict(metrics, bake_out_of_budget=bake_oob_total)
        if callback is not None:
            callback(it, ts, pbr_state, metrics)
    return ts, pbr_state, metrics
