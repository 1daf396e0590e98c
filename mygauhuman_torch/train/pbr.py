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

`make_pbr_train_step(..., donate=True)` is the JAX package's jitted step
and its chunk program: a `GraphedPbrStep`, which serves the step from
captured CUDA graphs as `train/graph.py::GraphedTrainStep` serves branch
A's (the state donated, the view and both optimisers' scalars staged per
replay). One graph holds the whole iteration: from the camera's uint8
baked occlusion, the envmap export and `occlusion_color` under the current
light, then the render, the losses, `autograd.grad`, both Adams and the
light's clamp. `step.chunk` replays it once per iteration of a chunk, the
views copied in from a `[V, ...]` stack and each iteration's occlusion from
a slot of a bounded `[K, cap, H, W, 1]` uint8 buffer, with no host sync in
between. `train_loop_pbr(scan_chunk=K)` sizes and fills that buffer as the
JAX loop does (`occ_budget_mb`).

Deliberate differences from the JAX module: the light's Adam is a
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
from mygauhuman_torch.train.graph import GraphedTrainStep, stack_views
from mygauhuman_torch.train.optim import (
    GROUPS,
    Adam,
    TrainableParams,
    adam_leaf,
    adam_leaf_staged,
    staged_row,
    tree_leaves,
    tree_map,
)
from mygauhuman_torch.train.trainer import TrainBatch, TrainState, trainable_params
from mygauhuman_torch.utils.profiling import PHASES, annotate
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

    def staged_rows(self, count: int, k: int) -> np.ndarray:
        """[k, len(STAGED)] float32: the staged rows (train/optim.py::
        staged_row) of k successive updates from `count` completed ones."""
        return np.stack([staged_row(self.lr, count + t + 1) for t in range(k)])

    def step(self, params: dict, grads: dict, state: LightAdamState,
             staged: torch.Tensor | None = None):
        """One update; with `staged` (a [len(STAGED)] row on the parameters'
        device) its scalars are read from it, bit for bit those of the
        host count (`adam_leaf_staged`)."""
        count = state.count + 1
        if staged is None:
            def leaf(p, g, m, v):
                return adam_leaf(p, g, m, v, self.lr, count, LIGHT_ADAM_EPS)
        else:
            def leaf(p, g, m, v):
                return adam_leaf_staged(p, g, m, v, staged, LIGHT_ADAM_EPS)
        out = tree_map(leaf, params, grads, state.mu, state.nu)
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


class PbrInputs(NamedTuple):
    """What one iteration of the graphed step stages: its view and its
    occlusion, a camera's uint8 baked map [cap, H, W, 1] (`step.chunk`) or
    an occlusion colour [cap, 3] (a call of the step)."""

    batch: TrainBatch
    occlusion: torch.Tensor

    @property
    def camera(self):
        return self.batch.camera


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


def baked_occlusion_color(occlusion: torch.Tensor, light: dict) -> torch.Tensor:
    """[cap, 3] occlusion colour of a camera's uint8 baked map [cap, H, W, 1]
    under the light's grayscale envmap (train.py:196-198), without grad."""
    with torch.no_grad():
        env = export_envmap(light, occlusion.shape[1], occlusion.shape[2])
        return baking.occlusion_color(occlusion.float() * (1.0 / 255.0),
                                      env.mean(dim=-1, keepdim=True))


def make_pbr_train_step(smpl_model: SMPLModel, tx: Adam, light_tx: LightAdam,
                        cfg: OptimizationConfig, raster_config: RasterizerConfig,
                        bg: torch.Tensor, lpips_fn: Callable | None = None,
                        donate: bool = False):
    """The branch-B step:
    step(ts, pbr_state, batch, knn3, occlusion_color, prefilter_w,
    active_sh_degree) -> (new ts, new pbr_state, metrics). With donate=False
    the inputs are not modified. With donate=True it is a `GraphedPbrStep`:
    captured CUDA graphs on the card, the eager step with the same staging
    on the CPU; it writes the new states into the tensors of the states it
    returns, so the states passed in are consumed, and it has
    `step.chunk(ts, pbr_state, views, occ_buf, knn3, prefilter_w, idx, bidx,
    active_sh_degree, pad_to)`. `step.loss_and_grads(...)` (the step's
    arguments) is its first half: (loss, metrics, {"albedo", "roughness",
    "light"} gradients); `step.eager` the functional step."""
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

    def update(ts: TrainState, pbr_state: PbrState, batch: TrainBatch, knn3: torch.Tensor,
               occlusion_color: torch.Tensor, prefilter_w: dict, active_sh_degree: int,
               staged: torch.Tensor | None = None):
        """The step; with `staged` (rows of GROUPS, then the light's), both
        optimisers read their scalars from it."""
        _, metrics, grads = loss_and_grads(ts, pbr_state, batch, knn3, occlusion_color,
                                           prefilter_w, active_sh_degree)
        g = ts.gauss.params
        gauss_grads = G.GaussianParams(*(None for _ in g))._replace(
            normal=torch.zeros_like(g.normal), albedo=grads["albedo"],
            roughness=grads["roughness"])
        new_params, opt_state = tx.step(
            trainable_params(ts), TrainableParams(gauss_grads, None, None), ts.opt_state,
            groups=MATERIAL_GROUPS, staged=None if staged is None else staged[:len(GROUPS)])
        vol = pbr_state.volumes.coefficients
        new_lv, light_state = light_tx.step(
            {"light": pbr_state.light, "volumes": vol},
            {"light": {"base": grads["light"]}, "volumes": torch.zeros_like(vol)},
            pbr_state.opt_state, staged=None if staged is None else staged[len(GROUPS)])
        # clamp_ parity (train.py:423): the light stays non-negative
        new_pbr = PbrState(light={"base": torch.clamp(new_lv["light"]["base"], min=0.0)},
                           volumes=pbr_state.volumes._replace(coefficients=new_lv["volumes"]),
                           opt_state=light_state)
        new_ts = TrainState(gauss=ts.gauss._replace(params=new_params.gaussians),
                            pose_refiner=new_params.pose_refiner,
                            lbs_offset=new_params.lbs_offset, opt_state=opt_state,
                            step=ts.step + 1)
        return new_ts, new_pbr, metrics

    def step(ts: TrainState, pbr_state: PbrState, batch: TrainBatch, knn3: torch.Tensor,
             occlusion_color: torch.Tensor, prefilter_w: dict, active_sh_degree: int):
        return update(ts, pbr_state, batch, knn3, occlusion_color, prefilter_w,
                      active_sh_degree)

    def apply(state: tuple, inputs: PbrInputs, active_sh_degree: int,
              staged: torch.Tensor | None = None, frozen: bool | None = None):
        """The graphed program on (ts, pbr_state, knn3, prefilter_w); the
        geometry is always frozen here (`frozen` is not read)."""
        ts, pbr_state, knn3, prefilter_w = state
        occ = inputs.occlusion
        if occ.dtype == torch.uint8:
            occ = baked_occlusion_color(occ, pbr_state.light)
        new_ts, new_pbr, metrics = update(ts, pbr_state, inputs.batch, knn3, occ, prefilter_w,
                                          active_sh_degree, staged)
        return (new_ts, new_pbr, knn3, prefilter_w), metrics

    out = step
    if donate:
        out = GraphedPbrStep(apply, tx, light_tx,
                             instance_capacity=raster_config.instance_capacity)
    out.loss_and_grads = loss_and_grads
    out.eager = step
    return out


class GraphedPbrStep(GraphedTrainStep):
    """The branch-B step served from captured CUDA graphs on the card (run
    eagerly on the CPU): `step(ts, pbr_state, batch, knn3, occlusion_color,
    prefilter_w, deg)` and `step.chunk(ts, pbr_state, views, occ_buf, knn3,
    prefilter_w, idx, bidx, deg, pad_to)`, as the JAX step and its `chunk`.

    `GraphedTrainStep` with another state: the graphs own (ts, pbr_state,
    knn3, prefilter_w) (the last two constant, copied in when the caller
    passes other tensors), each replay stages a `PbrInputs` and one row per
    scene group and one for the light, and a step advances the material
    groups' counts, the light's count and the step (train/graph.py's
    docstring says the rest)."""

    def __init__(self, apply: Callable, tx: Adam, light_tx: LightAdam, *,
                 instance_capacity: int | None):
        super().__init__(apply, tx, frozen_from=0, instance_capacity=instance_capacity)
        self.light_tx = light_tx

    def __call__(self, ts, pbr_state, batch, knn3, occlusion_color, prefilter_w,
                 active_sh_degree: int):
        """One step -> (new ts, new pbr_state, metrics of this call)."""
        inputs = PbrInputs(batch, occlusion_color)
        (ts, pbr_state, _, _), (mseq, _) = self._run(
            (ts, pbr_state, knn3, prefilter_w), [(inputs, tree_leaves(inputs))],
            active_sh_degree, 1)
        return ts, pbr_state, {k: v[0] for k, v in mseq.items()}

    def chunk(self, ts, pbr_state, views, occ_buf, knn3, prefilter_w, idx, bidx,
              active_sh_degree: int, pad_to: int = 0):
        """len(idx) steps, step t on view idx[t] of the stack (train/graph.py::
        stack_views) and the occlusion in slot bidx[t] of occ_buf -> (ts,
        pbr_state, (metrics stacked [max(pad_to, len(idx))], len(idx)))."""
        items = []
        for i, b in zip(idx, bidx):
            occ = occ_buf[b]
            items.append((PbrInputs(views.views[i], occ), [*views.leaves[i], occ]))
        (ts, pbr_state, _, _), out = self._run((ts, pbr_state, knn3, prefilter_w), items,
                                               active_sh_degree, max(pad_to, len(items)))
        return ts, pbr_state, out

    def _staged_rows(self, state, k: int) -> np.ndarray:
        ts, pbr_state = state[:2]
        return np.concatenate([self.tx.staged_rows(ts.opt_state.count, k),
                               self.light_tx.staged_rows(pbr_state.opt_state.count, k)[:, None]],
                              axis=1)

    @staticmethod
    def _train_state(state):
        return state[0]

    def _advanced(self, state, k: int):
        ts, pbr_state, *consts = state
        count = {g: c + k if g in MATERIAL_GROUPS else c for g, c in ts.opt_state.count.items()}
        ts = ts._replace(step=ts.step + k, opt_state=ts.opt_state._replace(count=count))
        light = pbr_state.opt_state
        return (ts, pbr_state._replace(opt_state=light._replace(count=light.count + k)),
                *consts)


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
                   scan_chunk: int = 1, callback_iters: tuple = (),
                   occ_budget_mb: float = 1024.0, sharding=None):
    """The branch-B loop (train.py iter > pbr_iteration), the JAX loop: views
    in the order of np.random.RandomState(seed + 7); each camera's
    per-Gaussian occlusion maps are baked on its first visit
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

    scan_chunk > 1 runs up to that many iterations per call of
    `step_fn.chunk` (make_pbr_train_step(..., donate=True)) on a [V, ...]
    stack of the views, each iteration's occlusion in a slot of a uint8
    [K, cap, H, W, 1] buffer on the device: K = min(scan_chunk, V, the
    cameras that fit in `occ_budget_mb`), a camera placed on its first use
    in a chunk, in a free slot or in that of a camera the chunk does not
    use. A chunk never crosses an SH-degree change or an iteration in
    `callback_iters`, and ends early where its views would need more than
    K cameras; the view sequence is that of scan_chunk=1. The callback
    still fires every iteration, with that iteration's metrics from the
    chunk's buffer (device tensors) and the states at the chunk's end. A
    step_fn without `.chunk` runs one step per call.

    With `sharding` (parallel/mesh.py::StateSharding, a multi-rank run),
    `ts` is this rank's share of the state (a `Sharded`) in and out, as
    `step_fn` and `callback` take it: the KNN neighbours and each bake read
    the gathered whole state, and a bake's cache keeps this rank's rows, so
    `step_fn` gets the occlusion colour of its capacity slice.

    Spans (utils/profiling.py): `mgh.pbr.chunk` around each chunk's call,
    and each camera's bake (its posing, sweeps and rounding) is the phase
    `mgh.pbr.bake` of `PHASES`, which waits for the card at its start and
    its end (the bake waits once anyway, for its occupied-cell count)."""
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
    chunked = scan_chunk > 1 and hasattr(step_fn, "chunk")
    cb_set = {int(i) for i in callback_iters}
    if chunked:
        views = stack_views(batches)
        cap = ts.gauss.capacity
        k_max = max(1, min(scan_chunk, len(batches),
                           int(occ_budget_mb * 1e6) // max(cap * bake_height * bake_width, 1)))
        occ_buf = torch.zeros((k_max, cap, bake_height, bake_width, 1), dtype=torch.uint8,
                              device=dev)
        slot_of: dict = {}        # camera index -> buffer slot

    def ensure_baked(bi):
        nonlocal bake_oob_total
        if bi in occ_cache:
            return
        with PHASES.phase("mgh.pbr.bake", wait=True):
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

    def ensure_in_buffer(bi, keep: set) -> None:
        """Camera bi's map into a free slot of the buffer, or into the slot
        of a camera that the chunk does not use."""
        if bi in slot_of:
            return
        ensure_baked(bi)
        if len(slot_of) < k_max:
            slot = len(slot_of)
        else:
            slot = slot_of.pop(next(k for k in slot_of if k not in keep))
        occ_buf[slot].copy_(occ_cache[bi])
        slot_of[bi] = slot

    def pick_index():
        nonlocal stack
        if not stack:
            stack = list(range(len(batches)))
        return stack.pop(host_rng.randint(len(stack)))

    def chunk_end(it):
        """Last iteration of the chunk from `it` (the JAX loop's rule)."""
        end = min(it + scan_chunk - 1, start_iteration + num_iterations)
        end = min(end, (it // 1000 + 1) * 1000 - 1)     # one SH degree per chunk
        return next((e for e in range(it, end + 1) if e in cb_set), end)

    pending = None    # the view that a chunk left out for want of a slot
    it = start_iteration + 1
    while it <= start_iteration + num_iterations:
        deg = min(it // 1000, max_sh_degree)
        if chunked:
            idx: list = []
            distinct: set = set()
            for _ in range(it, chunk_end(it) + 1):
                bi = pending if pending is not None else pick_index()
                pending = None
                if bi not in distinct and len(distinct) >= k_max:
                    pending = bi       # the next chunk starts with this view
                    break
                distinct.add(bi)
                idx.append(bi)
            for bi in idx:
                ensure_in_buffer(bi, distinct)
            with annotate("mgh.pbr.chunk"):
                ts, pbr_state, (mseq, n) = step_fn.chunk(
                    ts, pbr_state, views, occ_buf, knn3, prefilter_w, idx,
                    [slot_of[bi] for bi in idx], deg, pad_to=scan_chunk)
            for t in range(n):
                metrics = {k: v[t] for k, v in mseq.items()}
                metrics["bake_out_of_budget"] = bake_oob_total
                if callback is not None:
                    callback(it + t, ts, pbr_state, metrics)
            it += n - 1
        else:
            bi = pick_index()
            ensure_baked(bi)
            occ_col = baked_occlusion_color(occ_cache[bi], pbr_state.light)
            ts, pbr_state, metrics = step_fn(ts, pbr_state, batches[bi], knn3, occ_col,
                                             prefilter_w, deg)
            metrics = dict(metrics, bake_out_of_budget=bake_oob_total)
            if callback is not None:
                callback(it, ts, pbr_state, metrics)
        it += 1
    return ts, pbr_state, metrics
