"""The system under test: the PyTorch/CUDA port, `mygauhuman_torch`. This is
the one module of the benchmark that imports it; it only wraps the inputs
in the port's types and calls its entry points, as `cli.train` and
`cli.render` call them.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from mygauhuman_torch.config import OptimizationConfig
from mygauhuman_torch.data.camera import Camera
from mygauhuman_torch.eval.lpips import LPIPSParams, lpips_distance
from mygauhuman_torch.models.gaussians import GaussianParams, GaussianState
from mygauhuman_torch.models.smpl import SMPLModel
from mygauhuman_torch.ops import cuda_lib
from mygauhuman_torch.ops.rasterize import RasterizerConfig
from mygauhuman_torch.render.graph import GraphedRenderer
from mygauhuman_torch.render.renderer import FrameInputs
from mygauhuman_torch.train.optim import B1
from mygauhuman_torch.train.trainer import (
    TrainBatch,
    create_train_state,
    make_train_step,
    scene_lpips_crop,
    train_loop,
    trainable_params,
)


def smpl_model(body: dict) -> SMPLModel:
    return SMPLModel(v_template=body["v_template"], shapedirs=body["shapedirs"],
                     posedirs=body["posedirs"], j_regressor=body["j_regressor"],
                     weights=body["weights"], parents=np.asarray(body["parents"], np.int32),
                     faces=np.zeros((0, 3), np.int32))


def camera(c: dict) -> Camera:
    return Camera(w2c=c["w2c"], full_proj=c["full_proj"], cam_center=c["cam_center"],
                  tan_fovx=c["tan_fovx"], tan_fovy=c["tan_fovy"], width=c["width"],
                  height=c["height"])


def frame(f: dict) -> FrameInputs:
    return FrameInputs(smpl_param={k: f[k] for k in ("poses", "shapes", "R", "Th")},
                       big_pose_param=f["big"], big_pose_verts=f["big_verts"])


def gaussian_state(params: dict, alive) -> GaussianState:
    """The port's state of the handed parameters (copies: the program may
    write into its state)."""
    cap = alive.shape[0]
    p = GaussianParams(**{k: v.detach().clone() for k, v in params.items()})
    z = torch.zeros(cap, dtype=torch.float32, device=alive.device)
    return GaussianState(params=p, alive=alive.clone(), smpl_normal=p.normal.clone(),
                         xyz_grad_accum=z, denom=z.clone(), max_radii2d=z.clone())


def clone_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree


def raster_config(r) -> RasterizerConfig:
    return RasterizerConfig(tile_w=r.tile_w, tile_h=r.tile_h,
                            max_tiles_per_gaussian=r.max_tiles_per_gaussian,
                            tile_capacity=r.tile_capacity,
                            instance_capacity=r.instance_capacity)


def lpips_fn(params: dict | None):
    """The LPIPS distance over the handed backbone (the port's
    `lpips_distance`, as its `LPIPS` object calls it)."""
    if params is None:
        return None
    lp = LPIPSParams(convs=tuple({"w": w, "b": b} for w, b in params["convs"]),
                     lins=tuple(params["lins"]))
    return functools.partial(lpips_distance, lp)


def state_rows(ts) -> dict:
    """Copies of what a densify event reads and writes: each per-Gaussian
    parameter (`<field>`), its Adam moments (`mu.<field>`, `nu.<field>`),
    `alive`, `xyz_grad_accum`, `denom`, `max_radii2d`."""
    g = ts.gauss
    out = {f: getattr(g.params, f).detach().clone() for f in GaussianParams._fields}
    for m in ("mu", "nu"):
        moments = getattr(ts.opt_state, m).gaussians
        out.update({f"{m}.{f}": getattr(moments, f).detach().clone()
                    for f in GaussianParams._fields})
    out.update({k: getattr(g, k).detach().clone()
                for k in ("alive", "xyz_grad_accum", "denom", "max_radii2d")})
    return out


def flat_leaves(trainable) -> dict:
    """{name: tensor} of a TrainableParams-shaped tree (params, or an Adam
    moment), named as `reference/train.py` names its leaves."""
    out = {f"gaussians.{f}": getattr(trainable.gaussians, f)
           for f in GaussianParams._fields}
    for prefix in ("pose_refiner", "lbs_offset"):
        tree = getattr(trainable, prefix)
        for i, layer in enumerate(tree["layers"]):
            for k in ("w", "b"):
                out[f"{prefix}.layers.{i}.{k}"] = layer[k]
        if "head" in tree:
            for k in ("w", "b"):
                out[f"{prefix}.head.{k}"] = tree["head"][k]
    return out


class Trainer:
    """`cli.train`'s branch A on the handed inputs: the TrainState from the
    initial Gaussians and MLPs, the donated (graphed) step with the raster
    settings, LPIPS and the crop that `cli.train` picks on these views
    (`scene_lpips_crop`), and `train_loop` over the views."""

    def __init__(self, inp: dict):
        self.model = smpl_model(inp["scene"].body)
        self.cfg = OptimizationConfig(**inp["optim"])
        self.raster = raster_config(inp["raster"])
        self.lpips = lpips_fn(inp["lpips"])
        self.bg = inp["bg"]
        self.inp = inp
        self.batches = [TrainBatch(camera=camera(v["camera"]), frame=frame(v["frame"]),
                                   gt_image=v["gt_image"], gt_normal=v["gt_normal"],
                                   bkgd_mask=v["bkgd_mask"], bound_mask=v["bound_mask"])
                        for v in inp["views"]]
        self.crop = scene_lpips_crop([b.bound_mask for b in self.batches])

    def subject(self):
        """A fresh (TrainState, Adam, donated step) from the same inputs."""
        inp = self.inp
        ts, tx = create_train_state(self.cfg, gaussian_state(inp["init"], inp["alive"]),
                                    clone_tree(inp["mlps"]["pose_refiner"]),
                                    clone_tree(inp["mlps"]["lbs_offset"]))
        step = make_train_step(self.model, tx, self.cfg, self.raster, bg=self.bg,
                               lpips_fn=self.lpips, lpips_crop=self.crop, donate=True)
        return ts, tx, step

    def loop(self, ts, tx, step, **kw):
        scene = self.inp["scene"]
        return train_loop(ts, tx, step, self.batches, self.cfg, extent=scene.extent,
                          smpl_vertices=scene.big_verts, max_sh_degree=self.inp["sh_degree"],
                          **kw)


def renderer(model: dict, body: dict, sh_degree: int, branch: str) -> GraphedRenderer:
    """`cli.render`'s serving of one model: the `GraphedRenderer` of the
    handed state at its SH degree and raster settings (4 instance slots per
    Gaussian slot), on a black background; on the deform branch with the
    model's correction MLPs."""
    mlp = clone_tree(model["mlps"]) if branch == "deform" else None
    return GraphedRenderer(gaussian_state(model["params"], model["alive"]), smpl_model(body),
                           bg=torch.zeros(3, device=model["alive"].device),
                           active_sh_degree=sh_degree, config=raster_config(model["raster"]),
                           mlp_params=mlp)
