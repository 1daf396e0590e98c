"""Branch B of the system under test, as `program.py` is branch A's: the
one other module of the benchmark that imports `mygauhuman_torch`. It
wraps the inputs in the port's types and calls `cli.train`'s branch-B
entry points (`create_pbr_state`, `make_pbr_train_step(..., donate=True)`,
`train_loop_pbr`), and reads the program's own bake phases and counters.
"""
from __future__ import annotations

import sys

import torch

from mygauhuman_torch.config import OptimizationConfig
from mygauhuman_torch.models.gaussians import GaussianParams
from mygauhuman_torch.occlusion import baking
from mygauhuman_torch.train.optim import GROUPS, AdamState, TrainableParams
from mygauhuman_torch.train.pbr import create_pbr_state, make_pbr_train_step, train_loop_pbr
from mygauhuman_torch.train.trainer import TrainBatch, create_train_state
from port_bench.harness import program as P
from port_bench.reference.train import unflatten_mlp

GEOMETRY = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


def bakes_every_instance() -> bool:
    """Whether the program's bake keeps every Gaussian in a face's tile
    lists (`occlusion/baking.py::bake_config`), as the configuration
    states; an older program keeps 256 per tile."""
    return hasattr(baking, "bake_config")


def trainable(flat: dict) -> TrainableParams:
    """The port's tree of a flat {`gaussians.<field>`, MLP leaf: tensor}."""
    g = GaussianParams(**{f: flat[f"gaussians.{f}"] for f in GaussianParams._fields})
    return TrainableParams(g, unflatten_mlp("pose_refiner", flat),
                           unflatten_mlp("lbs_offset", flat))


def phases() -> dict | None:
    """The program's bake phases and counters so far ({bake_s, bakes,
    sweeps, faces}); None where the program keeps none."""
    profiling = sys.modules.get("mygauhuman_torch.utils.profiling")
    phases_, counters = (getattr(profiling, n, None) for n in ("PHASES", "COUNTERS"))
    if phases_ is None or counters is None:
        return None
    return {"bake_s": phases_.totals.get("mgh.pbr.bake", 0.0),
            "bakes": phases_.counts.get("mgh.pbr.bake", 0),
            "sweeps": counters.get("mgh.pbr.sweeps", 0),
            "faces": counters.get("mgh.pbr.faces", 0)}


class PbrTrainer:
    """`cli.train`'s branch B on the handed inputs: the TrainState of the
    start (its parameters, Adam moments and counts), the light, the
    donated (graphed) branch-B step with the raster settings and the
    whole-frame LPIPS, and `train_loop_pbr` over the views with the bake
    settings of the configuration."""

    def __init__(self, inp: dict):
        self.inp = inp
        self.model = P.smpl_model(inp["scene"].body)
        self.cfg = OptimizationConfig(**inp["optim"])
        self.raster = P.raster_config(inp["raster"])
        self.lpips = P.lpips_fn(inp["lpips"])
        self.bg = inp["bg"]
        self.batches = [TrainBatch(camera=P.camera(v["camera"]), frame=P.frame(v["frame"]),
                                   gt_image=v["gt_image"], gt_normal=v["gt_normal"],
                                   bkgd_mask=v["bkgd_mask"], bound_mask=v["bound_mask"])
                        for v in inp["views"]]

    def subject(self):
        """A fresh (TrainState, PbrState, donated step) from the start."""
        s = self.inp["start"]
        mlps = {k: unflatten_mlp(k, s["params"]) for k in ("pose_refiner", "lbs_offset")}
        params = {f: s["params"][f"gaussians.{f}"] for f in GaussianParams._fields}
        ts, tx = create_train_state(self.cfg, P.gaussian_state(params, s["alive"]),
                                    P.clone_tree(mlps["pose_refiner"]),
                                    P.clone_tree(mlps["lbs_offset"]))
        moments = [trainable({k: v.clone() for k, v in s[m].items()}) for m in ("mu", "nu")]
        ts = ts._replace(step=s["iteration"],
                         opt_state=AdamState(count={g: s["iteration"] for g in GROUPS},
                                             mu=moments[0], nu=moments[1]))
        pbr_state, light_tx = create_pbr_state(self.cfg, base_res=self.inp["pbr"]["light_res"],
                                               device=s["alive"].device)
        step = make_pbr_train_step(self.model, tx, light_tx, self.cfg, self.raster, bg=self.bg,
                                   lpips_fn=self.lpips, donate=True)
        return ts, pbr_state, step

    def loop(self, ts, pbr_state, step, **kw):
        b = self.inp["pbr"]
        return train_loop_pbr(ts, pbr_state, step, self.batches, self.model, self.cfg,
                              start_iteration=self.inp["start"]["iteration"],
                              max_sh_degree=self.inp["sh_degree"],
                              bake_height=b["map_height"], bake_width=b["map_width"],
                              bake_max_cells=b["sweep_cells"], bake_full_coverage=True,
                              occ_budget_mb=b["occ_budget_mb"], **kw)


def geometry(ts) -> dict:
    """Copies of the leaves branch B keeps: the Gaussians' geometry and
    appearance, and both MLPs (flat names)."""
    flat = P.flat_leaves(P.trainable_params(ts))
    return {k: v.detach().clone() for k, v in flat.items()
            if k.split(".")[0] != "gaussians" or k.split(".")[1] in GEOMETRY}


def materials(ts, pbr_state) -> dict:
    """Copies of what a branch-B step moves: albedo, roughness, normals
    (by momentum) and the light's base."""
    g = ts.gauss.params
    return {"albedo": g.albedo.detach().clone(), "roughness": g.roughness.detach().clone(),
            "normal": g.normal.detach().clone(),
            "light": pbr_state.light["base"].detach().clone()}


def first_gradient(ts, pbr_state) -> dict:
    """The first step's gradients of the albedo, the roughness and the
    light, from Adam's first moments after it (their moments start at 0)."""
    mu = ts.opt_state.mu.gaussians
    return {"albedo": mu.albedo.detach().clone() / (1 - P.B1),
            "roughness": mu.roughness.detach().clone() / (1 - P.B1),
            "light": pbr_state.opt_state.mu["light"]["base"].detach().clone() / (1 - P.B1)}


def cuda_build() -> None:
    P.cuda_lib.build()


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
