"""Per-group Adam over fixed-capacity tensors (port of train/optim.py).

The reference runs one Adam (eps 1e-15) with named parameter groups, xyz on
an exponential-decay schedule scaled by the scene extent, and rebuilds
optimizer state surgically on densify events. Here the scene lives in
fixed-capacity tensors, so the optimizer is functional: `Adam.step` maps
(params, grads, state) to new ones, and densify events zero the moments of
rewritten slots (`reset_adam_slots`), which is what the reference's
zero-initialised appended moments amount to. `torch.optim` is not used: it
cannot reset moments per slot.

Each group is optax's `chain(scale_by_adam(b1=0.9, b2=0.999, eps), -lr)`:
  mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  count += 1
  p += -lr (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
with a step count per group, kept on the host. xyz's lr is `expon_lr` of
its group's count before the update.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from mygauhuman_torch.config import OptimizationConfig
from mygauhuman_torch.models.gaussians import GaussianParams

B1, B2 = 0.9, 0.999

# Gaussian leaf -> optimizer group (gaussian_model.py:266-282)
GAUSS_GROUPS = {
    "xyz": "xyz", "features_dc": "f_dc", "features_rest": "f_rest",
    "scaling": "scaling", "rotation": "rotation", "opacity": "opacity",
    "normal": "normal", "albedo": "albedo", "roughness": "roughness",
}
MLP_GROUPS = {"pose_refiner": "pose_decoder", "lbs_offset": "lweight_offset_decoder"}


class TrainableParams(NamedTuple):
    """The trainable tree: scene params + the correction MLPs (dicts)."""

    gaussians: GaussianParams
    pose_refiner: Any
    lbs_offset: Any


class AdamState(NamedTuple):
    count: dict          # group -> completed updates (host int)
    mu: TrainableParams  # first moments, the params' structure
    nu: TrainableParams  # second moments


def tree_map(fn, *trees):
    """Map fn over the tensor leaves of matching NamedTuple / dict / list trees."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if hasattr(t0, "_fields"):
        return type(t0)(*(tree_map(fn, *leaves) for leaves in zip(*trees)))
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *leaves) for leaves in zip(*trees))
    raise TypeError(f"not a tree node: {type(t0)}")


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def expon_lr(step: int, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000) -> float:
    """Log-lerp LR schedule (utils/general_utils.py:29-62)."""
    if lr_init <= 0.0:
        return 0.0
    t = min(max(step / max_steps, 0.0), 1.0)
    log_lerp = math.exp(math.log(lr_init) * (1.0 - t) + math.log(max(lr_final, 1e-30)) * t)
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay = 1.0
    return delay * log_lerp


class Adam(NamedTuple):
    """The per-group optimizer (the LR table of gaussian_model.py:266-282)."""

    cfg: OptimizationConfig
    spatial_lr_scale: float = 1.0

    def lr(self, group: str, count: int) -> float:
        cfg = self.cfg
        if group == "xyz":
            return expon_lr(count, cfg.position_lr_init * self.spatial_lr_scale,
                            cfg.position_lr_final * self.spatial_lr_scale,
                            lr_delay_mult=cfg.position_lr_delay_mult,
                            max_steps=cfg.position_lr_max_steps)
        return {
            "f_dc": cfg.feature_lr, "f_rest": cfg.feature_lr / 20.0,
            "opacity": cfg.opacity_lr, "scaling": cfg.scaling_lr,
            "rotation": cfg.rotation_lr, "normal": cfg.normal_lr,
            "albedo": cfg.opacity_lr, "roughness": cfg.opacity_lr,   # as the reference
            "pose_decoder": cfg.pose_refine_lr,
            "lweight_offset_decoder": cfg.lbs_offset_lr,
        }[group]

    def init(self, params: TrainableParams) -> AdamState:
        zeros = tree_map(torch.zeros_like, params)
        return AdamState(count={g: 0 for g in (*GAUSS_GROUPS.values(), *MLP_GROUPS.values())},
                         mu=zeros, nu=tree_map(torch.zeros_like, params))

    def _leaf(self, p, g, mu, nu, lr, count):
        mu = (1 - B1) * g + B1 * mu
        nu = (1 - B2) * (g * g) + B2 * nu
        bc1 = float(1 - np.float32(B1) ** count)     # float32, as optax's decay**count
        bc2 = float(1 - np.float32(B2) ** count)
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.cfg.adam_eps)
        return p + (-lr) * upd, mu, nu

    def step(self, params: TrainableParams, grads: TrainableParams,
             state: AdamState) -> tuple[TrainableParams, AdamState]:
        """One update of every group -> (new params, new state)."""
        count = dict(state.count)
        new_p, new_mu, new_nu = {}, {}, {}
        for field, group in GAUSS_GROUPS.items():
            lr = self.lr(group, count[group])
            count[group] += 1
            new_p[field], new_mu[field], new_nu[field] = self._leaf(
                getattr(params.gaussians, field), getattr(grads.gaussians, field),
                getattr(state.mu.gaussians, field), getattr(state.nu.gaussians, field),
                lr, count[group])
        out = {"gaussians": tuple(GaussianParams(**d) for d in (new_p, new_mu, new_nu))}
        for field, group in MLP_GROUPS.items():
            lr = self.lr(group, count[group])
            count[group] += 1
            tree = getattr(params, field)
            leaves = []
            tree_map(lambda p, g, m, v: leaves.append(self._leaf(p, g, m, v, lr, count[group])),
                     tree, getattr(grads, field), getattr(state.mu, field),
                     getattr(state.nu, field))
            its = [iter([leaf[i] for leaf in leaves]) for i in range(3)]
            out[field] = tuple(tree_map(lambda _, it=it: next(it), tree) for it in its)
        trees = [TrainableParams(**{f: out[f][i] for f in TrainableParams._fields})
                 for i in range(3)]
        return trees[0], AdamState(count=count, mu=trees[1], nu=trees[2])


def _map_gauss_moments(state: AdamState, fn) -> AdamState:
    """Apply fn to every per-Gaussian moment tensor (both moments)."""
    def one(m: TrainableParams) -> TrainableParams:
        return m._replace(gaussians=GaussianParams(*map(fn, m.gaussians)))

    return state._replace(mu=one(state.mu), nu=one(state.nu))


def reset_adam_slots(state: AdamState, written: torch.Tensor, capacity: int) -> AdamState:
    """Zero the per-Gaussian moment rows of densify-rewritten slots
    (fresh moments, as the reference's appended tensors get)."""
    def reset(m):
        if m.shape[0] != capacity:
            raise ValueError(f"moment rows {m.shape[0]} != capacity {capacity}")
        mask = written.reshape((capacity,) + (1,) * (m.dim() - 1))
        return torch.where(mask, torch.zeros_like(m), m)

    return _map_gauss_moments(state, reset)


def grow_opt_state(state: AdamState, old_capacity: int, new_capacity: int) -> AdamState:
    """Zero-pad the per-Gaussian moment rows to a larger capacity."""
    if new_capacity < old_capacity:
        raise ValueError(f"grow_opt_state cannot shrink {old_capacity} -> {new_capacity}")

    def grow(m):
        pad = m.new_zeros((new_capacity - old_capacity,) + tuple(m.shape[1:]))
        return torch.cat([m, pad], dim=0)

    return _map_gauss_moments(state, grow)


def geometry_freeze_mask(params: TrainableParams, frozen: bool) -> TrainableParams:
    """Gradient multipliers: 0 for geometry when `frozen` (xyz, features,
    opacity, scaling, rotation and both MLPs, gaussian_model.py:289-307);
    normal, albedo and roughness stay live."""
    dead = 0.0 if frozen else 1.0
    live_fields = ("normal", "albedo", "roughness")
    gmask = GaussianParams(**{f: 1.0 if f in live_fields else dead
                              for f in GaussianParams._fields})
    return TrainableParams(gaussians=gmask,
                           pose_refiner=tree_map(lambda _: dead, params.pose_refiner),
                           lbs_offset=tree_map(lambda _: dead, params.lbs_offset))


def reset_opacity_moments(state: AdamState) -> AdamState:
    """Zero the opacity group's moments after an opacity reset (the
    reference's replace_tensor_to_optimizer); its count is kept."""
    g_mu, g_nu = state.mu.gaussians, state.nu.gaussians
    return state._replace(
        mu=state.mu._replace(gaussians=g_mu._replace(opacity=torch.zeros_like(g_mu.opacity))),
        nu=state.nu._replace(gaussians=g_nu._replace(opacity=torch.zeros_like(g_nu.opacity))))
