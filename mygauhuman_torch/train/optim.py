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

A captured CUDA graph of the step (train/graph.py) cannot read the host
counts: it bakes in the scalars of the step it captured. So `Adam.step`
also takes the scalars of each group's update as a device tensor
(`staged`, rows of `Adam.staged_rows`), which the graph's caller refills
before every replay; with them the update is bit for bit the one the host
scalars give (`adam_leaf_staged`).
"""
from __future__ import annotations

import dataclasses
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
# every group, in the order of a staged table's rows
GROUPS = (*GAUSS_GROUPS.values(), *MLP_GROUPS.values())
# the columns of a staged row: one update's host scalars as float32
STAGED = ("bc1", "bc2", "neg_lr", "inv_bc1", "inv_bc2")


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
    """Map fn over the tensor leaves of matching NamedTuple / dataclass /
    dict / list trees. A leaf that is not a tensor is kept as it is, and
    must be equal in every tree."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if dataclasses.is_dataclass(t0) and not isinstance(t0, type):
        return dataclasses.replace(t0, **{
            f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)})
    if hasattr(t0, "_fields"):
        return type(t0)(*(tree_map(fn, *leaves) for leaves in zip(*trees)))
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *leaves) for leaves in zip(*trees))
    if any(t != t0 for t in trees[1:]):
        raise ValueError(f"trees differ in a leaf that is not a tensor: {list(trees)}")
    return t0


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_map_with_path(fn, tree, path: tuple = ()):
    """tree_map over the tensor leaves with each leaf's path: the field names
    and dict keys (list positions as ints) from the root down. Dataclasses
    are nodes too; leaves that are not tensors are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map_with_path(fn, getattr(tree, f.name), path + (f.name,))
            for f in dataclasses.fields(tree)})
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return tree


def is_gaussian_path(path) -> bool:
    """True iff a tree path descends through the per-Gaussian subtree (the
    `gaussians` field of TrainableParams and its Adam moments, or a
    TrainState's `gauss`). Matching the path, not only the leading
    dimension, keeps MLP layers as wide as a small capacity (the pose and
    LBS MLPs are 128 wide) from being taken for per-Gaussian rows."""
    return any(name in ("gaussians", "gauss") for name in path)


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


def adam_leaf(p, g, mu, nu, lr: float, count: int, eps: float):
    """One Adam update of a leaf after `count` updates (this one included)
    -> (new p, new mu, new nu)."""
    mu = (1 - B1) * g + B1 * mu
    nu = (1 - B2) * (g * g) + B2 * nu
    bc1 = float(1 - np.float32(B1) ** count)     # float32, as optax's decay**count
    bc2 = float(1 - np.float32(B2) ** count)
    upd = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
    return p + (-lr) * upd, mu, nu


def staged_row(lr: float, count: int) -> np.ndarray:
    """The scalars of one update after `count` updates (this one included)
    as float32, in the columns of STAGED: what `adam_leaf`'s host floats
    become in its kernels."""
    bc1 = np.float32(1 - np.float32(B1) ** count)
    bc2 = np.float32(1 - np.float32(B2) ** count)
    one = np.float32(1.0)
    return np.array([bc1, bc2, np.float32(-lr), one / bc1, one / bc2], np.float32)


def adam_leaf_staged(p, g, mu, nu, row: torch.Tensor, eps: float):
    """`adam_leaf` with its scalars read from `row` ([5] float32 on p's
    device, a `staged_row`), bit for bit: PyTorch's CUDA division by a host
    float multiplies by its float32 reciprocal, so on CUDA the bias
    corrections are products with the staged reciprocals; the CPU divides."""
    mu = (1 - B1) * g + B1 * mu
    nu = (1 - B2) * (g * g) + B2 * nu
    if p.is_cuda:
        upd = (mu * row[3]) / (torch.sqrt(nu * row[4]) + eps)
    else:
        upd = (mu / row[0]) / (torch.sqrt(nu / row[1]) + eps)
    return p + row[2] * upd, mu, nu


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
        return AdamState(count={g: 0 for g in GROUPS},
                         mu=zeros, nu=tree_map(torch.zeros_like, params))

    def staged_rows(self, count: dict, k: int) -> np.ndarray:
        """[k, len(GROUPS), 5] float32: the staged rows of k successive
        updates of every group from the counts `count`."""
        rows = np.zeros((k, len(GROUPS), len(STAGED)), np.float32)
        for gi, group in enumerate(GROUPS):
            for t in range(k):
                c = count[group] + t
                rows[t, gi] = staged_row(self.lr(group, c), c + 1)
        return rows

    def step(self, params: TrainableParams, grads: TrainableParams, state: AdamState,
             groups: tuple | None = None, staged: torch.Tensor | None = None
             ) -> tuple[TrainableParams, AdamState]:
        """One update of every group, or of the named `groups` only (the
        others keep their parameters, moments and count, and their gradients
        are not read) -> (new params, new state). With `staged` ([len(GROUPS),
        5] on the parameters' device, the rows of this update) the scalars
        are read from it instead of being computed from the counts."""
        count = dict(state.count)
        eps = self.cfg.adam_eps

        def leaf_fn(group):
            """The update of one of `group`'s leaves; advances its count."""
            if staged is not None:
                row = staged[GROUPS.index(group)]
                count[group] += 1
                return lambda p, g, m, v: adam_leaf_staged(p, g, m, v, row, eps)
            lr = self.lr(group, count[group])
            count[group] += 1
            c = count[group]
            return lambda p, g, m, v: adam_leaf(p, g, m, v, lr, c, eps)

        new_p, new_mu, new_nu = {}, {}, {}
        for field, group in GAUSS_GROUPS.items():
            p, mu, nu = (getattr(t.gaussians, field) for t in (params, state.mu, state.nu))
            if groups is not None and group not in groups:
                new_p[field], new_mu[field], new_nu[field] = p, mu, nu
                continue
            new_p[field], new_mu[field], new_nu[field] = leaf_fn(group)(
                p, getattr(grads.gaussians, field), mu, nu)
        out = {"gaussians": tuple(GaussianParams(**d) for d in (new_p, new_mu, new_nu))}
        for field, group in MLP_GROUPS.items():
            tree = getattr(params, field)
            if groups is not None and group not in groups:
                out[field] = (tree, getattr(state.mu, field), getattr(state.nu, field))
                continue
            fn = leaf_fn(group)
            leaves = []
            tree_map(lambda p, g, m, v: leaves.append(fn(p, g, m, v)),
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
