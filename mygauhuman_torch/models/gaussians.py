"""Gaussian scene model: fixed-capacity tensors + an alive mask.

Port of the serving part of models/gaussians.py: the state tuples, the
activations and getters, `create_from_pcd`, `grow_capacity` and
`compact_state`. Dead slots carry safe fills (log-scale -10, opacity
logit -10, unit quaternion) and are masked by `alive` in the rasterizer.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mygauhuman_torch.device import DEFAULT_DEVICE, resolve_device
from mygauhuman_torch.ops.knn import mean_knn_dist2
from mygauhuman_torch.ops.sh import num_sh_coeffs, rgb2sh
from mygauhuman_torch.utils.transforms import (
    covariance6_from_scaling_rotation,
    inverse_sigmoid,
    quat_to_rotmat_cols,
)

# leaf -> fill of a dead slot (0 elsewhere; rotation gets a unit quaternion)
DEAD_FILLS = {"scaling": -10.0, "opacity": -10.0}


class GaussianParams(NamedTuple):
    """Trainable per-Gaussian parameters (raw, pre-activation). [cap, ...]"""

    xyz: torch.Tensor            # [cap, 3] canonical big-pose positions
    features_dc: torch.Tensor    # [cap, 1, 3] SH DC
    features_rest: torch.Tensor  # [cap, (deg+1)^2-1, 3]
    scaling: torch.Tensor        # [cap, 3] log-scale
    rotation: torch.Tensor       # [cap, 4] unnormalized quaternion (w,x,y,z)
    opacity: torch.Tensor        # [cap, 1] logit
    normal: torch.Tensor         # [cap, 3] canonical normals
    albedo: torch.Tensor         # [cap, 3] logit
    roughness: torch.Tensor      # [cap, 1] logit


class GaussianState(NamedTuple):
    """Scene state: params + alive mask + densification statistics."""

    params: GaussianParams
    alive: torch.Tensor           # [cap] bool
    smpl_normal: torch.Tensor     # [cap, 3]
    xyz_grad_accum: torch.Tensor  # [cap]
    denom: torch.Tensor           # [cap]
    max_radii2d: torch.Tensor     # [cap]

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]


def get_scaling(p: GaussianParams) -> torch.Tensor:
    # the clamp to [-15, 8] only guards against inf covariances
    return torch.exp(torch.clamp(p.scaling, -15.0, 8.0))


def get_opacity(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.opacity)


def get_albedo(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.albedo)


def get_roughness(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.roughness)


def get_features(p: GaussianParams) -> torch.Tensor:
    """[cap, (deg+1)^2, 3] concatenated SH features."""
    return torch.cat([p.features_dc, p.features_rest], dim=1)


def get_covariance6(p: GaussianParams, scaling_modifier: float = 1.0,
                    transforms: torch.Tensor | None = None) -> torch.Tensor:
    """Symmetric 6-vector covariance, optionally LBS-conjugated (T S T^T)."""
    return covariance6_from_scaling_rotation(get_scaling(p), p.rotation,
                                             scaling_modifier, transforms)


def get_minimum_axis(p: GaussianParams) -> torch.Tensor:
    """Unit axis (rotation column) of the smallest scale."""
    scales = get_scaling(p)
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = quat_to_rotmat_cols(p.rotation)
    idx = torch.argmin(scales, dim=-1)
    pick0 = idx == 0
    pick1 = idx == 1

    def col(c0, c1, c2):
        return torch.where(pick0, c0, torch.where(pick1, c1, c2))

    return torch.stack([col(r00, r01, r02), col(r10, r11, r12), col(r20, r21, r22)],
                       dim=-1)


def flip_align_view(normal: torch.Tensor, viewdir: torch.Tensor):
    """Flip normals to face the viewer; returns (flipped, positive_mask)."""
    positive = (normal * (-viewdir)).sum(dim=-1, keepdim=True) >= 0.0
    return torch.where(positive, normal, -normal), positive


def _round_capacity(n: int) -> int:
    cap = 1024
    while cap < n:
        cap *= 2
    return cap


def _pad_rows(x: torch.Tensor, cap: int, fill: float = 0.0) -> torch.Tensor:
    pad = torch.full((cap - x.shape[0],) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=0)


def _unit_quat_rows(rotation: torch.Tensor, n: int) -> torch.Tensor:
    rotation = rotation.clone()
    rotation[n:, 0] = 1.0
    return rotation


def create_from_pcd(
    points: np.ndarray,
    colors: np.ndarray,
    normals: np.ndarray,
    sh_degree: int = 3,
    capacity: int | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> GaussianState:
    """Init the scene from a point cloud: colours to SH DC, scales from the
    log sqrt mean 3-NN squared distance, identity quaternions, opacity 0.1,
    albedo / roughness logits 1."""
    dev = resolve_device(device)
    n = points.shape[0]
    cap = capacity if capacity is not None else _round_capacity(n)
    rest = num_sh_coeffs(sh_degree) - 1
    f32 = torch.float32

    pts = torch.tensor(np.asarray(points, np.float32), device=dev)
    dist2 = torch.clamp(mean_knn_dist2(pts, k=3), min=1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    fdc = rgb2sh(torch.tensor(np.asarray(colors, np.float32), device=dev))[:, None, :]
    quats = torch.cat([torch.ones((n, 1), dtype=f32, device=dev),
                       torch.zeros((n, 3), dtype=f32, device=dev)], dim=1)
    opac = inverse_sigmoid(0.1 * torch.ones((n, 1), dtype=f32, device=dev))
    nrm = torch.tensor(np.asarray(normals, np.float32), device=dev)

    params = GaussianParams(
        xyz=_pad_rows(pts, cap),
        features_dc=_pad_rows(fdc, cap),
        features_rest=_pad_rows(torch.zeros((n, rest, 3), dtype=f32, device=dev), cap),
        scaling=_pad_rows(scales, cap, DEAD_FILLS["scaling"]),
        rotation=_unit_quat_rows(_pad_rows(quats, cap), n),
        opacity=_pad_rows(opac, cap, DEAD_FILLS["opacity"]),
        normal=_pad_rows(nrm, cap),
        albedo=_pad_rows(torch.ones((n, 3), dtype=f32, device=dev), cap),
        roughness=_pad_rows(torch.ones((n, 1), dtype=f32, device=dev), cap),
    )
    return GaussianState(
        params=params,
        alive=torch.arange(cap, device=dev) < n,
        smpl_normal=_pad_rows(nrm, cap),
        xyz_grad_accum=torch.zeros(cap, dtype=f32, device=dev),
        denom=torch.zeros(cap, dtype=f32, device=dev),
        max_radii2d=torch.zeros(cap, dtype=f32, device=dev),
    )


def grow_capacity(state: GaussianState, new_capacity: int) -> GaussianState:
    """Pad every leaf to a larger capacity with the dead-slot fills."""
    cap = state.capacity
    if new_capacity < cap:
        raise ValueError(f"grow_capacity cannot shrink {cap} -> {new_capacity}")
    params = GaussianParams(**{
        f: _pad_rows(getattr(state.params, f), new_capacity, DEAD_FILLS.get(f, 0.0))
        for f in GaussianParams._fields
    })
    params = params._replace(rotation=_unit_quat_rows(params.rotation, cap))
    return GaussianState(
        params=params,
        alive=_pad_rows(state.alive, new_capacity, False),
        smpl_normal=_pad_rows(state.smpl_normal, new_capacity),
        xyz_grad_accum=_pad_rows(state.xyz_grad_accum, new_capacity),
        denom=_pad_rows(state.denom, new_capacity),
        max_radii2d=_pad_rows(state.max_radii2d, new_capacity),
    )


def compact_state(state: GaussianState, capacity: int | None = None,
                  multiple: int = 256) -> GaussianState:
    """Repack alive Gaussians to the front of a tight capacity: the next
    `multiple` above the alive count (or above `capacity` when given)."""
    idx = torch.nonzero(state.alive).reshape(-1)
    n = int(idx.numel())
    want = capacity if capacity is not None else n
    cap = max(multiple, -(-want // multiple) * multiple)
    if cap < n:
        raise ValueError(f"capacity {cap} below the {n} alive Gaussians")

    def take(x, fill=0.0):
        out = torch.full((cap,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        out[:n] = x[idx]
        return out

    params = GaussianParams(**{
        f: take(getattr(state.params, f), DEAD_FILLS.get(f, 0.0))
        for f in GaussianParams._fields
    })
    params = params._replace(rotation=_unit_quat_rows(params.rotation, n))
    return GaussianState(
        params=params,
        alive=torch.arange(cap, device=state.alive.device) < n,
        smpl_normal=take(state.smpl_normal),
        xyz_grad_accum=take(state.xyz_grad_accum),
        denom=take(state.denom),
        max_radii2d=take(state.max_radii2d),
    )
