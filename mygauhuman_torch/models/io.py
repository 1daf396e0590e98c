"""Gaussian scene <-> PLY (port of models/io.py).

Attribute layout: x, y, z, nx, ny, nz, ar, ag, ab, roughness, f_dc_*,
f_rest_* (channel-major), opacity, scale_0..2, rot_0..3. Only alive
Gaussians are written; loading re-pads to a power-of-two capacity. A PLY
written by either package loads in the other to identical arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from mygauhuman_torch.device import DEFAULT_DEVICE, resolve_device
from mygauhuman_torch.models.gaussians import (
    DEAD_FILLS,
    GaussianParams,
    GaussianState,
    _round_capacity,
)
from mygauhuman_torch.utils.ply import read_ply, write_ply


def save_ply(state: GaussianState, path: str) -> None:
    alive = state.alive.detach().cpu().numpy()
    p = state.params

    def take(x):
        return x.detach().cpu().numpy()[alive]

    xyz = take(p.xyz)
    n = xyz.shape[0]
    f_dc = take(p.features_dc).transpose(0, 2, 1).reshape(n, -1)
    f_rest = take(p.features_rest).transpose(0, 2, 1).reshape(n, -1)
    names = (
        ["x", "y", "z", "nx", "ny", "nz", "ar", "ag", "ab", "roughness"]
        + [f"f_dc_{i}" for i in range(f_dc.shape[1])]
        + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    cols = np.concatenate(
        [xyz, take(p.normal), take(p.albedo), take(p.roughness), f_dc, f_rest,
         take(p.opacity), take(p.scaling), take(p.rotation)], axis=1)
    write_ply(path, names, cols)


def load_ply(path: str, sh_degree: int = 3,
             device: str | torch.device = DEFAULT_DEVICE) -> GaussianState:
    dev = resolve_device(device)
    d = read_ply(path)
    n = d["x"].shape[0]
    cap = _round_capacity(n)
    rest_total = ((sh_degree + 1) ** 2 - 1) * 3

    def cols(prefix, count):
        return np.stack([d[f"{prefix}{i}"] for i in range(count)], axis=1)

    arrays = {
        "xyz": np.stack([d["x"], d["y"], d["z"]], axis=1),
        "normal": np.stack([d["nx"], d["ny"], d["nz"]], axis=1),
        "albedo": np.stack([d["ar"], d["ag"], d["ab"]], axis=1),
        "roughness": d["roughness"][:, None],
        "features_dc": cols("f_dc_", 3).reshape(n, 3, 1).transpose(0, 2, 1),
        "features_rest": cols("f_rest_", rest_total).reshape(n, 3, rest_total // 3)
                                                    .transpose(0, 2, 1),
        "opacity": d["opacity"][:, None],
        "scaling": cols("scale_", 3),
        "rotation": cols("rot_", 4),
    }

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return torch.as_tensor(out, device=dev)

    params = GaussianParams(**{f: pad(arrays[f], DEAD_FILLS.get(f, 0.0))
                               for f in GaussianParams._fields})
    params.rotation[n:, 0] = 1.0
    return GaussianState(
        params=params,
        alive=torch.arange(cap, device=dev) < n,
        smpl_normal=pad(arrays["normal"]),
        xyz_grad_accum=torch.zeros(cap, dtype=torch.float32, device=dev),
        denom=torch.zeros(cap, dtype=torch.float32, device=dev),
        max_radii2d=torch.zeros(cap, dtype=torch.float32, device=dev),
    )
