"""Learnable cubemap environment light (port of pbr/light.py; reference
CubemapLight, pbr/light.py:57-149) as a dict of parameters and pure helpers.

State is {"base": [6, R, R, 3]} (trainable). `build_mips` derives the
diffuse irradiance map and the GGX-prefiltered specular chain:
  specular[0..n-2]: roughness ramp MIN..MAX over the avg-pool mip chain
  specular[n-1]:    roughness 1.0 at LIGHT_MIN_RES
as build_mips (pbr/light.py:103-117); `get_mip` maps roughness to a
fractional mip level (pbr/light.py:91-101).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mygauhuman_torch.device import DEFAULT_DEVICE, resolve_device
from mygauhuman_torch.pbr.cubemap import avg_pool_cubemap, cubemap_to_latlong
from mygauhuman_torch.pbr.prefilter import (
    diffuse_cubemap,
    diffuse_weights,
    specular_cubemap,
    specular_weights,
)

LIGHT_MIN_RES = 8
MIN_ROUGHNESS = 0.08
MAX_ROUGHNESS = 0.5


class CubemapLight(NamedTuple):
    """Derived light maps produced by build_mips (not trainable state)."""

    diffuse: torch.Tensor          # [6, R, R, 3]
    specular: tuple                # tuple of [6, r, r, 3], descending res


def init_cubemap_light(base_res: int = 32, init_value: float = 0.5,
                       device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """Trainable light params. Parity: train.py:150 (CubemapLight(base_res=32)
    with uniform 0.5 init)."""
    return {"base": torch.full((6, base_res, base_res, 3), init_value, dtype=torch.float32,
                               device=resolve_device(device))}


def clamp_light(params: dict, min_value: float = 0.0, max_value: float | None = None) -> dict:
    """Post-step projection (reference clamp_, train.py:423)."""
    base = torch.clamp(params["base"], min=min_value)
    if max_value is not None:
        base = torch.clamp(base, max=max_value)
    return {"base": base}


def num_levels(base_res: int) -> int:
    n = 1
    while base_res > LIGHT_MIN_RES:
        base_res //= 2
        n += 1
    return n


def level_roughness(base_res: int) -> list[float]:
    """The per-level GGX roughness schedule (pbr/light.py:103-117)."""
    n = num_levels(base_res)
    ramp = [(idx / max(n - 2, 1)) * (MAX_ROUGHNESS - MIN_ROUGHNESS) + MIN_ROUGHNESS
            for idx in range(n - 1)]
    return ramp + [1.0]


def prefilter_weight_set(base_res: int = 32, device: str | torch.device = DEFAULT_DEVICE
                         ) -> dict:
    """The constant prefilter weight matrices of every mip level, computed
    once and passed to build_mips(weights=...), not rebuilt per step."""
    dev = resolve_device(device)
    rough = level_roughness(base_res)
    res = [max(base_res // (2 ** i), LIGHT_MIN_RES)
           for i in range(len(rough) - 1)] + [LIGHT_MIN_RES]
    specular = tuple(specular_weights(r, rr, device=dev) for r, rr in zip(res, rough))
    return {"diffuse": diffuse_weights(base_res, dev), "specular": specular}


def build_mips(params: dict, weights: dict | None = None) -> CubemapLight:
    """Avg-pool chain + GGX prefilter per level + cosine diffuse."""
    chain = [params["base"]]
    while chain[-1].shape[1] > LIGHT_MIN_RES:
        chain.append(avg_pool_cubemap(chain[-1]))
    diffuse = diffuse_cubemap(chain[0], None if weights is None else weights["diffuse"])
    rough = level_roughness(chain[0].shape[1])
    specular = []
    for idx in range(len(chain) - 1):
        w = None if weights is None else weights["specular"][idx]
        specular.append(specular_cubemap(chain[idx], rough[idx], weights=w))
    w = None if weights is None else weights["specular"][-1]
    specular.append(specular_cubemap(chain[-1], 1.0, weights=w))
    return CubemapLight(diffuse=diffuse, specular=tuple(specular))


def get_mip(roughness: torch.Tensor, n_levels: int) -> torch.Tensor:
    """Roughness -> fractional specular mip level (pbr/light.py:91-101)."""
    low = ((torch.clamp(roughness, MIN_ROUGHNESS, MAX_ROUGHNESS) - MIN_ROUGHNESS)
           / (MAX_ROUGHNESS - MIN_ROUGHNESS) * (n_levels - 2))
    high = ((torch.clamp(roughness, MAX_ROUGHNESS, 1.0) - MAX_ROUGHNESS)
            / (1.0 - MAX_ROUGHNESS) + n_levels - 2)
    return torch.where(roughness < MAX_ROUGHNESS, low, high)


def export_envmap(params: dict, height: int = 256, width: int = 512) -> torch.Tensor:
    """Lat-long render of the base cubemap (pbr/light.py:119-149)."""
    return cubemap_to_latlong(params["base"], height, width)
