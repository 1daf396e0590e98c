"""Learned deformation-correction MLPs as plain parameter dicts.

Port of models/mlps.py: the pose refiner (3 (J - 1) -> 128 -> 128 ->
3 (J - 1), output through the regularised Rodrigues -> [J - 1, 3, 3]
corrections; 69 wide for SMPL's J = 24, 162 for SMPL-X's 55) and the PE-63
LBS-offset decoder (width 128, depth 4, skip concat after layer 2 ->
[N, J] blend-weight logit offsets); `total_bones` = J sizes both. The dict layout is the JAX one, so
`interop.tensor_tree` carries trained weights across. Weights are [in, out]
and applied as `h @ w + b`. The init draws from a `torch.Generator`; it does
not reproduce the JAX PRNG's numbers.
"""
from __future__ import annotations

import math

import torch

from mygauhuman_torch.device import DEFAULT_DEVICE, resolve_device
from mygauhuman_torch.utils.transforms import rodrigues_mlp

POSE_INPUT_DIM = 69  # SMPL: 23 non-root joints * 3 (SMPL-X: 162; sized by total_bones)
PE_FREQS = 10
PE_DIM = 3 + 3 * 2 * PE_FREQS  # 63


def _uniform(gen, shape, bound, device):
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return ((2.0 * u - 1.0) * bound).to(device)


def _linear_init(gen, fan_in, fan_out, device, gain_relu=True):
    # xavier-uniform with relu gain, as the reference's initseq
    gain = math.sqrt(2.0) if gain_relu else 1.0
    bound = gain * math.sqrt(3.0 / fan_in)
    return {"w": _uniform(gen, (fan_in, fan_out), bound, device),
            "b": torch.zeros(fan_out, dtype=torch.float32, device=device)}


def init_pose_refiner(gen: torch.Generator, total_bones: int = 24, width: int = 128,
                      depth: int = 2, device: str | torch.device = DEFAULT_DEVICE):
    dev = resolve_device(device)
    dims = [3 * (total_bones - 1)] + [width] * depth + [3 * (total_bones - 1)]
    layers = []
    for i in range(len(dims) - 1):
        last = i == len(dims) - 2
        p = _linear_init(gen, dims[i], dims[i + 1], dev, gain_relu=not last)
        if last:  # tiny init -> identity corrections at start
            p["w"] = _uniform(gen, (dims[i], dims[i + 1]), 1e-5, dev)
        layers.append(p)
    return {"layers": layers}


def apply_pose_refiner(params, pose_vec: torch.Tensor) -> torch.Tensor:
    """[3 (J - 1)] non-root pose -> [J - 1, 3, 3] correction rotations."""
    h = pose_vec
    layers = params["layers"]
    for p in layers[:-1]:
        h = torch.relu(h @ p["w"] + p["b"])
    rvec = (h @ layers[-1]["w"] + layers[-1]["b"]).reshape(-1, 3)
    return rodrigues_mlp(rvec)


def positional_encode(x: torch.Tensor, freqs: int = PE_FREQS) -> torch.Tensor:
    """NeRF PE: [.., 3] -> [.., 63] as [x, sin(2^0 x), cos(2^0 x), ...]."""
    outs = [x]
    for i in range(freqs):
        outs.append(torch.sin((2.0 ** i) * x))
        outs.append(torch.cos((2.0 ** i) * x))
    return torch.cat(outs, dim=-1)


def init_lbs_offset(gen: torch.Generator, total_bones: int = 24, width: int = 128,
                    depth: int = 4, skips: tuple = (2,),
                    device: str | torch.device = DEFAULT_DEVICE):
    dev = resolve_device(device)
    d_prev = PE_DIM
    layers = []
    for i in range(depth):
        layers.append(_linear_init(gen, d_prev, width, dev))
        d_prev = width + (PE_DIM if i in skips else 0)
    head = _linear_init(gen, d_prev, total_bones, dev, gain_relu=False)
    return {"layers": layers, "head": head}


def apply_lbs_offset(params, pts: torch.Tensor, skips: tuple = (2,)) -> torch.Tensor:
    """[N, 3] canonical points -> [N, J] blend-weight logit offsets
    (activation first, then the PE features concatenated after the skip)."""
    feat = positional_encode(pts)
    h = feat
    for i, p in enumerate(params["layers"]):
        h = torch.relu(h @ p["w"] + p["b"])
        if i in skips:
            h = torch.cat([feat, h], dim=-1)
    return h @ params["head"]["w"] + params["head"]["b"]
