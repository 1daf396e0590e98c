"""Cubemap prefiltering: cosine (diffuse) and GGX (specular) convolutions
(port of pbr/prefilter.py).

At the 32x32 base resolution the full convolution is one [6R'^2, 6R^2]
matrix product per level, exactly differentiable in the input texels. The
products run in full float32 (the port never enables TF32).
"""
from __future__ import annotations

import torch

from mygauhuman_torch.pbr.cubemap import face_directions, texel_solid_angles


def diffuse_weights(R: int, device=None) -> torch.Tensor:
    """Constant [6R^2, 6R^2] cosine-convolution weight matrix."""
    dirs = face_directions(R, device).reshape(-1, 3)
    omega = texel_solid_angles(R, device).reshape(-1)
    cos = torch.clamp(dirs @ dirs.T, min=0.0)                 # [out, in]
    return cos * omega[None, :] / torch.pi


def diffuse_cubemap(cubemap: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
    """Cosine-hemisphere irradiance: out[o] = sum_i L_i max(N_o.L_i,0) w_i / pi.

    Parity: DiffuseCubemapFwdKernel (cubemap.cu:110-138). `weights` takes a
    precomputed diffuse_weights(R)."""
    R = cubemap.shape[1]
    w = weights if weights is not None else diffuse_weights(R, cubemap.device)
    out = w @ cubemap.reshape(-1, cubemap.shape[-1])
    return out.reshape(cubemap.shape)


def _ndf_ggx(alpha_sqr, cos_theta: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(cos_theta, 1e-4, 1.0 - 1e-4)
    d = (c * alpha_sqr - c) * c + 1.0
    return alpha_sqr / (d * d * torch.pi)


def specular_weights(R: int, roughness: float, out_res: int | None = None,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Constant ([O, I] GGX weight matrix, [O, 1] normalizer) per
    (resolution, roughness) — precompute once (prefilter_weight_set)."""
    out_res = out_res or R
    out_dirs = face_directions(out_res, device).reshape(-1, 3)   # [O, 3]
    in_dirs = face_directions(R, device).reshape(-1, 3)          # [I, 3]
    omega = texel_solid_angles(R, device).reshape(-1)
    alpha_sqr = (roughness * roughness) ** 2
    cos_wi = out_dirs @ in_dirs.T                                # NoL [O, I]
    h = out_dirs[:, None, :] + in_dirs[None, :, :]
    h = h / torch.clamp(torch.linalg.norm(h, dim=-1, keepdim=True), min=1e-12)
    noh = torch.einsum("oc,oic->oi", out_dirs, h)
    w = torch.clamp(cos_wi, min=0.0) * _ndf_ggx(alpha_sqr, noh) * omega[None, :] / 4.0
    norm = torch.clamp(w.sum(dim=1, keepdim=True), min=1e-8)
    return w, norm


def specular_cubemap(cubemap: torch.Tensor, roughness: float, out_res: int | None = None,
                     weights: tuple | None = None) -> torch.Tensor:
    """GGX split-sum prefilter at one roughness (N = V = R assumption).

    Parity: SpecularCubemapFwdKernel (cubemap.cu:246-297): weight per texel
    = wiDotN * ndfGGX(alpha^2, NoH) * w_i / 4, normalized by the weight sum
    (ops.py:458), H = normalize(No + L_i)."""
    R = cubemap.shape[1]
    out_res = out_res or R
    w, norm = weights if weights is not None else specular_weights(
        R, roughness, out_res, cubemap.device)
    out = (w @ cubemap.reshape(-1, cubemap.shape[-1])) / norm
    return out.reshape((6, out_res, out_res, cubemap.shape[-1]))
