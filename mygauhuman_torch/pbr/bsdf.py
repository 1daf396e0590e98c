"""Point-light BSDF suite, shading-normal prep, transforms and image loss
(port of pbr/bsdf.py).

The reference renderutils API (pbr/renderutils/ops.py lambert / frostbite /
pbr_specular / pbr_bsdf / prepare_shading_normal / xfm_points / xfm_vectors /
image_loss; the pure-torch twins in bsdf.py:19-151 and loss.py are the
formula spec). Present but unused by the human pipeline (SURVEY.md §2.5).
"""
from __future__ import annotations

import math

import torch

NORMAL_THRESHOLD = 0.1
SPECULAR_EPSILON = 1e-4


def _dot(x, y):
    return (x * y).sum(dim=-1, keepdim=True)


def _reflect(x, n):
    return 2.0 * _dot(x, n) * n - x


def _safe_normalize(x, eps: float = 1e-20):
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + eps)


# ---- shading normal preparation (bsdf.py:28-52) ------------------------------

def _bend_normal(view_vec, smooth_nrm, geom_nrm, two_sided_shading):
    if two_sided_shading:
        facing = _dot(geom_nrm, view_vec) > 0
        smooth_nrm = torch.where(facing, smooth_nrm, -smooth_nrm)
        geom_nrm = torch.where(facing, geom_nrm, -geom_nrm)
    t = torch.clamp(_dot(view_vec, smooth_nrm) / NORMAL_THRESHOLD, 0.0, 1.0)
    return geom_nrm * (1.0 - t) + smooth_nrm * t


def _perturb_normal(perturbed_nrm, smooth_nrm, smooth_tng, opengl):
    bitang = _safe_normalize(torch.linalg.cross(smooth_tng, smooth_nrm, dim=-1))
    sign = -1.0 if opengl else 1.0
    shading = (smooth_tng * perturbed_nrm[..., 0:1]
               + sign * bitang * perturbed_nrm[..., 1:2]
               + smooth_nrm * torch.clamp(perturbed_nrm[..., 2:3], min=0.0))
    return _safe_normalize(shading)


def prepare_shading_normal(pos, view_pos, perturbed_nrm, smooth_nrm, smooth_tng, geom_nrm,
                           two_sided_shading: bool = True, opengl: bool = True):
    smooth_nrm = _safe_normalize(smooth_nrm)
    smooth_tng = _safe_normalize(smooth_tng)
    view_vec = _safe_normalize(view_pos - pos)
    shading = _perturb_normal(perturbed_nrm, smooth_nrm, smooth_tng, opengl)
    return _bend_normal(view_vec, shading, geom_nrm, two_sided_shading)


# ---- BSDFs (bsdf.py:55-151) ------------------------------------------------------

def lambert(nrm, wi):
    return torch.clamp(_dot(nrm, wi), min=0.0) / math.pi


def fresnel_shlick(f0, f90, cos_theta):
    c = torch.clamp(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    return f0 + (f90 - f0) * (1.0 - c) ** 5.0


def frostbite_diffuse(nrm, wi, wo, linear_roughness):
    wi_n = _dot(wi, nrm)
    wo_n = _dot(wo, nrm)
    h = _safe_normalize(wo + wi)
    wi_h = _dot(wi, h)
    energy_bias = 0.5 * linear_roughness
    energy_factor = 1.0 - (0.51 / 1.51) * linear_roughness
    f90 = energy_bias + 2.0 * wi_h * wi_h * linear_roughness
    res = fresnel_shlick(1.0, f90, wi_n) * fresnel_shlick(1.0, f90, wo_n) * energy_factor
    return torch.where((wi_n > 0.0) & (wo_n > 0.0), res, torch.zeros_like(res))


def ndf_ggx(alpha_sqr, cos_theta):
    c = torch.clamp(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    d = (c * alpha_sqr - c) * c + 1.0
    return alpha_sqr / (d * d * math.pi)


def lambda_ggx(alpha_sqr, cos_theta):
    c = torch.clamp(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    tan_sqr = (1.0 - c * c) / (c * c)
    return 0.5 * (torch.sqrt(1.0 + alpha_sqr * tan_sqr) - 1.0)


def masking_smith_ggx_correlated(alpha_sqr, cos_i, cos_o):
    return 1.0 / (1.0 + lambda_ggx(alpha_sqr, cos_i) + lambda_ggx(alpha_sqr, cos_o))


def pbr_specular(col, nrm, wo, wi, alpha, min_roughness: float = 0.08):
    a = torch.clamp(alpha, min_roughness * min_roughness, 1.0)
    alpha_sqr = a * a
    h = _safe_normalize(wo + wi)
    wo_n = _dot(wo, nrm)
    wi_n = _dot(wi, nrm)
    wo_h = _dot(wo, h)
    n_h = _dot(nrm, h)
    D = ndf_ggx(alpha_sqr, n_h)
    G = masking_smith_ggx_correlated(alpha_sqr, wo_n, wi_n)
    F = fresnel_shlick(col, 1.0, wo_h)
    w = F * D * G * 0.25 / torch.clamp(wo_n, min=SPECULAR_EPSILON)
    front = (wo_n > SPECULAR_EPSILON) & (wi_n > SPECULAR_EPSILON)
    return torch.where(front, w, torch.zeros_like(w))


def phong(nrm, wo, wi, exponent):
    dp_r = torch.clamp(_dot(_reflect(wo, nrm), wi), 0.0, 1.0)
    dp_l = torch.clamp(_dot(nrm, wi), 0.0, 1.0)
    return (dp_r ** exponent) * dp_l * (exponent + 2.0) / (2.0 * math.pi)


def pbr_bsdf(kd, arm, pos, nrm, view_pos, light_pos, min_roughness: float = 0.08,
             bsdf: str = "lambert"):
    """Full point-light BSDF (bsdf.py:137-151): arm = (spec_str, roughness,
    metallic)."""
    wo = _safe_normalize(view_pos - pos)
    wi = _safe_normalize(light_pos - pos)
    spec_str = arm[..., 0:1]
    roughness = arm[..., 1:2]
    metallic = arm[..., 2:3]
    ks = (0.04 * (1.0 - metallic) + kd * metallic) * (1.0 - spec_str)
    kd = kd * (1.0 - metallic)
    if bsdf == "lambert":
        diffuse = kd * lambert(nrm, wi)
    else:
        diffuse = kd * frostbite_diffuse(nrm, wi, wo, roughness)
    specular = pbr_specular(ks, nrm, wo, wi, roughness * roughness,
                            min_roughness=min_roughness)
    return diffuse + specular


# ---- transforms (ops.py:503-551) -------------------------------------------------

def xfm_points(points: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] x [..., 4, 4] -> [..., N, 4] homogeneous transform."""
    hom = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    return torch.einsum("...nk,...jk->...nj", hom, matrix)


def xfm_vectors(vectors: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """[..., N, 3] x [..., 4, 4] -> [..., N, 3] rotation-only transform."""
    return torch.einsum("...nk,...jk->...nj", vectors, matrix[..., :3, :3])


# ---- image losses (renderutils loss.py / ops.py:463-498) -------------------------

def _tonemap_srgb(x):
    return torch.where(x > 0.0031308,
                       torch.clamp(x, min=0.0031308) ** (1.0 / 2.4) * 1.055 - 0.055,
                       12.92 * x)


def image_loss(img, target, loss: str = "l1", tonemapper: str = "none"):
    """Parity: renderutils image_loss — optional log-sRGB tonemap then
    L1/SMAPE/MSE/relative-MSE."""
    if tonemapper == "log_srgb":
        img = _tonemap_srgb(torch.log(torch.clamp(img, 0.0, 65535.0) + 1.0))
        target = _tonemap_srgb(torch.log(torch.clamp(target, 0.0, 65535.0) + 1.0))
    if loss == "mse":
        return ((img - target) ** 2).mean()
    if loss == "smape":
        return ((img - target).abs() / (img.abs() + target.abs() + 0.01)).mean()
    if loss == "relmse":
        return ((img - target) ** 2 / (target ** 2 + 0.1)).mean()
    return (img - target).abs().mean()
