"""Loss stack: static-shape, mask-weighted losses (port of train/losses.py).

  * `image[mask == 1].mean()` is sum(x mask) / (C sum(mask)): the same value.
  * SSIM is evaluated over the full image and averaged with the mask as
    weights (the static-shape stand-in for the reference's bbox crop). Its
    11 x 11 Gaussian window is applied as two separable 1-D convolutions
    with zero padding, the same function as the JAX package's banded
    matmuls (that form exists for the TPU's matrix unit).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from mygauhuman_torch.device import device_constant, exact_convs


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).abs().mean()


def l2_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((x - y) ** 2).mean()


def masked_l1(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of |x - y| over pixels where mask == 1 (x, y: [H, W, C], mask: [H, W])."""
    m = mask[..., None]
    denom = torch.clamp(m.sum() * x.shape[-1], min=1.0)
    return ((x - y).abs() * m).sum() / denom


def masked_l2(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    if x.dim() == mask.dim():
        return (((x - y) ** 2) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    m = mask[..., None]
    denom = torch.clamp(m.sum() * x.shape[-1], min=1.0)
    return (((x - y) ** 2) * m).sum() / denom


def psnr(img: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-image MSE over all pixels (utils/image_utils.py:17-24)."""
    mse = ((img - gt) ** 2).mean()
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def _gaussian_taps(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The reference's 2-D window: the outer product of the 1-D taps."""
    g = _gaussian_taps(window_size, sigma)
    return np.outer(g, g).astype(np.float32)


def _filter2d(img: torch.Tensor, window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Separable Gaussian blur of [H, W, C] with zero padding."""
    g = device_constant(f"ssim_taps_{window_size}_{sigma}",
                        _gaussian_taps(window_size, sigma).astype(np.float32), img.device)
    half = window_size // 2
    x = img.permute(2, 0, 1)[:, None]                       # [C, 1, H, W]
    with exact_convs():
        x = F.conv2d(x, g.view(1, 1, -1, 1), padding=(half, 0))
        x = F.conv2d(x, g.view(1, 1, 1, -1), padding=(0, half))
    return x[:, 0].permute(1, 2, 0)


def ssim_map(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Per-pixel SSIM map [H, W, C] (loss_utils.py:47-60)."""
    mu1 = _filter2d(img1, window_size)
    mu2 = _filter2d(img2, window_size)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter2d(img1 * img1, window_size) - mu1_sq
    s2 = _filter2d(img2 * img2, window_size) - mu2_sq
    s12 = _filter2d(img1 * img2, window_size) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))


def ssim(img1: torch.Tensor, img2: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean SSIM; with `mask` [H, W], the mask-weighted mean of the map."""
    m = ssim_map(img1, img2)
    if mask is None:
        return m.mean()
    mm = mask[..., None]
    return (m * mm).sum() / torch.clamp(mm.sum() * m.shape[-1], min=1.0)


def tv_loss(img: torch.Tensor) -> torch.Tensor:
    """img: [H, W, C]."""
    tv_h = ((img[1:] - img[:-1]) ** 2).mean()
    tv_w = ((img[:, 1:] - img[:, :-1]) ** 2).mean()
    return tv_h + tv_w


def masked_tv_loss(mask: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Squared differences of adjacent pixels weighted by the products of
    their mask values, plain mean over all positions (train.py:82-95)."""
    tv_h = (img[1:] - img[:-1]) ** 2
    tv_w = (img[:, 1:] - img[:, :-1]) ** 2
    m_h = (mask[1:] * mask[:-1])[..., None]
    m_w = (mask[:, 1:] * mask[:, :-1])[..., None]
    return (tv_h * m_h).mean() + (tv_w * m_w).mean()


def relative_smooth_loss(values: torch.Tensor, nn_values: torch.Tensor,
                         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Relative L1 between per-point values [N, C] and their KNN neighbours
    [N, K, C], scaled by the neighbour mean."""
    diff = (values[:, None, :] - nn_values).abs()
    rel = diff / (nn_values.mean(dim=1, keepdim=True) + 1e-6)
    if mask is None:
        return rel.mean()
    m = mask[:, None, None]
    return (rel * m).sum() / torch.clamp(m.sum() * rel.shape[1] * rel.shape[2], min=1.0)


def gaussian_histogram(x: torch.Tensor, bins: int = 15, lo: float = 0.0,
                       hi: float = 1.0) -> torch.Tensor:
    """Soft KDE histogram [bins, C] (train.py:47-56)."""
    x = x.reshape(-1, x.shape[-1])
    sigma = x.var(dim=0, unbiased=False)
    delta = (hi - lo) / bins
    centers = lo + delta * (torch.arange(bins, dtype=x.dtype, device=x.device) + 0.5)
    d = x[None] - centers[:, None, None]                    # [bins, N, C]
    h = torch.exp(-0.5 * (d / (sigma + 1e-12)) ** 2) / (
        (sigma + 1e-12) * math.sqrt(2 * math.pi)) * delta
    return h.sum(dim=1)


def gaussian_entropy(x: torch.Tensor, bins: int = 15) -> torch.Tensor:
    """Sum of per-channel KDE entropies (train.py:58-71)."""
    h = gaussian_histogram(x, bins)
    eps = 1e-6
    total = h.sum(dim=0)
    hn = torch.where(total[None] > eps, h / (total[None] + 1e-12) + eps, torch.ones_like(h))
    return (-hn * torch.log(hn)).sum()


def predicted_normal_loss(normal: torch.Tensor, normal_ref: torch.Tensor,
                          weight: torch.Tensor | None = None) -> torch.Tensor:
    """Ref-NeRF predicted-normal penalty: mean of w (1 - n . n_ref)."""
    if weight is None:
        weight = torch.ones(normal.shape[:2], dtype=normal.dtype, device=normal.device)
    dot = (normal * normal_ref.detach()).sum(dim=-1)
    return (weight * (1.0 - dot)).mean()


def latent_kl_loss(latent_values: torch.Tensor, rho: float = 0.05) -> torch.Tensor:
    """Bernoulli KL against a target activation rate rho over the sigmoid of
    the latent BRDF codes (loss_utils.py:92-100)."""
    rho_hat = torch.sigmoid(latent_values.reshape(-1, 32)).mean(dim=0)
    return (rho * torch.log(rho / rho_hat)
            + (1.0 - rho) * torch.log((1.0 - rho) / (1.0 - rho_hat))).mean()
