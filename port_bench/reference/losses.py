"""Branch A's loss of the plain reference: a frozen copy of
`mygauhuman_torch/train/losses.py` (masked L1 / L2, SSIM with the 11-tap
Gaussian window as two separable convolutions, the masked TV), of
`eval/lpips.py::lpips_distance` (VGG16's 13 convolutions, the five
channel-normalised stages, the linear heads) and of
`train/trainer.py::compute_losses_a` with its static LPIPS crop:

  total = L1(bound) + 0.1 maskL2 + normalL1 + axisL1 + 0.01 lpips
          + 0.01 (2 - ssim(rgb) - ssim(normal)) + 0.01 normal_TV + mean(scaling)
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

STAGES = ((0, 1), (2, 3), (4, 6), (7, 9), (10, 12))
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def masked_l1(x, y, mask):
    m = mask[..., None]
    return ((x - y).abs() * m).sum() / torch.clamp(m.sum() * x.shape[-1], min=1.0)


def masked_l2(x, y, mask):
    return (((x - y) ** 2) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def ssim_taps(window: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window) - window // 2) ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _filter(img, taps):
    half = taps.shape[0] // 2
    x = img.permute(2, 0, 1)[:, None]
    x = F.conv2d(x, taps.view(1, 1, -1, 1), padding=(half, 0))
    x = F.conv2d(x, taps.view(1, 1, 1, -1), padding=(0, half))
    return x[:, 0].permute(1, 2, 0)


def ssim(img1, img2, mask):
    taps = torch.as_tensor(ssim_taps(), device=img1.device)
    mu1, mu2 = _filter(img1, taps), _filter(img2, taps)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter(img1 * img1, taps) - mu1_sq
    s2 = _filter(img2 * img2, taps) - mu2_sq
    s12 = _filter(img1 * img2, taps) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    mm = mask[..., None]
    return (m * mm).sum() / torch.clamp(mm.sum() * m.shape[-1], min=1.0)


def masked_tv(mask, img):
    tv_h = (img[1:] - img[:-1]) ** 2
    tv_w = (img[:, 1:] - img[:, :-1]) ** 2
    m_h = (mask[1:] * mask[:-1])[..., None]
    m_w = (mask[:, 1:] * mask[:, :-1])[..., None]
    return (tv_h * m_h).mean() + (tv_w * m_w).mean()


def vgg_features(convs, x):
    """x [N, H, W, 3] in [0, 1] -> the five stage activations."""
    shift = torch.tensor(SHIFT, device=x.device)
    scale = torch.tensor(SCALE, device=x.device)
    x = ((x * 2.0 - 1.0 - shift) / scale).permute(0, 3, 1, 2)
    feats = []
    for si, (start, end) in enumerate(STAGES):
        if si > 0:
            x = F.max_pool2d(x, 2, 2)
        for w, b in convs[start:end + 1]:
            x = torch.relu(F.conv2d(x, w, b, padding=1))
        feats.append(x)
    return feats


def lpips(params: dict, img1, img2):
    """[N, H, W, 3] pairs -> [N] distances (`params`: convs [(w, b)] x 13,
    lins [C] x 5)."""
    total = 0.0
    for a, b, lin in zip(vgg_features(params["convs"], img1),
                         vgg_features(params["convs"], img2), params["lins"]):
        a = a * torch.rsqrt((a * a).sum(dim=1, keepdim=True) + 1e-10)
        b = b * torch.rsqrt((b * b).sum(dim=1, keepdim=True) + 1e-10)
        total = total + (((a - b) ** 2) * lin[None, :, None, None]).sum(dim=1).mean(dim=(1, 2))
    return total


def scene_lpips_crop(bound_masks, pad: int = 8, align: int = 32) -> int:
    """The static LPIPS window's side: the largest bound-mask bbox + pad,
    rounded up to `align`, at most the frame."""
    ext = 1
    for bm in bound_masks:
        on = bm > 0
        if not bool(on.any()):
            continue
        rows = torch.nonzero(on.any(dim=1)).reshape(-1)
        cols = torch.nonzero(on.any(dim=0)).reshape(-1)
        ext = max(ext, int(rows[-1] - rows[0] + 1), int(cols[-1] - cols[0] + 1))
    side = -(-(ext + 2 * pad) // align) * align
    return int(min(side, max(b.shape[0] for b in bound_masks),
                   max(b.shape[1] for b in bound_masks)))


def lpips_crop(stack, bm, crop: int):
    """[K, H, W, 3] cut to the crop x crop window centred on the mask's bbox."""
    H, W = bm.shape
    ch, cw = min(crop, H), min(crop, W)
    if (ch, cw) == (H, W):
        return stack
    on = bm > 0
    rows = torch.nonzero(on.any(dim=1)).reshape(-1)
    cols = torch.nonzero(on.any(dim=0)).reshape(-1)
    y0, y1 = (int(rows[0]), int(rows[-1]) + 1) if rows.numel() else (0, H)
    x0, x1 = (int(cols[0]), int(cols[-1]) + 1) if cols.numel() else (0, W)
    ys = min(max((y0 + y1) // 2 - ch // 2, 0), H - ch)
    xs = min(max((x0 + x1) // 2 - cw // 2, 0), W - cw)
    return stack[:, ys:ys + ch, xs:xs + cw]


def loss_a(frame, view: dict, scaling_mean, lpips_params: dict | None, crop: int):
    """The total loss of one rendered `frame` against the `view`'s ground
    truth (gt_image, gt_normal, bkgd_mask, bound_mask)."""
    bm = view["bound_mask"].float()
    ll1 = masked_l1(frame.render, view["gt_image"], bm)
    mask_loss = masked_l2(frame.alpha, view["bkgd_mask"].float(), bm)
    normal_loss = masked_l1(frame.normal, view["gt_normal"], bm)
    axis_loss = masked_l1(frame.axis, view["gt_normal"], bm)
    ssim_val = ssim(frame.render, view["gt_image"], bm) + ssim(frame.normal, view["gt_normal"], bm)
    if lpips_params is not None:
        bm3 = bm[..., None]
        stack = torch.stack([frame.render * bm3, view["gt_image"] * bm3,
                             frame.normal * bm3, view["gt_normal"] * bm3])
        c = lpips_crop(stack, bm, crop)
        lp = lpips(lpips_params, c[0::2], c[1::2]).sum()
    else:
        lp = torch.zeros((), device=bm.device)
    tv = masked_tv(frame.alpha, frame.normal)
    return (ll1 + 0.1 * mask_loss + normal_loss + axis_loss + 0.01 * lp
            + 0.01 * (2.0 - ssim_val) + 0.01 * tv + scaling_mean)
