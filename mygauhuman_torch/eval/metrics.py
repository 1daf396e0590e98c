"""Image metrics over (render, ground truth) pairs (port of
eval/metrics.py::evaluate_images): PSNR, SSIM and LPIPS, per image and as
means. The LPIPS key is the model's `metric_name` ("lpips_rand" for the
random backbone)."""
from __future__ import annotations

import numpy as np
import torch

from mygauhuman_torch.eval.lpips import LPIPS
from mygauhuman_torch.train.losses import psnr, ssim


def evaluate_images(renders: list, gts: list, names: list | None = None,
                    lpips_model: LPIPS | None = None) -> dict:
    """renders, gts: [H, W, 3] float tensors in [0, 1], on one device."""
    lpips_model = lpips_model or LPIPS(device=renders[0].device if renders else "cpu")
    lkey = lpips_model.metric_name
    names = names or [str(i) for i in range(len(renders))]
    per_image = {}
    psnrs, ssims, lpipss = [], [], []
    with torch.no_grad():
        for name, r, g in zip(names, renders, gts):
            r, g = r.float(), g.float()
            p, s, l_ = float(psnr(r, g)), float(ssim(r, g)), float(lpips_model(r, g))
            per_image[name] = {"psnr": p, "ssim": s, lkey: l_}
            psnrs.append(p)
            ssims.append(s)
            lpipss.append(l_)
    return {
        "psnr": float(np.mean(psnrs)) if psnrs else 0.0,
        "ssim": float(np.mean(ssims)) if ssims else 0.0,
        lkey: float(np.mean(lpipss)) if lpipss else 0.0,
        "per_image": per_image,
    }
