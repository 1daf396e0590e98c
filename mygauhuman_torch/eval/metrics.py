"""Image metrics over (render, ground truth) pairs (port of
eval/metrics.py): PSNR, SSIM and LPIPS, per image and as means, over
tensors (`evaluate_images`) or two directories of PNG files
(`evaluate_dirs`). The LPIPS key is the model's `metric_name`
("lpips_rand" for the random backbone)."""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from mygauhuman_torch.device import DEFAULT_DEVICE, exact_convs, resolve_device
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
    with torch.no_grad(), exact_convs():   # SSIM's blur in fp32 (no TF32)
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


def evaluate_dirs(renders_dir: str, gt_dir: str, out_json: str | None = None,
                  device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """Directory mode like the reference metrics.py CLI: the PNG files of
    `renders_dir` against the same names in `gt_dir`, 8-bit / 255. Other
    files (cli.render's results.json) are skipped; the JAX package reads
    every file and fails on them."""
    from mygauhuman_torch.utils.image_io import read_png

    dev = resolve_device(device)
    names = sorted(n for n in os.listdir(renders_dir) if n.endswith(".png"))

    def load(d, n):
        return torch.as_tensor(read_png(os.path.join(d, n)).astype(np.float32) / 255.0,
                               device=dev)

    renders = [load(renders_dir, n) for n in names]
    gts = [load(gt_dir, n) for n in names]
    result = evaluate_images(renders, gts, names)
    if out_json:
        with open(out_json, "w") as f:
            json.dump(result, f, indent=2)
    return result
