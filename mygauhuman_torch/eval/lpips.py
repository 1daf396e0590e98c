"""LPIPS perceptual distance: VGG16 features (port of eval/lpips.py).

Five feature stages (relu1_2 .. relu5_3), channel-unit-normalised, squared
difference, a 1x1 linear head per stage, spatial mean, summed. The VGG
trunk runs as fp32 `F.conv2d` (the JAX package's trunk is XLA convolutions,
in bf16 for the TPU's matrix unit; no Pallas kernel to port).

Weights: no pretrained VGG ships, so by default the backbone is a
deterministic random He-init VGG from a `torch.Generator` (reported as
`lpips_rand`, never as published LPIPS). `weights_file` loads the JAX
package's .npz format (torchvision VGG16 + lpips heads), which
`export_torch_weights` writes from those state dicts. `LPIPSParams`
holds conv weights in PyTorch's [cout, cin, kh, kw] layout;
`interop.lpips_params` converts the JAX package's [kh, kw, cin, cout].
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from mygauhuman_torch.device import (
    DEFAULT_DEVICE,
    device_constant,
    exact_convs,
    resolve_device,
)

# VGG16 conv plan: (out_channels, pool_before)
_VGG_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
_STAGE_STARTS = [0, 2, 4, 7, 10]
_STAGE_ENDS = [1, 3, 6, 9, 12]
_STAGE_CHANNELS = [64, 128, 256, 512, 512]

# lpips' scaling layer (ImageNet shift / scale)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPSParams(NamedTuple):
    convs: tuple      # tuple of {"w": [cout, cin, 3, 3], "b": [cout]}
    lins: tuple       # tuple of [C] per stage (1x1 linear head weights)


def init_lpips(generator: torch.Generator | None = None, weights_file: str | None = None,
               device: str | torch.device = DEFAULT_DEVICE) -> LPIPSParams:
    """Weights from `weights_file` (.npz, JAX layout), else a random He-init
    backbone drawn from `generator` (seed 0 when None) with 1/C heads."""
    dev = resolve_device(device)
    if weights_file is not None:
        data = np.load(weights_file)
        convs = tuple(
            {"w": torch.as_tensor(np.transpose(data[f"conv{i}_w"], (3, 2, 0, 1)).copy(),
                                  dtype=torch.float32, device=dev),
             "b": torch.as_tensor(data[f"conv{i}_b"], dtype=torch.float32, device=dev)}
            for i in range(len(_VGG_PLAN)))
        lins = tuple(torch.as_tensor(data[f"lin{i}"], dtype=torch.float32, device=dev)
                     for i in range(5))
        return LPIPSParams(convs=convs, lins=lins)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    convs = []
    cin = 3
    for cout, _ in _VGG_PLAN:
        w = torch.randn((cout, cin, 3, 3), generator=generator) * np.sqrt(2.0 / (9 * cin))
        convs.append({"w": w.to(dev), "b": torch.zeros(cout, device=dev)})
        cin = cout
    lins = tuple(torch.full((c,), 1.0 / c, device=dev) for c in _STAGE_CHANNELS)
    return LPIPSParams(convs=tuple(convs), lins=lins)


def export_torch_weights(out_path: str, vgg_state: dict, lin_state: dict) -> None:
    """Convert a torchvision VGG16 `features` state_dict and the lpips
    package's lin heads into the .npz that `init_lpips(weights_file=)` (and
    the JAX package) reads: conv weights as [kh, kw, cin, cout]."""
    def arr(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    conv_ids = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    arrs = {}
    for i, cid in enumerate(conv_ids):
        arrs[f"conv{i}_w"] = np.transpose(arr(vgg_state[f"features.{cid}.weight"]), (2, 3, 1, 0))
        arrs[f"conv{i}_b"] = arr(vgg_state[f"features.{cid}.bias"])
    for i in range(5):
        arrs[f"lin{i}"] = arr(lin_state[f"lin{i}.model.1.weight"]).reshape(-1)
    np.savez(out_path, **arrs)


def _features(params: LPIPSParams, x: torch.Tensor) -> list:
    """x: [N, H, W, 3] in [0, 1] -> the five stage activations [N, C, h, w]."""
    shift = device_constant("lpips_shift", _SHIFT, x.device)
    scale = device_constant("lpips_scale", _SCALE, x.device)
    x = ((x * 2.0 - 1.0 - shift) / scale).permute(0, 3, 1, 2)
    feats = []
    for si, (start, end) in enumerate(zip(_STAGE_STARTS, _STAGE_ENDS)):
        if si > 0:
            x = F.max_pool2d(x, 2, 2)
        for p in params.convs[start:end + 1]:
            x = torch.relu(F.conv2d(x, p["w"], p["b"], padding=1))
        feats.append(x)
    return feats


def lpips_distance(params: LPIPSParams, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """img: [H, W, 3] or [N, H, W, 3] in [0, 1] -> scalar (or [N])."""
    squeeze = img1.dim() == 3
    if squeeze:
        img1, img2 = img1[None], img2[None]
    with exact_convs():
        f1 = _features(params, img1)
        f2 = _features(params, img2)
    total = 0.0
    for a, b, lin in zip(f1, f2, params.lins):
        a = a * torch.rsqrt((a * a).sum(dim=1, keepdim=True) + 1e-10)
        b = b * torch.rsqrt((b * b).sum(dim=1, keepdim=True) + 1e-10)
        d = (a - b) ** 2
        total = total + (d * lin[None, :, None, None]).sum(dim=1).mean(dim=(1, 2))
    return total[0] if squeeze else total


class LPIPS:
    """`lpips = LPIPS(); lpips(img1, img2)`. `metric_name` is "lpips" only
    with pretrained weights, "lpips_rand" for the random backbone."""

    def __init__(self, weights_file: str | None = None,
                 generator: torch.Generator | None = None,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.params = init_lpips(generator, weights_file, device)
        self.pretrained = weights_file is not None
        self.metric_name = "lpips" if self.pretrained else "lpips_rand"

    def __call__(self, img1, img2):
        return lpips_distance(self.params, img1, img2)
