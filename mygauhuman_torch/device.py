"""The port's device rule: entry points default to CUDA and never fall back."""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"

_CONSTANTS: dict = {}


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """torch.device for an entry point; raises if CUDA is asked for but absent.

    A quiet fall-back to the CPU would run the plain PyTorch versions where
    the caller expected the CUDA kernels, so the CPU must be asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch path"
        )
    return dev


def exact_convs():
    """cuDNN settings for the port's convolutions (SSIM, LPIPS): full fp32
    (no TF32, which cuDNN enables by default) and deterministic algorithms,
    so a step run twice gives the same bits. Hold it around the forward and
    the backward: cuDNN reads the flags when each convolution runs."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                      allow_tf32=False)


def device_constant(name: str, values, device: torch.device) -> torch.Tensor:
    """The float32 tensor of `values`, made once per (name, device) and kept:
    a CUDA graph capture refuses copies from the host, so a constant that a
    captured step reads must already be on the card. Callers never write
    to it."""
    key = (name, torch.device(device))
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.as_tensor(values, dtype=torch.float32, device=device)
    return _CONSTANTS[key]
