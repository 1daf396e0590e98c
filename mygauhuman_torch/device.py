"""The port's device rule: entry points default to CUDA and never fall back."""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


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
