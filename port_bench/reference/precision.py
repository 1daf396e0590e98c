"""The precision the reference computes in: float32 with TF32 off for
matmuls and convolutions (the configurations' stated precision), or, for
the control, TF32 on (the nearest precision below it)."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool = False):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=tf32):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
