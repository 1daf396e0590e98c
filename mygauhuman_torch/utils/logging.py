"""Training observability: JSONL metric stream + optional TensorBoard
(port of utils/logging.py).

The JSONL stream (`metrics.jsonl`, one record per call: step, wall seconds,
`<prefix>/<name>` values) is the primary channel; TensorBoard mirrors it
when `torch.utils.tensorboard` is importable. The record layout is the JAX
package's.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any

import numpy as np
import torch


def _host_floats(metrics: dict) -> dict:
    """{name: float}, with every tensor value read in one device-to-host copy."""
    names = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out = {k: float(v) for k, v in metrics.items() if k not in names}
    if names:
        vals = torch.stack([metrics[k].detach().reshape(()).float() for k in names]).cpu()
        out.update(zip(names, vals.tolist()))
    return {k: out[k] for k in metrics}


class MetricLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except ImportError:
                self._tb = None
        self._t0 = time.time()
        self._ema: dict = {}

    def log(self, step: int, metrics: dict, prefix: str = "train") -> None:
        record: dict[str, Any] = {
            "step": step,
            "wall_s": round(time.time() - self._t0, 3),
        }
        for k, v in _host_floats(metrics).items():
            record[f"{prefix}/{k}"] = v
            # 0.6/0.4 EMA like the reference progress bar (train.py:380-381)
            self._ema[k] = 0.6 * v + 0.4 * self._ema.get(k, v)
            if self._tb is not None:
                self._tb.add_scalar(f"{prefix}/{k}", v, step)
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def log_image(self, step: int, tag: str, image) -> None:
        if self._tb is not None:
            arr = image.detach().cpu().numpy() if isinstance(image, torch.Tensor) \
                else np.asarray(image)
            if arr.ndim == 3 and arr.shape[-1] in (1, 3):
                arr = arr.transpose(2, 0, 1)
            self._tb.add_image(tag, arr, step)

    @property
    def ema(self) -> dict:
        return dict(self._ema)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
