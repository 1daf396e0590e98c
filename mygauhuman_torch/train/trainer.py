"""Training batch type (port of train/trainer.py; the training loop itself
is not ported yet)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from mygauhuman_torch.data.camera import Camera
from mygauhuman_torch.render.renderer import FrameInputs


class TrainBatch(NamedTuple):
    """One training view: camera + ground truth + masks + SMPL frame."""

    camera: Camera
    frame: FrameInputs
    gt_image: torch.Tensor     # [H, W, 3]
    gt_normal: torch.Tensor    # [H, W, 3] in [0, 1] display encoding
    bkgd_mask: torch.Tensor    # [H, W] 1 = person
    bound_mask: torch.Tensor   # [H, W] 1 = inside projected SMPL bbox
