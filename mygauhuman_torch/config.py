"""Training configuration (port of config.py, the part the trainer reads).

A copy of the fields of the JAX package's `OptimizationConfig` that the
branch-A trainer reads, with the same defaults (the reference's
arguments/__init__.py). The loss weights of train/trainer.py's
compute_losses_a are fixed there, as in the JAX package; the PBR weights,
the model and
pipeline groups wait for the code that reads them.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class OptimizationConfig:
    iterations: int = 1200           # train_zju_mocap_refine.sh:4 budget
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    pose_refine_lr: float = 0.00005
    lbs_offset_lr: float = 0.00005
    normal_lr: float = 0.0002
    percent_dense: float = 0.01
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 400
    densify_until_iter: int = 2000
    pbr_iteration: int = 30_000      # train.py:131 hard-codes 30000
    densify_grad_threshold: float = 0.0002
    use_kl_densify: bool = False     # paper's KL gating (ref ships, disables)
    kl_threshold: float = 0.4
    adam_eps: float = 1e-15          # gaussian_model.py:284
