"""Configuration tree (port of config.py).

Dataclasses with the reference's defaults (its arguments/__init__.py),
serialized to `cfg_args.json` beside the checkpoints. The JSON layout is
the JAX package's, so each package reads the other's file. The TPU-only
`PipelineConfig.use_pallas` is dropped: the port's ops follow their
inputs' device. A file that carries it (one the JAX package wrote) loads
with the key ignored, and the JAX package reads the port's file with its
default.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

#: keys of the JAX package's configuration that the port does not have
TPU_ONLY_KEYS = {"pipeline": ("use_pallas",)}


@dataclass
class ModelConfig:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    white_background: bool = False
    eval: bool = False
    exp_name: str = ""
    smpl_type: str = "smpl"          # scripts pass --smpl_type smpl
    actor_gender: str = "neutral"
    motion_offset_flag: bool = True  # scripts pass --motion_offset_flag


@dataclass
class PipelineConfig:
    tile_w: int = 16
    tile_h: int = 16
    max_tiles_per_gaussian: int = 16
    tile_capacity: int = 1024
    chunk_tiles: int = 64


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
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 400
    densify_until_iter: int = 2000
    pbr_iteration: int = 30_000      # train.py:131 hard-codes 30000
    densify_grad_threshold: float = 0.0002
    use_kl_densify: bool = False     # paper's KL gating (ref ships, disables)
    kl_threshold: float = 0.4
    smpl_prune_threshold: float = 0.05
    adam_eps: float = 1e-15          # gaussian_model.py:284
    # PBR-phase loss weights (train.py:294-363)
    lambda_lpips: float = 0.01
    lambda_normal: float = 1.0
    lambda_mask: float = 0.1


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    optim: OptimizationConfig = field(default_factory=OptimizationConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        d = json.loads(text)

        def group(name):
            g = dict(d.get(name, {}))
            for key in TPU_ONLY_KEYS.get(name, ()):
                g.pop(key, None)
            return g

        return cls(
            model=ModelConfig(**group("model")),
            pipeline=PipelineConfig(**group("pipeline")),
            optim=OptimizationConfig(**group("optim")),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_json(f.read())
