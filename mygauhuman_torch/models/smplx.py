"""SMPL-X body model: loader, full pose and big pose (port of models/smplx.py).

SMPL-X loads into the same `SMPLModel` as SMPL: 55 joints, a 486-dim pose
basis ((55 - 1) * 9) and 20 shape dims (10 betas + 10 expression), so the
LBS, the MLPs and the renderer take it unchanged (they size themselves
from the model's arrays). The posedirs and shapedirs products stay fp32
(the port never enables TF32). `synthetic_smplx` draws from
`np.random.default_rng` exactly as the JAX one does, so both packages
build the same arrays bit for bit.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from mygauhuman_torch.device import DEFAULT_DEVICE, resolve_device
from mygauhuman_torch.models.smpl import SMPLModel, _parents_from_kintree, model_from_arrays

NUM_JOINTS_SMPLX = 55
NUM_BODY_JOINTS = 21  # non-root body joints (body_pose is 63 = 21*3)

SMPLX_PARENTS = np.array([
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
    18, 19, 15, 22, 23, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35,
    20, 37, 38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52,
    53,
], np.int32)


def load_smplx(model_path: str, gender: str = "neutral", num_betas: int = 10,
               num_expression: int = 10,
               device: str | torch.device = DEFAULT_DEVICE) -> SMPLModel:
    """Load an SMPL-X .npz into the common SMPLModel on `device`.

    `model_path` is a directory (the reference layout
    assets/models/smplx/SMPLX_{GENDER}.npz) or an .npz path. The shape
    basis becomes [V, 3, num_betas + num_expression], so the readers'
    `shapes = concat(betas, expression)` works directly."""
    if os.path.isdir(model_path):
        model_path = os.path.join(model_path, f"SMPLX_{gender.upper()}.npz")
    data = dict(np.load(model_path, allow_pickle=True))

    shapedirs = np.asarray(data["shapedirs"], np.float32)
    if shapedirs.shape[-1] > 300:   # combined shape + expression basis
        shape_part = shapedirs[..., :num_betas]
        expr_part = shapedirs[..., 300:300 + num_expression]
    else:
        shape_part = shapedirs[..., :num_betas]
        expr_part = shapedirs[..., shapedirs.shape[-1] - num_expression:] \
            if shapedirs.shape[-1] >= num_betas + num_expression \
            else np.zeros(shapedirs.shape[:2] + (num_expression,), np.float32)
    shapedirs = np.concatenate([shape_part, expr_part], axis=-1)

    posedirs = np.asarray(data["posedirs"], np.float32)
    if posedirs.ndim == 3 and posedirs.shape[0] != shapedirs.shape[0]:
        # smplx stores [486, V*3]; reshape to [V, 3, 486]
        posedirs = posedirs.reshape(posedirs.shape[0], -1, 3)
        posedirs = np.moveaxis(posedirs, 0, -1)
    elif posedirs.ndim == 2:
        posedirs = posedirs.reshape(-1, 3, posedirs.shape[-1])

    j_reg = np.asarray(data["J_regressor"], np.float32)[:NUM_JOINTS_SMPLX]
    weights = np.asarray(data["lbs_weights"] if "lbs_weights" in data
                         else data["weights"], np.float32)[:, :NUM_JOINTS_SMPLX]
    if "kintree_table" in data:
        parents = _parents_from_kintree(np.asarray(data["kintree_table"]))
    else:
        parents = np.asarray(data["parents"], np.int32)
    return model_from_arrays(
        {"v_template": data["v_template"], "shapedirs": shapedirs,
         "posedirs": posedirs[..., : (NUM_JOINTS_SMPLX - 1) * 9],
         "j_regressor": j_reg, "weights": weights},
        parents[:NUM_JOINTS_SMPLX],
        np.asarray(data["f"], np.int32) if "f" in data else np.zeros((0, 3), np.int32),
        device,
    )


def smplx_full_pose(global_orient, body_pose, jaw_pose=None, leye_pose=None,
                    reye_pose=None, left_hand_pose=None,
                    right_hand_pose=None) -> np.ndarray:
    """The 165-dim full pose in smplx joint order: root(3) + body(63) +
    jaw(3) + leye(3) + reye(3) + lhand(45) + rhand(45)."""
    z3 = np.zeros(3, np.float32)
    z45 = np.zeros(45, np.float32)

    def part(x, zero):
        return np.asarray(zero if x is None else x, np.float32).reshape(-1)

    return np.concatenate([
        part(global_orient, z3), np.asarray(body_pose, np.float32).reshape(-1),
        part(jaw_pose, z3), part(leye_pose, z3), part(reye_pose, z3),
        part(left_hand_pose, z45), part(right_hand_pose, z45),
    ])


def smplx_big_pose_params(num_betas: int = 10, num_expression: int = 10,
                          device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """Canonical big pose for SMPL-X (dataset_readers.py:1033-1036: body_pose
    indices 2, 5, 20, 23 at 45 / -45 / -30 / 30 degrees)."""
    dev = resolve_device(device)
    body = np.zeros(63, np.float32)
    body[2] = np.deg2rad(45.0)
    body[5] = np.deg2rad(-45.0)
    body[20] = np.deg2rad(-30.0)
    body[23] = np.deg2rad(30.0)
    poses = smplx_full_pose(np.zeros(3), body)
    return {
        "poses": torch.as_tensor(poses, device=dev),
        "shapes": torch.zeros(num_betas + num_expression, dtype=torch.float32, device=dev),
        "R": torch.eye(3, dtype=torch.float32, device=dev),
        "Th": torch.zeros(3, dtype=torch.float32, device=dev),
    }


def synthetic_smplx(num_vertices: int = 400, seed: int = 0,
                    device: str | torch.device = DEFAULT_DEVICE) -> SMPLModel:
    """Miniature 55-joint model with the SMPL-X kinematic chain (the same
    draws as the JAX one)."""
    rng = np.random.default_rng(seed)
    parents = SMPLX_PARENTS
    J = len(parents)
    joint_pos = np.zeros((J, 3), np.float32)
    for j in range(1, J):
        d = rng.normal(size=3)
        joint_pos[j] = joint_pos[parents[j]] + 0.08 * d / np.linalg.norm(d)
    owner = rng.integers(0, J, size=num_vertices)
    v_template = joint_pos[owner] + 0.03 * rng.normal(size=(num_vertices, 3))
    d = np.linalg.norm(v_template[:, None] - joint_pos[None], axis=-1)
    w = np.exp(-(d / 0.08) ** 2) + 1e-4
    keep2 = np.argsort(d, axis=1)[:, :2]
    mask = np.zeros_like(w)
    np.put_along_axis(mask, keep2, 1.0, axis=1)
    w = w * mask
    weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)
    jr = np.zeros((J, num_vertices), np.float32)
    for j in range(J):
        sel = owner == j
        if sel.any():
            jr[j, sel] = 1.0 / sel.sum()
        else:
            jr[j, np.argsort(d[:, j])[:4]] = 0.25
    shapedirs = 0.01 * rng.normal(size=(num_vertices, 3, 20)).astype(np.float32)
    posedirs = 0.001 * rng.normal(size=(num_vertices, 3, (J - 1) * 9)).astype(np.float32)
    return model_from_arrays(
        {"v_template": v_template.astype(np.float32), "shapedirs": shapedirs,
         "posedirs": posedirs, "j_regressor": jr, "weights": weights},
        parents, np.zeros((0, 3), np.int32), device)
