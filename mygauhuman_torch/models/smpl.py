"""SMPL body model: loader + forward (port of models/smpl.py).

Model files (SMPL_NEUTRAL.pkl etc.) are external assets the user supplies;
`synthetic_smpl` builds a structurally faithful miniature (24 joints, the
real kinematic chain) from a seed with the same numpy draws as the JAX
package, so both packages build identical arrays.
"""
from __future__ import annotations

import pickle
from typing import NamedTuple

import numpy as np
import torch

from mygauhuman_torch.device import DEFAULT_DEVICE, resolve_device
from mygauhuman_torch.utils.transforms import rodrigues

NUM_JOINTS = 24          # SMPL (SMPL-X: models/smplx.py, 55)
NUM_POSE_BASIS = 207  # (24-1) * 9

SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
    dtype=np.int32,
)


class SMPLModel(NamedTuple):
    """Constant tensors of one body model: J = 24 joints for SMPL, 55 for
    SMPL-X (models/smplx.py), whose pose basis is (J - 1) * 9 wide."""

    v_template: torch.Tensor   # [V, 3]
    shapedirs: torch.Tensor    # [V, 3, B] (SMPL-X: 10 betas + 10 expression)
    posedirs: torch.Tensor     # [V, 3, (J - 1) * 9]: 207 (SMPL), 486 (SMPL-X)
    j_regressor: torch.Tensor  # [J, V]
    weights: torch.Tensor      # [V, J]
    parents: np.ndarray        # [J] host-side int
    faces: np.ndarray          # [F, 3] host-side


def _parents_from_kintree(kintree_table: np.ndarray) -> np.ndarray:
    id_to_col = {int(kintree_table[1, i]): i for i in range(kintree_table.shape[1])}
    parents = np.full(kintree_table.shape[1], -1, np.int32)
    for i in range(1, kintree_table.shape[1]):
        parents[i] = id_to_col[int(kintree_table[0, i])]
    return parents


def model_from_arrays(arrays: dict, parents: np.ndarray, faces: np.ndarray,
                      device: str | torch.device = DEFAULT_DEVICE) -> SMPLModel:
    """SMPLModel from numpy arrays keyed by field name."""
    dev = resolve_device(device)

    def t(name):
        return torch.tensor(np.asarray(arrays[name], np.float32), device=dev)

    return SMPLModel(
        v_template=t("v_template"),
        shapedirs=t("shapedirs"),
        posedirs=t("posedirs"),
        j_regressor=t("j_regressor"),
        weights=t("weights"),
        parents=np.asarray(parents, np.int32),
        faces=np.asarray(faces, np.int32),
    )


def load_smpl(path: str, num_betas: int = 10,
              device: str | torch.device = DEFAULT_DEVICE) -> SMPLModel:
    """Load a SMPL .pkl (latin1 chumpy pickle) or SMPL-X style .npz.

    Unpickling runs code from the file: load only model files you trust."""
    if path.endswith(".npz"):
        data = dict(np.load(path, allow_pickle=True))
    else:
        with open(path, "rb") as f:
            u = pickle._Unpickler(f)
            u.encoding = "latin1"
            data = u.load()
    j_reg = data["J_regressor"]
    if hasattr(j_reg, "toarray"):
        j_reg = j_reg.toarray()
    posedirs = np.asarray(data["posedirs"], np.float32)
    if posedirs.ndim == 2:  # some releases store [V*3, 207]
        posedirs = posedirs.reshape(-1, 3, posedirs.shape[-1])
    return model_from_arrays(
        {
            "v_template": data["v_template"],
            "shapedirs": np.asarray(data["shapedirs"], np.float32)[..., :num_betas],
            "posedirs": posedirs,
            "j_regressor": j_reg,
            "weights": data["weights"],
        },
        _parents_from_kintree(np.asarray(data["kintree_table"])),
        np.asarray(data["f"], np.int32) if "f" in data else np.zeros((0, 3), np.int32),
        device,
    )


def synthetic_smpl(num_vertices: int = 300, num_betas: int = 10, seed: int = 0,
                   device: str | torch.device = DEFAULT_DEVICE) -> SMPLModel:
    """Structurally faithful miniature body model (same draws as the JAX one)."""
    rng = np.random.default_rng(seed)
    parents = SMPL_PARENTS
    joint_pos = np.zeros((NUM_JOINTS, 3), np.float32)
    for j in range(1, NUM_JOINTS):
        direction = rng.normal(size=3)
        direction /= np.linalg.norm(direction)
        joint_pos[j] = joint_pos[parents[j]] + 0.15 * direction

    owner = rng.integers(0, NUM_JOINTS, size=num_vertices)
    v_template = joint_pos[owner] + 0.05 * rng.normal(size=(num_vertices, 3))
    d = np.linalg.norm(v_template[:, None] - joint_pos[None], axis=-1)
    w = np.exp(-(d / 0.1) ** 2) + 1e-4
    keep2 = np.argsort(d, axis=1)[:, :2]
    mask = np.zeros_like(w)
    np.put_along_axis(mask, keep2, 1.0, axis=1)
    w = w * mask
    weights = (w / w.sum(axis=1, keepdims=True)).astype(np.float32)

    jr = np.zeros((NUM_JOINTS, num_vertices), np.float32)
    for j in range(NUM_JOINTS):
        sel = owner == j
        if sel.any():
            jr[j, sel] = 1.0 / sel.sum()
        else:
            nearest = np.argsort(d[:, j])[:4]
            jr[j, nearest] = 0.25
    shapedirs = 0.01 * rng.normal(size=(num_vertices, 3, num_betas)).astype(np.float32)
    posedirs = 0.001 * rng.normal(size=(num_vertices, 3, NUM_POSE_BASIS)).astype(np.float32)
    return model_from_arrays(
        {
            "v_template": v_template.astype(np.float32),
            "shapedirs": shapedirs,
            "posedirs": posedirs,
            "j_regressor": jr,
            "weights": weights,
        },
        parents,
        np.zeros((0, 3), np.int32),
        device,
    )


def big_pose_params(num_betas: int = 10,
                    device: str | torch.device = DEFAULT_DEVICE) -> dict:
    """GauHuman canonical 'big pose' (45deg legs, -30deg knees spread)."""
    dev = resolve_device(device)
    poses = np.zeros(72, np.float32)
    poses[5] = np.deg2rad(45.0)
    poses[8] = np.deg2rad(-45.0)
    poses[23] = np.deg2rad(-30.0)
    poses[26] = np.deg2rad(30.0)
    return {
        "poses": torch.as_tensor(poses, device=dev),
        "shapes": torch.zeros(num_betas, dtype=torch.float32, device=dev),
        "R": torch.eye(3, dtype=torch.float32, device=dev),
        "Th": torch.zeros(3, dtype=torch.float32, device=dev),
    }


def smpl_forward(
    model: SMPLModel,
    poses: torch.Tensor,     # [3 J] axis-angle or [J, 3, 3] rotations
    shapes: torch.Tensor,    # [B]
) -> tuple[torch.Tensor, torch.Tensor]:
    """SMPL forward: (vertices [V, 3], posed joints [J, 3])."""
    v_shaped = model.v_template + torch.einsum("vdb,b->vd", model.shapedirs, shapes)
    J = model.j_regressor @ v_shaped
    rot_mats = rodrigues(poses.reshape(-1, 3)) if poses.dim() == 1 else poses
    ident = torch.eye(3, dtype=v_shaped.dtype, device=v_shaped.device)
    lrotmin = (rot_mats[1:] - ident).reshape(-1)
    v_posed = v_shaped + torch.einsum("vdp,p->vd", model.posedirs, lrotmin)

    G = rigid_transform_chain(rot_mats, J, model.parents)
    A = remove_rest_joint_translation(G, J)
    T = torch.einsum("vj,jab->vab", model.weights, A)
    v_h = torch.cat([v_posed, torch.ones_like(v_posed[:, :1])], dim=-1)
    verts = torch.einsum("vab,vb->va", T, v_h)[:, :3]
    return verts, G[:, :3, 3]


def rigid_transform_chain(
    rot_mats: torch.Tensor, joints: torch.Tensor, parents: np.ndarray
) -> torch.Tensor:
    """Compose per-joint local transforms down the kinematic tree -> [J, 4, 4]."""
    n_joints = len(parents)
    # each parent's row by a host int (one stack, no index tensor copied from
    # the host, which a CUDA graph capture refuses)
    parent_joints = torch.stack([joints[int(p)] for p in parents[1:]])
    rel = torch.cat([joints[:1], joints[1:] - parent_joints], dim=0)
    bottom = torch.zeros((n_joints, 1, 4), dtype=rot_mats.dtype, device=rot_mats.device)
    bottom[..., 3:].fill_(1.0)
    local = torch.cat([torch.cat([rot_mats, rel[:, :, None]], dim=-1), bottom], dim=-2)
    chain = [local[0]]
    for j in range(1, n_joints):
        chain.append(chain[int(parents[j])] @ local[j])
    return torch.stack(chain, dim=0)


def remove_rest_joint_translation(G: torch.Tensor, joints: torch.Tensor) -> torch.Tensor:
    """A = G - pad(G @ [j_rest; 0]): makes A map rest-space points."""
    j_h = torch.cat([joints, torch.zeros_like(joints[:, :1])], dim=-1)
    posed = torch.einsum("jab,jb->ja", G, j_h)
    A = G.clone()
    A[:, :, 3] = A[:, :, 3] - posed
    return A
