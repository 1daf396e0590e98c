"""The body of the plain reference: a synthetic SMPL / SMPL-X made from the
seed, its forward pass and its per-joint transforms.

No SMPL or SMPL-X model file ships, so the benchmark makes a body at the
published joint and vertex counts by the recipe of
`mygauhuman_torch/models/smpl.py::synthetic_smpl` and
`models/smplx.py::synthetic_smplx` (joints on the real kinematic tree, each
vertex owned by a joint, skinning weights over its two nearest joints, a
joint regressor that averages the owned vertices, seeded shape and pose
blendshapes), drawn on the device from a `torch.Generator` in a few calls.
The forward pass and the transform chain are a frozen copy of
`models/smpl.py` and `models/lbs.py` (`smpl_forward`,
`rigid_transform_chain`, `remove_rest_joint_translation`,
`transform_params`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.reference.transforms import rodrigues

SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
    dtype=np.int64)
# models/smplx.py SMPLX_PARENTS: body 22, jaw, eyes, 15 + 15 finger joints
SMPLX_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 15, 22, 23,
     20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
     21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53], dtype=np.int64)

# A T-pose skeleton of a 1.7 m adult (metres, SMPL's 24 joints in its
# order; x to the body's left, y up, z forward). The joints are fixed so that
# every seed makes a body of the same size: the frames, the LPIPS crop and
# so the work of a step do not change with the seed.
SMPL_JOINTS = np.array([
    [0.00, 0.00, 0.00], [0.06, -0.09, 0.00], [-0.06, -0.09, 0.00], [0.00, 0.11, -0.02],
    [0.10, -0.46, 0.00], [-0.10, -0.46, 0.00], [0.00, 0.25, -0.02], [0.09, -0.86, -0.03],
    [-0.09, -0.86, -0.03], [0.00, 0.31, 0.00], [0.12, -0.92, 0.10], [-0.12, -0.92, 0.10],
    [0.00, 0.52, -0.01], [0.08, 0.43, -0.01], [-0.08, 0.43, -0.01], [0.00, 0.62, 0.04],
    [0.19, 0.46, -0.02], [-0.19, 0.46, -0.02], [0.45, 0.44, -0.03], [-0.45, 0.44, -0.03],
    [0.70, 0.45, -0.02], [-0.70, 0.45, -0.02], [0.78, 0.45, -0.02], [-0.78, 0.45, -0.02]])


def _smplx_joints() -> np.ndarray:
    """SMPL-X's 55 joints: SMPL's first 22, the jaw and eyes, and five
    three-joint fingers on each wrist."""
    j = list(SMPL_JOINTS[:22])
    j += [[0.00, 0.60, 0.06], [0.03, 0.66, 0.08], [-0.03, 0.66, 0.08]]
    for wrist, side in ((20, 1.0), (21, -1.0)):
        for f in range(5):
            base = SMPL_JOINTS[wrist] + np.array([side * 0.08, 0.0, 0.03 * (f - 2)])
            for k in range(3):
                j.append(base + np.array([side * 0.025 * k, 0.0, 0.0]))
    return np.array(j)


# vertex spread around its joint and skinning radius (the recipes' lengths)
_RECIPE = {"smpl": (0.05, 0.1), "smplx": (0.03, 0.08)}


def make_body(kind: str, n_verts: int, n_shape: int, gen: torch.Generator,
              device) -> dict:
    """A synthetic body of `kind` ("smpl" / "smplx") with `n_verts`
    vertices and `n_shape` shape coefficients: a dict of float32 device
    tensors (v_template [V, 3], shapedirs [V, 3, B], posedirs [V, 3, 9 (J - 1)],
    j_regressor [J, V], weights [V, J]) and `parents` (host ints)."""
    parents = SMPL_PARENTS if kind == "smpl" else SMPLX_PARENTS
    spread, radius = _RECIPE[kind]
    J = len(parents)
    f32 = dict(dtype=torch.float32, device=device)
    joint_pos = torch.as_tensor(SMPL_JOINTS if kind == "smpl" else _smplx_joints(), **f32)
    owner = torch.randint(0, J, (n_verts,), generator=gen, device=device)
    # the spread cut at 2.5 sigma: the body's outline, and so the frames'
    # work, hardly move with the seed
    noise = torch.clamp(torch.randn((n_verts, 3), generator=gen, **f32), -2.5, 2.5)
    v_template = joint_pos[owner] + spread * noise
    d = torch.cdist(v_template, joint_pos)
    w = torch.exp(-(d / radius) ** 2) + 1e-4
    near2 = torch.topk(d, 2, dim=1, largest=False).indices
    keep = torch.zeros_like(w).scatter_(1, near2, 1.0)
    w = w * keep
    weights = w / w.sum(dim=1, keepdim=True)
    onehot = torch.zeros((J, n_verts), **f32)
    onehot[owner, torch.arange(n_verts, device=device)] = 1.0
    counts = onehot.sum(dim=1, keepdim=True)
    # a joint that owns no vertex averages its four nearest vertices
    nearest4 = torch.topk(d.T, min(4, n_verts), dim=1, largest=False).indices
    fallback = torch.zeros_like(onehot).scatter_(1, nearest4, 0.25)
    j_regressor = torch.where(counts > 0, onehot / counts.clamp(min=1.0), fallback)
    shapedirs = 0.01 * torch.randn((n_verts, 3, n_shape), generator=gen, **f32)
    posedirs = 0.001 * torch.randn((n_verts, 3, 9 * (J - 1)), generator=gen, **f32)
    return {"v_template": v_template, "shapedirs": shapedirs, "posedirs": posedirs,
            "j_regressor": j_regressor, "weights": weights, "parents": parents}


def big_pose(kind: str, n_shape: int, device) -> dict:
    """GauHuman's canonical big pose (legs spread 45 degrees, knees 30):
    `models/smpl.py::big_pose_params` and `models/smplx.py::
    smplx_big_pose_params`."""
    if kind == "smpl":
        poses = np.zeros(72, np.float32)
        poses[5], poses[8] = np.deg2rad(45.0), np.deg2rad(-45.0)
        poses[23], poses[26] = np.deg2rad(-30.0), np.deg2rad(30.0)
    else:
        poses = np.zeros(165, np.float32)
        body = poses[3:66]
        body[2], body[5] = np.deg2rad(45.0), np.deg2rad(-45.0)
        body[20], body[23] = np.deg2rad(-30.0), np.deg2rad(30.0)
    return {"poses": torch.as_tensor(poses, device=device),
            "shapes": torch.zeros(n_shape, dtype=torch.float32, device=device),
            "R": torch.eye(3, dtype=torch.float32, device=device),
            "Th": torch.zeros(3, dtype=torch.float32, device=device)}


def rigid_transform_chain(rot_mats, joints, parents):
    """Per-joint local transforms composed down the tree -> [J, 4, 4]."""
    J = len(parents)
    rel = torch.cat([joints[:1], joints[1:] - joints[torch.as_tensor(
        parents[1:], device=joints.device)]], dim=0)
    bottom = torch.zeros((J, 1, 4), dtype=rot_mats.dtype, device=rot_mats.device)
    bottom[..., 3] = 1.0
    local = torch.cat([torch.cat([rot_mats, rel[:, :, None]], dim=-1), bottom], dim=-2)
    chain = [local[0]]
    for j in range(1, J):
        chain.append(chain[int(parents[j])] @ local[j])
    return torch.stack(chain)


def rest_transforms(G, joints):
    """A = G - pad(G [j; 0]): the transforms act on rest-space points."""
    j_h = torch.cat([joints, torch.zeros_like(joints[:, :1])], dim=-1)
    posed = torch.einsum("jab,jb->ja", G, j_h)
    A = G.clone()
    A[:, :, 3] = A[:, :, 3] - posed
    return A


def shaped(body: dict, shapes):
    v_shaped = body["v_template"] + torch.einsum("vdb,b->vd", body["shapedirs"],
                                                 shapes.reshape(-1))
    return v_shaped, body["j_regressor"] @ v_shaped


def pose_offsets(body: dict, rot_mats):
    """Pose blendshape offsets [V, 3] from the (R - I) features."""
    ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    return torch.einsum("vdp,p->vd", body["posedirs"], (rot_mats[1:] - ident).reshape(-1))


def forward(body: dict, poses, shapes):
    """Posed vertices [V, 3] (before the global R, Th)."""
    v_shaped, joints = shaped(body, shapes)
    rot = rodrigues(poses.reshape(-1, 3))
    v_posed = v_shaped + pose_offsets(body, rot)
    A = rest_transforms(rigid_transform_chain(rot, joints, body["parents"]), joints)
    T = torch.einsum("vj,jab->vab", body["weights"], A)
    v_h = torch.cat([v_posed, torch.ones_like(v_posed[:, :1])], dim=-1)
    return torch.einsum("vab,vb->va", T, v_h)[:, :3]


def joint_transforms(body: dict, params: dict, rot_mats):
    """Per-joint rest -> posed transforms [J, 4, 4] at `rot_mats`."""
    _, joints = shaped(body, params["shapes"])
    return rest_transforms(rigid_transform_chain(rot_mats, joints, body["parents"]), joints)


def orbit_eye(center, radius: float, theta: float, height: float = 0.0):
    return center + radius * np.array([math.sin(theta), height, math.cos(theta)])
