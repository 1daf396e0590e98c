"""Canonical-to-posed LBS deformation of Gaussians (port of models/lbs.py).

Undo the big pose to the T-pose (inverse skinning), apply the combined
blendshape offset, re-skin to the target pose (with learned per-joint
corrections folded in), then the global rigid transform. The nearest SMPL
vertex of each Gaussian comes from kernel A (`ops/knn.py`), the chain runs
in kernel B (`ops/pallas_deform.py`). All matmuls here are full fp32 (the
port never enables TF32).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mygauhuman_torch.models.smpl import (
    SMPLModel,
    remove_rest_joint_translation,
    rigid_transform_chain,
)
from mygauhuman_torch.ops.knn import knn
from mygauhuman_torch.ops.pallas_deform import deform_rows
from mygauhuman_torch.utils.transforms import inv3x3, rodrigues


class DeformOutput(NamedTuple):
    smpl_pts: torch.Tensor       # [N, 3] posed points in SMPL space
    world_pts: torch.Tensor      # [N, 3] posed points in world space
    bweights: torch.Tensor       # [N, J] blend weights used
    transforms: torch.Tensor     # [N, 3, 3] world rotation of each Gaussian
    translation: torch.Tensor    # [N, 3] world = T x + t
    world_normals: torch.Tensor  # [N, 3]


def apply_correct_rs(rot_mats: torch.Tensor, correct_Rs: torch.Tensor | None) -> torch.Tensor:
    """Fold learned per-joint correction rotations into non-root joints."""
    if correct_Rs is None:
        return rot_mats
    return torch.cat([rot_mats[:1], rot_mats[1:] @ correct_Rs], dim=0)


def transform_params(
    model: SMPLModel,
    params: dict,
    rot_mats: torch.Tensor | None = None,
    correct_Rs: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-joint rest->posed rigid transforms A [J, 4, 4] and rest joints."""
    v_shaped = model.v_template + torch.einsum(
        "vdb,b->vd", model.shapedirs, params["shapes"].reshape(-1))
    joints = model.j_regressor @ v_shaped
    if rot_mats is None:
        rot_mats = rodrigues(params["poses"].reshape(-1, 3))
        rot_mats = apply_correct_rs(rot_mats, correct_Rs)
    G = rigid_transform_chain(rot_mats, joints, model.parents)
    return remove_rest_joint_translation(G, joints), joints


def _pose_offsets(model: SMPLModel, rot_mats: torch.Tensor) -> torch.Tensor:
    """Per-vertex pose blendshape offsets [V, 3] from (R - I) features."""
    ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    feature = (rot_mats[1:] - ident).reshape(-1)  # [(J - 1) * 9]: 207 or 486
    return torch.einsum("vdp,p->vd", model.posedirs, feature)


def coarse_deform_c2source(
    model: SMPLModel,
    query_pts: torch.Tensor,            # [N, 3] canonical (big pose) Gaussians
    params: dict,                       # poses [72], shapes [B], R [3,3], Th [3]
    big_pose_params: dict,
    big_pose_verts: torch.Tensor,       # [V, 3]
    lbs_offset: torch.Tensor | None = None,   # [N, J] weight-logit offsets
    correct_Rs: torch.Tensor | None = None,   # [J - 1, 3, 3]
    normals: torch.Tensor | None = None,      # [N, 3]
    vert_ids: torch.Tensor | None = None,     # [N] nearest SMPL vertex
) -> DeformOutput:
    """Deform canonical Gaussians to the observed frame."""
    N = query_pts.shape[0]
    if normals is None:
        normals = torch.zeros_like(query_pts)
    if vert_ids is None:
        _, idx = knn(query_pts, big_pose_verts, k=1)
        vert_ids = idx[:, 0]
    vert_ids = vert_ids.long()

    bweights = model.weights[vert_ids]  # [N, J]
    if lbs_offset is not None:
        bweights = torch.log(bweights + 1e-9) + lbs_offset
        bweights = torch.exp(bweights - bweights.max(dim=-1, keepdim=True).values)
        bweights = bweights / bweights.sum(dim=-1, keepdim=True)

    def blend12(A):
        """[J, 4, 4] -> [12, N] components (r00, r01, r02, t0, ..., t2)."""
        return torch.einsum("jk,nj->kn", A[:, :3, :].reshape(-1, 12), bweights)

    A_big, _ = transform_params(model, big_pose_params)
    big_rot_mats = rodrigues(big_pose_params["poses"].reshape(-1, 3))
    rot_mats = rodrigues(params["poses"].reshape(-1, 3))
    rot_mats = apply_correct_rs(rot_mats, correct_Rs)
    A_src, _ = transform_params(model, params, rot_mats=rot_mats)

    # -pose_offset(big) + shape_offset + pose_offset(target), combined at
    # vertex level so one gather serves all three
    shape_offset_v = torch.einsum(
        "vdb,b->vd", model.shapedirs, params["shapes"].reshape(-1))
    off_v = (-_pose_offsets(model, big_rot_mats) + shape_offset_v
             + _pose_offsets(model, rot_mats))
    off = off_v[vert_ids]

    Rg = params["R"].float()
    scalars = torch.zeros((1, 32), dtype=torch.float32, device=query_pts.device)
    scalars = torch.cat([Rg.reshape(1, 9), inv3x3(Rg).reshape(1, 9),
                         params["Th"].reshape(1, 3).float(), scalars[:, 21:]], dim=1)

    packed = torch.cat([query_pts.T, normals.T, off.T], dim=0)   # [9, N]
    out = deform_rows(blend12(A_big).contiguous(), blend12(A_src).contiguous(),
                      packed.contiguous(), scalars)

    return DeformOutput(
        smpl_pts=out[0:3].T,
        world_pts=out[3:6].T,
        bweights=bweights,
        transforms=out[6:15].T.reshape(N, 3, 3),
        translation=out[15:18].T,
        world_normals=out[18:21].T,
    )
