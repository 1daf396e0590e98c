"""Canonical-to-posed deformation of the plain reference: the nearest SMPL
vertex of each Gaussian, the learned corrections, and the LBS chain.

The published chain (GauHuman `coarse_deform_c2source`, as
`mygauhuman_torch/models/lbs.py` documents it): undo the big pose to the
T pose with the inverse of the Gaussian's blended big-pose transform, add
the combined blendshape offset (minus the big pose's pose offset, plus the
shape offset, plus the target pose's pose offset) of its nearest vertex,
skin to the target pose with the blended target transform, then apply the
global rotation and translation. The program runs kernel A for the
nearest vertex and kernel B for the chain; here both are plain PyTorch in
the operation order the program states (the near-singular guard of the
inverse: |det| < 1e-8). The correction MLPs follow
`models/mlps.py` (pose refiner -> per-joint rotations through the
regularised Rodrigues; PE-63 LBS-offset decoder with a skip after layer 2).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from port_bench.reference import body as B
from port_bench.reference.transforms import inv3x3, rodrigues, rodrigues_mlp


def nearest_vertex(points, verts, block: int = 4096):
    """Index of the nearest vertex of each point, the lowest on ties, by the
    squared distance |q|^2 + |r|^2 - 2 q.r clamped at 0, each term summed
    over x, y, z in that order: the program's statement of the search, so
    that a near-tie breaks the same way on both sides."""
    rx, ry, rz = verts[:, 0], verts[:, 1], verts[:, 2]
    rn = rx * rx + ry * ry + rz * rz
    out = []
    for q0 in range(0, points.shape[0], block):
        q = points[q0:q0 + block]
        qx, qy, qz = q[:, 0:1], q[:, 1:2], q[:, 2:3]
        qn = qx * qx + qy * qy + qz * qz
        cross = qx * rx + qy * ry + qz * rz
        out.append(torch.argmin(torch.clamp(qn + rn - 2.0 * cross, min=0.0), dim=1))
    return torch.cat(out)


def positional_encode(x, freqs: int = 10):
    outs = [x]
    for i in range(freqs):
        outs.append(torch.sin((2.0 ** i) * x))
        outs.append(torch.cos((2.0 ** i) * x))
    return torch.cat(outs, dim=-1)


def pose_refiner(params: dict, pose_vec):
    """[3 (J - 1)] non-root pose -> [J - 1, 3, 3] correction rotations."""
    h = pose_vec
    layers = params["layers"]
    for p in layers[:-1]:
        h = torch.relu(h @ p["w"] + p["b"])
    return rodrigues_mlp((h @ layers[-1]["w"] + layers[-1]["b"]).reshape(-1, 3))


def lbs_offset(params: dict, pts, skips=(2,)):
    """[N, 3] canonical points -> [N, J] blend-weight logit offsets."""
    feat = positional_encode(pts)
    h = feat
    for i, p in enumerate(params["layers"]):
        h = torch.relu(h @ p["w"] + p["b"])
        if i in skips:
            h = torch.cat([feat, h], dim=-1)
    return h @ params["head"]["w"] + params["head"]["b"]


# ---- the chain, op for op as the program states it ----------------------------
# (a frozen copy of `ops/pallas_deform.py`'s plain forward, which kernel B
# matches bit for bit: the same float operations in the same order, so a
# near-tie of depths or of the 1/255 alpha test falls the same way)

def _mat_vec(m, v):
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m
    v0, v1, v2 = v
    return (m00 * v0 + m01 * v1 + m02 * v2,
            m10 * v0 + m11 * v1 + m12 * v2,
            m20 * v0 + m21 * v1 + m22 * v2)


def _mat_mat(a, b):
    a00, a01, a02, a10, a11, a12, a20, a21, a22 = a
    b00, b01, b02, b10, b11, b12, b20, b21, b22 = b
    return (
        a00 * b00 + a01 * b10 + a02 * b20,
        a00 * b01 + a01 * b11 + a02 * b21,
        a00 * b02 + a01 * b12 + a02 * b22,
        a10 * b00 + a11 * b10 + a12 * b20,
        a10 * b01 + a11 * b11 + a12 * b21,
        a10 * b02 + a11 * b12 + a12 * b22,
        a20 * b00 + a21 * b10 + a22 * b20,
        a20 * b01 + a21 * b11 + a22 * b21,
        a20 * b02 + a21 * b12 + a22 * b22,
    )


def _apply_rgi(rgi, v):
    """v @ Rg^-1 (row-vector convention of lbs.py apply_rg_inv)."""
    v0, v1, v2 = v
    return (v0 * rgi[0] + v1 * rgi[3] + v2 * rgi[6],
            v0 * rgi[1] + v1 * rgi[4] + v2 * rgi[7],
            v0 * rgi[2] + v1 * rgi[5] + v2 * rgi[8])


class _Chain(NamedTuple):
    """The forward chain's values that the outputs and the adjoint read."""
    cof: tuple     # adjugate (A .. I) of the big-pose blend
    guard: object  # |det| < 1e-8: det replaced, no gradient into it
    inv: object    # 1 / det
    r: tuple       # the inverse blend
    u: tuple       # point - big-pose translation
    x: tuple       # T-pose point, with the offset
    nrm: tuple     # T-pose normal
    tr: tuple      # T-pose translation, with the offset
    smpl: tuple    # target-pose point
    nrm2: tuple    # target-pose normal
    tf: tuple      # rs r
    tr2: tuple     # target-pose translation


def _chain(ab, as_, pk):
    """The chain up to the target pose on component rows, op for op as
    csrc/deform.cu."""
    (b00, b01, b02, bt0, b10, b11, b12, bt1, b20, b21, b22, bt2) = ab
    (s00, s01, s02, st0, s10, s11, s12, st1, s20, s21, s22, st2) = as_
    q0, q1, q2, n0, n1, n2, o0, o1, o2 = pk

    # inverse of the big-pose blend: adjugate with the det guard
    A = b11 * b22 - b12 * b21
    B_ = b02 * b21 - b01 * b22
    C = b01 * b12 - b02 * b11
    D = b12 * b20 - b10 * b22
    E = b00 * b22 - b02 * b20
    F_ = b02 * b10 - b00 * b12
    G = b10 * b21 - b11 * b20
    H = b01 * b20 - b00 * b21
    I = b00 * b11 - b01 * b10
    det = b00 * A + b01 * D + b02 * G
    guard = det.abs() < 1e-8
    det = torch.where(guard, torch.sign(det) * 1e-8 + 1e-12, det)
    inv = 1.0 / det
    cof = (A, B_, C, D, E, F_, G, H, I)
    r = tuple(c * inv for c in cof)

    # big pose -> T pose, then the combined blendshape offset
    u = (q0 - bt0, q1 - bt1, q2 - bt2)
    x = _mat_vec(r, u)
    nrm = _mat_vec(r, (n0, n1, n2))
    tr = _mat_vec(r, (-bt0, -bt1, -bt2))
    x = (x[0] + o0, x[1] + o1, x[2] + o2)
    tr = (tr[0] + o0, tr[1] + o1, tr[2] + o2)

    # T pose -> target pose
    rs = (s00, s01, s02, s10, s11, s12, s20, s21, s22)
    sp = _mat_vec(rs, x)
    smpl = (sp[0] + st0, sp[1] + st1, sp[2] + st2)
    nrm2 = _mat_vec(rs, nrm)
    tf = _mat_mat(rs, r)
    tr2 = _mat_vec(rs, tr)
    tr2 = (tr2[0] + st0, tr2[1] + st1, tr2[2] + st2)
    return _Chain(cof, guard, inv, r, u, x, nrm, tr, smpl, nrm2, tf, tr2)


def _deform_math(ab, as_, pk, sc):
    """The chain on component rows, op for op as csrc/deform.cu: 21 rows."""
    c = _chain(ab, as_, pk)
    rg, rgi, th = sc[0:9], sc[9:18], sc[18:21]
    # SMPL -> world
    wp = _apply_rgi(rgi, c.smpl)
    wn = _apply_rgi(rgi, c.nrm2)
    tf = _mat_mat(rg, c.tf)
    trw = _apply_rgi(rgi, c.tr2)
    return (*c.smpl,
            wp[0] + th[0], wp[1] + th[1], wp[2] + th[2],
            *tf,
            trw[0] + th[0], trw[1] + th[1], trw[2] + th[2],
            *wn)


def deform(body: dict, xyz, normals, params: dict, big: dict, big_verts,
           mlp: dict | None):
    """(world points [N, 3], world normals [N, 3], transforms [N, 3, 3],
    translation [N, 3]) of canonical Gaussians at the frame `params`
    (`models/lbs.py::coarse_deform_c2source`'s statement)."""
    N = xyz.shape[0]
    vid = nearest_vertex(xyz.detach(), big_verts)
    bw = body["weights"][vid]
    rot = rodrigues(params["poses"].reshape(-1, 3))
    if mlp is not None:
        corr = pose_refiner(mlp["pose_refiner"], params["poses"].reshape(-1)[3:])
        rot = torch.cat([rot[:1], rot[1:] @ corr], dim=0)
        bw = torch.log(bw + 1e-9) + lbs_offset(mlp["lbs_offset"], xyz.detach())
        bw = torch.exp(bw - bw.max(dim=-1, keepdim=True).values)
        bw = bw / bw.sum(dim=-1, keepdim=True)

    def blend12(A):
        return torch.einsum("jk,nj->kn", A[:, :3, :].reshape(-1, 12), bw)

    big_rot = rodrigues(big["poses"].reshape(-1, 3))
    A_big = B.joint_transforms(body, big, big_rot)
    A_src = B.joint_transforms(body, params, rot)
    off_v = (-B.pose_offsets(body, big_rot)
             + torch.einsum("vdb,b->vd", body["shapedirs"], params["shapes"].reshape(-1))
             + B.pose_offsets(body, rot))
    off = off_v[vid]
    Rg = params["R"].float()
    sc = [*Rg.reshape(9), *inv3x3(Rg).reshape(9), *params["Th"].reshape(3).float()]
    packed = torch.cat([xyz.T, normals.T, off.T], dim=0)
    rows = _deform_math(list(blend12(A_big).contiguous()), list(blend12(A_src).contiguous()),
                        list(packed.contiguous()), sc)
    out = torch.stack(rows, dim=0)
    return out[3:6].T, out[18:21].T, out[6:15].T.reshape(N, 3, 3), out[15:18].T
