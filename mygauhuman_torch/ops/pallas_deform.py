"""The per-Gaussian LBS deform chain: kernel B, forward and backward.

Port of ops/pallas_deform.py. Layout contract (component-major):
  * `abig`, `asrc`: [12, N] blended joint transforms, rows
    (r00, r01, r02, t0, r10, r11, r12, t1, r20, r21, r22, t2);
  * `packed`: [9, N], rows (point 3, normal 3, combined blendshape offset 3);
  * `scalars`: [1, 32]: Rg row-major 9, Rg^-1 row-major 9, Th 3, pad;
  * output [21, N]: smpl point 3, world point 3, transform row-major 9,
    translation 3, world normal 3.

`deform_rows` launches the CUDA kernels (`csrc/deform.cu`) on CUDA tensors
inside a `torch.autograd.Function`: the forward entry, and as its backward
the backward entry (the JAX custom_vjp's `jax.vjp` of the plain chain,
here one kernel that recomputes the chain and runs its adjoint). On CPU
tensors it runs `deform_rows_plain` directly, under autograd. The plain
versions of the two entries are `deform_rows_plain` and
`deform_rows_bwd_plain`, written op for op as the kernels, which are built
with -fmad=false, so that each agrees with its kernel bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from mygauhuman_torch.ops import cuda_lib

WARP = 32   # the backward reduces the scalars' gradient per warp of Gaussians


def _mat_vec(m, v):
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m
    v0, v1, v2 = v
    return (m00 * v0 + m01 * v1 + m02 * v2,
            m10 * v0 + m11 * v1 + m12 * v2,
            m20 * v0 + m21 * v1 + m22 * v2)


def _mat_t_vec(m, v):
    """m^T v."""
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m
    v0, v1, v2 = v
    return (m00 * v0 + m10 * v1 + m20 * v2,
            m01 * v0 + m11 * v1 + m21 * v2,
            m02 * v0 + m12 * v1 + m22 * v2)


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


def _mat_t_mat(a, b):
    """a^T b."""
    return tuple(a[k] * b[j] + a[3 + k] * b[3 + j] + a[6 + k] * b[6 + j]
                 for k in range(3) for j in range(3))


def _mat_mat_t(a, b):
    """a b^T."""
    return tuple(a[3 * i] * b[3 * k] + a[3 * i + 1] * b[3 * k + 1] + a[3 * i + 2] * b[3 * k + 2]
                 for i in range(3) for k in range(3))


def _apply_rgi(rgi, v):
    """v @ Rg^-1 (row-vector convention of lbs.py apply_rg_inv)."""
    v0, v1, v2 = v
    return (v0 * rgi[0] + v1 * rgi[3] + v2 * rgi[6],
            v0 * rgi[1] + v1 * rgi[4] + v2 * rgi[7],
            v0 * rgi[2] + v1 * rgi[5] + v2 * rgi[8])


def _add(a, b):
    return tuple(x + y for x, y in zip(a, b))


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


def _deform_bwd_math(ab, as_, pk, sc, g):
    """The adjoint of `_deform_math` on component rows, op for op as
    csrc/deform.cu's backward: g (21 rows) -> the gradient rows of ab (12),
    as_ (12), pk (9), and each Gaussian's share of the scalars' (21)."""
    (b00, b01, b02, bt0, b10, b11, b12, bt1, b20, b21, b22, bt2) = ab
    rs = (*as_[0:3], *as_[4:7], *as_[8:11])
    n = pk[3:6]
    rg, rgi = sc[0:9], sc[9:18]
    c = _chain(ab, as_, pk)
    gs, gw, gT, gtr, gn = g[0:3], g[3:6], g[6:15], g[15:18], g[18:21]

    # SMPL -> world
    d_smpl = _add(gs, _mat_vec(rgi, gw))
    d_nrm2 = _mat_vec(rgi, gn)
    d_tr2 = _mat_vec(rgi, gtr)
    d_tf = _mat_t_mat(rg, gT)
    d_rg = _mat_mat_t(gT, c.tf)
    d_rgi = tuple(c.smpl[i] * gw[j] + c.nrm2[i] * gn[j] + c.tr2[i] * gtr[j]
                  for i in range(3) for j in range(3))
    d_th = _add(gw, gtr)

    # T pose -> target pose
    d_st = _add(d_smpl, d_tr2)
    dtf_rt = _mat_mat_t(d_tf, c.r)
    d_rs = tuple(d_smpl[i] * c.x[j] + d_nrm2[i] * c.nrm[j] + dtf_rt[3 * i + j]
                 + d_tr2[i] * c.tr[j] for i in range(3) for j in range(3))
    d_x = _mat_t_vec(rs, d_smpl)
    d_nrm = _mat_t_vec(rs, d_nrm2)
    d_tr = _mat_t_vec(rs, d_tr2)
    d_r = _mat_t_mat(rs, d_tf)

    # the combined blendshape offset, then big pose -> T pose
    d_o = _add(d_x, d_tr)
    mbt = (-bt0, -bt1, -bt2)
    d_r = tuple(d_r[3 * i + j] + d_x[i] * c.u[j] + d_nrm[i] * n[j] + d_tr[i] * mbt[j]
                for i in range(3) for j in range(3))
    d_q = _mat_t_vec(c.r, d_x)
    d_n = _mat_t_vec(c.r, d_nrm)
    d_mbt = _mat_t_vec(c.r, d_tr)
    d_bt = tuple(-(d_q[i] + d_mbt[i]) for i in range(3))

    # r = cofactors * inv, inv = 1 / det; where the guard fired, det is a
    # constant and takes no gradient
    A, B_, C, D, E, F_, G, H, I = c.cof
    dA, dB, dC, dD, dE, dF, dG, dH, dI = (d * c.inv for d in d_r)
    d_inv = d_r[0] * A
    for k in range(1, 9):
        d_inv = d_inv + d_r[k] * c.cof[k]
    d_det = torch.where(c.guard, 0.0, -d_inv * c.inv * c.inv)
    # det = b00 A + b01 D + b02 G
    dA = dA + d_det * b00
    dD = dD + d_det * b01
    dG = dG + d_det * b02
    d_b = (d_det * A + dE * b22 - dF * b12 - dH * b21 + dI * b11,
           d_det * D - dB * b22 + dC * b12 + dH * b20 - dI * b10,
           d_det * G + dB * b21 - dC * b11 - dE * b20 + dF * b10,
           -dD * b22 + dF * b02 + dG * b21 - dI * b01,
           dA * b22 - dC * b02 - dG * b20 + dI * b00,
           -dA * b21 + dC * b01 + dD * b20 - dF * b00,
           dD * b12 - dE * b02 - dG * b11 + dH * b01,
           -dA * b12 + dB * b02 + dG * b10 - dH * b00,
           dA * b11 - dB * b01 - dD * b10 + dE * b00)

    d_ab = (*d_b[0:3], d_bt[0], *d_b[3:6], d_bt[1], *d_b[6:9], d_bt[2])
    d_as = (*d_rs[0:3], d_st[0], *d_rs[3:6], d_st[1], *d_rs[6:9], d_st[2])
    return d_ab, d_as, (*d_q, *d_n, *d_o), (*d_rg, *d_rgi, *d_th)


def _halve(x):
    """Sum the last axis (a power of two) by halving: lane 0 of a warp's
    xor-shuffle butterfly, in its order."""
    while x.shape[-1] > 1:
        w = x.shape[-1] // 2
        x = x[..., :w] + x[..., w:]
    return x[..., 0]


def warp_sums(rows):
    """[K, N] -> [K, ceil(N / 32)]: the kernel's first pass, each warp's 32
    Gaussians summed by a butterfly (zeros past N)."""
    K, N = rows.shape
    nw = -(-N // WARP)
    return _halve(F.pad(rows, (0, nw * WARP - N)).reshape(K, nw, WARP))


def final_sums(partial):
    """[K, W] -> [K]: the kernel's second pass, lane l summing partials
    l, l + 32, ... in turn from 0, then a butterfly over the lanes."""
    K, W = partial.shape
    rounds = -(-W // WARP)
    p = F.pad(partial, (0, rounds * WARP - W)).reshape(K, rounds, WARP)
    acc = torch.zeros((K, WARP), dtype=partial.dtype, device=partial.device)
    for i in range(rounds):
        acc = acc + p[:, i]
    return _halve(acc)


def deform_rows_plain(abig, asrc, packed, scalars):
    """Plain PyTorch version: [12,N] x [12,N] x [9,N] x [1,32] -> [21,N]."""
    sc = [scalars[0, i] for i in range(21)]
    rows = _deform_math(list(abig[:12]), list(asrc[:12]), list(packed[:9]), sc)
    return torch.stack(rows, dim=0)


def deform_rows_bwd_plain(abig, asrc, packed, scalars, g):
    """Plain version of the backward kernel: the gradients of
    `deform_rows_plain`'s inputs for the output cotangent g [21, N]:
    (d_abig [12,N], d_asrc [12,N], d_packed [9,N], d_scalars [1,32]).
    d_scalars sums each Gaussian's share in the kernel's fixed order
    (`warp_sums`, then `final_sums`); its entries 21-31 are 0."""
    sc = [scalars[0, i] for i in range(21)]
    d_ab, d_as, d_pk, d_sc = _deform_bwd_math(
        list(abig[:12]), list(asrc[:12]), list(packed[:9]), sc, list(g[:21]))
    d_sc = final_sums(warp_sums(torch.stack(d_sc, dim=0)))
    d_scalars = F.pad(d_sc, (0, 32 - 21)).reshape(1, 32)
    return (torch.stack(d_ab, dim=0), torch.stack(d_as, dim=0), torch.stack(d_pk, dim=0),
            d_scalars)


def _check(abig, asrc, packed, scalars, g=None):
    n = abig.shape[1] if abig.dim() == 2 else -1
    rows = [("abig", abig, 12), ("asrc", asrc, 12), ("packed", packed, 9)]
    if g is not None:
        rows.append(("g", g, 21))
    for name, t, r in rows:
        if t.shape != (r, n):
            raise ValueError(f"{name} must be [{r}, N], got {tuple(t.shape)}")
    if scalars.shape != (1, 32):
        raise ValueError(f"scalars must be [1, 32], got {tuple(scalars.shape)}")
    for _, t, _ in rows + [("scalars", scalars, 1)]:
        if not t.is_cuda or t.dtype != torch.float32 or t.device != abig.device:
            raise ValueError("kernel B takes float32 tensors on one CUDA device")


def deform_rows_cuda(abig, asrc, packed, scalars):
    """Launch kernel B's forward (no autograd)."""
    _check(abig, asrc, packed, scalars)
    abig, asrc, packed, scalars = (t.contiguous() for t in (abig, asrc, packed, scalars))
    N = abig.shape[1]
    out = torch.empty((21, N), dtype=torch.float32, device=abig.device)
    fn = cuda_lib.library("deform").deform_rows
    err = fn(abig.data_ptr(), asrc.data_ptr(), packed.data_ptr(), scalars.data_ptr(),
             N, out.data_ptr(), torch.cuda.current_stream(abig.device).cuda_stream)
    cuda_lib.check("deform", err)
    cuda_lib.LAUNCHES["deform"] += 1
    return out


def deform_rows_bwd_cuda(abig, asrc, packed, scalars, g, needs=(True, True, True, True)):
    """Launch kernel B's backward: the gradients of abig, asrc, packed and
    scalars for the output cotangent g [21, N], each only where `needs`
    asks for it (None otherwise). The scalars' gradient takes a second,
    small launch that sums the first one's per-warp partials."""
    _check(abig, asrc, packed, scalars, g)
    abig, asrc, packed, scalars, g = (t.contiguous() for t in (abig, asrc, packed, scalars, g))
    N = abig.shape[1]

    def empty(shape, need):
        return torch.empty(shape, dtype=torch.float32, device=abig.device) if need else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    d_abig, d_asrc, d_packed = (empty((r, N), need) for r, need in zip((12, 12, 9), needs))
    d_scalars = empty((1, 32), needs[3])
    partial = empty((21, -(-N // WARP)), needs[3])
    fn = cuda_lib.library("deform").deform_rows_bwd
    err = fn(abig.data_ptr(), asrc.data_ptr(), packed.data_ptr(), scalars.data_ptr(),
             g.data_ptr(), N, ptr(d_abig), ptr(d_asrc), ptr(d_packed), ptr(partial),
             ptr(d_scalars), torch.cuda.current_stream(abig.device).cuda_stream)
    cuda_lib.check("deform_bwd", err)
    cuda_lib.LAUNCHES["deform_bwd"] += 1
    return d_abig, d_asrc, d_packed, d_scalars


class _DeformRows(torch.autograd.Function):
    """Forward: kernel B's forward entry. Backward: its backward entry (no
    second derivative, as the JAX custom_vjp)."""

    @staticmethod
    def forward(ctx, abig, asrc, packed, scalars):
        ctx.save_for_backward(abig, asrc, packed, scalars)
        return deform_rows_cuda(abig, asrc, packed, scalars)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        return deform_rows_bwd_cuda(*ctx.saved_tensors, grad_out,
                                    needs=tuple(ctx.needs_input_grad))


def deform_rows(abig, asrc, packed, scalars):
    """[12,N] x [12,N] x [9,N] x [1,32] -> [21,N]: kernel B on CUDA tensors,
    the plain version on CPU tensors."""
    if abig.is_cuda:
        return _DeformRows.apply(abig, asrc, packed, scalars)
    return deform_rows_plain(abig, asrc, packed, scalars)
