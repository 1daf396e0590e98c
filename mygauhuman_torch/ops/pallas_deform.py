"""The per-Gaussian LBS deform chain: kernel B.

Port of ops/pallas_deform.py. Layout contract (component-major):
  * `abig`, `asrc`: [12, N] blended joint transforms, rows
    (r00, r01, r02, t0, r10, r11, r12, t1, r20, r21, r22, t2);
  * `packed`: [9, N], rows (point 3, normal 3, combined blendshape offset 3);
  * `scalars`: [1, 32]: Rg row-major 9, Rg^-1 row-major 9, Th 3, pad;
  * output [21, N]: smpl point 3, world point 3, transform row-major 9,
    translation 3, world normal 3.

`deform_rows` launches the CUDA kernel (`csrc/deform.cu`) on CUDA tensors
inside a `torch.autograd.Function` whose backward is autograd through the
plain version `deform_rows_plain` (the split of the JAX custom_vjp); on CPU
tensors it runs `deform_rows_plain` directly.
"""
from __future__ import annotations

import torch

from mygauhuman_torch.ops import cuda_lib


def _deform_math(ab, as_, pk, sc):
    """The chain on component rows, op for op as csrc/deform.cu."""
    (b00, b01, b02, bt0, b10, b11, b12, bt1, b20, b21, b22, bt2) = ab
    (s00, s01, s02, st0, s10, s11, s12, st1, s20, s21, s22, st2) = as_
    q0, q1, q2, n0, n1, n2, o0, o1, o2 = pk
    rg = sc[0:9]
    rgi = sc[9:18]
    th = sc[18:21]

    A = b11 * b22 - b12 * b21
    B_ = b02 * b21 - b01 * b22
    C = b01 * b12 - b02 * b11
    D = b12 * b20 - b10 * b22
    E = b00 * b22 - b02 * b20
    F = b02 * b10 - b00 * b12
    G = b10 * b21 - b11 * b20
    H = b01 * b20 - b00 * b21
    I = b00 * b11 - b01 * b10
    det = b00 * A + b01 * D + b02 * G
    det = torch.where(det.abs() < 1e-8, torch.sign(det) * 1e-8 + 1e-12, det)
    inv = 1.0 / det
    r = (A * inv, B_ * inv, C * inv, D * inv, E * inv, F * inv,
         G * inv, H * inv, I * inv)

    def mat_vec(m, v):
        m00, m01, m02, m10, m11, m12, m20, m21, m22 = m
        v0, v1, v2 = v
        return (m00 * v0 + m01 * v1 + m02 * v2,
                m10 * v0 + m11 * v1 + m12 * v2,
                m20 * v0 + m21 * v1 + m22 * v2)

    def mat_mat(a, b):
        a00, a01, a02, a10, a11, a12, a20, a21, a22 = a
        b00_, b01_, b02_, b10_, b11_, b12_, b20_, b21_, b22_ = b
        return (
            a00 * b00_ + a01 * b10_ + a02 * b20_,
            a00 * b01_ + a01 * b11_ + a02 * b21_,
            a00 * b02_ + a01 * b12_ + a02 * b22_,
            a10 * b00_ + a11 * b10_ + a12 * b20_,
            a10 * b01_ + a11 * b11_ + a12 * b21_,
            a10 * b02_ + a11 * b12_ + a12 * b22_,
            a20 * b00_ + a21 * b10_ + a22 * b20_,
            a20 * b01_ + a21 * b11_ + a22 * b21_,
            a20 * b02_ + a21 * b12_ + a22 * b22_,
        )

    # big pose -> T pose, then the combined blendshape offset
    x = mat_vec(r, (q0 - bt0, q1 - bt1, q2 - bt2))
    nrm = mat_vec(r, (n0, n1, n2))
    translation = mat_vec(r, (-bt0, -bt1, -bt2))
    x = (x[0] + o0, x[1] + o1, x[2] + o2)
    translation = (translation[0] + o0, translation[1] + o1, translation[2] + o2)

    # T pose -> target pose
    rs = (s00, s01, s02, s10, s11, s12, s20, s21, s22)
    sp = mat_vec(rs, x)
    smpl = (sp[0] + st0, sp[1] + st1, sp[2] + st2)
    nrm = mat_vec(rs, nrm)
    tf = mat_mat(rs, r)
    tr = mat_vec(rs, translation)
    tr = (tr[0] + st0, tr[1] + st1, tr[2] + st2)

    # SMPL -> world (x @ Rg^-1 convention)
    def apply_rgi(v):
        v0, v1, v2 = v
        return (v0 * rgi[0] + v1 * rgi[3] + v2 * rgi[6],
                v0 * rgi[1] + v1 * rgi[4] + v2 * rgi[7],
                v0 * rgi[2] + v1 * rgi[5] + v2 * rgi[8])

    wp = apply_rgi(smpl)
    wn = apply_rgi(nrm)
    tf = mat_mat(rg, tf)
    trw = apply_rgi(tr)

    return (smpl[0], smpl[1], smpl[2],
            wp[0] + th[0], wp[1] + th[1], wp[2] + th[2],
            *tf,
            trw[0] + th[0], trw[1] + th[1], trw[2] + th[2],
            wn[0], wn[1], wn[2])


def deform_rows_plain(abig, asrc, packed, scalars):
    """Plain PyTorch version: [12,N] x [12,N] x [9,N] x [1,32] -> [21,N]."""
    sc = [scalars[0, i] for i in range(21)]
    rows = _deform_math(list(abig[:12]), list(asrc[:12]), list(packed[:9]), sc)
    return torch.stack(rows, dim=0)


def _check(abig, asrc, packed, scalars):
    n = abig.shape[1] if abig.dim() == 2 else -1
    for name, t, rows in (("abig", abig, 12), ("asrc", asrc, 12),
                          ("packed", packed, 9)):
        if t.shape != (rows, n):
            raise ValueError(f"{name} must be [{rows}, N], got {tuple(t.shape)}")
    if scalars.shape != (1, 32):
        raise ValueError(f"scalars must be [1, 32], got {tuple(scalars.shape)}")
    for t in (abig, asrc, packed, scalars):
        if not t.is_cuda or t.dtype != torch.float32 or t.device != abig.device:
            raise ValueError("kernel B takes float32 tensors on one CUDA device")


def deform_rows_cuda(abig, asrc, packed, scalars):
    """Launch kernel B (forward only, no autograd)."""
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


class _DeformRows(torch.autograd.Function):
    """Forward: kernel B. Backward: autograd through the plain version."""

    @staticmethod
    def forward(ctx, abig, asrc, packed, scalars):
        ctx.save_for_backward(abig, asrc, packed, scalars)
        return deform_rows_cuda(abig, asrc, packed, scalars)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = deform_rows_plain(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad_out)) if wanted else iter(())
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def deform_rows(abig, asrc, packed, scalars):
    """[12,N] x [12,N] x [9,N] x [1,32] -> [21,N]: kernel B on CUDA tensors,
    the plain version on CPU tensors."""
    if abig.is_cuda:
        return _DeformRows.apply(abig, asrc, packed, scalars)
    return deform_rows_plain(abig, asrc, packed, scalars)
