"""k nearest neighbours over a small reference set (k <= 3): kernel A.

Port of ops/pallas_knn.py. `knn_small_refs` launches the CUDA kernel
(`csrc/knn.cu`) on CUDA tensors and runs `knn_small_refs_plain`, the same
function in plain PyTorch, on CPU tensors. Exact f32: both compute
d2 = max(|q|^2 + |r|^2 - 2 (qx rx + qy ry + qz rz), 0) with the same
rounding, and break ties towards the lower index. Not differentiable.
"""
from __future__ import annotations

import torch

from mygauhuman_torch.ops import cuda_lib

BIG = 3e38
QUERY_BLOCK = 4096   # plain version: rows of the distance matrix at a time
KERNEL_QUERIES_PER_BLOCK = 16   # csrc/knn.cu QPB: a block of 4 warps
KERNEL_WARPS_PER_BLOCK = 4


def argmin_passes(d2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k passes of (row minimum, first index holding it) over d2 [Q, R],
    each masking its pick with BIG: ascending, ties to the lower index
    (argmin's tie-break is not documented for every backend, so take it
    explicitly). Returns (dists2 [Q, k], idx [Q, k] int64)."""
    R = d2.shape[1]
    col = torch.arange(R, device=d2.device)
    ds, ids = [], []
    for j in range(k):
        m = d2.min(dim=1, keepdim=True).values
        idx = torch.where(d2 == m, col, R).min(dim=1, keepdim=True).values
        ds.append(m)
        ids.append(idx)
        if j + 1 < k:
            d2 = d2.scatter(1, idx, BIG)
    return torch.cat(ds, dim=1), torch.cat(ids, dim=1)


def knn_small_refs_plain(
    queries: torch.Tensor,
    refs: torch.Tensor,
    k: int,
    ref_mask: torch.Tensor | None = None,
    exclude_self: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (dists2 [Q, k] f32, idx [Q, k] int32)."""
    queries = queries.detach().float()
    refs = refs.detach().float()
    Q, R = queries.shape[0], refs.shape[0]
    rx, ry, rz = refs[:, 0], refs[:, 1], refs[:, 2]
    rn = rx * rx + ry * ry + rz * rz
    pen = torch.zeros(R, dtype=torch.float32, device=refs.device)
    if ref_mask is not None:
        pen = torch.where(ref_mask.bool(), pen, torch.full_like(pen, BIG))
    col = torch.arange(R, device=refs.device)
    out_d, out_i = [], []
    for q0 in range(0, Q, QUERY_BLOCK):
        q = queries[q0:q0 + QUERY_BLOCK]
        qx, qy, qz = q[:, 0:1], q[:, 1:2], q[:, 2:3]
        qn = qx * qx + qy * qy + qz * qz
        cross = qx * rx + qy * ry + qz * rz
        d2 = torch.clamp(qn + rn - 2.0 * cross, min=0.0) + pen
        if exclude_self:
            row = torch.arange(q0, q0 + q.shape[0], device=refs.device)
            d2 = torch.where(row[:, None] == col[None, :],
                             torch.full_like(d2, BIG), d2)
        d, i = argmin_passes(d2, k)
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i).to(torch.int32)


def knn_small_refs_cuda(
    queries: torch.Tensor,
    refs: torch.Tensor,
    k: int,
    ref_mask: torch.Tensor | None = None,
    exclude_self: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel A on CUDA tensors."""
    if not (1 <= k <= 3):
        raise ValueError(f"kernel A takes k in 1..3, got {k}")
    for name, t in (("queries", queries), ("refs", refs)):
        if not t.is_cuda or t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name} must be a CUDA [n, 3] tensor, got "
                             f"{tuple(t.shape)} on {t.device}")
    q = queries.detach().float().contiguous()
    r = refs.detach().float().contiguous()
    if q.device != r.device:
        raise ValueError("queries and refs on different devices")
    mask = None
    if ref_mask is not None:
        if ref_mask.shape != (r.shape[0],):
            raise ValueError("ref_mask must be [R]")
        mask = ref_mask.to(device=r.device, dtype=torch.uint8).contiguous()
    Q, R = q.shape[0], r.shape[0]
    out_d = torch.empty((Q, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=q.device)
    if Q == 0:
        return out_d, out_i
    fn = cuda_lib.library("knn").knn_small_refs
    err = fn(q.data_ptr(), r.data_ptr(), mask.data_ptr() if mask is not None else None,
             Q, R, k, int(exclude_self), out_d.data_ptr(), out_i.data_ptr(),
             torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check("knn", err)
    cuda_lib.LAUNCHES["knn"] += 1
    return out_d, out_i


def knn_small_refs(
    queries: torch.Tensor,
    refs: torch.Tensor,
    k: int,
    ref_mask: torch.Tensor | None = None,
    exclude_self: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dists2 [Q, k], idx [Q, k] int32), ascending: kernel A on CUDA
    tensors, the plain version on CPU tensors."""
    if queries.is_cuda or refs.is_cuda:
        return knn_small_refs_cuda(queries, refs, k, ref_mask, exclude_self)
    return knn_small_refs_plain(queries, refs, k, ref_mask, exclude_self)
