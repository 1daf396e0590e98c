"""Brute-force k nearest neighbours (port of ops/knn.py).

`knn` routes small reference sets (k <= 3, R <= 16,384, 3-D points) to
kernel A (`ops/pallas_knn.py`), exactly as the JAX dispatcher does; every
other case takes the blocked path below: a full-f32 matmul distance block
per query block and `topk` (or k argmin passes for k <= 3).
"""
from __future__ import annotations

import torch

from mygauhuman_torch.ops.pallas_knn import argmin_passes, knn_small_refs


def _dist2_block(q: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
    """[Qb, R] squared distances. The cross term must be full f32: TF32
    mis-picks nearest neighbours (the port never enables TF32)."""
    qn = (q * q).sum(dim=-1, keepdim=True)
    rn = (refs * refs).sum(dim=-1)[None, :]
    return torch.clamp(qn + rn - 2.0 * (q @ refs.T), min=0.0)


def knn(
    queries: torch.Tensor,
    refs: torch.Tensor,
    k: int,
    ref_mask: torch.Tensor | None = None,
    exclude_self: bool = False,
    block_size: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest refs per query: (dists2 [Q, k], idx [Q, k] int32), ascending.

    ref_mask [R] bool masks refs out; exclude_self drops ref i for query i
    (exact when queries is refs)."""
    queries = queries.detach().float()
    refs = refs.detach().float()
    Q, R = queries.shape[0], refs.shape[0]
    if k <= 3 and R <= 16384 and queries.shape[-1] == 3:
        return knn_small_refs(queries, refs, k, ref_mask=ref_mask,
                              exclude_self=exclude_self)

    col = torch.arange(R, device=refs.device)
    out_d, out_i = [], []
    for q0 in range(0, Q, block_size):
        q = queries[q0:q0 + block_size]
        d2 = _dist2_block(q, refs)
        if ref_mask is not None:
            d2 = torch.where(ref_mask.bool()[None, :], d2, torch.inf)
        if exclude_self:
            row = torch.arange(q0, q0 + q.shape[0], device=refs.device)
            d2 = torch.where(row[:, None] == col[None, :], torch.inf, d2)
        if k <= 3:
            d, i = argmin_passes(d2, k)
        else:
            d, i = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i).to(torch.int32)


def mean_knn_dist2(
    points: torch.Tensor, mask: torch.Tensor | None = None, k: int = 3
) -> torch.Tensor:
    """Mean squared distance to the k nearest other points, >= 1e-7."""
    d2, _ = knn(points, points, k=k, ref_mask=mask, exclude_self=True)
    return torch.clamp(d2.mean(dim=-1), min=1e-7)
