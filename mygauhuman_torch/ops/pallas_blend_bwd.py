"""Backward of the instance-list blend: kernel D.

Port of ops/pallas_blend_bwd.py. Given the forward's instance matrix
[D, NS] (D = 8 + Cf, Cf = ceil8(C) feature rows; layout in
ops/pallas_blend.py) and the tile-major cotangents [T, P, Cf + 3]
(colour, then sum w, sum w depth, final T), it returns one gradient row per
instance, [NS, D]:

  0 d_x | 1 d_y | 2 d_cxx | 3 d_cxy | 4 d_cyy | 5 d_op | 6 d_depth | 7 0
  | 8.. d_feat

CUDA tensors go through kernel D (`csrc/blend_bwd.cu`), CPU tensors through
`blend_tiles_bwd_plain`, autograd of kernel C's plain version with respect
to the instance matrix. The TPU kernel's 128-lane pad of the rows is
dropped. The per-Gaussian reduction of these rows lives with the autograd
wrapper (`ops/pallas_blend.py::blend_pallas`).
"""
from __future__ import annotations

import torch

from mygauhuman_torch.ops import cuda_lib
from mygauhuman_torch.ops.pallas_blend import (
    HDR,
    MAX_CHANNELS,
    SMEM_LIMIT,
    _blend_instances_plain,
)


def _batch(P: int) -> int:
    """Instances staged per batch: the per-warp partials [P / 32, 7 + Cf, B]
    stay within the static shared-memory limit."""
    return min(32, 256 // (P // 32))


def blend_tiles_bwd_plain(data, starts, counts, tile_base, cotangents, *, n_tiles,
                          tiles_x, tile_w=16, tile_h=16):
    """Plain PyTorch version of kernel D: the gradient of kernel C's plain
    version with respect to `data` at the given cotangents, as [NS, D]."""
    cf = data.shape[0] - HDR
    with torch.enable_grad():
        d = data.detach().requires_grad_(True)
        out, _, _, _ = _blend_instances_plain(
            d, starts, counts, tile_base, n_tiles=n_tiles, tiles_x=tiles_x,
            n_channels=cf, tile_w=tile_w, tile_h=tile_h)
        (g,) = torch.autograd.grad(out, d, cotangents.permute(0, 2, 1), allow_unused=True)
    if g is None:
        g = torch.zeros_like(d)
    return g.T.contiguous()


def blend_tiles_bwd_cuda(data, starts, counts, tile_base, cotangents, *, n_tiles,
                         tiles_x, tile_w=16, tile_h=16):
    """Launch kernel D; same output as blend_tiles_bwd_plain."""
    P = tile_w * tile_h
    if not data.is_cuda or data.dtype != torch.float32 or data.dim() != 2:
        raise ValueError("kernel D takes a float32 CUDA instance matrix [D, NS]")
    D, ns = data.shape
    cf = D - HDR
    if not 1 <= cf <= MAX_CHANNELS:
        raise ValueError(f"kernel D takes 1..{MAX_CHANNELS} feature rows, got {cf}")
    if P > 1024 or P % 32:
        raise ValueError(f"kernel D needs a tile of whole warps (<= 1024 px), got {P}")
    if (cotangents.shape != (n_tiles, P, cf + 3) or cotangents.dtype != torch.float32
            or cotangents.device != data.device):
        raise ValueError(f"cotangents must be float32 [{n_tiles}, {P}, {cf + 3}] on "
                         f"{data.device}, got {tuple(cotangents.shape)}")
    for name, t in (("starts", starts), ("counts", counts)):
        if t.shape != (n_tiles,) or t.device != data.device:
            raise ValueError(f"{name} must be [{n_tiles}] on {data.device}")
    B = _batch(P)
    if (7 + cf) * B * (1 + P // 32) * 4 + 128 > SMEM_LIMIT:
        raise ValueError(f"tile {tile_w}x{tile_h} with {cf} feature rows exceeds "
                         "kernel D's shared memory")
    data = data.contiguous()
    cotangents = cotangents.contiguous()
    starts = starts.to(torch.int32).contiguous()
    counts = counts.to(torch.int32).contiguous()
    grads = torch.zeros((ns, D), dtype=torch.float32, device=data.device)
    fn = cuda_lib.library("blend_bwd").blend_bwd
    err = fn(data.data_ptr(), ns, starts.data_ptr(), counts.data_ptr(), n_tiles,
             int(tile_base), tiles_x, cf, tile_w, tile_h, cotangents.data_ptr(), B,
             grads.data_ptr(), torch.cuda.current_stream(data.device).cuda_stream)
    cuda_lib.check("blend_bwd", err)
    cuda_lib.LAUNCHES["blend_bwd"] += 1
    return grads


def blend_tiles_bwd_raw(data, starts, counts, tile_base, cotangents, *, n_tiles,
                        tiles_x, tile_w=16, tile_h=16):
    """Per-instance gradient rows [NS, D] of tiles [tile_base, tile_base +
    n_tiles) of a tiles_x-wide grid."""
    fn = blend_tiles_bwd_cuda if data.is_cuda else blend_tiles_bwd_plain
    return fn(data, starts, counts, tile_base, cotangents, n_tiles=n_tiles,
              tiles_x=tiles_x, tile_w=tile_w, tile_h=tile_h)


def blend_pallas_bwd_raw(data, starts, counts, cotangents, *, width, height,
                         tile_w=16, tile_h=16):
    """Per-instance gradient rows [NS, D] of a whole width x height image."""
    tw = -(-width // tile_w)
    th = -(-height // tile_h)
    return blend_tiles_bwd_raw(data, starts, counts, 0, cotangents, n_tiles=tw * th,
                               tiles_x=tw, tile_w=tile_w, tile_h=tile_h)
