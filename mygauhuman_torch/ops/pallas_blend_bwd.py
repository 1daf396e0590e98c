"""Backward of the instance-list blend: kernel D.

Port of ops/pallas_blend_bwd.py. Given the forward's instance matrix
[D, NS] (D = 8 + Cf, Cf = ceil8(C) feature rows; layout in
ops/pallas_blend.py) and the tile-major cotangents [T, P, Cf + 3]
(colour, then sum w, sum w depth, final T), it returns one gradient row per
instance, [NS, D]:

  0 d_x | 1 d_y | 2 d_cxx | 3 d_cxy | 4 d_cyy | 5 d_op | 6 d_depth | 7 0
  | 8.. d_feat

With `n_channels` = C < Cf the pad rows 8 + C.. are 0 (their cotangent is
taken as 0). CUDA tensors go through kernel D (`csrc/blend_bwd.cu`), three
launches: D1 cuts each tile's serial chain in T at chunks of CHUNK
instances, D1s sums w q per chunk (together the `Checkpoints`), D2 replays
the chunks in parallel into the rows. Each has its plain version here
(`blend_bwd_checkpoints_plain` for D1 and D1s together,
`blend_bwd_sums_plain`, `blend_bwd_rows_plain`); the yardstick of the
whole, and the CPU path of the standalone backward `blend_tiles_bwd_raw`,
is `blend_tiles_bwd_plain`, autograd of kernel C's plain version with
respect to the instance matrix.

A differentiated forward has kernel C write D1's checkpoints
(`ops/pallas_blend.py`, checkpoint mode), so the backward of
`blend_pallas` (`blend_pallas_bwd_raw` -> `blend_tiles_bwd_from_ckpt_raw`)
runs D1s and D2 only, or on CPU tensors their plain versions. D1 stays as
the standalone backward's first launch and the cross-check of kernel C's
checkpoints. The TPU kernel's 128-lane pad of the rows is dropped. The
per-Gaussian reduction of these rows lives with the autograd wrapper
(`ops/pallas_blend.py::blend_pallas`).
"""
from __future__ import annotations

import torch

from mygauhuman_torch.ops import cuda_lib
from mygauhuman_torch.ops.pallas_blend import (
    CHUNK,
    HDR,
    MAX_CHANNELS,
    PLAIN_TILES,
    SMEM_LIMIT,
    Checkpoints,
    _blend_instances_plain,
    _checkpoints_plain,
    _chunk_layout,
    _tile_group,
    empty_checkpoints,
    max_chunks,
)

ROWS_MAX_PIXELS = 256  # D1s' and D2's block is one tile (launch bounds)


def _cot(cotangents, cf, n_channels):
    """The cotangents with the feature pad past n_channels set to 0, and C."""
    C = cf if n_channels is None else n_channels
    if C < cf:
        cotangents = cotangents.clone()
        cotangents[..., C:cf] = 0.0
    return cotangents, C


def blend_tiles_bwd_plain(data, starts, counts, tile_base, cotangents, *, n_tiles,
                          tiles_x, tile_w=16, tile_h=16, n_channels=None):
    """Plain PyTorch version of kernel D: the gradient of kernel C's plain
    version with respect to `data` at the given cotangents, as [NS, D]."""
    cf = data.shape[0] - HDR
    cotangents, _ = _cot(cotangents, cf, n_channels)
    with torch.enable_grad():
        d = data.detach().requires_grad_(True)
        out, _, _, _ = _blend_instances_plain(
            d, starts, counts, tile_base, n_tiles=n_tiles, tiles_x=tiles_x,
            n_channels=cf, tile_w=tile_w, tile_h=tile_h)
        (g,) = torch.autograd.grad(out, d, cotangents.permute(0, 2, 1), allow_unused=True)
    if g is None:
        g = torch.zeros_like(d)
    return g.T.contiguous()


def blend_bwd_checkpoints_plain(data, starts, counts, tile_base, cotangents, *, n_tiles,
                                tiles_x, tile_w=16, tile_h=16, n_channels=None,
                                chunk=CHUNK) -> Checkpoints:
    """Plain PyTorch version of D1 and D1s together, from kernel C's plain
    per-pixel T (the log-space cumulative product of
    `ops/blend.py::transmittance`)."""
    cotangents, C = _cot(cotangents.float(), data.shape[0] - HDR, n_channels)
    return _checkpoints_plain(data, starts, counts, tile_base, cotangents, C,
                              n_tiles=n_tiles, tiles_x=tiles_x, tile_w=tile_w,
                              tile_h=tile_h, chunk=chunk)


def _replay_group(data, starts, counts, tile_base, cotangents, ckpt, nch_all, off_all,
                  t0, t1, C, *, tiles_x, tile_w, tile_h, chunk):
    """Tiles [t0, t1) replayed from the checkpoints, chunk by chunk: T
    before each instance is its chunk's checkpoint times the chunk's
    earlier (1 - alpha) of included instances. [B, K, P] terms."""
    P = tile_w * tile_h
    cf = data.shape[0] - HDR
    dev = data.device
    B = t1 - t0
    cols, valid, pos, k, nchk, px, py = _tile_group(
        data, starts, counts, tile_base, t0, t1, tiles_x, tile_w, tile_h, chunk)
    x, y, cxx, cxy, cyy, op, dep = (r[..., None] for r in cols[:7])   # [B, K, 1]
    dx = x - px[:, None, :]
    dy = y - py[:, None, :]
    power = -0.5 * (cxx * dx * dx + cyy * dy * dy) - cxy * dx * dy
    e_p = torch.exp(power)
    raw = op * e_p
    alpha = torch.clamp(raw, max=0.99)
    incl = (valid[..., None] & (power <= 0.0) & (alpha >= 1.0 / 255.0)
            & (k[None, :, None] < ckpt.stop[t0:t1].long()[:, None, :]))
    a = torch.where(incl, alpha, torch.zeros_like(alpha))
    c_ar = torch.arange(nchk, device=dev)
    in_tile = (c_ar[None, :] < nch_all[t0:t1, None])[..., None]         # [B, nchk, 1]
    slot = torch.clamp(off_all[t0:t1, None] + c_ar[None, :], max=ckpt.t_start.shape[0] - 1)
    ts = torch.where(in_tile, ckpt.t_start[slot], torch.ones_like(ckpt.t_start[slot]))
    one_m = (1.0 - a).reshape(B, nchk, chunk, P)
    before = torch.cat([torch.ones_like(one_m[:, :, :1]),
                        torch.cumprod(one_m, dim=2)[:, :, :-1]], dim=2)
    t_b = (ts[:, :, None, :] * before).reshape(B, -1, P)
    cot = cotangents[t0:t1]
    q = (torch.einsum("bkc,bpc->bkp", cols[HDR:HDR + C].permute(1, 2, 0), cot[..., :C])
         + cot[:, None, :, cf] + dep * cot[:, None, :, cf + 1])
    return dict(B=B, nchk=nchk, pos=pos, valid=valid, in_tile=in_tile, slot=slot,
                dx=dx, dy=dy, cxx=cxx, cxy=cxy, cyy=cyy, op=op, e_p=e_p, raw=raw,
                alpha=alpha, incl=incl, t_b=t_b, w=a * t_b, q=q, cot=cot)


def blend_bwd_sums_plain(data, starts, counts, tile_base, cotangents, ckpt: Checkpoints,
                         *, n_tiles, tiles_x, tile_w=16, tile_h=16, n_channels=None,
                         chunk=CHUNK):
    """Plain PyTorch version of D1s: each chunk's sum of w q [G, P] from the
    T checkpoints and stops (slots past n_chunks 0)."""
    P = tile_w * tile_h
    cotangents, C = _cot(cotangents.float(), data.shape[0] - HDR, n_channels)
    nch_all, off_all, _ = _chunk_layout(counts, n_tiles, chunk)
    sums = torch.zeros_like(ckpt.t_start)
    for t0 in range(0, n_tiles, PLAIN_TILES):
        t1 = min(t0 + PLAIN_TILES, n_tiles)
        r = _replay_group(data, starts, counts, tile_base, cotangents, ckpt, nch_all, off_all,
                          t0, t1, C, tiles_x=tiles_x, tile_w=tile_w, tile_h=tile_h,
                          chunk=chunk)
        per = (r["w"] * r["q"]).reshape(r["B"], r["nchk"], chunk, P).sum(dim=2)
        inside = r["in_tile"][..., 0]
        sums[r["slot"][inside]] = per[inside]
    return sums


def blend_bwd_rows_plain(data, starts, counts, tile_base, cotangents, ckpt: Checkpoints,
                         *, n_tiles, tiles_x, tile_w=16, tile_h=16, n_channels=None,
                         chunk=CHUNK):
    """Plain PyTorch version of D2: the rows [NS, D] from the checkpoints.
    S after an instance is the chunk's later w q, then the tile's later
    chunk sums."""
    P = tile_w * tile_h
    D, ns = data.shape
    cf = D - HDR
    cotangents, C = _cot(cotangents.float(), cf, n_channels)
    nch_all, off_all, _ = _chunk_layout(counts, n_tiles, chunk)
    grads = torch.zeros((ns, D), dtype=torch.float32, device=data.device)
    for t0 in range(0, n_tiles, PLAIN_TILES):
        t1 = min(t0 + PLAIN_TILES, n_tiles)
        r = _replay_group(data, starts, counts, tile_base, cotangents, ckpt, nch_all, off_all,
                          t0, t1, C, tiles_x=tiles_x, tile_w=tile_w, tile_h=tile_h,
                          chunk=chunk)
        B, nchk, cot, w, q = r["B"], r["nchk"], r["cot"], r["w"], r["q"]
        cs = torch.where(r["in_tile"], ckpt.chunk_sum[r["slot"]],
                         torch.zeros_like(ckpt.chunk_sum[r["slot"]]))
        # S after each chunk: the later chunk sums (suffix, no subtraction)
        s_end = torch.cat([cs.flip(1).cumsum(1).flip(1)[:, 1:],
                           torch.zeros_like(cs[:, :1])], dim=1)
        wq = (w * q).reshape(B, nchk, chunk, P)
        s_in = torch.cat([wq.flip(2).cumsum(2).flip(2)[:, :, 1:],
                          torch.zeros_like(wq[:, :, :1])], dim=2)
        S = (s_end[:, :, None, :] + s_in).reshape(B, -1, P)
        tail = (ckpt.t_final[t0:t1] * cot[..., cf + 2])[:, None, :]
        d_a = r["t_b"] * q - (S + tail) / torch.clamp(1.0 - r["alpha"], min=1e-6)
        chain = r["incl"] & (r["raw"] < 0.99)
        d_pow = torch.where(chain, d_a * r["op"] * r["e_p"], torch.zeros_like(d_a))
        dx, dy, cxx, cxy, cyy = (r[n] for n in ("dx", "dy", "cxx", "cxy", "cyy"))
        rows = torch.zeros((B, q.shape[1], D), dtype=torch.float32, device=data.device)
        rows[..., 0] = (d_pow * -(cxx * dx + cxy * dy)).sum(-1)
        rows[..., 1] = (d_pow * -(cyy * dy + cxy * dx)).sum(-1)
        rows[..., 2] = (d_pow * (-0.5 * dx * dx)).sum(-1)
        rows[..., 3] = (d_pow * (-dx * dy)).sum(-1)
        rows[..., 4] = (d_pow * (-0.5 * dy * dy)).sum(-1)
        rows[..., 5] = torch.where(chain, d_a * r["e_p"], torch.zeros_like(d_a)).sum(-1)
        rows[..., 6] = torch.einsum("bkp,bp->bk", w, cot[..., cf + 1])
        rows[..., HDR:HDR + C] = torch.einsum("bkp,bpc->bkc", w, cot[..., :C])
        valid = r["valid"]
        grads[r["pos"][valid]] = rows[valid]
    return grads


def checkpoint_errors(got: Checkpoints, want: Checkpoints, counts) -> dict:
    """The checkpoints of D1 and D1s against the plain ones where both are
    defined.

    The kernel's T is kernel C's serial fp32 product; the plain T is the
    exp of a fp32 log-space cumsum. A pixel whose T lands within rounding of
    the 1e-4 threshold may stop one instance apart in the two: then the
    version that included the instance ends with T_final within 1e-4
    relative of 1e-4 (a near-tie). Returns the slot count and map equality,
    the stop mismatches that are not near-ties, the near-ties, and off the
    pixels whose stops differ the largest relative error of T before each
    chunk and of T_final, and the largest chunk-sum error over the largest
    chunk sum."""
    n = int(want.n_chunks)
    busy = (counts > 0)[:, None]
    differ = (got.stop != want.stop) & busy
    tie = torch.minimum(got.t_final, want.t_final) < 1e-4 * (1.0 + 1e-4)
    keep = ~differ[want.chunk_map[:n, 0].long()]                     # [n, P]
    t_rel = (got.t_start[:n] - want.t_start[:n]).abs() / want.t_start[:n]
    f_rel = (got.t_final - want.t_final).abs() / want.t_final
    s_err = (got.chunk_sum[:n] - want.chunk_sum[:n]).abs()
    s_max = float(want.chunk_sum[:n].abs().max()) if n else 0.0

    def top(x):
        return float(x.max()) if x.numel() else 0.0

    return dict(
        n_chunks_equal=int(got.n_chunks) == n,
        map_equal=bool(torch.equal(got.chunk_map[:n], want.chunk_map[:n])),
        stop_mismatch=int((differ & ~tie).sum()), near_ties=int((differ & tie).sum()),
        t_rel=top(t_rel[keep]), t_final_rel=top(f_rel[busy & ~differ]),
        sum_rel=top(s_err[keep]) / s_max if s_max > 0 else 0.0)


def checkpoint_mismatches(got: Checkpoints, want: Checkpoints, counts) -> dict:
    """Values that differ, bit for bit, between two checkpoint sets of the
    same serial product (kernel C's checkpoint mode and D1) where both are
    defined: the slot count, the map and T of the slots in use, stop and
    T_final of the tiles that hold instances. The chunk sums are not
    compared (D1s writes them)."""
    n = int(want.n_chunks)
    busy = counts > 0
    return dict(
        n_chunks=int(int(got.n_chunks) != n),
        chunk_map=int((got.chunk_map[:n] != want.chunk_map[:n]).sum()),
        t_start=int((got.t_start[:n] != want.t_start[:n]).sum()),
        stop=int((got.stop[busy] != want.stop[busy]).sum()),
        t_final=int((got.t_final[busy] != want.t_final[busy]).sum()))


def _kernel_inputs(name, data, starts, counts, cotangents, n_tiles, P, n_channels):
    """Checked, contiguous inputs of kernel D's launches, and (Cf, C)."""
    if not data.is_cuda or data.dtype != torch.float32 or data.dim() != 2:
        raise ValueError(f"{name} takes a float32 CUDA instance matrix [D, NS]")
    cf = data.shape[0] - HDR
    C = cf if n_channels is None else n_channels
    if not 1 <= C <= cf <= MAX_CHANNELS:
        raise ValueError(f"{name} takes 1 <= C <= Cf <= {MAX_CHANNELS} feature rows, "
                         f"got C={C}, Cf={cf}")
    if P > ROWS_MAX_PIXELS or P % 32:
        raise ValueError(f"{name} needs a tile of whole warps (<= {ROWS_MAX_PIXELS} px), "
                         f"got {P}")
    if (cotangents.shape != (n_tiles, P, cf + 3) or cotangents.dtype != torch.float32
            or cotangents.device != data.device):
        raise ValueError(f"cotangents must be float32 [{n_tiles}, {P}, {cf + 3}] on "
                         f"{data.device}, got {tuple(cotangents.shape)}")
    for label, t in (("starts", starts), ("counts", counts)):
        if t.shape != (n_tiles,) or t.device != data.device:
            raise ValueError(f"{label} must be [{n_tiles}] on {data.device}")
    return (data.contiguous(), starts.to(torch.int32).contiguous(),
            counts.to(torch.int32).contiguous(), cotangents.contiguous(), cf, C)


def _check_checkpoints(ckpt, data, n_tiles, P):
    G = max_chunks(data.shape[1], n_tiles)
    want = ((G, P), (G, P), (n_tiles, P), (n_tiles, P), (G, 2), (1,))
    for x, shape, dtype in zip(ckpt, want, (torch.float32, torch.float32, torch.int32,
                                            torch.float32, torch.int32, torch.int32)):
        if x.shape != shape or x.dtype != dtype or x.device != data.device or \
                not x.is_contiguous():
            raise ValueError(f"checkpoints must be D1's for these inputs: {shape} "
                             f"{dtype}, got {tuple(x.shape)} {x.dtype}")


def blend_bwd_ckpt_cuda(data, starts, counts, tile_base, cotangents, *, n_tiles, tiles_x,
                        tile_w=16, tile_h=16, n_channels=None) -> Checkpoints:
    """Launch D1: the checkpoints but the chunk sums (allocated, left for
    blend_bwd_sums_cuda); the rest as blend_bwd_checkpoints_plain where
    that is defined (slots < n_chunks; stop and t_final of tiles that hold
    instances)."""
    P = tile_w * tile_h
    data, starts, counts, _, _, _ = _kernel_inputs(
        "kernel D1", data, starts, counts, cotangents, n_tiles, P, n_channels)
    dev = data.device
    ckpt = empty_checkpoints(data.shape[1], n_tiles, P, dev)   # n_chunks: D1's last block
    fn = cuda_lib.library("blend_bwd").blend_bwd_ckpt
    err = fn(data.data_ptr(), data.shape[1], starts.data_ptr(), counts.data_ptr(), n_tiles,
             int(tile_base), tiles_x, tile_w, tile_h, ckpt.t_start.shape[0],
             ckpt.t_start.data_ptr(),
             ckpt.stop.data_ptr(), ckpt.t_final.data_ptr(), ckpt.chunk_map.data_ptr(),
             ckpt.n_chunks.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check("blend_bwd_ckpt", err)
    cuda_lib.LAUNCHES["blend_bwd_ckpt"] += 1
    return ckpt


def blend_bwd_sums_cuda(data, starts, counts, tile_base, cotangents, ckpt: Checkpoints, *,
                        n_tiles, tiles_x, tile_w=16, tile_h=16, n_channels=None):
    """Launch D1s: fill ckpt.chunk_sum (slots < n_chunks) in place, as
    blend_bwd_sums_plain; returns ckpt."""
    P = tile_w * tile_h
    data, starts, counts, cot, cf, C = _kernel_inputs(
        "kernel D1s", data, starts, counts, cotangents, n_tiles, P, n_channels)
    _check_checkpoints(ckpt, data, n_tiles, P)
    fn = cuda_lib.library("blend_bwd").blend_bwd_sums
    err = fn(data.data_ptr(), data.shape[1], starts.data_ptr(), counts.data_ptr(), n_tiles,
             int(tile_base), tiles_x, C, cf, tile_w, tile_h, cot.data_ptr(),
             ckpt.t_start.shape[0], ckpt.t_start.data_ptr(), ckpt.stop.data_ptr(),
             ckpt.chunk_map.data_ptr(), ckpt.n_chunks.data_ptr(), ckpt.chunk_sum.data_ptr(),
             torch.cuda.current_stream(data.device).cuda_stream)
    cuda_lib.check("blend_bwd_sums", err)
    cuda_lib.LAUNCHES["blend_bwd_sums"] += 1
    return ckpt


def blend_bwd_checkpoints_cuda(data, starts, counts, tile_base, cotangents, *, n_tiles,
                               tiles_x, tile_w=16, tile_h=16,
                               n_channels=None) -> Checkpoints:
    """Launch D1 then D1s; same output as blend_bwd_checkpoints_plain where
    that is defined."""
    kw = dict(n_tiles=n_tiles, tiles_x=tiles_x, tile_w=tile_w, tile_h=tile_h,
              n_channels=n_channels)
    ckpt = blend_bwd_ckpt_cuda(data, starts, counts, tile_base, cotangents, **kw)
    return blend_bwd_sums_cuda(data, starts, counts, tile_base, cotangents, ckpt, **kw)


def blend_bwd_rows_cuda(data, starts, counts, tile_base, cotangents, ckpt: Checkpoints, *,
                        n_tiles, tiles_x, tile_w=16, tile_h=16, n_channels=None):
    """Launch D2; same output as blend_bwd_rows_plain."""
    P = tile_w * tile_h
    data, starts, counts, cot, cf, C = _kernel_inputs(
        "kernel D2", data, starts, counts, cotangents, n_tiles, P, n_channels)
    if (7 + C) * CHUNK * (1 + P // 32) * 4 > SMEM_LIMIT:
        raise ValueError(f"tile {tile_w}x{tile_h} with {C} channels exceeds "
                         "kernel D2's shared memory")
    _check_checkpoints(ckpt, data, n_tiles, P)
    G = ckpt.t_start.shape[0]
    grads = torch.zeros((data.shape[1], data.shape[0]), dtype=torch.float32,
                        device=data.device)
    fn = cuda_lib.library("blend_bwd").blend_bwd_rows
    err = fn(data.data_ptr(), data.shape[1], starts.data_ptr(), counts.data_ptr(), n_tiles,
             int(tile_base), tiles_x, C, cf, tile_w, tile_h, cot.data_ptr(), G,
             *(x.data_ptr() for x in ckpt), grads.data_ptr(),
             torch.cuda.current_stream(data.device).cuda_stream)
    cuda_lib.check("blend_bwd_rows", err)
    cuda_lib.LAUNCHES["blend_bwd_rows"] += 1
    return grads


def blend_tiles_bwd_cuda(data, starts, counts, tile_base, cotangents, *, n_tiles,
                         tiles_x, tile_w=16, tile_h=16, n_channels=None):
    """Launch kernel D (D1, D1s, D2); same output as blend_tiles_bwd_plain."""
    kw = dict(n_tiles=n_tiles, tiles_x=tiles_x, tile_w=tile_w, tile_h=tile_h,
              n_channels=n_channels)
    ckpt = blend_bwd_checkpoints_cuda(data, starts, counts, tile_base, cotangents, **kw)
    grads = blend_bwd_rows_cuda(data, starts, counts, tile_base, cotangents, ckpt, **kw)
    cuda_lib.LAUNCHES["blend_bwd"] += 1
    return grads


def blend_tiles_bwd_raw(data, starts, counts, tile_base, cotangents, *, n_tiles,
                        tiles_x, tile_w=16, tile_h=16, n_channels=None):
    """Per-instance gradient rows [NS, D] of tiles [tile_base, tile_base +
    n_tiles) of a tiles_x-wide grid."""
    fn = blend_tiles_bwd_cuda if data.is_cuda else blend_tiles_bwd_plain
    return fn(data, starts, counts, tile_base, cotangents, n_tiles=n_tiles,
              tiles_x=tiles_x, tile_w=tile_w, tile_h=tile_h, n_channels=n_channels)


def blend_tiles_bwd_from_ckpt_cuda(data, starts, counts, tile_base, cotangents,
                                   ckpt: Checkpoints, *, n_tiles, tiles_x, tile_w=16,
                                   tile_h=16, n_channels=None):
    """Launch D1s then D2 on kernel C's checkpoints (ckpt.chunk_sum filled in
    place); same output as blend_tiles_bwd_plain."""
    kw = dict(n_tiles=n_tiles, tiles_x=tiles_x, tile_w=tile_w, tile_h=tile_h,
              n_channels=n_channels)
    ckpt = blend_bwd_sums_cuda(data, starts, counts, tile_base, cotangents, ckpt, **kw)
    grads = blend_bwd_rows_cuda(data, starts, counts, tile_base, cotangents, ckpt, **kw)
    cuda_lib.LAUNCHES["blend_bwd"] += 1
    return grads


def blend_tiles_bwd_from_ckpt_plain(data, starts, counts, tile_base, cotangents,
                                    ckpt: Checkpoints, *, n_tiles, tiles_x, tile_w=16,
                                    tile_h=16, n_channels=None, chunk=CHUNK):
    """Plain versions of D1s then D2 on the forward's checkpoints (chunk
    sums left as they are in `ckpt`)."""
    kw = dict(n_tiles=n_tiles, tiles_x=tiles_x, tile_w=tile_w, tile_h=tile_h,
              n_channels=n_channels, chunk=chunk)
    sums = blend_bwd_sums_plain(data, starts, counts, tile_base, cotangents, ckpt, **kw)
    return blend_bwd_rows_plain(data, starts, counts, tile_base, cotangents,
                                ckpt._replace(chunk_sum=sums), **kw)


def blend_tiles_bwd_from_ckpt_raw(data, starts, counts, tile_base, cotangents,
                                  ckpt: Checkpoints, *, n_tiles, tiles_x, tile_w=16,
                                  tile_h=16, n_channels=None):
    """Per-instance gradient rows [NS, D] of tiles [tile_base, tile_base +
    n_tiles) from the checkpoints of their differentiated forward."""
    fn = blend_tiles_bwd_from_ckpt_cuda if data.is_cuda else blend_tiles_bwd_from_ckpt_plain
    return fn(data, starts, counts, tile_base, cotangents, ckpt, n_tiles=n_tiles,
              tiles_x=tiles_x, tile_w=tile_w, tile_h=tile_h, n_channels=n_channels)


def blend_pallas_bwd_raw(data, starts, counts, cotangents, ckpt: Checkpoints, *, width,
                         height, tile_w=16, tile_h=16, n_channels=None):
    """Per-instance gradient rows [NS, D] of a whole width x height image,
    from the checkpoints of its differentiated forward."""
    tw = -(-width // tile_w)
    th = -(-height // tile_h)
    return blend_tiles_bwd_from_ckpt_raw(data, starts, counts, 0, cotangents, ckpt,
                                         n_tiles=tw * th, tiles_x=tw, tile_w=tile_w,
                                         tile_h=tile_h, n_channels=n_channels)
