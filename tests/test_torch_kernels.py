"""The port's four CUDA kernels against their plain PyTorch versions, and
the rules of the kernel wrappers. No JAX here, so on a CUDA machine
without JAX run

    python -m pytest --noconftest tests/test_torch_kernels.py -q

(`--noconftest` because tests/conftest.py imports JAX). The kernel tests
skip without a CUDA card. Tolerances: kernels A and B are built with
-fmad=false and written op for op as their plain versions, so they must be
bit-equal (B's backward too, against `deform_rows_bwd_plain`, whose scalars'
gradient sums in the kernel's fixed order; and to autograd of the plain
forward within 1e-5 of each gradient's largest value + 1e-6, the same sums in
another order); kernel C multiplies T per instance where the plain version sums
log(1 - alpha), and sums colours sequentially where it uses a matmul, so it
is held to 1e-4 abs (depth row 1e-3: depths are ~3). Kernel D divides T
back where its plain version (autograd of kernel C's) differentiates the
log-space cumsum, so each gradient component is held to 1e-4 of its
largest plain value + 1e-6; the CUDA gradients of `blend_pallas` to the
CPU ones within 1e-4 of each leaf's largest value + 1e-6, and two CUDA
runs to each other bit for bit. Kernel D's three launches on their own:
the checkpoints of D1 and D1s against their plain version by
`checkpoint_errors` (equal stops off near-ties; T and the chunk sums within
CKPT_RTOL, since the plain T is the exp of a fp32 cumsum of up to 1,024 log
terms), D1s' chunk sums against their plain version on the same T
checkpoints within CKPT_RTOL of the largest, D2's rows against their plain
version on the same checkpoints, per component as kernel D. Kernel C's
checkpoint mode (a differentiated forward) computes D1's serial product in
D1's order, so its checkpoints are held to D1's bit for bit, to the plain
ones as D1's are, and the backward of D1s and D2 on them as kernel D.
Kernel C tile-major at the occlusion bake's shapes (a 32 x 32 face, one
channel, tile capacity 256) is held as at the other shapes, and the bake's
rasterize on the card to the CPU's (alpha within 1e-4). Its launch of a
bake's stacked faces (`tiles_per_image`) is each face's own launch bit for
bit, and a launch of one image with its own tile count, at tile_base 0 or
a strip's, is the launch it was; the batched bake sweep (one graph replay,
one launch per group of cells) is the per-cell program bit for bit.
"""
import numpy as np
import pytest
import torch

from mygauhuman_torch.data.camera import make_camera
from mygauhuman_torch.ops import cuda_lib
from mygauhuman_torch.ops import pallas_blend as pb
from mygauhuman_torch.ops import pallas_blend_bwd as pbb
from mygauhuman_torch.ops.binning import bin_gaussians
from mygauhuman_torch.ops.pallas_deform import (
    deform_rows,
    deform_rows_bwd_cuda,
    deform_rows_bwd_plain,
    deform_rows_cuda,
    deform_rows_plain,
)
from mygauhuman_torch.ops.pallas_knn import (
    knn_small_refs,
    knn_small_refs_cuda,
    knn_small_refs_plain,
)
from mygauhuman_torch.ops.projection import preprocess
from mygauhuman_torch.ops.rasterize import rasterize
from mygauhuman_torch.utils.transforms import covariance6_from_scaling_rotation

torch.set_num_threads(1)
CKPT_RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest "
                    "tests/test_torch_kernels.py on the GPU")
    return torch.device("cuda")


def deform_inputs(N, seed=0, singular=True):
    rng = np.random.RandomState(seed)
    eye = np.zeros((12, 1), np.float32)
    eye[[0, 5, 10]] = 1.0
    abig = (rng.randn(12, N) * 0.1 + eye).astype(np.float32)
    asrc = (rng.randn(12, N) * 0.1 + eye).astype(np.float32)
    packed = rng.randn(9, N).astype(np.float32)
    rg = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    sc = np.zeros((1, 32), np.float32)
    sc[0, 0:9] = rg.reshape(-1)
    sc[0, 9:18] = np.linalg.inv(rg).reshape(-1)
    sc[0, 18:21] = rng.randn(3)
    if singular:   # a singular blend goes through the det guard
        abig[:, 0] = 0.0
        abig[0, 0] = 1.0
    return abig, asrc, packed, sc


def deform_bwd_inputs(device, N, seed=0, guarded=True):
    """(abig, asrc, packed, scalars, g) on `device`: deform_inputs plus a
    random cotangent. With `guarded`, columns 0-2 (where N allows) go through
    the det guard: column 0 singular, 1 and 2 at det = +-5e-9, so that 1 / det
    reaches their gradients."""
    abig, asrc, packed, sc = deform_inputs(max(N, 3), seed, singular=guarded)
    for col, s in ((1, 1.0), (2, -1.0)) if guarded else ():
        abig[[0, 1, 2, 4, 5, 6, 8, 9, 10], col] = 0.0
        abig[[0, 5, 10], col] = (1.0, s, 5e-9)
    g = np.random.RandomState(seed + 1).randn(21, max(N, 3)).astype(np.float32)
    return [torch.as_tensor(np.ascontiguousarray(a[:, :N] if a.shape[0] != 1 else a),
                            device=device) for a in (abig, asrc, packed, sc, g)]


def instance_inputs(device, w, h, n=6000, C=19, seed=8, cluster=0):
    """A projected, binned cloud of n Gaussians -> (instance data, kwargs).
    The last `cluster` of them sit in a tight clump at the centre, so that
    its tile's list reaches the 1,024-instance cap."""
    rng = np.random.RandomState(seed)
    xyz = rng.randn(n, 3) * 0.4
    xyz[n - cluster:] = rng.randn(cluster, 3) * 0.01
    means = torch.as_tensor(xyz.astype(np.float32), device=device)
    scales = torch.as_tensor(np.exp(rng.randn(n, 3) * 0.3 - 2.6).astype(np.float32),
                             device=device)
    quats = torch.as_tensor(rng.randn(n, 4).astype(np.float32), device=device)
    cov6 = covariance6_from_scaling_rotation(scales, quats)
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), w, h, fovx=1.0, fovy=1.0,
                      device=device)
    p = preprocess(means, cov6, cam.w2c, cam.full_proj, w, h, cam.tan_fovx, cam.tan_fovy)
    bins = bin_gaussians(p.means2d, p.radii, p.depths, p.visible, width=w, height=h,
                         tile_capacity=1024, instance_capacity=4 * n)
    opac = torch.as_tensor((rng.rand(n) * 0.9 + 0.05).astype(np.float32), device=device)
    feats = torch.as_tensor(rng.rand(n, C).astype(np.float32), device=device)
    inst = pb.build_instance_data(bins.sorted_rank, bins.starts,
                                  torch.clamp(bins.counts, max=1024), p.means2d, p.conics,
                                  opac, p.depths, feats, order=bins.order)
    tw = -(-w // 16)
    n_tiles = tw * (-(-h // 16))
    planar = bool(pb.row_mode_supported(n_tiles, tw, 16, 16))
    return inst, dict(n_tiles=n_tiles, tiles_x=tw, n_channels=C, planar=planar)


def test_cuda_entries_refuse_cpu_tensors():
    q = torch.zeros(10, 3)
    with pytest.raises(ValueError, match="CUDA"):
        knn_small_refs_cuda(q, q, 1)
    with pytest.raises(ValueError, match="CUDA"):
        deform_rows_cuda(*(torch.as_tensor(a) for a in deform_inputs(8)))
    with pytest.raises(ValueError, match="CUDA"):
        deform_rows_bwd_cuda(*deform_bwd_inputs("cpu", 8))
    inst, kw = instance_inputs("cpu", 32, 32, n=50, C=4)
    with pytest.raises(ValueError, match="CUDA"):
        pb.blend_instances_cuda(inst.data, inst.starts, inst.counts, 0, **kw)
    cot = torch.zeros((kw["n_tiles"], 256, inst.data.shape[0] - 5))
    with pytest.raises(ValueError, match="CUDA"):
        pbb.blend_tiles_bwd_cuda(inst.data, inst.starts, inst.counts, 0, cot,
                                 n_tiles=kw["n_tiles"], tiles_x=kw["tiles_x"])


def test_kernel_d_launches_refuse_cpu_tensors():
    inst, kw = instance_inputs("cpu", 32, 32, n=50, C=4)
    cot = torch.zeros((kw["n_tiles"], 256, inst.data.shape[0] - 5))
    args = (inst.data, inst.starts, inst.counts, 0, cot)
    tiles = dict(n_tiles=kw["n_tiles"], tiles_x=kw["tiles_x"])
    ckpt = pbb.blend_bwd_checkpoints_plain(*args, **tiles)
    with pytest.raises(ValueError, match="CUDA"):
        pbb.blend_bwd_ckpt_cuda(*args, **tiles)
    with pytest.raises(ValueError, match="CUDA"):
        pbb.blend_bwd_sums_cuda(*args, ckpt, **tiles)
    with pytest.raises(ValueError, match="CUDA"):
        pbb.blend_bwd_rows_cuda(*args, ckpt, **tiles)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    """A kernel that cannot be built raises; there is no quiet fallback."""
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_lib, "_loaded", {})
    monkeypatch.setattr(cuda_lib.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_lib.os.path, "exists", lambda path: False)
    for name in cuda_lib.SOURCES:
        with pytest.raises(RuntimeError, match="nvcc"):
            cuda_lib.library(name)


def test_plain_instance_blend_layouts_agree():
    """The planar plain output is the tile-major one rearranged."""
    inst, kw = instance_inputs("cpu", 64, 32, n=80, C=4)
    kw.pop("planar")
    tiles = pb.blend_instances_plain(inst.data, inst.starts, inst.counts, 0, **kw)
    planar = pb.blend_instances_plain(inst.data, inst.starts, inst.counts, 0,
                                      planar=True, **kw)
    img_t = pb.finish_tiles(tiles, torch.zeros(4), n_channels=4, width=64, height=32,
                            tile_w=16, tile_h=16)
    img_p = pb.finish_planar(planar, torch.zeros(4), n_channels=4, width=64, height=32)
    for a, b in zip(img_t, img_p):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(img_t[1].max()) > 0.1


@pytest.mark.parametrize("k,exclude", [(1, False), (2, False), (3, True)])
def test_knn_kernel_matches_plain(cuda, k, exclude):
    rng = np.random.default_rng(3)
    q = torch.as_tensor(rng.normal(size=(3000, 3)).astype(np.float32), device=cuda)
    r = q[:2000] if exclude else torch.as_tensor(
        rng.normal(size=(2000, 3)).astype(np.float32), device=cuda)
    q = q[:2000] if exclude else q
    mask = torch.as_tensor(rng.random(r.shape[0]) > 0.1, device=cuda)
    d_k, i_k = knn_small_refs(q, r, k, ref_mask=mask, exclude_self=exclude)
    d_p, i_p = knn_small_refs_plain(q, r, k, ref_mask=mask, exclude_self=exclude)
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_p)
    assert torch.equal(d_k, d_p)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("Q,R,mask,exclude", [
    (1001, 997, False, False),    # neither a multiple of the block's 16 queries
    (37, 2085, True, False),      # nor of the 32 slices; R spans three staged tiles
    (2085, 2085, True, True),     # the self case of mean_knn_dist2, masked
    (5, 3, False, True),          # fewer refs than slices
])
def test_knn_kernel_ragged_shapes(cuda, k, Q, R, mask, exclude):
    rng = np.random.default_rng(Q + R + k)
    r = torch.as_tensor(rng.normal(size=(R, 3)).astype(np.float32), device=cuda)
    q = r[:Q] if exclude and Q <= R else torch.as_tensor(
        rng.normal(size=(Q, 3)).astype(np.float32), device=cuda)
    m = torch.as_tensor(rng.random(R) > 0.2, device=cuda) if mask else None
    d_k, i_k = knn_small_refs_cuda(q, r, k, ref_mask=m, exclude_self=exclude)
    d_p, i_p = knn_small_refs_plain(q, r, k, ref_mask=m, exclude_self=exclude)
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_p) and torch.equal(d_k, d_p)


@pytest.mark.parametrize("Q", [16384, 32768])
def test_knn_kernel_at_the_smplx_shape(cuda, Q):
    """The SMPL-X path's queries: the state's capacity against R = 10,475
    big-pose vertices (5 full 2,048-ref tiles and a ragged 235)."""
    rng = np.random.default_rng(Q)
    r = torch.as_tensor(rng.normal(size=(10475, 3)).astype(np.float32) * 0.3, device=cuda)
    pick = rng.integers(0, 10475, Q)
    q = r[torch.as_tensor(pick, device=cuda)] + torch.as_tensor(
        rng.normal(size=(Q, 3)).astype(np.float32) * 0.01, device=cuda)
    d_k, i_k = knn_small_refs_cuda(q, r, 1)
    d_p, i_p = knn_small_refs_plain(q, r, 1)
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_p) and torch.equal(d_k, d_p)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("n_valid", [0, 1, 2])
@pytest.mark.parametrize("exclude", [False, True])
def test_knn_kernel_fewer_valid_refs_than_k(cuda, k, n_valid, exclude):
    """With fewer than k refs below BIG (a mask keeping n_valid refs, the
    self match excluded), the later slots are the plain version's: BIG and
    the lowest index holding BIG after the earlier picks."""
    rng = np.random.default_rng(10 * k + n_valid)
    r = torch.as_tensor(rng.normal(size=(40, 3)).astype(np.float32), device=cuda)
    keep = np.zeros(40, bool)
    keep[rng.choice(40, n_valid, replace=False)] = True
    m = torch.as_tensor(keep, device=cuda)
    d_k, i_k = knn_small_refs_cuda(r[:23], r, k, ref_mask=m, exclude_self=exclude)
    d_p, i_p = knn_small_refs_plain(r[:23], r, k, ref_mask=m, exclude_self=exclude)
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_p) and torch.equal(d_k, d_p)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_knn_kernel_ties_across_slices_go_to_the_lower_index(cuda, k):
    """Each of 97 points is repeated at indices 97 apart (97 mod 32 = 1), so
    the copies of a point lie in different slices and staged tiles; the
    queries sit exactly on the points, so every query has exact ties, and
    the lower index must win as in one scan."""
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(97, 3)).astype(np.float32)
    r = torch.as_tensor(np.tile(pts, (23, 1)), device=cuda)          # R = 2,231
    q = torch.as_tensor(np.concatenate([pts, pts[::-1] + 1e-3]), device=cuda)
    d_k, i_k = knn_small_refs_cuda(q, r, k)
    d_p, i_p = knn_small_refs_plain(q, r, k)
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_p) and torch.equal(d_k, d_p)
    assert bool((i_k[:97, 0] == torch.arange(97, device=cuda)).all())
    if k > 1:   # the second copy, 97 further on, ties the first at distance 0
        assert bool((i_k[:97, 1] == torch.arange(97, device=cuda) + 97).all())


@pytest.mark.parametrize("N", [6912, 6890, 1])
def test_deform_kernel_matches_plain(cuda, N):
    args = [torch.as_tensor(a, device=cuda) for a in deform_inputs(max(N, 2))]
    args = [a[:, :N] if a.shape[0] != 1 else a for a in args]
    args = [a.contiguous() for a in args]
    got = deform_rows(*args)
    want = deform_rows_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_deform_kernel_backward_matches_plain_autograd(cuda):
    """The backward kernel against autograd of the plain forward: each
    gradient within 1e-5 of its largest value + 1e-6."""
    args = deform_inputs(1000, seed=2)
    args[0][:, 0] = args[0][:, 1]
    a = [torch.as_tensor(x, device=cuda).requires_grad_(True) for x in args]
    b = [torch.as_tensor(x, device=cuda).requires_grad_(True) for x in args]
    (deform_rows(*a) ** 2).sum().backward()
    (deform_rows_plain(*b) ** 2).sum().backward()
    for x, y in zip(a, b):
        err = float((x.grad - y.grad).abs().max())
        assert err <= 1e-5 * float(y.grad.abs().max()) + 1e-6


@pytest.mark.parametrize("N", [6912, 6890, 1])
def test_deform_bwd_kernel_matches_plain(cuda, N):
    """All four gradients bit-equal to the plain backward, guarded columns
    included, and the same bits on a second run."""
    args = deform_bwd_inputs(cuda, N)
    got = deform_rows_bwd_cuda(*args)
    again = deform_rows_bwd_cuda(*args)
    want = deform_rows_bwd_plain(*args)
    torch.cuda.synchronize()
    for x, y, z in zip(got, want, again):
        assert torch.isfinite(x).all()
        assert torch.equal(x, y) and torch.equal(x, z)
    assert not bool(got[3][0, 21:].any())
    if N > 2:   # the guard's 1 / det reached the guarded columns
        assert float(got[0][:, 1:3].abs().max()) > 1e6


@pytest.mark.parametrize("needs", [tuple(bool(m >> i & 1) for i in range(4))
                                   for m in range(1, 16)])
def test_deform_bwd_kernel_gradients_asked_for(cuda, needs):
    """Through autograd, each subset of inputs that need a gradient: one
    backward launch, the asked-for gradients bit-equal to the plain
    backward's, and none for the others."""
    args = deform_bwd_inputs(cuda, 6890, seed=3)
    want = deform_rows_bwd_plain(*args)
    t = [a.clone().requires_grad_(need) for a, need in zip(args[:4], needs)]
    out = deform_rows(*t)
    cuda_lib.reset_launches()
    out.backward(args[4])
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["deform_bwd"] == 1 and cuda_lib.LAUNCHES["deform"] == 0
    for x, y, need in zip(t, want, needs):
        assert (x.grad is not None) == need
        assert not need or torch.equal(x.grad, y)


def test_dna_frames_take_the_tile_major_layout():
    """1224 x 1024 frames: 77 x 64 tiles, 1,232 px rows, not a multiple of
    128, so the layout rule picks tile-major (no card needed)."""
    inst, kw = instance_inputs("cpu", 1224, 1024, n=60, C=3)
    assert (kw["n_tiles"], kw["tiles_x"], kw["planar"]) == (4928, 77, False)
    assert pb.row_mode_supported(4928, 77, 16, 16) == 0
    assert pb.row_mode_supported(32 * 32, 32, 16, 16) == 8


@pytest.mark.parametrize("w,h", [(512, 512), (208, 144), (1224, 1024)])
def test_blend_kernel_matches_plain(cuda, w, h):
    inst, kw = instance_inputs(cuda, w, h)
    assert kw["planar"] == (w == 512)
    for base in (0, kw["tiles_x"]):
        got = pb.blend_instances_cuda(inst.data, inst.starts, inst.counts, base, **kw)
        want = pb.blend_instances_plain(inst.data, inst.starts, inst.counts, base, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().movedim(0 if kw["planar"] else 1, 0).reshape(22, -1)
        assert float(torch.cat([err[:20], err[21:]]).max()) <= 1e-4
        assert float(err[20].max()) <= 1e-3
    assert float(want.max()) > 0.1


def test_blend_kernel_alpha_test_rounds_as_plain(cuda):
    """Alpha at the 1/255 test: 4,096 tiles of one instance each, each
    instance's opacity set to the smallest value whose plain alpha passes
    the test at one pixel of its tile. The kernel keeps every one of them
    and decides as the plain version at every pixel (with its exponent
    contracted into FMAs it dropped such instances: a pixel of the SMPL-X
    training step, 0.0073 in its final T)."""
    rng = np.random.default_rng(11)
    T, tx = 4096, 64
    t = np.arange(T)
    p = rng.integers(0, 256, T)
    px = ((t % tx) * 16 + p % 16).astype(np.float32)
    py = ((t // tx) * 16 + p // 16).astype(np.float32)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)   # noqa: E731
    x, y = f(px + rng.uniform(-12, 12, T)), f(py + rng.uniform(-12, 12, T))
    cxx, cyy = f(rng.uniform(0.002, 0.05, T)), f(rng.uniform(0.002, 0.05, T))
    cxy = f(rng.uniform(-0.5, 0.5, T)) * torch.sqrt(cxx * cyy)
    dx, dy = x - f(px), y - f(py)
    e = torch.exp(-0.5 * (cxx * dx * dx + cyy * dy * dy) - cxy * dx * dy)
    thr = torch.tensor(1.0 / 255.0, dtype=torch.float32, device=cuda)
    op = thr / e
    for _ in range(8):      # up by an ulp until the plain alpha passes
        op = torch.where(op * e < thr, torch.nextafter(op, torch.full_like(op, 1.0)), op)
    ones = torch.ones(T, device=cuda)
    data = torch.stack([x, y, cxx, cxy, cyy, op, ones, ones, ones]
                       + [torch.zeros(T, device=cuda)] * 7).contiguous()
    args = (data, torch.arange(T, dtype=torch.int32, device=cuda),
            torch.ones(T, dtype=torch.int32, device=cuda), 0)
    kw = dict(n_tiles=T, tiles_x=tx, n_channels=1, planar=False)
    got = pb.blend_instances_cuda(*args, **kw)
    want = pb.blend_instances_plain(*args, **kw)
    torch.cuda.synchronize()
    idx = torch.as_tensor(p, device=cuda)
    assert bool((want[torch.arange(T, device=cuda), 1, idx] > 0).all())
    assert torch.equal(got[:, 1] > 0, want[:, 1] > 0)


@pytest.mark.parametrize("C", [1, 19, 32])
@pytest.mark.parametrize("planar", [True, False])
def test_blend_kernel_channels_layouts_and_tile_cap(cuda, C, planar):
    """C = 1, 19, 32 in both layouts, at tile_base 0 and one tile row on,
    with a tile at the 1,024-instance cap."""
    inst, kw = instance_inputs(cuda, 256, 128, n=3000, C=C, cluster=1500)
    assert int(inst.counts.max()) == 1024
    kw = dict(kw, planar=planar)
    for base in (0, kw["tiles_x"]):
        got = pb.blend_instances_cuda(inst.data, inst.starts, inst.counts, base, **kw)
        want = pb.blend_instances_plain(inst.data, inst.starts, inst.counts, base, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().movedim(0 if planar else 1, 0).reshape(C + 3, -1)
        assert float(torch.cat([err[:C + 1], err[C + 2:]]).max()) <= 1e-4
        assert float(err[C + 1].max()) <= 1e-3
    assert float(want.max()) > 0.1


@pytest.mark.parametrize("w,h,cluster", [(512, 512, 0), (208, 144, 0), (256, 128, 1500),
                                         (1224, 1024, 1500)])
def test_blend_checkpoint_mode_matches_d1_and_plain(cuda, w, h, cluster):
    """Kernel C's checkpoint mode: the same output as without, checkpoints
    equal to D1's bit for bit (the same serial product) and to the plain
    ones as D1's are; at tile_base 0 and one tile row on."""
    inst, kw = instance_inputs(cuda, w, h, cluster=cluster)
    cot = cotangents(inst, kw["n_tiles"])
    tiles = dict(n_tiles=kw["n_tiles"], tiles_x=kw["tiles_x"])
    for base in (0, kw["tiles_x"]):
        args = (inst.data, inst.starts, inst.counts, base)
        out = pb.blend_instances_cuda(*args, **kw)
        out_ck, ck = pb.blend_instances_cuda(*args, checkpoints=True, **kw)
        ck_d1 = pbb.blend_bwd_ckpt_cuda(*args, cot, **tiles)
        want = pb.blend_fwd_checkpoints_plain(*args, **tiles)
        torch.cuda.synchronize()
        assert torch.equal(out, out_ck)
        mism = pbb.checkpoint_mismatches(ck, ck_d1, inst.counts)
        assert not any(mism.values()), mism
        e = pbb.checkpoint_errors(ck._replace(chunk_sum=want.chunk_sum), want, inst.counts)
        assert e["n_chunks_equal"] and e["map_equal"] and e["stop_mismatch"] == 0, e
        assert max(e["t_rel"], e["t_final_rel"]) <= CKPT_RTOL, e
    assert int(want.n_chunks) > int((inst.counts > 0).sum())   # tiles of several chunks


@pytest.mark.parametrize("w,h", [(512, 512), (208, 144), (1224, 1024)])
def test_backward_on_forward_checkpoints_matches_plain(cuda, w, h):
    """The backward without D1: D1s and D2 on kernel C's checkpoints against
    the plain kernel D."""
    inst, kw = instance_inputs(cuda, w, h)
    cot = cotangents(inst, kw["n_tiles"])
    tiles = dict(n_tiles=kw["n_tiles"], tiles_x=kw["tiles_x"], n_channels=19)
    for base in (0, kw["tiles_x"]):
        args = (inst.data, inst.starts, inst.counts, base)
        _, ck = pb.blend_instances_cuda(*args, checkpoints=True, **kw)
        before = cuda_lib.LAUNCHES["blend_bwd_ckpt"]
        got = pbb.blend_tiles_bwd_from_ckpt_cuda(*args, cot, ck, **tiles)
        want = pbb.blend_tiles_bwd_plain(*args, cot, **tiles)
        torch.cuda.synchronize()
        assert cuda_lib.LAUNCHES["blend_bwd_ckpt"] == before
        tol = 1e-4 * want.abs().max(dim=0).values + 1e-6
        assert bool(((got - want).abs().max(dim=0).values <= tol).all())
    assert float(want[:, :7].abs().max()) > 1e-3


def cotangents(inst, n_tiles, seed=9):
    rng = np.random.RandomState(seed)
    cf = inst.data.shape[0] - pb.HDR
    cot = rng.randn(n_tiles, 256, cf + 3).astype(np.float32)
    cot[:, :, 19:cf] = 0.0                  # the feature pad carries no cotangent
    return torch.as_tensor(cot, device=inst.data.device)


@pytest.mark.parametrize("w,h", [(512, 512), (208, 144)])
def test_blend_bwd_kernel_matches_plain(cuda, w, h):
    inst, kw = instance_inputs(cuda, w, h)
    cot = cotangents(inst, kw["n_tiles"])
    for base in (0, kw["tiles_x"]):
        args = (inst.data, inst.starts, inst.counts, base, cot)
        got = pbb.blend_tiles_bwd_cuda(*args, n_tiles=kw["n_tiles"], tiles_x=kw["tiles_x"])
        want = pbb.blend_tiles_bwd_plain(*args, n_tiles=kw["n_tiles"], tiles_x=kw["tiles_x"])
        torch.cuda.synchronize()
        tol = 1e-4 * want.abs().max(dim=0).values + 1e-6
        assert bool(((got - want).abs().max(dim=0).values <= tol).all())
    assert float(want[:, :7].abs().max()) > 1e-3


@pytest.mark.parametrize("w,h", [(512, 512), (208, 144)])
def test_blend_bwd_ckpt_kernel_matches_plain(cuda, w, h):
    inst, kw = instance_inputs(cuda, w, h)
    cot = cotangents(inst, kw["n_tiles"])
    tiles = dict(n_tiles=kw["n_tiles"], tiles_x=kw["tiles_x"], n_channels=19)
    for base in (0, kw["tiles_x"]):
        args = (inst.data, inst.starts, inst.counts, base, cot)
        got = pbb.blend_bwd_checkpoints_cuda(*args, **tiles)
        want = pbb.blend_bwd_checkpoints_plain(*args, **tiles)
        torch.cuda.synchronize()
        e = pbb.checkpoint_errors(got, want, inst.counts)
        assert e["n_chunks_equal"] and e["map_equal"] and e["stop_mismatch"] == 0, e
        assert max(e["t_rel"], e["t_final_rel"], e["sum_rel"]) <= CKPT_RTOL, e
    assert int(want.n_chunks) > int((inst.counts > 0).sum())   # tiles of several chunks


@pytest.mark.parametrize("w,h", [(512, 512), (208, 144)])
def test_blend_bwd_sums_kernel_matches_plain(cuda, w, h):
    inst, kw = instance_inputs(cuda, w, h)
    cot = cotangents(inst, kw["n_tiles"])
    tiles = dict(n_tiles=kw["n_tiles"], tiles_x=kw["tiles_x"], n_channels=19)
    args = (inst.data, inst.starts, inst.counts, 0, cot)
    ckpt = pbb.blend_bwd_checkpoints_cuda(*args, **tiles)
    want = pbb.blend_bwd_sums_plain(*args, ckpt, **tiles)
    torch.cuda.synchronize()
    n = int(ckpt.n_chunks)
    err = float((ckpt.chunk_sum[:n] - want[:n]).abs().max())
    assert err <= CKPT_RTOL * float(want[:n].abs().max())


@pytest.mark.parametrize("w,h", [(512, 512), (208, 144)])
def test_blend_bwd_rows_kernel_matches_plain(cuda, w, h):
    inst, kw = instance_inputs(cuda, w, h)
    cot = cotangents(inst, kw["n_tiles"])
    tiles = dict(n_tiles=kw["n_tiles"], tiles_x=kw["tiles_x"], n_channels=19)
    args = (inst.data, inst.starts, inst.counts, 0, cot)
    ckpt = pbb.blend_bwd_checkpoints_cuda(*args, **tiles)
    got = pbb.blend_bwd_rows_cuda(*args, ckpt, **tiles)
    want = pbb.blend_bwd_rows_plain(*args, ckpt, **tiles)
    torch.cuda.synchronize()
    tol = 1e-4 * want.abs().max(dim=0).values + 1e-6
    assert bool(((got - want).abs().max(dim=0).values <= tol).all())
    assert float(got[:, 8 + 19:].abs().max()) == 0.0 and float(got[:, 7].abs().max()) == 0.0
    assert float(want[:, :7].abs().max()) > 1e-3


def test_blend_bwd_kernel_wide_channels(cuda):
    """C = 29 (Cf = 32): the launches' 32-register feature paths and D2's
    components past the 32-lane butterfly."""
    inst, kw = instance_inputs(cuda, 208, 144, C=29)
    cot = torch.as_tensor(np.random.RandomState(11).randn(kw["n_tiles"], 256, 35)
                          .astype(np.float32), device=cuda)
    cot[:, :, 29:32] = 0.0
    args = (inst.data, inst.starts, inst.counts, 0, cot)
    tiles = dict(n_tiles=kw["n_tiles"], tiles_x=kw["tiles_x"], n_channels=29)
    got = pbb.blend_tiles_bwd_cuda(*args, **tiles)
    want = pbb.blend_tiles_bwd_plain(*args, **tiles)
    torch.cuda.synchronize()
    tol = 1e-4 * want.abs().max(dim=0).values + 1e-6
    assert bool(((got - want).abs().max(dim=0).values <= tol).all())
    assert float(want[:, 8 + 28].abs().max()) > 1e-3


def rasterize_grads(device, seed=10, w=96, h=80):
    """Gradients of a rasterized image's weighted sum w.r.t. the means,
    covariances, opacities, features and background."""
    rng = np.random.RandomState(seed)
    n = 400
    leaves = [torch.as_tensor(a, device=device).requires_grad_(True) for a in (
        (rng.randn(n, 3) * 0.4).astype(np.float32),
        np.tile(np.array([0.004, 0.0, 0.0, 0.004, 0.0, 0.004], np.float32), (n, 1)),
        (rng.rand(n) * 0.9 + 0.05).astype(np.float32),
        rng.rand(n, 5).astype(np.float32),
        np.linspace(0.1, 0.9, 5).astype(np.float32))]
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), w, h, fovx=1.0, fovy=1.0,
                      device=device)
    out = rasterize(*leaves[:4], cam.w2c, cam.full_proj, leaves[4], width=w, height=h,
                    tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy)
    g = torch.as_tensor(rng.randn(h, w, 5).astype(np.float32), device=device)
    loss = (out.image * g).sum() + out.alpha.sum() + 0.3 * out.depth.sum() \
        + 0.7 * out.final_t.sum()
    return torch.autograd.grad(loss, leaves)


def test_blend_pallas_grads_match_cpu_and_are_bit_stable(cuda):
    """CUDA: kernels C and D; CPU: the spec blend under autograd."""
    got = rasterize_grads(cuda)
    again = rasterize_grads(cuda)
    want = rasterize_grads(torch.device("cpu"))
    assert cuda_lib.LAUNCHES["blend_bwd"] > 0
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)
        tol = 1e-4 * float(c.abs().max()) + 1e-6
        assert float((a.cpu() - c).abs().max()) <= tol
    assert float(want[0].abs().max()) > 0


def test_differentiated_forward_writes_checkpoints_and_backward_skips_d1(cuda):
    """A differentiated blend has kernel C write the checkpoints and its
    backward runs D1s and D2 only; the same forward without grad writes
    none."""
    cuda_lib.reset_launches()
    rasterize_grads(cuda)
    n = dict(cuda_lib.LAUNCHES)
    assert n["blend_fwd"] == n["blend_fwd_ckpt"] == n["blend_bwd"] == 1
    assert n["blend_bwd_sums"] == n["blend_bwd_rows"] == 1 and n["blend_bwd_ckpt"] == 0
    cuda_lib.reset_launches()
    with torch.no_grad(), pytest.raises(RuntimeError, match="does not require grad"):
        rasterize_grads(cuda)      # the forward runs, then there is no graph
    assert cuda_lib.LAUNCHES["blend_fwd"] == 1 and cuda_lib.LAUNCHES["blend_fwd_ckpt"] == 0


def bake_face_inputs(device, n=16000, seed=9, face=4):
    """One cubemap face of the occlusion bake: a seeded body-sized cloud
    seen from a cell center inside it by the bake's fov-90 camera of cube
    face `face` (32 x 32, 1 zero channel, tile capacity 256, 4 tiles per
    Gaussian) -> (instance data, kwargs, rasterize arguments)."""
    from mygauhuman_torch.occlusion.baking import DEFAULT_BAKE_CONFIG, face_cameras

    rng = np.random.RandomState(seed)
    xyz = (rng.randn(n, 3) * np.array([0.25, 0.5, 0.15])).astype(np.float32)
    means = torch.as_tensor(xyz, device=device)
    scales = torch.as_tensor(np.exp(rng.randn(n, 3) * 0.3 - 3.5).astype(np.float32),
                             device=device)
    quats = torch.as_tensor(rng.randn(n, 4).astype(np.float32), device=device)
    cov6 = covariance6_from_scaling_rotation(scales, quats)
    opac = torch.as_tensor((rng.rand(n) * 0.6 + 0.35).astype(np.float32), device=device)
    cams = torch.as_tensor(face_cameras(np.array([[0.02, 0.1, 0.03]], np.float32)),
                           device=device)
    w2c, full = cams[0, face, 0], cams[0, face, 1]
    cfg = DEFAULT_BAKE_CONFIG
    p = preprocess(means, cov6, w2c, full, 32, 32, 1.0, 1.0)
    bins = bin_gaussians(p.means2d, p.radii, p.depths, p.visible, width=32, height=32,
                         max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
                         tile_capacity=cfg.tile_capacity)
    feats = torch.zeros((n, 1), device=device)
    inst = pb.build_instance_data(bins.sorted_rank, bins.starts,
                                  torch.clamp(bins.counts, max=cfg.tile_capacity), p.means2d,
                                  p.conics, opac, p.depths, feats, order=bins.order)
    assert not pb.row_mode_supported(4, 2, 16, 16)     # a bake face is tile-major
    raster = (means, cov6, opac, feats, w2c, full, torch.zeros(1, device=device))
    return inst, dict(n_tiles=4, tiles_x=2, n_channels=1), dict(args=raster, config=cfg)


def test_blend_kernel_tile_major_at_bake_faces(cuda):
    """Kernel C tile-major at the bake's shapes against its plain version
    (1e-4; depth row 1e-3), and the bake's rasterize on the card against
    the same rasterize on the CPU (alpha within 1e-4)."""
    inst, kw, r = bake_face_inputs(cuda)
    assert int(inst.counts.max()) == 256         # the bake's tile capacity is reached
    got = pb.blend_instances_cuda(inst.data, inst.starts, inst.counts, 0, **kw)
    want = pb.blend_instances_plain(inst.data, inst.starts, inst.counts, 0, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs().movedim(1, 0).reshape(4, -1)
    assert float(torch.cat([err[:2], err[3:]]).max()) <= 1e-4
    assert float(err[2].max()) <= 1e-3
    assert float(want[:, 1].max()) > 0.5         # the alpha row sees occluders
    cuda_lib.reset_launches()
    with torch.no_grad():
        alpha = rasterize(*r["args"], width=32, height=32, tan_fovx=1.0, tan_fovy=1.0,
                          config=r["config"]).alpha
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["blend_fwd_tiles"] == cuda_lib.LAUNCHES["blend_fwd"] == 1
    with torch.no_grad():
        ref = rasterize(*(a.cpu() for a in r["args"]), width=32, height=32, tan_fovx=1.0,
                        tan_fovy=1.0, config=r["config"]).alpha
    assert float((alpha.cpu() - ref).abs().max()) <= 1e-4


def test_blend_kernel_face_batch_is_its_faces_launches_bit_for_bit(cuda):
    """The bake's face-batched launch: the six faces of a cell, their
    instance matrices side by side, in one tile-major launch of 24 tiles at
    4 tiles an image, against each face's own launch, bit for bit, and
    against the plain version of the same launch (1e-4; depth row 1e-3)."""
    faces = [bake_face_inputs(cuda, face=f)[0] for f in range(6)]
    offsets = np.cumsum([0] + [i.data.shape[1] for i in faces])
    data = torch.cat([i.data for i in faces], dim=1)
    starts = torch.cat([i.starts + int(o) for i, o in zip(faces, offsets)])
    counts = torch.cat([i.counts for i in faces])
    assert int(counts.max()) == 256 and int((counts > 0).sum()) >= 12
    kw = dict(tiles_x=2, n_channels=1)
    cuda_lib.reset_launches()
    got = pb.blend_instances_cuda(data, starts, counts, 0, n_tiles=24, tiles_per_image=4, **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["blend_fwd_tiles"] == 1
    want = torch.cat([pb.blend_instances_cuda(i.data, i.starts, i.counts, 0, n_tiles=4, **kw)
                      for i in faces])
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert float(want[:, 1].max()) > 0.5
    plain = pb.blend_instances_plain(data, starts, counts, 0, n_tiles=24, tiles_per_image=4,
                                     **kw)
    err = (got - plain).abs().movedim(1, 0).reshape(4, -1)
    assert float(torch.cat([err[:2], err[3:]]).max()) <= 1e-4
    assert float(err[2].max()) <= 1e-3
    with pytest.raises(ValueError, match="whole images"):
        pb.blend_instances_cuda(data, starts[:22], counts[:22], 0, n_tiles=22,
                                tiles_per_image=4, **kw)


@pytest.mark.parametrize("w,h", [(1224, 1024), (208, 144)])
def test_blend_kernel_single_image_keeps_its_tiles(cuda, w, h):
    """A tile-major launch of one image with its own tile count is the
    launch without it, and a strip at tile_base (one tile row on) is the
    whole image's launch from that tile, bit for bit."""
    inst, kw = instance_inputs(cuda, w, h, C=3)
    T, tw = kw["n_tiles"], kw["tiles_x"]
    kw = dict(kw, planar=False)
    whole = pb.blend_instances_cuda(inst.data, inst.starts, inst.counts, 0, **kw)
    own = pb.blend_instances_cuda(inst.data, inst.starts, inst.counts, 0, tiles_per_image=T,
                                  **kw)
    strip = pb.blend_instances_cuda(inst.data, inst.starts[tw:].contiguous(),
                                    inst.counts[tw:].contiguous(), tw,
                                    **dict(kw, n_tiles=T - tw), tiles_per_image=T)
    torch.cuda.synchronize()
    assert torch.equal(own, whole) and torch.equal(strip, whole[tw:])
    assert float(whole[:, 3].max()) > 0.1


@pytest.mark.parametrize("w,h", [(512, 512), (1224, 1024)])
def test_blend_instances_strip_at_tile_base(cuda, w, h):
    """The tile-sharded rasterizer's blend of a strip of whole tile rows
    from the one holding the median instance to the end of the grid
    (planar at 512^2, tile-major at 1224x1024): kernel C in checkpoint mode
    at that tile_base against its plain version, and the backward (D1s and
    D2 on those checkpoints) against autograd of the plain version, as
    kernel D is held."""
    inst, kw = instance_inputs(cuda, w, h)
    T, tw = kw["n_tiles"], kw["tiles_x"]
    cum = torch.cumsum(inst.counts.long(), 0)
    base = int(torch.searchsorted(cum, cum[-1] // 2)) // tw * tw
    assert 0 < base and int(inst.counts[base:].sum()) > 0
    n = T - base
    starts, counts = inst.starts[base:].contiguous(), inst.counts[base:].contiguous()
    fn = pb.blend_instances_planar if kw["planar"] else pb.blend_instances
    data = inst.data.clone().requires_grad_(True)
    before = dict(cuda_lib.LAUNCHES)
    out = fn(data, starts, counts, base, n, tw, 19)
    want = pb.blend_instances_plain(inst.data, starts, counts, base, n_tiles=n, tiles_x=tw,
                                    n_channels=19, planar=kw["planar"])
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["blend_fwd_ckpt"] == before["blend_fwd_ckpt"] + 1
    rows = (out.detach() - want).abs().movedim(0 if kw["planar"] else 1, 0).reshape(22, -1)
    assert float(rows[:20].max()) <= 1e-4 and float(rows[21].max()) <= 1e-4
    assert float(rows[20].max()) <= 1e-3                        # the depth row
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(3),
                    device=cuda)
    (got,) = torch.autograd.grad(out, data, g)
    with torch.enable_grad():
        d = inst.data.clone().requires_grad_(True)
        ref = pb.blend_instances_plain(d, starts, counts, base, n_tiles=n, tiles_x=tw,
                                       n_channels=19, planar=kw["planar"])
        (want_g,) = torch.autograd.grad(ref, d, g)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["blend_bwd_ckpt"] == before["blend_bwd_ckpt"]
    assert cuda_lib.LAUNCHES["blend_bwd"] == before["blend_bwd"] + 1
    tol = 1e-4 * want_g.abs().max(dim=1, keepdim=True).values + 1e-6
    assert bool(((got - want_g).abs() <= tol).all())
    assert float(want_g[:7].abs().max()) > 1e-3


# ---- the captured serving frame (render/graph.py) -------------------------
#
# A graph replays the same kernels on the same inputs as the eager frame, so
# every field is held bit for bit; requests interleave views and epsilons,
# so a static input that a request failed to overwrite shows up.

GRAPH_FIELDS = ("render", "render_depth", "render_alpha", "normal", "world_normal",
                "albedo", "occlusion", "roughness", "render_axis", "radii", "transforms",
                "translation")
GRAPH_REQUESTS = [(0, 0.0), (1, 3e-12), (0, 1e-3), (3, 2e-12), (2, -1e-3)]


@pytest.fixture(scope="module")
def graph_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest "
                    "tests/test_torch_kernels.py on the GPU")
    from mygauhuman_torch.data.synthetic import make_synthetic_scene
    from mygauhuman_torch.ops.rasterize import RasterizerConfig
    from mygauhuman_torch.render import render_frame

    cfg = RasterizerConfig(tile_capacity=1024, chunk_tiles=64, instance_capacity=4 * 1024)
    scene = make_synthetic_scene(n_views=4, width=128, height=128, n_verts=400,
                                 raster_config=cfg, device="cuda")
    kw = dict(bg=torch.tensor([0.1, 0.3, 0.6], device="cuda"), active_sh_degree=0,
              config=cfg)
    with torch.no_grad():
        rows = [render_frame(scene.gt_state, b.camera, b.frame, scene.smpl_model, **kw)
                for b in scene.batches]
    return scene, kw, [dict(transforms=r.transforms, translation=r.translation) for r in rows]


def eager_frame(scene, kw, v, eps, replay):
    from mygauhuman_torch.render import render_frame

    st = scene.gt_state
    st = st._replace(params=st.params._replace(opacity=st.params.opacity + eps))
    b = scene.batches[v]
    with torch.no_grad():
        return render_frame(st, b.camera, b.frame, scene.smpl_model, **kw, **replay)


@pytest.mark.parametrize("branch", ["deform", "replay"])
def test_graphed_frames_match_eager_bit_for_bit(graph_scene, branch):
    from mygauhuman_torch.render.graph import GraphedRenderer

    scene, kw, rows = graph_scene
    renderer = GraphedRenderer(scene.gt_state, scene.smpl_model, **kw)
    for v, eps in GRAPH_REQUESTS:
        replay = rows[v] if branch == "replay" else {}
        want = eager_frame(scene, kw, v, eps, replay)
        got = renderer(scene.batches[v].camera, scene.batches[v].frame, opacity_eps=eps,
                       **replay)
        for f in GRAPH_FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), (v, eps, f)
    assert renderer.captures == 1


def test_graph_key_miss_captures_a_new_graph(graph_scene):
    from mygauhuman_torch.data.camera import make_camera
    from mygauhuman_torch.render.graph import GraphedRenderer

    scene, kw, rows = graph_scene
    renderer = GraphedRenderer(scene.gt_state, scene.smpl_model, **kw)
    b = scene.batches[1]
    renderer(b.camera, b.frame, **rows[1])
    c = b.camera
    c2w = np.linalg.inv(c.w2c.cpu().numpy().astype(np.float64))
    narrow = make_camera(c2w[:3, :3], c.w2c[:3, 3].cpu().numpy(), c.width, c.height,
                         fovx=0.8, fovy=0.8, device="cuda")
    got = renderer(narrow, b.frame, **rows[1])
    assert renderer.captures == 2 and len(renderer.slots) == 2
    from mygauhuman_torch.render import render_frame

    with torch.no_grad():
        want = render_frame(scene.gt_state, narrow, b.frame, scene.smpl_model, **kw, **rows[1])
    for f in GRAPH_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    renderer(b.camera, b.frame, **rows[1])
    assert renderer.captures == 2


@pytest.mark.parametrize("branch", ["deform", "replay"])
def test_graph_capture_makes_no_host_sync(graph_scene, branch):
    from mygauhuman_torch.render.graph import GraphedRenderer

    scene, kw, rows = graph_scene
    replay = rows[2] if branch == "replay" else {}
    b = scene.batches[2]
    eager_frame(scene, kw, 2, 0.0, replay)     # the per-device constants exist
    renderer = GraphedRenderer(scene.gt_state, scene.smpl_model, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        renderer(b.camera, b.frame, opacity_eps=1e-12, **replay)   # warm-up + capture + replay
        renderer(b.camera, b.frame, opacity_eps=2e-12, **replay)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert renderer.captures == 1


def test_graph_replays_count_the_captured_launches(graph_scene):
    from mygauhuman_torch.render.graph import GraphedRenderer

    scene, kw, rows = graph_scene
    renderer = GraphedRenderer(scene.gt_state, scene.smpl_model, **kw)
    b = scene.batches[0]
    renderer(b.camera, b.frame)
    (per_frame,) = renderer.launches.values()
    assert per_frame["knn"] == per_frame["deform"] == per_frame["blend_fwd"] == 1
    cuda_lib.reset_launches()
    n = 5
    for i in range(n):
        renderer(b.camera, b.frame, opacity_eps=1e-12 * i)
    torch.cuda.synchronize()
    assert {k: v for k, v in cuda_lib.LAUNCHES.items() if v} == \
        {k: n * v for k, v in per_frame.items()}


def test_graphed_frame_spans_make_no_host_sync(graph_scene, tmp_path):
    import json

    from torch.profiler import ProfilerActivity, profile

    from mygauhuman_torch.render.graph import GraphedRenderer

    scene, kw, rows = graph_scene
    renderer = GraphedRenderer(scene.gt_state, scene.smpl_model, **kw)
    b = scene.batches[0]
    n = 5
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        renderer(b.camera, b.frame, **rows[0])     # the capture
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(n):
                renderer(b.camera, b.frame, opacity_eps=1e-12 * i, **rows[0])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    prof.export_chrome_trace(str(tmp_path / "frames.json"))
    names = [e["name"] for e in json.loads((tmp_path / "frames.json").read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert names.count("mgh.render.capture") == renderer.captures == 1
    assert names.count("mgh.render.stage") == names.count("mgh.render.replay") == n + 1


# ---- the training step from captured CUDA graphs (train/graph.py) ----------
# make_train_step(..., donate=True) against the eager step on the same
# inputs: the same kernels in the same order on the same inputs, so every
# state leaf and metric bit for bit.

@pytest.fixture(scope="module")
def train_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest "
                    "tests/test_torch_kernels.py on the GPU")
    from mygauhuman_torch.data.synthetic import make_synthetic_scene
    from mygauhuman_torch.eval.lpips import LPIPS
    from mygauhuman_torch.ops.rasterize import RasterizerConfig

    cfg = RasterizerConfig(tile_capacity=1024, instance_capacity=4 * 1024)
    scene = make_synthetic_scene(n_views=4, width=128, height=128, n_verts=400,
                                 capacity=1024, raster_config=cfg, device="cuda")
    return scene, LPIPS(device="cuda")


def train_steps(train_scene):
    """(initial state, eager step, graphed step) with LPIPS on."""
    from mygauhuman_torch.config import OptimizationConfig
    from mygauhuman_torch.models.mlps import init_lbs_offset, init_pose_refiner
    from mygauhuman_torch.train import trainer as TT

    scene, lpips = train_scene
    opt = OptimizationConfig()
    gen = torch.Generator().manual_seed(0)
    ts, tx = TT.create_train_state(opt, scene.init_state,
                                   init_pose_refiner(gen, device="cuda"),
                                   init_lbs_offset(gen, device="cuda"))
    crop = TT.scene_lpips_crop([b.bound_mask for b in scene.batches])
    steps = [TT.make_train_step(scene.smpl_model, tx, opt, scene.raster_config,
                                bg=torch.zeros(3, device="cuda"), lpips_fn=lpips,
                                lpips_crop=crop, donate=d) for d in (False, True)]
    return ts, *steps


def assert_same_state(a, b):
    from mygauhuman_torch.train.optim import tree_leaves

    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
        assert torch.equal(x, y), f"state leaf {i} {tuple(x.shape)}"


def test_graphed_train_step_matches_eager_bit_for_bit(train_scene):
    from mygauhuman_torch.train.graph import stack_views

    ts0, eager, graphed = train_steps(train_scene)
    scene = train_scene[0]
    ts_e = ts_g = ts0
    for i in range(5):
        b = scene.batches[i % 4]
        ts_e, m_e = eager(ts_e, b, 0)
        ts_g, m_g = graphed(ts_g, b, 0)
        for k in m_e:
            assert torch.equal(m_e[k], m_g[k]), (i, k)
        assert_same_state(ts_e, ts_g)
    idx = [3, 1, 0, 2, 1]
    ts_g, (mseq, n) = graphed.chunk(ts_g, stack_views(scene.batches), idx, 0, pad_to=8)
    assert n == 5 and mseq["loss"].shape == (8,)
    for t, v in enumerate(idx):
        ts_e, m_e = eager(ts_e, scene.batches[v], 0)
        for k in m_e:
            assert torch.equal(m_e[k], mseq[k][t]), (t, k)
    assert_same_state(ts_e, ts_g)
    assert graphed.captures == 1       # one fov, capacity and SH degree


def test_graphed_train_chunk_makes_no_host_sync(train_scene):
    from mygauhuman_torch.train.graph import stack_views

    ts, eager, graphed = train_steps(train_scene)
    scene = train_scene[0]
    eager(ts, scene.batches[0], 0)      # the per-device constants exist
    views = stack_views(scene.batches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts, _ = graphed.chunk(ts, views, [0, 1, 2, 3, 0], 0, pad_to=8)  # warm-up, capture
        ts, _ = graphed.chunk(ts, views, [2, 1], 0, pad_to=8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert graphed.captures == 1 and ts.step == 7


def test_graphed_train_step_recaptures_after_capacity_growth(train_scene):
    from mygauhuman_torch.train import trainer as TT

    ts, eager, graphed = train_steps(train_scene)
    b = train_scene[0].batches[0]
    ts, _ = graphed(ts, b, 0)
    (old_key,) = graphed.slots
    grown = TT.maybe_grow_capacity(ts, min_free=10 ** 6)
    assert grown.gauss.capacity == 2 * ts.gauss.capacity
    got, m_g = graphed(grown, b, 0)
    assert graphed.captures == 2 and graphed.released == 1
    (new_key,) = graphed.slots
    assert new_key.capacity == grown.gauss.capacity and old_key.capacity == ts.gauss.capacity
    want, m_e = eager(grown, b, 0)     # the graphed step copied `grown`, not consumed it
    assert_same_state(want, got)
    assert torch.equal(m_e["loss"], m_g["loss"])


def test_graphed_train_replays_count_the_captured_launches(train_scene):
    from mygauhuman_torch.train.graph import stack_views

    ts, _, graphed = train_steps(train_scene)
    scene = train_scene[0]
    ts, _ = graphed(ts, scene.batches[0], 0)
    (per_step,) = graphed.launches.values()
    for name in ("knn", "deform", "deform_bwd", "blend_fwd", "blend_fwd_ckpt", "blend_bwd",
                 "blend_bwd_sums", "blend_bwd_rows"):
        assert per_step[name] == 1, (name, per_step)
    assert "blend_bwd_ckpt" not in per_step
    cuda_lib.reset_launches()
    n = 5
    graphed.chunk(ts, stack_views(scene.batches), [i % 4 for i in range(n)], 0)
    torch.cuda.synchronize()
    assert {k: v for k, v in cuda_lib.LAUNCHES.items() if v} == \
        {k: n * v for k, v in per_step.items()}


# ---- branch B from captured CUDA graphs (train/pbr.py::GraphedPbrStep) ----
# make_pbr_train_step(..., donate=True) against the eager step, and a bake
# sweep's graph replays (occlusion/baking.py) against the same cell program
# run slot by slot: the same kernels on the same inputs, so the same bits.

@pytest.fixture(scope="module")
def pbr_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest "
                    "tests/test_torch_kernels.py on the GPU")
    from mygauhuman_torch.config import OptimizationConfig
    from mygauhuman_torch.data.synthetic import make_synthetic_scene
    from mygauhuman_torch.eval.lpips import LPIPS
    from mygauhuman_torch.models.mlps import init_lbs_offset, init_pose_refiner
    from mygauhuman_torch.ops.rasterize import RasterizerConfig
    from mygauhuman_torch.train import pbr as TPB
    from mygauhuman_torch.train import trainer as TT

    cfg = RasterizerConfig(tile_capacity=1024, instance_capacity=4 * 1024)
    scene = make_synthetic_scene(n_views=4, width=128, height=128, n_verts=400,
                                 capacity=1024, raster_config=cfg, device="cuda")
    opt = OptimizationConfig(pbr_iteration=0)
    gen = torch.Generator().manual_seed(0)
    ts, tx = TT.create_train_state(opt, scene.init_state, init_pose_refiner(gen, device="cuda"),
                                   init_lbs_offset(gen, device="cuda"))
    pbr, ltx = TPB.create_pbr_state(opt, base_res=16, device="cuda")
    lpips = LPIPS(device="cuda")
    steps = [TPB.make_pbr_train_step(scene.smpl_model, tx, ltx, opt, cfg,
                                     bg=torch.zeros(3, device="cuda"), lpips_fn=lpips, donate=d)
             for d in (False, True)]
    rng = np.random.RandomState(4)
    occ_buf = torch.as_tensor(rng.randint(0, 256, (2, 1024, 8, 16, 1)).astype(np.uint8),
                              device="cuda")
    return dict(scene=scene, ts=ts, pbr=pbr, knn3=TPB.compute_knn3(ts.gauss),
                pw=TPB.prefilter_weight_set(16, "cuda"), occ_buf=occ_buf, steps=steps)


def assert_same_pbr_state(a, b):
    from mygauhuman_torch.train.optim import tree_leaves

    assert a[0].step == b[0].step and a[0].opt_state.count == b[0].opt_state.count
    assert a[1].opt_state.count == b[1].opt_state.count
    for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b), strict=True)):
        assert torch.equal(x, y), f"state leaf {i} {tuple(x.shape)}"


def test_graphed_pbr_step_matches_eager_bit_for_bit(pbr_scene):
    from mygauhuman_torch.train import pbr as TPB
    from mygauhuman_torch.train.graph import stack_views

    s = pbr_scene
    eager, graphed = s["steps"]
    batches, occ_buf = s["scene"].batches, s["occ_buf"]
    colour = torch.rand((1024, 3), generator=torch.Generator().manual_seed(1)).cuda()
    e = g = (s["ts"], s["pbr"])
    for v in (0, 1, 2):
        *e, m_e = eager(*e, batches[v], s["knn3"], colour, s["pw"], 0)
        *g, m_g = graphed(*g, batches[v], s["knn3"], colour, s["pw"], 0)
        for k in m_e:
            assert torch.equal(m_e[k], m_g[k]), (v, k)
        assert_same_pbr_state(e, g)
    idx, bidx = [3, 1, 0, 2, 1], [0, 1, 1, 0, 1]
    *g, (mseq, n) = graphed.chunk(*g, stack_views(batches), occ_buf, s["knn3"], s["pw"], idx,
                                  bidx, 0, pad_to=8)
    assert n == 5 and mseq["loss"].shape == (8,)
    for t, (v, b) in enumerate(zip(idx, bidx)):
        col = TPB.baked_occlusion_color(occ_buf[b], e[1].light)
        *e, m_e = eager(*e, batches[v], s["knn3"], col, s["pw"], 0)
        for k in m_e:
            assert torch.equal(m_e[k], mseq[k][t]), (t, k)
    assert_same_pbr_state(e, g)
    assert graphed.captures == 2     # an occlusion colour, a baked map


def test_graphed_pbr_chunk_makes_no_host_sync_and_counts_its_launches(pbr_scene):
    from mygauhuman_torch.train.graph import stack_views

    s = pbr_scene
    eager, graphed = s["steps"]
    views = stack_views(s["scene"].batches)
    state = (s["ts"], s["pbr"])
    *state, _ = graphed.chunk(*state, views, s["occ_buf"], s["knn3"], s["pw"], [0], [0], 0)
    (per_step,) = [v for k, v in graphed.launches.items() if k.shapes[-1] == (1024, 8, 16, 1)]
    for name in ("knn", "deform", "blend_fwd", "blend_fwd_ckpt", "blend_bwd", "blend_bwd_sums",
                 "blend_bwd_rows"):
        assert per_step[name] == 1, (name, per_step)
    assert "deform_bwd" not in per_step and "blend_bwd_ckpt" not in per_step
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        *state, _ = graphed.chunk(*state, views, s["occ_buf"], s["knn3"], s["pw"],
                                  [2, 1, 3, 0], [1, 0, 0, 1], 0, pad_to=8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert {k: v for k, v in cuda_lib.LAUNCHES.items() if v} == \
        {k: 4 * v for k, v in per_step.items()}


def bake_cloud(device, n=3000, cap=3072, seed=5):
    """A seeded body with an occluding slab, 72 dead slots: the bake's
    inputs (means, covariances, opacities, normals, alive)."""
    rng = np.random.RandomState(seed)
    body = rng.randn(n - 600, 3) * np.array([0.25, 0.45, 0.2])
    slab = rng.randn(600, 3) * np.array([0.3, 0.05, 0.3]) + np.array([0.0, 0.8, 0.0])
    pts = np.concatenate([body, slab, rng.randn(cap - n, 3) * 5.0]).astype(np.float32)
    scales = torch.as_tensor(np.exp(rng.randn(cap, 3) * 0.3 - 3.5).astype(np.float32))
    quats = torch.as_tensor(rng.randn(cap, 4).astype(np.float32))
    nrm = rng.randn(cap, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return tuple(torch.as_tensor(a).to(device) for a in (
        pts, covariance6_from_scaling_rotation(scales, quats),
        (rng.rand(cap) * 0.6 + 0.35).astype(np.float32), nrm, np.arange(cap) < n))


def test_device_face_cameras_are_the_host_ones(cuda):
    from mygauhuman_torch.occlusion.baking import face_cameras, face_cameras_torch

    c = np.random.RandomState(2).randn(50, 3).astype(np.float32)
    got = face_cameras_torch(torch.as_tensor(c, device=cuda)).cpu().numpy()
    np.testing.assert_array_equal(got, face_cameras(c))


def graphed_sweeps_match_eager(cuda, config, face_res=32):
    """Both windows of a 40-cell sweep over the cloud's 4^3 grid as the
    graphed batched program against the per-cell program (`eager=True`),
    bit for bit, then a sweep under `set_sync_debug_mode("error")` -> the
    kernel C launches of that sweep and its groups."""
    from mygauhuman_torch.occlusion import baking

    means, cov6, opac, _, alive = bake_cloud(cuda)
    grid_res, max_cells = 4, 40
    n_occ = baking.count_occupied(means, alive, grid_res)
    assert max_cells < n_occ < 2 * max_cells   # the last window clamps and holds empty slots
    kw = dict(height=16, width=32, grid_res=grid_res, max_cells=max_cells, face_res=face_res,
              config=config)
    vis0 = torch.ones((means.shape[0], 16, 32, 1), device=cuda)
    groups = baking.cell_groups(max_cells, means.shape[0], config)
    for offset in (0, max_cells):
        want, want_n = baking._bake_sweep(means, cov6, opac, alive, vis0, offset, eager=True,
                                          **kw)
        cuda_lib.reset_launches()
        graphs = len(baking._SWEEP_GRAPHS)
        got, got_n = baking._bake_sweep(means, cov6, opac, alive, vis0, offset, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got_n, want_n), offset
        assert not torch.equal(got, vis0)
        # a sweep that captured the graph ran the program once before it
        captured = len(baking._SWEEP_GRAPHS) - graphs
        assert cuda_lib.LAUNCHES["blend_fwd_tiles"] == (1 + captured) * len(groups)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, _ = baking._bake_sweep(means, cov6, opac, alive, vis0, 0, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return cuda_lib.LAUNCHES["blend_fwd_tiles"], groups


def test_graphed_bake_sweep_matches_eager_bit_for_bit(cuda):
    from mygauhuman_torch.occlusion import baking

    launches, groups = graphed_sweeps_match_eager(cuda, baking.DEFAULT_BAKE_CONFIG)
    assert len(groups) == 1 and launches == 1    # one replay, every face in one launch


@pytest.mark.parametrize("face_res", [32, 16])
def test_grouped_graphed_bake_sweep_matches_eager_bit_for_bit(cuda, monkeypatch, face_res):
    """The same sweeps with GROUP_SLOTS cut to 12 cells a group (at the
    lists of every instance): 4 groups of 10, one launch each, in one
    replay; faces of 4 tiles and of one."""
    from mygauhuman_torch.occlusion import baking

    monkeypatch.setattr(baking, "_SWEEP_GRAPHS", {})
    monkeypatch.setattr(baking, "GROUP_SLOTS", 6 * 3072 * 4 * 12)
    launches, groups = graphed_sweeps_match_eager(cuda, baking.bake_config(3072), face_res)
    assert [len(g) for g in groups] == [10] * 4 and launches == 4
