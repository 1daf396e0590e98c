"""The port's three CUDA kernels against their plain PyTorch versions, and
the rules of the kernel wrappers. No JAX here, so on a CUDA machine
without JAX run

    python -m pytest --noconftest tests/test_torch_kernels.py -q

(`--noconftest` because tests/conftest.py imports JAX). The kernel tests
skip without a CUDA card. Tolerances: kernels A and B are built with
-fmad=false and written op for op as their plain versions, so they must be
bit-equal; kernel C multiplies T per instance where the plain version sums
log(1 - alpha), and sums colours sequentially where it uses a matmul, so it
is held to 1e-4 abs (depth row 1e-3: depths are ~3).
"""
import numpy as np
import pytest
import torch

from mygauhuman_torch.data.camera import make_camera
from mygauhuman_torch.ops import cuda_lib
from mygauhuman_torch.ops import pallas_blend as pb
from mygauhuman_torch.ops.binning import bin_gaussians
from mygauhuman_torch.ops.pallas_deform import deform_rows, deform_rows_cuda, deform_rows_plain
from mygauhuman_torch.ops.pallas_knn import (
    knn_small_refs,
    knn_small_refs_cuda,
    knn_small_refs_plain,
)
from mygauhuman_torch.ops.projection import preprocess
from mygauhuman_torch.ops.rasterize import rasterize
from mygauhuman_torch.utils.transforms import covariance6_from_scaling_rotation

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest "
                    "tests/test_torch_kernels.py on the GPU")
    return torch.device("cuda")


def deform_inputs(N, seed=0):
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
    abig[:, 0] = 0.0   # a singular blend goes through the det guard
    abig[0, 0] = 1.0
    return abig, asrc, packed, sc


def instance_inputs(device, w, h, n=6000, C=19, seed=8):
    """A projected, binned cloud of n Gaussians -> (instance data, kwargs)."""
    rng = np.random.RandomState(seed)
    means = torch.as_tensor((rng.randn(n, 3) * 0.4).astype(np.float32), device=device)
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
    inst, kw = instance_inputs("cpu", 32, 32, n=50, C=4)
    with pytest.raises(ValueError, match="CUDA"):
        pb.blend_instances_cuda(inst.data, inst.starts, inst.counts, 0, **kw)


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


@pytest.mark.parametrize("N", [6912, 6890, 1])
def test_deform_kernel_matches_plain(cuda, N):
    args = [torch.as_tensor(a, device=cuda) for a in deform_inputs(max(N, 2))]
    args = [a[:, :N] if a.shape[0] != 1 else a for a in args]
    args = [a.contiguous() for a in args]
    got = deform_rows(*args)
    want = deform_rows_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_deform_kernel_backward_is_plain_autograd(cuda):
    args = deform_inputs(1000, seed=2)
    args[0][:, 0] = args[0][:, 1]
    a = [torch.as_tensor(x, device=cuda).requires_grad_(i < 3) for i, x in enumerate(args)]
    b = [torch.as_tensor(x, device=cuda).requires_grad_(i < 3) for i, x in enumerate(args)]
    (deform_rows(*a) ** 2).sum().backward()
    (deform_rows_plain(*b) ** 2).sum().backward()
    for x, y in zip(a[:3], b[:3]):
        torch.testing.assert_close(x.grad, y.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("w,h", [(512, 512), (208, 144)])
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


def test_blend_kernel_refuses_grad(cuda):
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), 64, 64, fovx=1.0, fovy=1.0,
                      device=cuda)
    feats = torch.rand(20, 3, device=cuda, requires_grad=True)
    means = torch.randn(20, 3, device=cuda) * 0.3
    cov6 = torch.tensor([0.01, 0, 0, 0.01, 0, 0.01], device=cuda).expand(20, 6)
    with pytest.raises(RuntimeError, match="forward-only"):
        rasterize(means, cov6, torch.full((20,), 0.5, device=cuda), feats, cam.w2c,
                  cam.full_proj, torch.zeros(3, device=cuda), width=64, height=64,
                  tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy)
    with torch.no_grad():
        out = rasterize(means, cov6, torch.full((20,), 0.5, device=cuda), feats, cam.w2c,
                        cam.full_proj, torch.zeros(3, device=cuda), width=64, height=64,
                        tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy)
    assert torch.isfinite(out.image).all()
