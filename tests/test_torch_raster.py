"""Port vs JAX package: binning, the blend spec, the instance-list blend
(kernel C's plain version, incl. saturation and the tile-major layout) and
rasterize.

Tolerances: binning is integer work and must be BIT-EQUAL on identical
means2d / radii / depths. Images 1e-5 abs (depth 1e-4, it carries the
~3-unit depth scale): the spec sums weights with a matmul on both sides, in
different orders. Kernel C itself is held to its plain version in
tests/test_torch_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygauhuman_tpu.data.camera import make_camera as jmake_camera
from mygauhuman_tpu.ops import pallas_blend as jpb
from mygauhuman_tpu.ops.binning import bin_gaussians as jbin
from mygauhuman_tpu.ops.blend import blend as jblend
from mygauhuman_tpu.ops.projection import preprocess as jpreprocess
from mygauhuman_tpu.ops.rasterize import (
    RasterizerConfig as JConfig,
    mark_visible as jmark_visible,
    rasterize as jrasterize,
)
from mygauhuman_tpu.utils.transforms import covariance6_from_scaling_rotation as jcov6
from mygauhuman_torch.data.camera import make_camera
from mygauhuman_torch.ops import pallas_blend as tpb
from mygauhuman_torch.ops.binning import bin_gaussians
from mygauhuman_torch.ops.blend import blend
from mygauhuman_torch.ops.rasterize import RasterizerConfig, mark_visible, rasterize

torch.set_num_threads(1)
C = 5
K = 256


def t(a):
    return torch.as_tensor(np.array(a))


def scene(seed=0, n=120, w=64, h=64, saturate=False):
    """Gaussians in front of a camera at z = 3, as numpy, plus both cameras."""
    rng = np.random.RandomState(seed)
    if saturate:   # a dense stack of near-opaque splats
        means = np.concatenate([rng.randn(n, 2) * 0.05, 2.0 + rng.rand(n, 1)], 1)
        scales = np.full((n, 3), 0.05)
        quats = np.tile([1.0, 0, 0, 0], (n, 1))
        opac = np.full(n, 0.97)
    else:
        means = rng.randn(n, 3) * 0.4
        scales = np.exp(rng.randn(n, 3) * 0.3 - 2.2)
        quats = rng.randn(n, 4)
        opac = rng.rand(n) * 0.9 + 0.05
    f32 = lambda a: np.asarray(a, np.float32)   # noqa: E731
    cov6 = np.asarray(jcov6(jnp.asarray(f32(scales)), jnp.asarray(f32(quats))))
    feats = rng.rand(n, C)
    cams = [mk(np.eye(3), np.array([0.0, 0.0, 3.0]), w, h, fovx=1.0, fovy=1.0, **kw)
            for mk, kw in ((jmake_camera, {}), (make_camera, {"device": "cpu"}))]
    return dict(means=f32(means), cov6=cov6, opac=f32(opac), feats=f32(feats),
                w=w, h=h, cam_j=cams[0], cam_t=cams[1])


def projected(s):
    cam = s["cam_j"]
    return jpreprocess(jnp.asarray(s["means"]), jnp.asarray(s["cov6"]), cam.w2c,
                       cam.full_proj, s["w"], s["h"], cam.tan_fovx, cam.tan_fovy)


@pytest.mark.parametrize("inst_cap", [None, 300])
def test_binning_bit_equal(inst_cap):
    s = scene(1, n=200)
    p = projected(s)
    depths = np.asarray(p.depths).copy()
    depths[10:20] = depths[10]          # ties: the stable argsort keeps id order
    kw = dict(width=64, height=64, tile_capacity=64, max_tiles_per_gaussian=8,
              instance_capacity=inst_cap)
    want = jbin(p.means2d, p.radii, jnp.asarray(depths), p.visible, **kw)
    got = bin_gaussians(t(p.means2d), t(p.radii), t(depths), t(p.visible), **kw)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    if inst_cap is not None:
        assert int(got.overflow_inst) > 0


def both_blends(s, bg_val=0.3):
    """(JAX spec blend, port spec blend, port instance-list blend) on the
    JAX package's own projection and binning."""
    p = projected(s)
    bins = jbin(p.means2d, p.radii, p.depths, p.visible, width=s["w"], height=s["h"],
                tile_capacity=K)
    bg = np.full(C, bg_val, np.float32)
    args_j = (p.means2d, p.conics, jnp.asarray(s["opac"]), jnp.asarray(s["feats"]),
              p.depths, jnp.asarray(bg))
    args_t = tuple(t(a) for a in args_j)
    ref = jblend(bins.idx, bins.valid, *args_j, width=s["w"], height=s["h"])
    spec = blend(t(bins.idx), t(bins.valid), *args_t, width=s["w"], height=s["h"])
    inst = tpb.blend_pallas(t(bins.sorted_rank), t(bins.order), t(bins.rank), t(bins.starts),
                            torch.clamp(t(bins.counts), max=K), *args_t,
                            width=s["w"], height=s["h"])
    return ref, spec, inst, bins


def assert_blend_close(got, ref):
    np.testing.assert_allclose(got.image.numpy(), np.asarray(ref.image), atol=1e-5)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(ref.alpha), atol=1e-5)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth), atol=1e-4)
    np.testing.assert_allclose(got.final_t.numpy(), np.asarray(ref.final_t), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_and_instance_blend_match_jax(seed):
    ref, spec, inst, _ = both_blends(scene(seed))
    assert_blend_close(spec, ref)
    assert_blend_close(inst, ref)
    assert float(inst.alpha.max()) > 0.1, "nothing blended"


def test_saturation_truncates_exactly():
    """Dense near-opaque stacks drive T below 1e-4 within a tile's list; the
    include test on the full cumprod must match the spec exactly."""
    ref, spec, inst, bins = both_blends(scene(3, n=300, saturate=True), bg_val=0.2)
    assert float(np.min(np.asarray(ref.final_t))) < 2e-4
    assert int(np.max(np.asarray(bins.counts))) > 256
    assert_blend_close(spec, ref)
    assert_blend_close(inst, ref)


@pytest.mark.parametrize("w,h,planar", [(128, 128, True), (48, 32, False)])
def test_layouts(w, h, planar):
    """128^2 takes the planar (row-kernel) layout, 48 px wide the tile-major."""
    tw = -(-w // 16)
    n_tiles = tw * (-(-h // 16))
    assert bool(tpb.row_mode_supported(n_tiles, tw, 16, 16)) == planar
    s = scene(4, n=200, w=w, h=h)
    ref, spec, inst, _ = both_blends(s)
    assert_blend_close(inst, ref)


def test_instance_blend_against_interpret_pallas():
    """One tiny case of the raw tile-major blend vs the interpret-mode Pallas
    kernel on the same instance matrix, with a nonzero tile_base."""
    s = scene(5, n=60, w=32, h=32)
    p = projected(s)
    bins = jbin(p.means2d, p.radii, p.depths, p.visible, width=32, height=32,
                tile_capacity=K)
    counts = jnp.minimum(bins.counts, K)
    inst = jpb.build_instance_data(bins.sorted_rank, bins.starts, counts, p.means2d,
                                   p.conics, jnp.asarray(s["opac"]), p.depths,
                                   jnp.asarray(s["feats"]), order=bins.order)
    base = jnp.asarray([2], jnp.int32)
    want = jpb.blend_tiles_raw(inst.data, inst.starts, inst.counts, base, n_tiles=2,
                               tiles_x=2, n_channels=C, interpret=True)
    got = tpb.blend_tiles_raw(t(inst.data), t(inst.starts)[:2], t(inst.counts)[:2], 2,
                              n_tiles=2, tiles_x=2, n_channels=C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :C + 3], atol=1e-5)
    ours = tpb.build_instance_data(t(bins.sorted_rank), t(bins.starts), t(counts),
                                   t(p.means2d), t(p.conics), t(s["opac"]), t(p.depths),
                                   t(s["feats"]), order=t(bins.order))
    ns = ours.data.shape[1]
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(inst.data)[:, :ns])


def test_rasterize_and_mark_visible_match_jax():
    s = scene(6, n=200)
    cj, ct = s["cam_j"], s["cam_t"]
    bg = np.linspace(0.1, 0.9, C).astype(np.float32)
    alive = np.arange(200) < 180
    common = dict(width=64, height=64, tan_fovx=cj.tan_fovx, tan_fovy=cj.tan_fovy)
    want = jrasterize(jnp.asarray(s["means"]), jnp.asarray(s["cov6"]), jnp.asarray(s["opac"]),
                      jnp.asarray(s["feats"]), cj.w2c, cj.full_proj, jnp.asarray(bg),
                      config=JConfig(tile_capacity=K, instance_capacity=800),
                      alive=jnp.asarray(alive), **common)
    got = rasterize(t(s["means"]), t(s["cov6"]), t(s["opac"]), t(s["feats"]), ct.w2c,
                    ct.full_proj, t(bg), config=RasterizerConfig(tile_capacity=K,
                                                                instance_capacity=800),
                    alive=t(alive), **common)
    assert_blend_close(got, want)
    for f in ("radii", "visible", "overflow_tiles", "overflow_gauss", "overflow_inst"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(
        mark_visible(t(s["means"]), ct.w2c, ct.full_proj).numpy(),
        np.asarray(jmark_visible(jnp.asarray(s["means"]), cj.w2c, cj.full_proj)))


def test_spec_gradients_flow():
    """The CPU path is differentiable by autograd (the training slice's
    yardstick); gradients are finite and nonzero."""
    s = scene(7)
    ct = s["cam_t"]
    means = t(s["means"]).requires_grad_(True)
    feats = t(s["feats"]).requires_grad_(True)
    out = rasterize(means, t(s["cov6"]), t(s["opac"]), feats, ct.w2c, ct.full_proj,
                    torch.zeros(C), width=64, height=64, tan_fovx=ct.tan_fovx,
                    tan_fovy=ct.tan_fovy, config=RasterizerConfig(tile_capacity=K))
    (out.image ** 2).sum().backward()
    for g in (means.grad, feats.grad):
        assert torch.isfinite(g).all() and g.abs().sum() > 0
