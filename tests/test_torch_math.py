"""Port vs JAX package: transforms, spherical harmonics, camera, projection.

Inputs are made with numpy from a seed and fed to both packages on the CPU.
Tolerance 1e-5 (abs and rel) unless stated: both sides are fp32 elementwise
chains, so only the last-ulp rounding of matmuls and transcendentals differs.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygauhuman_tpu.data import camera as jcam
from mygauhuman_tpu.ops import projection as jproj
from mygauhuman_tpu.ops import sh as jsh
from mygauhuman_tpu.utils import transforms as jtf
from mygauhuman_torch.data import camera as tcam
from mygauhuman_torch.ops import projection as tproj
from mygauhuman_torch.ops import sh as tsh
from mygauhuman_torch.utils import transforms as ttf

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
    return torch.as_tensor(np.array(a, np.float32))


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def test_quat_rotmat_and_rodrigues(rng):
    q = rng.randn(50, 4).astype(np.float32)
    close(torch.stack(ttf.quat_to_rotmat_cols(t(q)), -1).reshape(50, 3, 3),
          jtf.quat_to_rotmat(jnp.asarray(q)))
    r = (rng.randn(50, 3) * 0.8).astype(np.float32)
    close(ttf.rodrigues(t(r)), jtf.rodrigues(jnp.asarray(r)))
    close(ttf.rodrigues_mlp(t(r)), jtf.rodrigues_mlp(jnp.asarray(r)))


@pytest.mark.parametrize("with_transform", [False, True])
def test_covariance6(rng, with_transform):
    s = np.exp(rng.randn(40, 3) * 0.3 - 2).astype(np.float32)
    q = rng.randn(40, 4).astype(np.float32)
    tf = rng.randn(40, 3, 3).astype(np.float32) if with_transform else None
    got = ttf.covariance6_from_scaling_rotation(t(s), t(q), 1.3,
                                                None if tf is None else t(tf))
    want = jtf.covariance6_from_scaling_rotation(
        jnp.asarray(s), jnp.asarray(q), 1.3, None if tf is None else jnp.asarray(tf))
    close(got, want, rtol=1e-5, atol=1e-7)


def test_inv3x3_with_det_guard(rng):
    m = rng.randn(30, 3, 3).astype(np.float32)
    m[0] = np.array([[1, 2, 3], [2, 4, 6], [0, 1, 0]], np.float32)   # singular
    got = ttf.inv3x3(t(m))
    want = jtf.inv3x3(jnp.asarray(m))
    assert torch.isfinite(got).all()
    # the guarded row is ~1e8 in magnitude: compare relative to its scale
    close(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(np.asarray(want)).max()))


def test_normalize_rot_apply_inverse_sigmoid(rng):
    v = rng.randn(20, 3).astype(np.float32)
    v[0] = 0.0   # the eps keeps a zero vector finite
    close(ttf.normalize(t(v)), jtf.normalize(jnp.asarray(v)))
    m = rng.randn(20, 3, 3).astype(np.float32)
    close(ttf.rot_apply(t(m), t(v)), jtf.rot_apply(jnp.asarray(m), jnp.asarray(v)))
    x = rng.uniform(0.05, 0.95, 20).astype(np.float32)
    close(ttf.inverse_sigmoid(t(x)), jtf.inverse_sigmoid(jnp.asarray(x)))
    assert ttf.inverse_sigmoid(0.9) == float(jtf.inverse_sigmoid(0.9))


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh(rng, deg):
    sh = rng.randn(25, 3, (deg + 1) ** 2).astype(np.float32)
    d = rng.randn(25, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    close(tsh.eval_sh_color(deg, t(sh), t(d)),
          jsh.eval_sh_color(deg, jnp.asarray(sh), jnp.asarray(d)))
    rgb = rng.rand(5, 3).astype(np.float32)
    close(tsh.rgb2sh(t(rgb)), jsh.rgb2sh(jnp.asarray(rgb)))


def test_make_camera_fov_and_K():
    R = np.linalg.qr(np.random.RandomState(1).randn(3, 3))[0]
    tvec = np.array([0.1, -0.2, 3.0])
    for kw in (dict(fovx=1.0, fovy=0.8),
               dict(K=np.array([[300.0, 0, 30.0], [0, 310.0, 33.0], [0, 0, 1]]))):
        a = tcam.make_camera(R, tvec, 64, 48, device="cpu", **kw)
        b = jcam.make_camera(R, tvec, 64, 48, **kw)
        for f in ("w2c", "full_proj", "cam_center"):
            np.testing.assert_array_equal(getattr(a, f).numpy(), getattr(b, f))
        assert (a.width, a.height) == (b.width, b.height)
        assert math.isclose(a.tan_fovx, b.tan_fovx) and math.isclose(a.tan_fovy, b.tan_fovy)


def test_preprocess_matches_jax(rng):
    n = 400
    means = (rng.randn(n, 3) * 0.6).astype(np.float32)
    means[:5, 2] = -3.5          # behind the camera: culled
    s = np.exp(rng.randn(n, 3) * 0.3 - 2.2).astype(np.float32)
    q = rng.randn(n, 4).astype(np.float32)
    cov6 = np.asarray(jtf.covariance6_from_scaling_rotation(jnp.asarray(s), jnp.asarray(q)))
    cam_j = jcam.make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), 64, 64, fovx=1.0, fovy=1.0)
    cam_t = tcam.make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), 64, 64, fovx=1.0,
                             fovy=1.0, device="cpu")
    want = jproj.preprocess(jnp.asarray(means), jnp.asarray(cov6), cam_j.w2c,
                            cam_j.full_proj, 64, 64, cam_j.tan_fovx, cam_j.tan_fovy)
    got = tproj.preprocess(t(means), t(cov6), cam_t.w2c, cam_t.full_proj, 64, 64,
                           cam_t.tan_fovx, cam_t.tan_fovy)
    close(got.means2d, want.means2d, rtol=1e-5, atol=1e-4)   # pixels
    close(got.depths, want.depths)
    close(got.cov2d, want.cov2d, rtol=1e-5, atol=1e-5)
    close(got.conics, want.conics, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.visible.numpy(), np.asarray(want.visible))
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(want.radii))
    assert not got.visible[:5].any() and got.visible.sum() > n // 2
