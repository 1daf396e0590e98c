"""Port vs JAX package: SMPL, the MLPs, the deform chain (kernel B) and LBS.

Shared numpy inputs, CPU. Tolerance 1e-5 abs/rel: fp32 on both sides, the
matmuls (einsums over 6-207 terms) and transcendentals round differently in
the last ulps. Kernel B itself is held to its plain version in
tests/test_torch_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygauhuman_tpu.models import lbs as jlbs
from mygauhuman_tpu.models import mlps as jmlps
from mygauhuman_tpu.models import smpl as jsmpl
from mygauhuman_tpu.ops.pallas_deform import _deform_rows_jnp, deform_rows as jdeform
from mygauhuman_torch import interop
from mygauhuman_torch.models import lbs as tlbs
from mygauhuman_torch.models import mlps as tmlps
from mygauhuman_torch.models import smpl as tsmpl
from mygauhuman_torch.ops.pallas_deform import deform_rows

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), **(tol or TOL))


@pytest.fixture(scope="module")
def models():
    return jsmpl.synthetic_smpl(300, seed=1), tsmpl.synthetic_smpl(300, seed=1, device="cpu")


def frame_params(seed, scale=0.3):
    rng = np.random.RandomState(seed)
    R = np.linalg.qr(rng.randn(3, 3))[0].astype(np.float32)
    return {"poses": (scale * rng.randn(72)).astype(np.float32),
            "shapes": (0.5 * rng.randn(10)).astype(np.float32),
            "R": R, "Th": rng.randn(3).astype(np.float32)}


def test_synthetic_smpl_identical_and_forward(models):
    jm, tm = models
    for f in ("v_template", "shapedirs", "posedirs", "j_regressor", "weights"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)))
    np.testing.assert_array_equal(tm.parents, jm.parents)
    p = frame_params(0)
    vj, jj = jsmpl.smpl_forward(jm, jnp.asarray(p["poses"]), jnp.asarray(p["shapes"]))
    vt, jt = tsmpl.smpl_forward(tm, torch.as_tensor(p["poses"]), torch.as_tensor(p["shapes"]))
    close(vt, vj)
    close(jt, jj)
    big_j = jsmpl.big_pose_params()
    big_t = tsmpl.big_pose_params(device="cpu")
    for k in big_j:
        np.testing.assert_array_equal(big_t[k].numpy(), np.asarray(big_j[k]))


def test_interop_smpl_model(models):
    jm, _ = models
    tm = interop.smpl_model(jax.tree.map(np.asarray, jm), device="cpu")
    np.testing.assert_array_equal(tm.posedirs.numpy(), np.asarray(jm.posedirs))


def test_load_smpl_npz_matches_jax(models, tmp_path):
    """An SMPL-style .npz (kintree table, 2-D posedirs) loads to the same
    arrays and kinematic tree in both packages."""
    jm, _ = models
    parents = np.asarray(jm.parents)
    kintree = np.stack([np.where(parents < 0, 2**32 - 1, parents), np.arange(24)])
    path = str(tmp_path / "smpl.npz")
    np.savez(path, v_template=np.asarray(jm.v_template), J_regressor=np.asarray(jm.j_regressor),
             shapedirs=np.asarray(jm.shapedirs), weights=np.asarray(jm.weights),
             posedirs=np.asarray(jm.posedirs).reshape(-1, 207), kintree_table=kintree,
             f=np.zeros((4, 3), np.int32))
    want = jsmpl.load_smpl(path)
    got = tsmpl.load_smpl(path, device="cpu")
    for f in ("v_template", "shapedirs", "posedirs", "j_regressor", "weights"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(got.parents, want.parents)
    np.testing.assert_array_equal(got.parents, parents)
    assert got.faces.shape == (4, 3)


def test_transform_params_pose_offsets_correct_rs(models):
    jm, tm = models
    p = frame_params(1)
    rng = np.random.RandomState(2)
    corr = np.asarray(jsmpl.rodrigues(jnp.asarray(0.05 * rng.randn(23, 3), jnp.float32)))
    A_j, J_j = jlbs.transform_params(jm, {k: jnp.asarray(v) for k, v in p.items()},
                                     correct_Rs=jnp.asarray(corr))
    A_t, J_t = tlbs.transform_params(tm, {k: torch.as_tensor(v) for k, v in p.items()},
                                     correct_Rs=torch.as_tensor(corr))
    close(A_t, A_j)
    close(J_t, J_j)
    rot = np.asarray(jsmpl.rodrigues(jnp.asarray(p["poses"]).reshape(-1, 3)))
    close(tlbs._pose_offsets(tm, torch.as_tensor(rot)), jlbs._pose_offsets(jm, jnp.asarray(rot)))


def test_mlps_with_jax_weights():
    pr = jmlps.init_pose_refiner(jax.random.PRNGKey(0))
    lo = jmlps.init_lbs_offset(jax.random.PRNGKey(1))
    pr_t = interop.tensor_tree(jax.tree.map(np.asarray, pr), device="cpu")
    lo_t = interop.tensor_tree(jax.tree.map(np.asarray, lo), device="cpu")
    rng = np.random.RandomState(3)
    pose = (0.3 * rng.randn(69)).astype(np.float32)
    pts = (0.4 * rng.randn(50, 3)).astype(np.float32)
    close(tmlps.apply_pose_refiner(pr_t, torch.as_tensor(pose)),
          jmlps.apply_pose_refiner(pr, jnp.asarray(pose)))
    close(tmlps.apply_lbs_offset(lo_t, torch.as_tensor(pts)),
          jmlps.apply_lbs_offset(lo, jnp.asarray(pts)), rtol=1e-5, atol=1e-4)
    close(tmlps.positional_encode(torch.as_tensor(pts)), jmlps.positional_encode(jnp.asarray(pts)))
    # the port's own init has the JAX structure and shapes
    gen = torch.Generator().manual_seed(0)
    own = tmlps.init_lbs_offset(gen, device="cpu")
    assert [tuple(p["w"].shape) for p in own["layers"]] == [p["w"].shape for p in lo["layers"]]
    assert tmlps.apply_pose_refiner(tmlps.init_pose_refiner(gen, device="cpu"),
                                    torch.as_tensor(pose)).shape == (23, 3, 3)


def deform_inputs(N, seed=0):
    """Well-conditioned blends (near identity + noise), as the JAX tests."""
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
    abig[:, 0] = 0.0   # a singular blend: the det guard keeps it finite
    abig[0, 0] = 1.0
    return abig, asrc, packed, sc


@pytest.mark.parametrize("N", [256, 333])
def test_deform_plain_matches_jax(N):
    args = deform_inputs(N)
    got = deform_rows(*(torch.as_tensor(a) for a in args))
    want = _deform_rows_jnp(*(jnp.asarray(a) for a in args))
    assert torch.isfinite(got).all()
    # column 0 went through the 1e-8 det guard: its entries are ~1e8
    close(got[:, 1:], np.asarray(want)[:, 1:], rtol=1e-5, atol=1e-5)
    close(got[:, 0], np.asarray(want)[:, 0], rtol=1e-4)


def test_deform_against_interpret_pallas_and_grads():
    args = deform_inputs(128, seed=4)
    args[0][:, 0] = args[0][:, 1]    # no singular column for the gradients
    want = jdeform(*(jnp.asarray(a) for a in args), "interpret")
    tens = [torch.as_tensor(a).requires_grad_(i < 3) for i, a in enumerate(args)]
    got = deform_rows(*tens)
    close(got, want, rtol=1e-5, atol=1e-5)
    (got ** 2).sum().backward()
    g_j = jax.grad(lambda a, b, p: jnp.sum(_deform_rows_jnp(a, b, p, jnp.asarray(args[3])) ** 2),
                   argnums=(0, 1, 2))(*(jnp.asarray(a) for a in args[:3]))
    for t_, g in zip(tens[:3], g_j):
        close(t_.grad, g, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("use_mlps", [False, True])
def test_coarse_deform_matches_jax(models, use_mlps):
    jm, tm = models
    rng = np.random.RandomState(5)
    big_j = jsmpl.big_pose_params()
    big_t = tsmpl.big_pose_params(device="cpu")
    verts, _ = jsmpl.smpl_forward(jm, big_j["poses"], big_j["shapes"])
    verts = np.asarray(verts)
    pts = (verts[rng.randint(0, 300, 500)] + 0.01 * rng.randn(500, 3)).astype(np.float32)
    nrm = rng.randn(500, 3).astype(np.float32)
    p = frame_params(6)
    kw_j, kw_t = {}, {}
    if use_mlps:
        off = (0.5 * rng.randn(500, 24)).astype(np.float32)
        corr = np.asarray(jsmpl.rodrigues(jnp.asarray(0.05 * rng.randn(23, 3), jnp.float32)))
        kw_j = dict(lbs_offset=jnp.asarray(off), correct_Rs=jnp.asarray(corr))
        kw_t = dict(lbs_offset=torch.as_tensor(off), correct_Rs=torch.as_tensor(corr))
    want = jlbs.coarse_deform_c2source(
        jm, jnp.asarray(pts), {k: jnp.asarray(v) for k, v in p.items()}, big_j,
        jnp.asarray(verts), normals=jnp.asarray(nrm), **kw_j)
    got = tlbs.coarse_deform_c2source(
        tm, torch.as_tensor(pts), {k: torch.as_tensor(v) for k, v in p.items()}, big_t,
        torch.as_tensor(verts.copy()), normals=torch.as_tensor(nrm), **kw_t)
    for f in want._fields:
        close(getattr(got, f), getattr(want, f))
