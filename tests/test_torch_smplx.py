"""Port vs JAX package: the SMPL-X body (models/smplx.py) and the 55-joint
path through the deform chain, the renderer and one branch-A step.

Tolerances, each stated where it is used:
  * `load_smplx` (both posedirs layouts, combined and split shapedirs, a
    directory or an .npz path), `smplx_full_pose`, `smplx_big_pose_params`
    and `synthetic_smplx`: exactly equal (the same numpy draws and
    reshapes);
  * `smpl_forward` on a 55-joint model: 1e-5 (fp32 LBS on both sides,
    different reduction orders);
  * a deform-branch `render_frame` with 55-joint MLPs: 1e-3, as
    tests/test_torch_render.py states for SMPL;
  * one branch-A step: loss and metrics 1e-4 relative, every gradient leaf
    (the 55-joint MLPs' included) within 1e-3 of the leaf's max, as
    tests/test_torch_train.py states for SMPL.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygauhuman_tpu.config import OptimizationConfig as JOptCfg
from mygauhuman_tpu.data.camera import make_camera as jmake_camera
from mygauhuman_tpu.models import gaussians as JG
from mygauhuman_tpu.models import mlps as jmlps
from mygauhuman_tpu.models import smplx as JX
from mygauhuman_tpu.models.smpl import smpl_forward as jfwd
from mygauhuman_tpu.ops.rasterize import RasterizerConfig as JConfig
from mygauhuman_tpu.render import FrameInputs as JFrame, render_frame as jrender
from mygauhuman_tpu.train import trainer as JT
from mygauhuman_torch import interop
from mygauhuman_torch.config import OptimizationConfig
from mygauhuman_torch.data.camera import make_camera
from mygauhuman_torch.models import smplx as TX
from mygauhuman_torch.models.smpl import smpl_forward
from mygauhuman_torch.ops.rasterize import RasterizerConfig
from mygauhuman_torch.render import FrameInputs, render_frame
from mygauhuman_torch.train import optim as TO
from mygauhuman_torch.train import trainer as TT
from test_smplx_training import export_smplx_npz

torch.set_num_threads(1)
W = H = 48
RENDER_ATOL = 1e-3
FIELDS = ("v_template", "shapedirs", "posedirs", "j_regressor", "weights")


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def assert_model_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got.parents, np.asarray(want.parents))
    np.testing.assert_array_equal(got.faces, np.asarray(want.faces))


@pytest.mark.parametrize("seed,n", [(0, 150), (3, 61)])
def test_synthetic_smplx_matches_jax(seed, n):
    t = TX.synthetic_smplx(num_vertices=n, seed=seed, device="cpu")
    assert_model_equal(t, JX.synthetic_smplx(num_vertices=n, seed=seed))
    assert t.j_regressor.shape == (55, n) and t.posedirs.shape == (n, 3, 486)
    assert t.shapedirs.shape == (n, 3, 20) and t.v_template.dtype == torch.float32


def _reference_layout(model, path, layout):
    """The SMPL-X npz in one of the layouts `load_smplx` reads."""
    rng = np.random.RandomState(5)
    V = model.v_template.shape[0]
    arrays = dict(v_template=np.asarray(model.v_template),
                  J_regressor=np.asarray(model.j_regressor),
                  f=rng.randint(0, V, (7, 3)).astype(np.int64))
    posedirs = np.asarray(model.posedirs)
    shapedirs = np.asarray(model.shapedirs)
    if layout == "smplx_release":
        # the smplx release: combined 400-column shape basis (300 betas +
        # 100 expression), pose basis first ([486, V, 3]), a kintree table,
        # lbs_weights
        full = rng.randn(V, 3, 400).astype(np.float32)
        full[..., :10] = shapedirs[..., :10]
        full[..., 300:310] = shapedirs[..., 10:]
        arrays.update(shapedirs=full,
                      posedirs=np.moveaxis(posedirs, -1, 0),
                      lbs_weights=np.asarray(model.weights))
        kintree = np.zeros((2, 55), np.int64)
        kintree[0] = np.asarray(model.parents)
        kintree[0, 0] = 2**32 - 1
        kintree[1] = np.arange(55)
        arrays["kintree_table"] = kintree
    elif layout == "flat_posedirs":
        # posedirs [V*3, 486], a 16-column shape basis (the expression part
        # is its last 10 columns)
        arrays.update(shapedirs=np.concatenate(
            [shapedirs[..., :10], rng.randn(V, 3, 6).astype(np.float32), shapedirs[..., 10:]],
            axis=-1), posedirs=posedirs.reshape(V * 3, 486),
            weights=np.asarray(model.weights), parents=np.asarray(model.parents, np.int64))
    else:
        # betas only: the expression columns are zero
        arrays.update(shapedirs=shapedirs[..., :10], posedirs=posedirs,
                      weights=np.asarray(model.weights),
                      parents=np.asarray(model.parents, np.int64))
    np.savez(path, **arrays)


@pytest.mark.parametrize("layout", ["exported", "smplx_release", "flat_posedirs",
                                    "betas_only", "directory"])
def test_load_smplx_matches_jax(layout, tmp_path):
    model = JX.synthetic_smplx(num_vertices=70, seed=1)
    path = str(tmp_path / "SMPLX_FEMALE.npz")
    if layout in ("exported", "directory"):
        export_smplx_npz(model, path)
    else:
        _reference_layout(model, path, layout)
    src = str(tmp_path) if layout == "directory" else path
    want = JX.load_smplx(src, gender="female")
    got = TX.load_smplx(src, gender="female", device="cpu")
    assert_model_equal(got, want)
    if layout in ("exported", "smplx_release", "flat_posedirs", "directory"):
        # every layout with the basis gives back the model's own arrays
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(model, f)))


def test_full_pose_and_big_pose_match_jax():
    rng = np.random.RandomState(2)
    parts = [rng.randn(n).astype(np.float32) for n in (3, 63, 3, 3, 3, 45, 45)]
    got = TX.smplx_full_pose(parts[0], parts[1], *parts[2:])
    want = JX.smplx_full_pose(parts[0], parts[1], *parts[2:])
    np.testing.assert_array_equal(got, want)
    assert got.shape == (165,) and got.dtype == np.float32
    np.testing.assert_array_equal(TX.smplx_full_pose(parts[0], parts[1]),
                                  JX.smplx_full_pose(parts[0], parts[1]))
    tb, jb = TX.smplx_big_pose_params(device="cpu"), JX.smplx_big_pose_params()
    assert sorted(tb) == sorted(jb)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)


@pytest.fixture(scope="module")
def body():
    jm = JX.synthetic_smplx(num_vertices=300, seed=0)
    rng = np.random.RandomState(0)
    pose = (0.15 * rng.randn(165)).astype(np.float32)
    pose[:3] = 0.0
    shapes = (0.3 * rng.randn(20)).astype(np.float32)
    return jm, TX.synthetic_smplx(num_vertices=300, seed=0, device="cpu"), pose, shapes


def test_smpl_forward_55_joints_matches_jax(body):
    """1e-5: fp32 LBS with the [486] pose feature and 20 shape dims."""
    jm, tm, pose, shapes = body
    for p, s in ((pose, shapes), (np.asarray(JX.smplx_big_pose_params()["poses"]),
                                  np.zeros(20, np.float32))):
        jv, jj = jfwd(jm, jnp.asarray(p), jnp.asarray(s))
        tv, tj = smpl_forward(tm, torch.tensor(p), torch.tensor(s))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
        np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=1e-5)
        assert tj.shape == (55, 3)


@pytest.fixture(scope="module")
def scene(body):
    """A 300-vertex SMPL-X scene in both packages from the same numpy
    inputs, with 55-joint MLPs and ground truth rendered by the JAX package."""
    jm, tm, pose, shapes = body
    jbig = JX.smplx_big_pose_params()
    verts = np.asarray(jfwd(jm, jbig["poses"], jbig["shapes"])[0])
    rng = np.random.RandomState(1)
    colors = rng.rand(300, 3).astype(np.float32)
    normals = rng.randn(300, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    jstate = JG.create_from_pcd(verts, colors, normals, capacity=512)
    p = jstate.params
    jstate = jstate._replace(params=p._replace(
        features_rest=jnp.asarray(0.2 * rng.randn(*p.features_rest.shape), jnp.float32),
        opacity=jnp.asarray(rng.randn(512, 1) + 1.0, jnp.float32)))
    param = {"poses": pose, "shapes": shapes, "R": np.eye(3, dtype=np.float32),
             "Th": np.array([0.0, 0.05, 0.0], np.float32)}
    jframe = JFrame(smpl_param={k: jnp.asarray(v) for k, v in param.items()},
                    big_pose_param=jbig, big_pose_verts=jnp.asarray(verts))
    tframe = FrameInputs(smpl_param=interop.tensor_tree(param, "cpu"),
                         big_pose_param=TX.smplx_big_pose_params(device="cpu"),
                         big_pose_verts=torch.as_tensor(verts.copy()))
    center = verts.mean(0)
    cam_args = (np.eye(3), -center + np.array([0.0, 0.0, 1.6]), W, H)
    jmlp = {"pose_refiner": jmlps.init_pose_refiner(jax.random.PRNGKey(0), total_bones=55),
            "lbs_offset": jmlps.init_lbs_offset(jax.random.PRNGKey(1), total_bones=55)}
    return dict(jm=jm, tm=tm, jstate=jstate, tstate=interop.gaussian_state(as_np(jstate), "cpu"),
                jframe=jframe, tframe=tframe, jmlp=jmlp,
                tmlp=interop.tensor_tree(as_np(jmlp), "cpu"),
                jcam=jmake_camera(*cam_args, fovx=1.0, fovy=1.0),
                tcam=make_camera(*cam_args, fovx=1.0, fovy=1.0, device="cpu"))


def test_render_deform_branch_55_joints_matches_jax(scene):
    s = scene
    jcfg, tcfg = JConfig(tile_capacity=256, chunk_tiles=16), RasterizerConfig(
        tile_capacity=256, chunk_tiles=16)
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    want = jrender(s["jstate"], s["jcam"], s["jframe"], s["jm"], bg=jnp.asarray(bg),
                   active_sh_degree=3, config=jcfg, mlp_params=s["jmlp"])
    got = render_frame(s["tstate"], s["tcam"], s["tframe"], s["tm"], bg=torch.as_tensor(bg),
                       active_sh_degree=3, config=tcfg, mlp_params=s["tmlp"])
    for f in ("render", "render_depth", "render_alpha", "normal", "world_normal", "albedo"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=RENDER_ATOL, err_msg=f)
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(want.radii))
    np.testing.assert_allclose(got.transforms.numpy(), np.asarray(want.transforms),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.correct_Rs.numpy(), np.asarray(want.correct_Rs), atol=1e-6)
    assert got.correct_Rs.shape == (54, 3, 3)
    assert float(got.render_alpha.max()) > 0.5


def close(got, want, rel, abs_=0.0, msg=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max(initial=0.0)) + abs_,
                               err_msg=msg)


def test_train_step_55_joints_matches_jax(scene):
    s = scene
    jcfg_r = JConfig(tile_capacity=256, chunk_tiles=16, instance_capacity=4 * 512)
    tcfg_r = RasterizerConfig(tile_capacity=256, chunk_tiles=16, instance_capacity=4 * 512)
    gt = jrender(s["jstate"], s["jcam"], s["jframe"], s["jm"], bg=jnp.zeros(3),
                 active_sh_degree=0, config=jcfg_r)
    # the init: the same cloud, gray, at the default opacity
    jinit = s["jstate"]._replace(params=s["jstate"].params._replace(
        features_dc=jnp.zeros_like(s["jstate"].params.features_dc),
        opacity=jnp.full_like(s["jstate"].params.opacity, -2.0)))
    masks = dict(gt_image=np.asarray(gt.render), gt_normal=np.asarray(gt.normal),
                 bkgd_mask=(np.asarray(gt.render_alpha) > 0.5).astype(np.float32),
                 bound_mask=np.ones((H, W), np.float32))
    jb = JT.TrainBatch(camera=s["jcam"], frame=s["jframe"],
                       **{k: jnp.asarray(v) for k, v in masks.items()})
    tb = TT.TrainBatch(camera=s["tcam"], frame=s["tframe"],
                       **{k: torch.tensor(v) for k, v in masks.items()})
    jts, _ = JT.create_train_state(JOptCfg(), jinit, s["jmlp"]["pose_refiner"],
                                   s["jmlp"]["lbs_offset"])

    def loss_fn(params, m2d):
        out = jrender(jts.gauss._replace(params=params.gaussians), jb.camera, jb.frame,
                      s["jm"], bg=jnp.zeros(3), active_sh_degree=1,
                      mlp_params={"pose_refiner": params.pose_refiner,
                                  "lbs_offset": params.lbs_offset},
                      config=jcfg_r, means2d_offset=m2d)
        alive = jts.gauss.alive.astype(jnp.float32)
        sm = jnp.sum(JG.get_scaling(params.gaussians) * alive[:, None]) / jnp.maximum(
            jnp.sum(alive) * 3, 1.0)
        total, metrics = JT.compute_losses_a(out, jb, sm)
        return total, (metrics, out.radii)

    (_, (jm, jradii)), (jg, jg2d) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(JT.trainable_params(jts), jnp.zeros((512, 2)))

    cfg = OptimizationConfig()
    tts, tx = TT.create_train_state(cfg, interop.gaussian_state(as_np(jinit), "cpu"),
                                    s["tmlp"]["pose_refiner"], s["tmlp"]["lbs_offset"])
    step = TT.make_train_step(s["tm"], tx, cfg, tcfg_r, bg=torch.zeros(3))
    total, metrics, grads, g2d, radii = step.loss_and_grads(tts, tb, 1)
    for k in ("loss", "l1", "mask", "normal", "axis", "ssim", "tv", "scaling_mean", "psnr"):
        close(metrics[k], jm[k], 1e-4, 1e-7, k)
    np.testing.assert_array_equal(radii.numpy(), np.asarray(jradii))
    jleaves = jax.tree_util.tree_leaves(jg)
    tleaves = TO.tree_leaves(grads)
    assert len(jleaves) == len(tleaves)
    for i, (a, b) in enumerate(zip(tleaves, jleaves)):
        close(a, b, 1e-3, 1e-10, f"gradient leaf {i} {tuple(b.shape)}")
    close(g2d, jg2d, 1e-3, 1e-10, "means2d_offset")
    # the 55-joint MLPs: 162 inputs, 162 outputs, 55 blend-weight logits
    assert tuple(grads.pose_refiner["layers"][0]["w"].shape) == (162, 128)
    assert tuple(grads.lbs_offset["head"]["w"].shape)[1] == 55
    assert float(grads.pose_refiner["layers"][-1]["w"].abs().max()) > 0
    assert float(np.abs(np.asarray(jg.gaussians.xyz)).max()) > 0
