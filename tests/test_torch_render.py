"""Port vs JAX package: render_frame (both branches, with and without the
MLPs), the synthetic scene, the Gaussian state (create / grow / compact),
PLY interchange, interop, and the package's own rules (no JAX import, CUDA
by default).

render_frame on a 64^2 scene with 300 SMPL vertices is held to max abs
1e-3: the whole chain (SMPL, KNN, deform, projection, binning, blend) runs
in fp32 on both sides with different rounding, which moves splats by
~1e-6 px; the measured error is ~1e-6 and the bound leaves room for a
Gaussian whose 3-sigma tile rect lands on the other side of a tile edge.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygauhuman_tpu.data.camera import make_camera as jmake_camera
from mygauhuman_tpu.data.synthetic import make_synthetic_scene as jscene
from mygauhuman_tpu.models import gaussians as JG
from mygauhuman_tpu.models import io as jio
from mygauhuman_tpu.models import mlps as jmlps
from mygauhuman_tpu.models.smpl import big_pose_params as jbig, smpl_forward as jfwd
from mygauhuman_tpu.models.smpl import synthetic_smpl as jsmpl
from mygauhuman_tpu.ops.rasterize import RasterizerConfig as JConfig
from mygauhuman_tpu.render import FrameInputs as JFrame, render_frame as jrender
from mygauhuman_torch import interop
from mygauhuman_torch.data.camera import make_camera
from mygauhuman_torch.data.synthetic import make_synthetic_scene
from mygauhuman_torch.models import gaussians as TG
from mygauhuman_torch.models import io as tio
from mygauhuman_torch.models.smpl import big_pose_params, synthetic_smpl
from mygauhuman_torch.ops.rasterize import RasterizerConfig
from mygauhuman_torch.render import FrameInputs, render_frame

torch.set_num_threads(1)
W = H = 64
RENDER_ATOL = 1e-3
JCFG = JConfig(tile_capacity=256, chunk_tiles=16)
TCFG = RasterizerConfig(tile_capacity=256, chunk_tiles=16)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """One 300-vertex scene in both packages, from the same numpy inputs."""
    jm = jsmpl(num_vertices=300, seed=0)
    big = jbig()
    verts = np.asarray(jfwd(jm, big["poses"], big["shapes"])[0])
    rng = np.random.RandomState(0)
    colors = rng.rand(300, 3).astype(np.float32)
    normals = rng.randn(300, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    jstate = JG.create_from_pcd(verts, colors, normals, capacity=512)
    # some SH rest energy and varied opacity so every channel carries signal
    p = jstate.params
    jstate = jstate._replace(params=p._replace(
        features_rest=jnp.asarray(0.2 * rng.randn(*p.features_rest.shape), jnp.float32),
        opacity=jnp.asarray(rng.randn(512, 1), jnp.float32)))
    pose = (0.2 * rng.randn(72)).astype(np.float32)
    smpl_param = {"poses": pose, "shapes": np.zeros(10, np.float32),
                  "R": np.eye(3, dtype=np.float32), "Th": np.array([0.0, 0.1, 0.0], np.float32)}
    jframe = JFrame(smpl_param={k: jnp.asarray(v) for k, v in smpl_param.items()},
                    big_pose_param=big, big_pose_verts=jnp.asarray(verts))
    tframe = FrameInputs(smpl_param=interop.tensor_tree(smpl_param, "cpu"),
                         big_pose_param=big_pose_params(device="cpu"),
                         big_pose_verts=torch.as_tensor(verts.copy()))
    cam_args = (np.eye(3), np.array([0.0, 0.0, 3.0]), W, H)
    return dict(
        jm=jm, tm=synthetic_smpl(num_vertices=300, seed=0, device="cpu"),
        jstate=jstate, tstate=interop.gaussian_state(as_np(jstate), device="cpu"),
        jframe=jframe, tframe=tframe,
        jcam=jmake_camera(*cam_args, fovx=1.0, fovy=1.0),
        tcam=make_camera(*cam_args, fovx=1.0, fovy=1.0, device="cpu"),
    )


def assert_render_close(got, want, atol=RENDER_ATOL):
    for f in ("render", "render_depth", "render_alpha", "normal", "world_normal",
              "albedo", "occlusion", "roughness", "render_axis"):
        np.testing.assert_allclose(getattr(got, f).detach().numpy(),
                                   np.asarray(getattr(want, f)), atol=atol, err_msg=f)
    for f in ("radii", "overflow_tiles", "overflow_gauss", "overflow_inst"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


@pytest.mark.parametrize("use_mlps", [False, True])
def test_render_deform_branch_matches_jax(setup, use_mlps):
    s = setup
    jmlp = tmlp = None
    if use_mlps:
        jmlp = {"pose_refiner": jmlps.init_pose_refiner(jax.random.PRNGKey(0)),
                "lbs_offset": jmlps.init_lbs_offset(jax.random.PRNGKey(1))}
        tmlp = interop.tensor_tree(as_np(jmlp), "cpu")
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    want = jrender(s["jstate"], s["jcam"], s["jframe"], s["jm"], bg=jnp.asarray(bg),
                   active_sh_degree=3, config=JCFG, mlp_params=jmlp)
    got = render_frame(s["tstate"], s["tcam"], s["tframe"], s["tm"], bg=torch.as_tensor(bg),
                       active_sh_degree=3, config=TCFG, mlp_params=tmlp)
    assert_render_close(got, want)
    np.testing.assert_allclose(got.transforms.numpy(), np.asarray(want.transforms),
                               rtol=1e-5, atol=1e-5)
    assert float(got.render_alpha.max()) > 0.5
    if use_mlps:
        np.testing.assert_allclose(got.correct_Rs.numpy(), np.asarray(want.correct_Rs),
                                   atol=1e-6)


def test_render_replay_branch_matches_jax_and_deform(setup):
    s = setup
    bg = torch.zeros(3)
    first = render_frame(s["tstate"], s["tcam"], s["tframe"], s["tm"], bg=bg,
                         active_sh_degree=3, config=TCFG)
    want = jrender(s["jstate"], s["jcam"], s["jframe"], s["jm"], bg=jnp.zeros(3),
                   active_sh_degree=3, config=JCFG,
                   transforms=jnp.asarray(first.transforms.numpy()),
                   translation=jnp.asarray(first.translation.numpy()))
    got = render_frame(s["tstate"], s["tcam"], s["tframe"], s["tm"], bg=bg,
                       active_sh_degree=3, config=TCFG, transforms=first.transforms,
                       translation=first.translation)
    assert_render_close(got, want)
    # replay reproduces the deform render (the same tolerance chip_smoke uses)
    assert float((got.render - first.render).abs().max()) <= RENDER_ATOL


def test_synthetic_scene_matches_jax():
    cfg_j = JConfig(tile_capacity=256, chunk_tiles=16, instance_capacity=4 * 1024)
    cfg_t = RasterizerConfig(tile_capacity=256, chunk_tiles=16, instance_capacity=4 * 1024)
    js = jscene(n_views=2, width=W, height=H, n_verts=300, seed=1, raster_config=cfg_j)
    ts = make_synthetic_scene(n_views=2, width=W, height=H, n_verts=300, seed=1,
                              raster_config=cfg_t, device="cpu")
    assert ts.gt_state.capacity == js.gt_state.capacity == 1024
    np.testing.assert_allclose(ts.big_pose_verts.numpy(), np.asarray(js.big_pose_verts),
                               atol=1e-6)
    for bt, bj in zip(ts.batches, js.batches):
        np.testing.assert_allclose(bt.gt_image.numpy(), np.asarray(bj.gt_image),
                                   atol=RENDER_ATOL)
        np.testing.assert_allclose(bt.gt_normal.numpy(), np.asarray(bj.gt_normal),
                                   atol=RENDER_ATOL)
        np.testing.assert_array_equal(bt.bkgd_mask.numpy(), np.asarray(bj.bkgd_mask))
        np.testing.assert_array_equal(bt.bound_mask.numpy(), np.asarray(bj.bound_mask))
        assert float(bt.gt_image.max()) > 0.1
    np.testing.assert_allclose(ts.extent, js.extent, rtol=1e-5)


def assert_state_equal(got, want, atol=0.0):
    for f in want.params._fields:
        np.testing.assert_allclose(getattr(got.params, f).numpy(),
                                   np.asarray(getattr(want.params, f)), atol=atol, err_msg=f)
    for f in ("alive", "smpl_normal", "xyz_grad_accum", "denom", "max_radii2d"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def test_state_create_grow_compact_match_jax():
    rng = np.random.RandomState(2)
    pts = rng.randn(700, 3).astype(np.float32)
    cols = rng.rand(700, 3).astype(np.float32)
    nrm = rng.randn(700, 3).astype(np.float32)
    js = JG.create_from_pcd(pts, cols, nrm)
    ts = TG.create_from_pcd(pts, cols, nrm, device="cpu")
    assert_state_equal(ts, js, atol=1e-5)   # scales come from KNN distances
    ts = interop.gaussian_state(as_np(js), device="cpu")
    assert_state_equal(TG.grow_capacity(ts, 2048), JG.grow_capacity(js, 2048))
    alive = rng.rand(1024) > 0.5
    js2 = js._replace(alive=jnp.asarray(alive))
    ts2 = ts._replace(alive=torch.as_tensor(alive))
    for cap in (None, 700):
        assert_state_equal(TG.compact_state(ts2, cap), JG.compact_state(js2, cap))


def test_jax_ply_loads_in_port_and_back(setup, tmp_path):
    js = setup["jstate"]
    path = str(tmp_path / "jax.ply")
    jio.save_ply(js, path)
    assert_state_equal(tio.load_ply(path, device="cpu"), jio.load_ply(path))
    path2 = str(tmp_path / "port.ply")
    tio.save_ply(tio.load_ply(path, device="cpu"), path2)
    with open(path, "rb") as a, open(path2, "rb") as b:
        assert a.read() == b.read()


def test_interop_state_roundtrip(setup):
    js, ts = setup["jstate"], setup["tstate"]
    assert_state_equal(ts, js)
    assert ts.params.xyz.dtype == torch.float32 and ts.alive.dtype == torch.bool


def test_package_imports_no_jax():
    """Importing the port (and the repo root's bench_torch.py) loads neither
    jax nor mygauhuman_tpu, nor the image libraries cv2 and imageio, nor
    h5py (the readers import those inside the functions that use them): all
    are blocked in sys.modules first, so any import of them raises."""
    code = (
        "import sys\n"
        "blocked = ('jax', 'mygauhuman_tpu', 'cv2', 'imageio', 'h5py')\n"
        "for m in [m for m in sys.modules if m.split('.')[0] in blocked]:\n"
        "    del sys.modules[m]\n"
        "for m in blocked:\n"
        "    sys.modules[m] = None\n"
        "import mygauhuman_torch.render, mygauhuman_torch.data.synthetic\n"
        "import mygauhuman_torch.interop, mygauhuman_torch.models.io\n"
        "import mygauhuman_torch.cli.train, mygauhuman_torch.cli.render\n"
        "import mygauhuman_torch.cli.metrics, mygauhuman_torch.data.readers\n"
        "import mygauhuman_torch.data.scene, mygauhuman_torch.train.checkpoint\n"
        "import mygauhuman_torch.models.smplx, mygauhuman_torch.data.smc_reader\n"
        "import mygauhuman_torch.data.dna_rendering, mygauhuman_torch.data.colmap\n"
        "import mygauhuman_torch.data.colmap_loader, mygauhuman_torch.data.blender\n"
        "import mygauhuman_torch.utils.network_gui, mygauhuman_torch.cli.convert\n"
        "import mygauhuman_torch.cli.full_eval, mygauhuman_torch.render.graph\n"
        "import mygauhuman_torch.train.trainer, mygauhuman_torch.train.graph\n"
        "import bench_torch\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None\n"
        "       and m.split('.')[0] in blocked]\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_default_to_cuda():
    calls = [lambda: synthetic_smpl(50),
             lambda: big_pose_params(),
             lambda: make_camera(np.eye(3), np.zeros(3), 8, 8, fovx=1.0, fovy=1.0),
             lambda: make_synthetic_scene(n_views=1, width=16, height=16, n_verts=40)]
    for call in calls:
        if torch.cuda.is_available():
            leaves = call()
            first = leaves[0] if isinstance(leaves, tuple) else leaves
            if isinstance(first, dict):
                first = next(iter(first.values()))
            elif hasattr(first, "w2c"):
                first = first.w2c
            assert first.is_cuda
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
