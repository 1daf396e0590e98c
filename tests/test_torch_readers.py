"""The port's dataset readers, Scene and native loader
(mygauhuman_torch/data/{readers,scene,native_loader}.py) against the JAX
package's, on tests/test_data_readers.py's disk fixtures (ZJU-MoCap-refine,
MonoCap) and tests/test_native_loader.py's images.

Tolerances, each stated where it is used:
  * every CameraInfo field read from disk (images, masks, normals,
    cameras, SMPL parameters and vertices, bounds) exact;
  * what the big-pose SMPL evaluation gives (the big-pose vertices, their
    bound and normals, the point cloud): 1e-5 absolute (float32 SMPL chain,
    another order of the same sums);
  * camera_info_to_batch tensors: 1e-6 absolute against the JAX TrainBatch;
  * the native loader: bit-equal.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from mygauhuman_tpu.data import native_loader as JN
from mygauhuman_tpu.data import readers as JR
from mygauhuman_tpu.data.scene import Scene as JScene
from mygauhuman_tpu.models.smpl import synthetic_smpl
from mygauhuman_torch import interop
from mygauhuman_torch.data import native_loader as TN
from mygauhuman_torch.data import readers as TR
from mygauhuman_torch.data.scene import Scene as TScene
from test_data_readers import TestMonoCap, make_zju_fixture
from test_native_loader import images  # noqa: F401  (the fixture)

torch.set_num_threads(1)

#: fields the big-pose SMPL evaluation computes (1e-5); the rest are exact
SMPL_DERIVED = {"big_pose_world_vertex", "big_pose_world_bound", "smpl_normal"}


def _read(reader, root, model, tmp_path):
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        return reader(root, False, "test_exp", True, smpl_model=model)
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def zju(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zju")
    root = str(tmp / "my_zju_377")
    os.makedirs(root)
    make_zju_fixture(root)
    jmodel = synthetic_smpl(num_vertices=120)
    tmodel = interop.smpl_model(jax.tree.map(np.asarray, jmodel), "cpu")
    return dict(root=root, tmp=tmp, jmodel=jmodel, tmodel=tmodel,
                j=_read(JR.read_zju_mocap_refine_info, root, jmodel, tmp),
                t=_read(TR.read_zju_mocap_refine_info, root, tmodel, tmp))


def _assert_value_equal(got, want, name, derived=False):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), name
        for k in want:
            _assert_value_equal(got[k], want[k], f"{name}.{k}", derived)
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape, name
        if derived:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
        else:
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        assert got == want, name


def _assert_scene_info_equal(t, j):
    assert len(t.train_cameras) == len(j.train_cameras)
    assert len(t.test_cameras) == len(j.test_cameras)
    for tc, jc in zip(t.train_cameras + t.test_cameras, j.train_cameras + j.test_cameras):
        for f in dataclasses.fields(jc):
            _assert_value_equal(getattr(tc, f.name), getattr(jc, f.name), f.name,
                                derived=f.name in SMPL_DERIVED)
    for f in ("points", "colors", "normals"):
        np.testing.assert_allclose(getattr(t.point_cloud, f), getattr(j.point_cloud, f),
                                   rtol=0, atol=1e-5, err_msg=f)
    _assert_value_equal(t.nerf_normalization, j.nerf_normalization, "nerf_normalization")
    assert t.ply_path == j.ply_path


def test_zju_reader_matches_jax(zju):
    assert len(zju["t"].train_cameras) == 50 * 4 and len(zju["t"].test_cameras) == 17
    _assert_scene_info_equal(zju["t"], zju["j"])


def test_monocap_reader_matches_jax(tmp_path):
    TestMonoCap().test_read_scene(tmp_path)      # writes the fixture, runs the JAX reader
    root = str(tmp_path / "monocap_lan")
    jmodel = synthetic_smpl(num_vertices=100)
    tmodel = interop.smpl_model(jax.tree.map(np.asarray, jmodel), "cpu")
    _assert_scene_info_equal(_read(TR.read_monocap_info, root, tmodel, tmp_path),
                             _read(JR.read_monocap_info, root, jmodel, tmp_path))


def test_camera_info_to_batch_matches_jax(zju):
    for jc, tc in ((zju["j"].train_cameras[5], zju["t"].train_cameras[5]),
                   (zju["j"].test_cameras[3], zju["t"].test_cameras[3])):
        jb = JR.camera_info_to_batch(jc)
        tb = TR.camera_info_to_batch(tc, device="cpu")
        jl = jax.tree_util.tree_leaves_with_path(jb)
        for path, want in jl:
            node = tb
            for key in path:
                node = (node[key.key] if isinstance(key, jax.tree_util.DictKey)
                        else getattr(node, key.name))
            got = node.cpu().numpy() if isinstance(node, torch.Tensor) else node
            np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6,
                                       err_msg=jax.tree_util.keystr(path))
        assert (tb.camera.width, tb.camera.height) == (jb.camera.width, jb.camera.height)


def test_scene_matches_jax(zju, tmp_path):
    cwd = os.getcwd()
    os.chdir(zju["tmp"])
    try:
        js = JScene(zju["root"], "t", smpl_model=zju["jmodel"], shuffle=True)
        ts = TScene(zju["root"], "t", smpl_model=zju["tmodel"], shuffle=True, device="cpu")
    finally:
        os.chdir(cwd)
    assert [c.image_name for c in ts.get_train_cameras()] == \
        [c.image_name for c in js.get_train_cameras()]
    assert [c.uid for c in ts.get_train_cameras()] == [c.uid for c in js.get_train_cameras()]
    assert ts.cameras_extent == js.cameras_extent
    np.testing.assert_array_equal(ts.get_canonical_rays(), js.get_canonical_rays())
    jg, tg = js.gaussians, ts.gaussians
    assert tg.capacity == jg.capacity and int(tg.num_alive) == int(jg.num_alive) == 120
    for f in jg.params._fields:
        np.testing.assert_allclose(getattr(tg.params, f).numpy(),
                                   np.asarray(getattr(jg.params, f)), rtol=0, atol=1e-5,
                                   err_msg=f)
    assert len(ts.test_batches()) == 17
    tp, jp = ts.save(str(tmp_path / "t"), 7), js.save(str(tmp_path / "j"), 7)
    assert os.path.basename(tp) == os.path.basename(jp) == "point_cloud_7.ply"


def test_orbit_cameras_match_jax(zju):
    jo = JR.orbit_camera_infos(zju["j"].train_cameras[0], n_views=6)
    to = TR.orbit_camera_infos(zju["t"].train_cameras[0], n_views=6)
    for a, b in zip(to, jo):
        for f in ("R", "T", "K", "FovX", "FovY", "image_name", "pose_id"):
            _assert_value_equal(getattr(a, f), getattr(b, f), f)


def test_native_loader_matches_jax_binding(images):  # noqa: F811
    assert TN.native_available() and JN.native_available()
    assert TN._SO != JN._SO
    for key in ("png", "gray"):
        p, _ = images[key]
        for half in (False, True):
            np.testing.assert_array_equal(TN.decode_image(p, half), JN.decode_image(p, half))
    paths = [images[k][0] for k in ("png", "jpg", "gray")] * 3
    with TN.NativeImageLoader(workers=3) as tl, JN.NativeImageLoader(workers=3) as jl:
        for a, b in zip(tl.load_all(paths), jl.load_all(paths)):
            np.testing.assert_array_equal(a, b)
