"""The port's other scene formats against the JAX package's, on the JAX
tests' disk fixtures: the DNA-Rendering SMC reader
(data/smc_reader.py), the DNA-Rendering reader with the SMPL-X body
(data/dna_rendering.py), COLMAP models in text and binary
(data/colmap_loader.py, data/colmap.py) and Blender / NeRF-synthetic
scenes (data/blender.py), and `load_scene_info`'s dispatch to them.

Tolerances, each stated where it is used:
  * every SMCReader accessor: exact (the same arrays through the same
    code);
  * every SceneInfo field (images, masks, cameras, SMPL-X parameters and
    vertices, bounds, point cloud, normalisation): within 1e-6 (the SMPL-X
    vertices come from float32 LBS on both sides); strings and ints exact;
  * JPEG images: the port decodes them with cv2, the JAX readers with
    imageio; both are libjpeg-turbo builds, the pixels are held within
    one 8-bit level (1/255). PNG fixtures hold the rest exactly.
"""
import dataclasses
import json
import os
import struct

import jax
import numpy as np
import pytest
import torch

from mygauhuman_tpu.data import colmap as JC
from mygauhuman_tpu.data import colmap_loader as JCL
from mygauhuman_tpu.data import dna_rendering as JD
from mygauhuman_tpu.data import readers as JR
from mygauhuman_tpu.data.smc_reader import SMCReader as JSMC
from mygauhuman_tpu.models.smplx import synthetic_smplx
from mygauhuman_torch import interop
from mygauhuman_torch.data import colmap as TC
from mygauhuman_torch.data import colmap_loader as TCL
from mygauhuman_torch.data import dna_rendering as TD
from mygauhuman_torch.data import readers as TR
from mygauhuman_torch.data.smc_reader import SMCReader as TSMC
from test_data_readers import TestSMC
from test_smplx_training import make_posed_smc

torch.set_num_threads(1)
ATOL = 1e-6
JPEG_LEVEL = 1.0 / 255.0


def assert_value_close(got, want, name, atol=ATOL):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), name
        for k in want:
            assert_value_close(got[k], want[k], f"{name}.{k}", atol)
    elif isinstance(want, (np.ndarray, float, np.floating)):
        got = np.asarray(got)
        assert got.shape == np.shape(want), name
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), name
        for i, (a, b) in enumerate(zip(got, want)):
            assert_value_close(a, b, f"{name}[{i}]", atol)
    else:
        assert got == want, name


def assert_scene_close(t, j, image_atol=ATOL):
    assert len(t.train_cameras) == len(j.train_cameras) > 0
    assert len(t.test_cameras) == len(j.test_cameras)
    for tc, jc in zip(t.train_cameras + t.test_cameras, j.train_cameras + j.test_cameras):
        for f in dataclasses.fields(jc):
            assert_value_close(getattr(tc, f.name), getattr(jc, f.name), f.name,
                               image_atol if f.name == "image" else ATOL)
    for f in ("points", "colors", "normals"):
        assert_value_close(getattr(t.point_cloud, f), getattr(j.point_cloud, f), f)
    assert_value_close(t.nerf_normalization, j.nerf_normalization, "nerf_normalization")
    assert t.ply_path == j.ply_path


# ---- the SMC reader -------------------------------------------------------------

@pytest.fixture(scope="module")
def smc(tmp_path_factory):
    """tests/test_data_readers.py's SMC fixture (12 frames, 2 cameras), with
    frame 1 of camera 0 and its mask stored encoded (PNG bytes: the
    reader's cv2.imdecode path)."""
    import cv2
    import h5py

    path = str(tmp_path_factory.mktemp("smc") / "actor_annots.smc")
    TestSMC().make_smc(path, n_frames=12)
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
    mask = (rng.rand(32, 32, 3) > 0.5).astype(np.uint8) * 255
    with h5py.File(path, "a") as f:
        for key, arr in (("Camera_5mp/0/color/1", img), ("Mask/0/mask/1", mask)):
            del f[key]
            f.create_dataset(key, data=np.frombuffer(cv2.imencode(".png", arr)[1], np.uint8))
        f["Camera_5mp"].attrs["num_frame"] = 12
        f["Camera_5mp"].attrs["resolution"] = np.array([32, 32])
        f.create_group("Kinect").attrs["num_device"] = 1
    return path


SMC_CALLS = {
    "info": lambda r: (r.get_available_keys(), r.get_actor_info(), r.get_Camera_5mp_info(),
                       r.get_Camera_12mp_info(), r.get_Kinect_info()),
    "img_int": lambda r: r.get_img("Camera_5mp", 0, "color", 1),
    "img_str": lambda r: r.get_img("Camera_5mp", "1", "color", "3"),
    "img_list": lambda r: r.get_img("Camera_5mp", 0, "color", Frame_id=[1, 10, 2]),
    "img_all": lambda r: r.get_img("Camera_5mp", 1),
    "mask_int": lambda r: r.get_mask(0, Frame_id=1),
    "mask_all": lambda r: r.get_mask(1),
    "calibration": lambda r: r.get_Calibration(1),
    "calibration_all": lambda r: r.get_Calibration_all(),
    "smplx_int": lambda r: r.get_SMPLx(Frame_id=10),
    "smplx_list": lambda r: r.get_SMPLx(Frame_id=[0]),   # betas: one row
    "smplx_all": lambda r: r.get_SMPLx(),
    "counts": lambda r: (r.get_frame_count(), r.get_frame_count("Camera_5mp", 1),
                         r.get_camera_ids()),
}


@pytest.mark.parametrize("call", sorted(SMC_CALLS))
def test_smc_reader_accessors_match_jax(smc, call):
    """Exact: the same arrays through the same accessor code."""
    t, j = TSMC(smc), JSMC(smc)
    got, want = SMC_CALLS[call](t), SMC_CALLS[call](j)

    def walk(a, b, name):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), name
            for k in b:
                walk(a[k], b[k], f"{name}.{k}")
        elif isinstance(b, (list, tuple)):
            assert len(a) == len(b), name
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{name}[{i}]")
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name

    walk(got, want, call)
    t.release()
    j.release()
    assert t.smc is None and t.actor_info is None


def test_smc_reader_decodes_encoded_frames(smc):
    r = TSMC(smc)
    img = r.get_img("Camera_5mp", 0, "color", 1)
    mask = r.get_mask(0, Frame_id=1)
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8
    assert mask.shape == (32, 32) and set(np.unique(mask)) <= {0, 255}
    raw = r.get_img("Camera_5mp", 0, "color", 0)
    assert np.all(raw == 128)
    r.release()


# ---- DNA-Rendering --------------------------------------------------------------

@pytest.fixture(scope="module")
def dna(tmp_path_factory):
    """tests/test_smplx_training.py's posed capture (4 cameras, 3 frames,
    per-frame SMPL-X poses, betas, expression, transl) and its SMPL-X body."""
    tmp = tmp_path_factory.mktemp("dna")
    path = str(tmp / "actor7_main.smc")
    make_posed_smc(path, n_frames=3, n_cams=4)
    jmodel = synthetic_smplx(num_vertices=150)
    return dict(path=path, tmp=tmp, jmodel=jmodel,
                tmodel=interop.smpl_model(jax.tree.map(np.asarray, jmodel), "cpu"))


@pytest.mark.parametrize("eval_", [True, False])
def test_dna_reader_matches_jax(dna, eval_):
    t = TD.read_dna_rendering_info(dna["path"], False, "exp", eval_,
                                   smplx_model=dna["tmodel"])
    j = JD.read_dna_rendering_info(dna["path"], False, "exp", eval_,
                                   smplx_model=dna["jmodel"])
    assert_scene_close(t, j)
    # the split: cameras 0-2 train, the last camera (3) tests; 3 frames
    # train, frame 0 tests (the schedule's interval 5)
    n_train, n_test = (9, 1) if eval_ else (10, 0)
    assert (len(t.train_cameras), len(t.test_cameras)) == (n_train, n_test)
    c = t.train_cameras[0]
    assert c.image.shape == (16, 16, 3) and c.smpl_param["poses"].shape == (165,)
    assert c.smpl_param["shapes"].shape == (20,) and c.world_vertex.shape == (150, 3)


def test_dna_reader_cameras_white_background_match_jax(dna):
    for split in ("train", "test"):
        t = TD.read_cameras_dna_rendering(dna["path"], [1, 3], True, dna["tmodel"],
                                          split=split)
        j = JD.read_cameras_dna_rendering(dna["path"], [1, 3], True, dna["jmodel"],
                                          split=split)
        assert len(t) == len(j) == (6 if split == "train" else 2)
        for tc, jc in zip(t, j):
            for f in dataclasses.fields(jc):
                assert_value_close(getattr(tc, f.name), getattr(jc, f.name), f.name)


def test_dna_sibling_annotations_and_dispatch(tmp_path, monkeypatch):
    """The annotations file beside the main one supplies the masks; a dot in
    the directory name misses it (the reference quirk, kept), so the main
    file's masks are read; load_scene_info forwards a 55-joint model. The
    paths are relative, so that only these directory names hold dots."""
    import h5py

    monkeypatch.chdir(tmp_path)
    jmodel = synthetic_smplx(num_vertices=90)
    tmodel = interop.smpl_model(jax.tree.map(np.asarray, jmodel), "cpu")
    results = {}
    for dirname in ("plain", "v1.5"):
        os.mkdir(dirname)
        main = os.path.join(dirname, "subj_main.smc")
        make_posed_smc(main, n_frames=2, n_cams=2)
        annots = os.path.join(dirname, "subj_annotations_annots.smc")
        make_posed_smc(annots, n_frames=2, n_cams=2)
        with h5py.File(annots, "a") as f:       # half the mask off in the annotations
            for cid in range(2):
                for fr in range(2):
                    m = np.full((32, 32), 255, np.uint8)
                    m[:, :16] = 0
                    del f[f"Mask/{cid}/mask/{fr}"]
                    f.create_dataset(f"Mask/{cid}/mask/{fr}", data=m)
        t = TR.load_scene_info(main, False, "exp", True, smpl_model=tmodel)
        j = JR.load_scene_info(main, False, "exp", True, smpl_model=jmodel)
        assert_scene_close(t, j)
        results[dirname] = float(t.train_cameras[0].bkgd_mask.mean())
    assert results["plain"] == 0.5 and results["v1.5"] == 1.0


@pytest.mark.parametrize("word", ["render", "zju"])
def test_dna_dispatch_order_matches_jax(tmp_path, monkeypatch, word):
    """load_scene_info tests "zju", "monocap", "render" and "mixamo" before
    the `.smc` suffix (the reference order, kept): a capture whose path
    holds one of them goes to another reader, in both packages: the
    ZJU-layout readers, which look for an SMPL model under assets/ first."""
    monkeypatch.chdir(tmp_path)
    os.mkdir(f"{word}_take")
    src = f"{word}_take/subj_main.smc"
    make_posed_smc(src, n_frames=1, n_cams=2)
    for mod in (TR, JR):
        with pytest.raises(FileNotFoundError, match="No SMPL model found under assets"):
            mod.load_scene_info(src, False, "exp", True)


# ---- COLMAP ---------------------------------------------------------------------

def _colmap_model():
    rng = np.random.RandomState(3)
    cams = {1: ("PINHOLE", 40, 32, [36.0, 34.0, 20.5, 15.5]),
            2: ("SIMPLE_PINHOLE", 40, 32, [30.0, 20.0, 16.0])}
    images = []
    for i in range(9):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        images.append((i + 1, q, rng.randn(3), 1 + i % 2, f"im{i}"))
    pts = rng.randn(25, 3), rng.randint(0, 256, (25, 3)), rng.rand(25)
    return cams, images, pts


def _write_colmap(sparse, binary):
    cams, images, (xyz, rgb, err) = _colmap_model()
    os.makedirs(sparse)
    if binary:
        ids = {name: i for i, (name, _) in JCL.CAMERA_MODELS.items()}
        with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(cams)))
            for cid, (model, w, h, params) in cams.items():
                f.write(struct.pack("<iiQQ", cid, ids[model], w, h))
                f.write(struct.pack("<" + "d" * len(params), *params))
        with open(os.path.join(sparse, "images.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(images)))
            for iid, q, tv, cid, name in images:
                f.write(struct.pack("<i", iid) + struct.pack("<dddd", *q)
                        + struct.pack("<ddd", *tv) + struct.pack("<i", cid))
                f.write(name.encode() + b".png\x00")
                f.write(struct.pack("<Q", 2) + struct.pack("<ddqddq", 1.5, 2.5, 3, 4.0, 5.0, -1))
        with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(xyz)))
            for i in range(len(xyz)):
                f.write(struct.pack("<Q", i + 1) + struct.pack("<ddd", *xyz[i])
                        + struct.pack("<BBB", *rgb[i]) + struct.pack("<d", err[i])
                        + struct.pack("<Q", 2) + struct.pack("<iiii", 1, 0, 2, 1))
    else:
        with open(os.path.join(sparse, "cameras.txt"), "w") as f:
            f.write("# Camera list\n")
            for cid, (model, w, h, params) in cams.items():
                f.write(f"{cid} {model} {w} {h} " + " ".join(repr(p) for p in params) + "\n")
        with open(os.path.join(sparse, "images.txt"), "w") as f:
            f.write("# Image list\n")
            for iid, q, tv, cid, name in images:
                f.write(f"{iid} " + " ".join(repr(float(v)) for v in (*q, *tv))
                        + f" {cid} {name}.png\n1.5 2.5 3 4.0 5.0 -1\n")
        with open(os.path.join(sparse, "points3D.txt"), "w") as f:
            for i in range(len(xyz)):
                f.write(f"{i + 1} " + " ".join(repr(float(v)) for v in xyz[i])
                        + " " + " ".join(str(int(v)) for v in rgb[i])
                        + f" {float(err[i])!r} 1 0 2 1\n")


def _write_images(directory, names, ext, channels=3):
    import imageio.v2 as imageio

    os.makedirs(directory, exist_ok=True)
    rng = np.random.RandomState(4)
    for name in names:
        yy, xx = np.mgrid[0:32, 0:40]
        img = np.stack([(xx * 6) % 256, (yy * 8) % 256, (xx + yy) * 3 % 256]
                       + [rng.randint(0, 256, (32, 40))] * (channels - 3), axis=-1)
        img = (img + rng.randint(0, 20, img.shape)).clip(0, 255).astype(np.uint8)
        imageio.imwrite(os.path.join(directory, name + ext), img)


@pytest.mark.parametrize("binary", [False, True], ids=["text", "binary"])
def test_colmap_model_files_match_jax(tmp_path, binary):
    sparse = str(tmp_path / "sparse" / "0")
    _write_colmap(sparse, binary)
    t, j = TCL.read_model(sparse), JCL.read_model(sparse)
    for a, b in zip(t[:2], j[:2]):
        assert sorted(a) == sorted(b)
        for k in b:
            assert_value_close(dataclasses.asdict(a[k]), dataclasses.asdict(b[k]), str(k), 0.0)
    for a, b in zip(t[2], j[2]):
        np.testing.assert_array_equal(a, b)
    assert len(t[1]) == 9 and t[1][1].xys.shape == (2, 2)


@pytest.mark.parametrize("binary,eval_", [(False, True), (True, True), (True, False)],
                         ids=["text-eval", "binary-eval", "binary-all"])
def test_colmap_scene_matches_jax(tmp_path, binary, eval_):
    root = str(tmp_path / "garden")
    _write_colmap(os.path.join(root, "sparse", "0"), binary)
    _write_images(os.path.join(root, "images"), [f"im{i}" for i in range(9)], ".png")
    t = TR.load_scene_info(root, False, "exp", eval_)
    j = JR.load_scene_info(root, False, "exp", eval_)
    assert_scene_close(t, j)
    # llffhold 8: images 0 and 8 test with --eval
    assert len(t.test_cameras) == (2 if eval_ else 0)
    assert t.train_cameras[0].image.shape == (32, 40, 3)


def test_colmap_jpeg_images_within_a_level(tmp_path):
    """The port decodes JPEG with cv2, the JAX reader with imageio: within
    one 8-bit level."""
    root = str(tmp_path / "garden")
    _write_colmap(os.path.join(root, "sparse", "0"), False)
    names = [f"im{i}" for i in range(9)]
    _write_images(os.path.join(root, "images"), names, ".jpg")
    for f in os.listdir(os.path.join(root, "sparse", "0")):
        p = os.path.join(root, "sparse", "0", f)
        with open(p) as fh:
            txt = fh.read().replace(".png", ".jpg")
        with open(p, "w") as fh:
            fh.write(txt)
    t = TC.read_colmap_scene_info(root, eval=True)
    j = JC.read_colmap_scene_info(root, eval=True)
    assert_scene_close(t, j, image_atol=JPEG_LEVEL + 1e-7)


# ---- Blender --------------------------------------------------------------------

def _write_blender(root, channels, with_test):
    os.makedirs(root)
    rng = np.random.RandomState(6)
    for split, n in (("train", 3), ("test", 2 if with_test else 0)):
        frames = []
        for i in range(n):
            c2w = np.eye(4)
            a = rng.rand() * 2 * np.pi
            c2w[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
            c2w[:3, 3] = c2w[:3, :3] @ np.array([0.0, 0.0, 4.0])
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
        if n:
            with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
                json.dump({"camera_angle_x": 0.69, "frames": frames}, f)
            _write_images(os.path.join(root, split), [f"r_{i}" for i in range(n)], ".png",
                          channels)


@pytest.mark.parametrize("channels,white,eval_,with_test", [
    (4, False, True, True), (4, True, True, True), (3, False, False, True),
    (4, True, True, False)], ids=["rgba", "rgba-white", "rgb-all", "no-test-split"])
def test_blender_scene_matches_jax(tmp_path, channels, white, eval_, with_test):
    root = str(tmp_path / "lego")
    _write_blender(root, channels, with_test)
    t = TR.load_scene_info(root, white, "exp", eval_)
    j = JR.load_scene_info(root, white, "exp", eval_)
    assert_scene_close(t, j)
    assert len(t.test_cameras) == (2 if eval_ and with_test else 0)
    assert t.point_cloud.points.shape == (100_000, 3)
    assert t.train_cameras[0].image.shape == (32, 40, 3)


def test_unknown_source_raises(tmp_path):
    with pytest.raises(ValueError, match="Could not recognize"):
        TR.load_scene_info(str(tmp_path))
