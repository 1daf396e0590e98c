"""The port's COLMAP conversion (mygauhuman_torch/cli/convert.py)
against the JAX package's, with tests/test_convert_cli.py's recording stub
in place of the external `colmap` binary.

  * the stage sequence and every command line, run by both packages on the
    same scene layout: equal, token for token (the scene path aside);
  * the sparse/ -> sparse/0 shuffle: the same files in the same places;
  * `--skip_matching`, a missing binary and the `main` entry point;
  * the images_2/4/8 pyramid: the same files, byte for byte (both write
    with cv2's INTER_AREA and half-up rounding).
"""
import os

import cv2
import numpy as np
import pytest

from mygauhuman_tpu.cli import convert as jconvert
from mygauhuman_torch.cli import convert as tconvert
from test_convert_cli import _make_stub_colmap


def _run_both(tmp_path, **kw):
    """Each package's run_colmap on its own copy of the scene layout, one
    stub log each; returns {who: (scene dir, [argv tokens per call])}."""
    out = {}
    for who, mod in (("jax", jconvert), ("port", tconvert)):
        root = tmp_path / who
        scene = root / "scene"
        (scene / "input").mkdir(parents=True)
        colmap, log = _make_stub_colmap(root)
        mod.run_colmap(str(scene), colmap=colmap, **kw)
        calls = [c.replace(str(scene), "<scene>").split()
                 for c in log.read_text().strip().splitlines()]
        out[who] = (scene, calls)
    return out


@pytest.mark.parametrize("kw", [dict(camera="OPENCV", use_gpu=False),
                                dict(camera="PINHOLE", use_gpu=True),
                                dict(skip_matching=True)],
                         ids=["opencv-cpu", "pinhole-gpu", "skip-matching"])
def test_command_lines_and_layout_match_jax(tmp_path, kw):
    res = _run_both(tmp_path, **kw)
    (jscene, jcalls), (tscene, tcalls) = res["jax"], res["port"]
    assert tcalls == jcalls
    stages = [c[0] for c in tcalls]
    want = ["image_undistorter"] if kw.get("skip_matching") else [
        "feature_extractor", "exhaustive_matcher", "mapper", "image_undistorter"]
    assert stages == want
    if "use_gpu" in kw:
        assert tcalls[0][tcalls[0].index("--SiftExtraction.use_gpu") + 1] == \
            ("1" if kw["use_gpu"] else "0")
    layout = {}
    for who, scene in (("jax", jscene), ("port", tscene)):
        layout[who] = sorted(os.path.relpath(os.path.join(d, f), scene)
                             for d, _, files in os.walk(scene) for f in files)
    assert layout["port"] == layout["jax"]
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tscene / "sparse" / "0" / name).exists()
        assert not (tscene / "sparse" / name).exists()


def test_missing_colmap_fails_clearly(tmp_path):
    with pytest.raises(SystemExit, match="not found"):
        tconvert.run_colmap(str(tmp_path), colmap="definitely-not-a-binary")


def test_main_with_resize(tmp_path):
    scene = tmp_path / "scene"
    (scene / "input").mkdir(parents=True)
    colmap, log = _make_stub_colmap(tmp_path)
    # the stub's undistorter makes images/; put a frame there for the pyramid
    (scene / "images").mkdir()
    cv2.imwrite(str(scene / "images" / "a.png"), np.full((20, 30, 3), 90, np.uint8))
    tconvert.main(["-s", str(scene), "--colmap_executable", colmap, "--no_gpu",
                   "--skip_matching", "--resize"])
    assert [c.split()[0] for c in log.read_text().strip().splitlines()] == ["image_undistorter"]
    for factor, shape in ((2, (10, 15, 3)), (4, (5, 8, 3)), (8, (3, 4, 3))):
        assert cv2.imread(str(scene / f"images_{factor}" / "a.png")).shape == shape


def test_image_pyramid_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    frames = {"frame.png": (rng.random((64, 48, 3)) * 255).astype(np.uint8),
              "odd.png": (rng.random((101, 13, 3)) * 255).astype(np.uint8),
              "gray.png": (rng.random((33, 17)) * 255).astype(np.uint8),
              "photo.jpg": (rng.random((40, 50, 3)) * 255).astype(np.uint8)}
    scenes = {}
    for who, mod in (("jax", jconvert), ("port", tconvert)):
        scene = tmp_path / who
        (scene / "images").mkdir(parents=True)
        for name, img in frames.items():
            cv2.imwrite(str(scene / "images" / name), img)
        (scene / "images" / "notes.txt").write_text("not an image")
        mod.build_image_pyramid(str(scene))
        scenes[who] = scene
    for factor in (2, 4, 8):
        names = sorted(os.listdir(scenes["jax"] / f"images_{factor}"))
        assert names == sorted(os.listdir(scenes["port"] / f"images_{factor}")) \
            == sorted(frames)
        for name in names:
            a = (scenes["jax"] / f"images_{factor}" / name).read_bytes()
            b = (scenes["port"] / f"images_{factor}" / name).read_bytes()
            assert a == b, (factor, name)
    assert cv2.imread(str(scenes["port"] / "images_2" / "odd.png")).shape == (51, 7, 3)
