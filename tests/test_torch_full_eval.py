"""The port's batch entry point (mygauhuman_torch/cli/full_eval.py) against the
JAX package's, on a DNA-Rendering capture with the SMPL-X body
(tests/test_smplx_training.py's fixture), on the CPU (`--device cpu`).

  * the port trains and renders the scene (the `.smc` source makes both
    CLIs load the SMPL-X npz); the JAX `full_eval`, with --skip_training,
    renders the same directory: both summaries hold the same scene and the same metric keys,
    PSNR within 0.05 dB (two rasterizers in float32;
    tests/test_torch_cli.py's bound);
  * `full_eval.json` on disk equals the returned summary;
  * --skip_training renders a trained directory again, --skip_rendering
    leaves an empty summary.
"""
import json
import os

import numpy as np
import pytest
import torch

from mygauhuman_tpu.cli.full_eval import main as jax_full_eval
from mygauhuman_tpu.models.smplx import synthetic_smplx
from mygauhuman_torch.cli.full_eval import main as full_eval_main
from test_smplx_training import export_smplx_npz, make_posed_smc

torch.set_num_threads(1)
NAME = "subject_main.smc"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("full_eval")
    smc = str(tmp / NAME)
    make_posed_smc(smc, n_frames=2, n_cams=3)
    npz = str(tmp / "SMPLX_NEUTRAL.npz")
    export_smplx_npz(synthetic_smplx(num_vertices=100), npz)
    out_root = str(tmp / "out")
    args = ["--scenes", smc, "--output_root", out_root, "--iterations", "3",
            "--smpl_model_path", npz]
    got = full_eval_main(args + ["--device", "cpu"])
    return dict(args=args, out_root=out_root, got=got)


def test_full_eval_summary_matches_jax(run):
    got = run["got"]
    with open(os.path.join(run["out_root"], "full_eval.json")) as f:
        assert json.load(f) == got
    assert os.path.exists(os.path.join(run["out_root"], NAME, "point_cloud_3.ply"))
    want = jax_full_eval(run["args"] + ["--skip_training"])
    assert sorted(got) == sorted(want) == [NAME]
    g, w = got[NAME], want[NAME]
    for key in ("psnr", "ssim", "lpips_rand", "fps", "fps_wall", "fps_device"):
        assert key in g and key in w and np.isfinite(g[key]), key
    assert set(w) <= set(g) and "renders" not in g
    assert g["psnr"] > 0 and abs(g["psnr"] - w["psnr"]) <= 0.05


def test_full_eval_skip_flags(run):
    body = ["--device", "cpu"]
    again = full_eval_main(run["args"] + body + ["--skip_training"])
    assert sorted(again) == [NAME] and again[NAME]["psnr"] == run["got"][NAME]["psnr"]
    assert full_eval_main(run["args"] + body + ["--skip_training", "--skip_rendering"]) == {}
