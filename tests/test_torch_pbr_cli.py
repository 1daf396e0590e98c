"""The port's entry points past `--pbr_iteration` and with `--relight`
(mygauhuman_torch/cli/{train,render}.py) against the JAX package's
`cli.render --relight`, on the CPU (`--device cpu`).

`cli.train` runs branch A then branch B on the 400-vertex synthetic scene
at 48^2 (capacity 1,024), with one 24-cell bake sweep per camera
(`--bake_cells 24 --bake_single_sweep`, whose out-of-budget Gaussians are
counted); the full-coverage bake is tests/test_torch_occlusion.py's and
tests/test_torch_pbr_train.py's. Both render CLIs then relight the port's
directory with its `envmap_<it>.npy`: images and the relit ground truth
within 2/255 per pixel (8-bit PNGs of float32 renders through two
rasterizers), PSNR within 0.05 dB.
"""
import os
import shutil

import imageio.v2 as imageio
import numpy as np
import torch

from mygauhuman_tpu.cli.render import main as jax_render
from mygauhuman_torch.cli.render import main as render_main
from mygauhuman_torch.cli.train import main as train_main
from mygauhuman_torch.train.checkpoint import load_checkpoint

torch.set_num_threads(1)
CPU = "cpu"


def test_cli_train_branch_b_and_both_relight_clis(tmp_path):
    """cli.train A -> B on the port, then both packages' cli.render --relight
    on its directory with its envmap_<it>.npy."""
    out = str(tmp_path / "exp")
    synth = ["--synthetic", "--synthetic_size", "48"]
    r = train_main(synth + ["--iterations", "6", "--pbr_iteration", "4", "--test_iterations",
                            "6", "--save_iterations", "6", "--model_path", out, "--device", CPU,
                            "--skip_galleries", "--bake_cells", "24", "--bake_single_sweep",
                            "--occ_budget_mb", "8"])
    assert (r["first_iteration"], r["last_iteration"]) == (1, 6)
    assert np.isfinite(r["final_loss"]) and r["pbr"]["iterations"] == 2
    assert r["pbr"]["bake_out_of_budget"] > 0     # one 24-cell sweep leaves cells out
    assert float(r["pbr_state"].light["base"].min()) >= 0.0
    env = np.load(os.path.join(out, "envmap_6.npy"))
    assert env.shape == (64, 128, 3) and np.isfinite(env).all()
    back_ts, back_pbr = load_checkpoint(out, 6, (r["state"], r["pbr_state"]))
    assert torch.equal(back_pbr.light["base"], r["pbr_state"].light["base"])
    assert torch.equal(back_ts.gauss.params.albedo, r["state"].gauss.params.albedo)

    dirs = {}
    for who in ("jax", "port"):
        dirs[who] = str(tmp_path / who)
        shutil.copytree(out, dirs[who], ignore=shutil.ignore_patterns("eval_*", "chkpnt*"))
    args = ["--iteration", "6", "--use_replay_cache"] + synth
    jm = jax_render(["--model_path", dirs["jax"], "--relight",
                     os.path.join(dirs["jax"], "envmap_6.npy")] + args)
    tm = render_main(["--model_path", dirs["port"], "--device", CPU, "--relight",
                      os.path.join(dirs["port"], "envmap_6.npy")] + args)
    assert tm["relight_oracle"] is True and jm["relight_oracle"] is True
    for key in ("psnr", "psnr_drift"):
        assert abs(tm[key] - jm[key]) <= 0.05, key
    for v in range(4):
        for name in (f"{v:05d}.png", f"relight_gt_{v:05d}.png"):
            a = imageio.imread(os.path.join(dirs["jax"], "renders_6", name)).astype(int)
            b = imageio.imread(os.path.join(dirs["port"], "renders_6", name)).astype(int)
            assert np.abs(a - b).max() <= 2, (name, np.abs(a - b).max())
