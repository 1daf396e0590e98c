"""The port's entry points (mygauhuman_torch/cli/{train,render,metrics}.py)
against the JAX package's CLIs, on the CPU (`--device cpu`).

  * `cli.train` on the synthetic scene at 48^2 writes the JAX CLI's
    layout: PLY, replay cache, cfg_args.json, metrics.jsonl, galleries,
    and `chkpnt<it>` (the port's format); the JAX package reads the PLY,
    the cache and the config.
  * Both render CLIs, the JAX `cli.render` and the port's, read that
    directory with `--use_replay_cache`: images within 2/255 per pixel
    (8-bit PNGs of float32 renders through two rasterizers) and PSNR
    within 0.05 dB.
  * `--start_checkpoint` resumes at the next iteration; `cli.train` reads
    tests/test_data_readers.py's ZJU disk fixture; `--multichip` on one
    process (no launcher) is the single-device run, bit for bit;
    `--precompile` returns at once without training.
  * `cli.metrics` against the JAX `evaluate_dirs` on the same PNG
    directories: PSNR and SSIM within 1e-4 (float32, another order of the
    same sums). LPIPS: the two random backbones come from different PRNGs,
    so only a finite value is required there; with one weights npz loaded
    by both packages, within 3e-2 relative (the JAX trunk runs in bf16,
    the port's in float32, as tests/test_torch_train.py states).
"""
import json
import os
import pickle
import shutil

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from mygauhuman_tpu.cli.render import main as jax_render
from mygauhuman_tpu.config import Config as JConfig
from mygauhuman_tpu.eval.lpips import LPIPS as JLPIPS
from mygauhuman_tpu.eval.metrics import evaluate_dirs as jax_evaluate_dirs
from mygauhuman_tpu.eval.metrics import evaluate_images as jax_evaluate_images
from mygauhuman_tpu.models.io import load_ply as jax_load_ply
from mygauhuman_tpu.models.smpl import synthetic_smpl
from mygauhuman_tpu.train.checkpoint import load_eval_cache as jax_load_eval_cache
from mygauhuman_torch.cli.metrics import main as metrics_main
from mygauhuman_torch.cli.render import main as render_main
from mygauhuman_torch.cli.train import main as train_main
from mygauhuman_torch.eval.lpips import LPIPS
from mygauhuman_torch.eval.metrics import evaluate_images
from mygauhuman_torch.train import optim as TO
from mygauhuman_torch.train import trainer as TT
from mygauhuman_torch.train.checkpoint import load_checkpoint
from test_data_readers import make_zju_fixture

torch.set_num_threads(1)

SYNTH = ["--synthetic", "--synthetic_size", "48"]
ITERS = 8


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cli") / "exp")
    result = train_main(SYNTH + [
        "--iterations", str(ITERS), "--test_iterations", str(ITERS),
        "--save_iterations", str(ITERS), "--model_path", out, "--device", "cpu"])
    return out, result


def test_train_writes_the_jax_layout(trained):
    out, result = trained
    assert np.isfinite(result["final_loss"]) and result["test_psnr"] > 10
    assert (result["first_iteration"], result["last_iteration"]) == (1, ITERS)
    assert result["state"].step == ITERS and result["n_gaussians"] == 400
    for name in (f"point_cloud_{ITERS}.ply", f"smpl_rot_{ITERS}.npz", "cfg_args.json",
                 "metrics.jsonl", f"chkpnt{ITERS}/state.pt", f"eval_{ITERS}/test/000.png",
                 f"eval_{ITERS}/train/003.png"):
        assert os.path.exists(os.path.join(out, name)), name
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    test_rows = [r for r in rows if "test/psnr" in r]
    for k in ("l1", "psnr", "ssim", "lpips_rand"):
        assert f"test/{k}" in test_rows[-1] and f"train/{k}" in rows[-1]
    assert any("train/loss" in r for r in rows) and any("scene/n_gaussians" in r for r in rows)
    # the JAX package reads what the port wrote
    assert JConfig.load(os.path.join(out, "cfg_args.json")).optim.iterations == ITERS
    assert int(jax_load_ply(os.path.join(out, f"point_cloud_{ITERS}.ply")).num_alive) == 400
    cache = jax_load_eval_cache(os.path.join(out, f"smpl_rot_{ITERS}.npz"))
    # every synthetic view is in the test split, so every view is cached
    assert sorted(cache) == ["0", "1", "2", "3"]
    assert cache["0"]["transforms"].shape == (400, 3, 3)
    # the snapshot is the returned state, bit for bit
    back = load_checkpoint(out, ITERS, result["state"])
    for a, b in zip(back.gauss.params, result["state"].gauss.params):
        assert torch.equal(a, b)
    assert back.opt_state.count == result["state"].opt_state.count


def test_both_render_clis_read_the_port_run(trained, tmp_path):
    out, _ = trained
    dirs = {}
    for who in ("jax", "port"):
        dirs[who] = str(tmp_path / who)
        shutil.copytree(out, dirs[who], ignore=shutil.ignore_patterns("eval_*", "chkpnt*"))
    args = ["--iteration", str(ITERS), "--use_replay_cache"] + SYNTH
    jm = jax_render(["--model_path", dirs["jax"]] + args)
    tm = render_main(["--model_path", dirs["port"], "--device", "cpu"] + args)
    assert abs(tm["psnr"] - jm["psnr"]) <= 0.05
    for key in ("fps", "fps_wall", "fps_device", "ssim", "lpips_rand"):
        assert key in tm and np.isfinite(tm[key])
    with open(os.path.join(dirs["port"], f"renders_{ITERS}", "results.json")) as f:
        assert json.load(f)["psnr"] == tm["psnr"]
    for v in range(4):
        name = f"renders_{ITERS}/{v:05d}.png"
        a = imageio.imread(os.path.join(dirs["jax"], name)).astype(int)
        b = imageio.imread(os.path.join(dirs["port"], name)).astype(int)
        assert np.abs(a - b).max() <= 2, (name, np.abs(a - b).max())


def test_start_checkpoint_resume(trained, tmp_path):
    out, first = trained
    out2 = str(tmp_path / "resumed")
    r = train_main(SYNTH + ["--iterations", str(ITERS + 4), "--test_iterations",
                            str(ITERS + 4), "--save_iterations", str(ITERS + 4),
                            "--model_path", out2, "--skip_galleries", "--device", "cpu",
                            "--start_checkpoint", os.path.join(out, f"chkpnt{ITERS}")])
    assert (r["first_iteration"], r["last_iteration"]) == (ITERS + 1, ITERS + 4)
    assert r["state"].step == ITERS + 4
    assert r["state"].opt_state.count["xyz"] == first["state"].opt_state.count["xyz"] + 4
    assert np.isfinite(r["final_loss"]) and r["final_loss"] < first["final_loss"] * 1.5
    assert os.path.exists(os.path.join(out2, f"point_cloud_{ITERS + 4}.ply"))


def _smpl_pkl(path, n_verts):
    """A synthetic body model in the reference pkl layout
    (scene/gaussian_model.py:78-84 reads these keys)."""
    model = synthetic_smpl(num_vertices=n_verts)
    kintree = np.zeros((2, 24), np.int64)
    kintree[1] = np.arange(24)
    kintree[0] = np.asarray(model.parents)
    kintree[0, 0] = 2**32 - 1   # root sentinel, reference convention
    with open(path, "wb") as f:
        pickle.dump({"v_template": np.asarray(model.v_template),
                     "shapedirs": np.asarray(model.shapedirs),
                     "posedirs": np.asarray(model.posedirs).reshape(-1, 207),
                     "J_regressor": np.asarray(model.j_regressor),
                     "weights": np.asarray(model.weights),
                     "kintree_table": kintree, "f": np.asarray(model.faces)}, f)


def test_train_on_zju_disk_fixture(tmp_path, monkeypatch):
    root = str(tmp_path / "zju_mocap_refine" / "my_377")
    os.makedirs(root)
    make_zju_fixture(root)
    pkl = str(tmp_path / "SMPL_NEUTRAL.pkl")
    _smpl_pkl(pkl, 120)
    out = str(tmp_path / "exp")
    monkeypatch.chdir(tmp_path)      # the reader writes output/<exp>/points3d.ply
    r = train_main(["-s", root, "--smpl_model_path", pkl, "--iterations", "4",
                    "--test_iterations", "4", "--save_iterations", "4", "--model_path", out,
                    "--skip_galleries", "--device", "cpu"])
    assert np.isfinite(r["final_loss"]) and r["n_gaussians"] == 120
    for name in ("point_cloud_4.ply", "cfg_args.json", "chkpnt4/state.pt"):
        assert os.path.exists(os.path.join(out, name)), name
    # 17 test poses of view 3, keyed by pose id
    cache = jax_load_eval_cache(os.path.join(out, "smpl_rot_4.npz"))
    assert sorted(int(k) for k in cache) == list(range(17))


def test_multichip_on_one_process_is_the_single_device_run(trained, tmp_path):
    """--multichip without a launcher (one process) trains with the
    single-device step, as the JAX CLI does with one device: the same
    state and losses as the module's run, bit for bit."""
    r = train_main(SYNTH + [
        "--iterations", str(ITERS), "--test_iterations", str(ITERS),
        "--save_iterations", str(ITERS), "--model_path", str(tmp_path / "mc"), "--multichip",
        "--device", "cpu"])
    want = trained[1]
    assert r["mesh"] is None and r["final_loss"] == want["final_loss"]
    assert r["test_psnr"] == want["test_psnr"] and r["densify"] == want["densify"]
    for a, b in zip(TO.tree_leaves(TT.trainable_params(r["state"])),
                    TO.tree_leaves(TT.trainable_params(want["state"]))):
        assert torch.equal(a, b)
    assert torch.equal(r["state"].gauss.xyz_grad_accum, want["state"].gauss.xyz_grad_accum)


def test_precompile_returns_without_training(tmp_path):
    out = str(tmp_path / "pre")
    r = train_main(SYNTH + ["--model_path", out, "--precompile", "--scan_chunk", "4",
                            "--use_pallas", "--device", "cpu"])
    assert r["precompiled"] is True
    assert not os.path.exists(os.path.join(out, "point_cloud_1200.ply"))


def test_entry_points_default_to_cuda(tmp_path):
    calls = [lambda: train_main(SYNTH + ["--model_path", str(tmp_path / "a")]),
             lambda: render_main(["--model_path", str(tmp_path / "a")] + SYNTH),
             lambda: metrics_main(["-r", str(tmp_path), "-g", str(tmp_path)])]
    for call in calls:
        if torch.cuda.is_available():
            return
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def _png_dirs(tmp_path):
    r_dir, g_dir = str(tmp_path / "renders"), str(tmp_path / "gt")
    os.makedirs(r_dir)
    os.makedirs(g_dir)
    rng = np.random.RandomState(0)
    for i in range(3):
        gt = rng.rand(40, 36, 3)
        render = np.clip(gt + 0.05 * rng.randn(40, 36, 3), 0, 1)
        imageio.imwrite(os.path.join(g_dir, f"{i:05d}.png"), (gt * 255).astype(np.uint8))
        imageio.imwrite(os.path.join(r_dir, f"{i:05d}.png"), (render * 255).astype(np.uint8))
    return r_dir, g_dir


def test_metrics_cli_matches_jax_evaluate_dirs(tmp_path):
    r_dir, g_dir = _png_dirs(tmp_path)
    out = str(tmp_path / "results.json")
    got = metrics_main(["-r", r_dir, "-g", g_dir, "-o", out, "--device", "cpu"])
    want = jax_evaluate_dirs(r_dir, g_dir)
    for key in ("psnr", "ssim"):
        assert abs(got[key] - want[key]) <= 1e-4, key
        for name in want["per_image"]:
            assert abs(got["per_image"][name][key] - want["per_image"][name][key]) <= 1e-4
    assert np.isfinite(got["lpips_rand"]) and got["lpips_rand"] > 0
    with open(out) as f:
        assert json.load(f)["psnr"] == got["psnr"]


def test_lpips_matches_jax_with_shared_weights(tmp_path):
    """One weights npz, written as tests/test_eval_cli.py::TestLPIPSWeights
    writes it, loaded by both packages."""
    from mygauhuman_tpu.eval.lpips import _STAGE_CHANNELS, _VGG_PLAN, export_torch_weights

    rng = np.random.RandomState(0)
    vgg_state, cin = {}, 3
    for cid, (cout, _) in zip([0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28], _VGG_PLAN):
        vgg_state[f"features.{cid}.weight"] = rng.randn(cout, cin, 3, 3).astype(np.float32) * 0.05
        vgg_state[f"features.{cid}.bias"] = np.zeros(cout, np.float32)
        cin = cout
    lin_state = {f"lin{i}.model.1.weight": rng.rand(1, c, 1, 1).astype(np.float32)
                 for i, c in enumerate(_STAGE_CHANNELS)}
    path = str(tmp_path / "lpips.npz")
    export_torch_weights(path, vgg_state, lin_state)
    gts = [rng.rand(32, 32, 3).astype(np.float32) for _ in range(2)]
    renders = [np.clip(g + 0.1 * rng.randn(32, 32, 3), 0, 1).astype(np.float32) for g in gts]
    want = jax_evaluate_images(renders, gts, lpips_model=JLPIPS(weights_file=path))
    got = evaluate_images([torch.as_tensor(x) for x in renders],
                          [torch.as_tensor(x) for x in gts],
                          lpips_model=LPIPS(weights_file=path, device="cpu"))
    assert "lpips" in got and "lpips_rand" not in got
    assert abs(got["lpips"] - want["lpips"]) <= 3e-2 * abs(want["lpips"])
    assert abs(got["psnr"] - want["psnr"]) <= 1e-4

