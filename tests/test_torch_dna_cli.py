"""The port's entry points on a DNA-Rendering capture with the 55-joint
SMPL-X body, on the CPU (`--device cpu`), against the JAX package.

  * `cli.train -s <capture>_main.smc --smpl_type smplx` on
    tests/test_smplx_training.py's capture and SMPL-X npz: the 55-joint
    refiner trains, densify fires, eval, snapshot, PLY and the pose-keyed
    replay cache land on disk in the JAX CLI's layout, and the JAX package
    reads the PLY, the cache and the config;
  * the JAX `cli.render` and the port's on that directory, through the
    replay cache and through the deform branch: images within 2/255 per
    pixel (8-bit PNGs of float32 renders through two rasterizers, as
    tests/test_torch_cli.py holds the SMPL run) and PSNR within 0.05 dB;
  * `--start_checkpoint` resumes the SMPL-X run at the next iteration;
  * `--multichip --smpl_type smplx` on 2 gloo ranks trains as the
    single-process run does (the densify trajectory and the alive set).
"""
import os
import shutil

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from mygauhuman_tpu.cli.render import main as jax_render
from mygauhuman_tpu.config import Config as JConfig
from mygauhuman_tpu.models.io import load_ply as jax_load_ply
from mygauhuman_tpu.models.smplx import synthetic_smplx
from mygauhuman_tpu.train.checkpoint import load_eval_cache as jax_load_eval_cache
from mygauhuman_torch.cli.render import main as render_main
from mygauhuman_torch.cli.train import main as train_main
from mygauhuman_torch.parallel.dryrun import launch
from mygauhuman_torch.train.checkpoint import load_checkpoint
from test_smplx_training import export_smplx_npz, make_posed_smc

torch.set_num_threads(1)
ITERS = 12
DENSIFY = ["--densify_from_iter", "2", "--densify_until_iter", "11",
           "--densification_interval", "4", "--densify_grad_threshold", "1e-8"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("smplx_cli")
    smc = str(tmp / "actor7_main.smc")
    make_posed_smc(smc)
    npz = str(tmp / "SMPLX_NEUTRAL.npz")
    export_smplx_npz(synthetic_smplx(num_vertices=150), npz)
    out = str(tmp / "exp")
    body = ["-s", smc, "--smpl_type", "smplx", "--smpl_model_path", npz]
    result = train_main(body + DENSIFY + [
        "--iterations", str(ITERS), "--test_iterations", str(ITERS),
        "--save_iterations", str(ITERS), "--model_path", out, "--device", "cpu"])
    return dict(out=out, body=body, result=result, tmp=tmp)


def test_train_on_dna_capture_writes_the_jax_layout(trained):
    out, r = trained["out"], trained["result"]
    assert np.isfinite(r["final_loss"]) and np.isfinite(r["test_psnr"]) and r["test_psnr"] > 0
    assert (r["first_iteration"], r["last_iteration"]) == (1, ITERS)
    # densify fired: the cloud outgrew the 150-vertex init
    assert r["n_gaussians"] > 150 and [e["iteration"] for e in r["densify"]] == [4, 8]
    for name in (f"point_cloud_{ITERS}.ply", f"smpl_rot_{ITERS}.npz", "cfg_args.json",
                 "metrics.jsonl", f"chkpnt{ITERS}/state.pt", f"eval_{ITERS}/test/000.png"):
        assert os.path.exists(os.path.join(out, name)), name
    # the 55-joint MLPs: 54 x 3 pose inputs and outputs, 55 blend-weight logits
    ts = r["state"]
    assert tuple(ts.pose_refiner["layers"][0]["w"].shape) == (162, 128)
    assert tuple(ts.pose_refiner["layers"][-1]["w"].shape) == (128, 162)
    assert ts.lbs_offset["head"]["w"].shape[1] == 55
    back = load_checkpoint(out, ITERS, ts)
    for a, b in zip(back.gauss.params, ts.gauss.params):
        assert torch.equal(a, b)
    # the JAX package reads what the port wrote
    assert JConfig.load(os.path.join(out, "cfg_args.json")).optim.iterations == ITERS
    assert int(jax_load_ply(os.path.join(out, f"point_cloud_{ITERS}.ply")).num_alive) \
        == r["n_gaussians"]
    cache = jax_load_eval_cache(os.path.join(out, f"smpl_rot_{ITERS}.npz"))
    # the test split: the last camera at frame 0, keyed by its pose id
    assert sorted(cache) == ["0"]
    assert cache["0"]["transforms"].shape == (r["n_gaussians"], 3, 3)


@pytest.mark.parametrize("branch", ["replay", "deform"])
def test_both_render_clis_read_the_smplx_run(trained, tmp_path, branch):
    dirs = {}
    for who in ("jax", "port"):
        dirs[who] = str(tmp_path / who)
        shutil.copytree(trained["out"], dirs[who],
                        ignore=shutil.ignore_patterns("eval_*", "chkpnt*"))
    args = ["--iteration", str(ITERS)] + trained["body"] + (
        ["--use_replay_cache"] if branch == "replay" else [])
    jm = jax_render(["--model_path", dirs["jax"]] + args)
    tm = render_main(["--model_path", dirs["port"], "--device", "cpu"] + args)
    assert abs(tm["psnr"] - jm["psnr"]) <= 0.05
    name = f"renders_{ITERS}/00000.png"
    a = imageio.imread(os.path.join(dirs["jax"], name)).astype(int)
    b = imageio.imread(os.path.join(dirs["port"], name)).astype(int)
    assert a.shape == (16, 16, 3)
    assert np.abs(a - b).max() <= 2, np.abs(a - b).max()


def test_start_checkpoint_resumes_the_smplx_run(trained):
    out2 = str(trained["tmp"] / "resumed")
    r = train_main(trained["body"] + [
        "--iterations", str(ITERS + 3), "--test_iterations", str(ITERS + 3),
        "--save_iterations", str(ITERS + 3), "--model_path", out2, "--skip_galleries",
        "--densify_from_iter", "100", "--device", "cpu",
        "--start_checkpoint", os.path.join(trained["out"], f"chkpnt{ITERS}")])
    assert (r["first_iteration"], r["last_iteration"]) == (ITERS + 1, ITERS + 3)
    assert r["state"].step == ITERS + 3 and np.isfinite(r["final_loss"])
    assert r["n_gaussians"] == trained["result"]["n_gaussians"]


def test_multichip_smplx_on_two_ranks(trained):
    """`--multichip --smpl_type smplx` on 2 gloo ranks (processes, as
    torch.distributed.run starts them; mesh (1, 1, 2)): the run of the
    module's fixture, sharded. The densify events and the alive set are the
    single-process run's, the loss within 2e-3 relative (the JAX loop
    test's bound) and xyz within 5e-3; every rank ends with the same state,
    gathered from its half of the per-Gaussian bytes; only rank 0 writes the
    output directory."""
    out = trained["tmp"] / "multichip"
    torch.save(dict(argv=trained["body"] + DENSIFY + [
        "--iterations", str(ITERS), "--test_iterations", str(ITERS), "--save_iterations",
        str(ITERS), "--model_path", str(out), "--skip_galleries", "--multichip",
        "--device", "cpu"]), trained["tmp"] / "mc_inputs.pt")
    res = launch("cli", 2, trained["tmp"] / "mc_ranks", inputs=trained["tmp"] / "mc_inputs.pt",
                 device="cpu")
    want = trained["result"]
    for r in res:
        assert r["mesh"] == {"data": 1, "gauss": 1, "tiles": 2}
        assert r["densify"] == want["densify"] and r["n_gaussians"] == want["n_gaussians"]
        assert torch.equal(r["alive"], want["state"].gauss.alive)
        np.testing.assert_allclose(r["xyz"].numpy(), want["state"].gauss.params.xyz.numpy(),
                                   rtol=0, atol=5e-3)
        assert abs(r["final_loss"] - want["final_loss"]) < 2e-3 * abs(want["final_loss"])
        assert torch.equal(r["xyz"], res[0]["xyz"])
        assert 2 * r["state_bytes"]["end"]["rank"] == r["state_bytes"]["end"]["whole"] > 0
    assert res[0]["test_psnr"] > 0 and res[1]["test_psnr"] == 0.0   # rank 0 evaluates
    assert os.path.exists(out / f"point_cloud_{ITERS}.ply")
