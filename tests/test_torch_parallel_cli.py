"""`cli.train --multichip` (mygauhuman_torch/cli/train.py) through both
branches on 2 gloo ranks, as processes (`parallel/dryrun.py::launch`, a
`file://` store under tmp_path), against the single-process run of the same
command. Tolerances in the test's docstring.
"""
import numpy as np
import torch

from mygauhuman_torch.cli.train import main as train_main
from mygauhuman_torch.config import OptimizationConfig
from mygauhuman_torch.parallel.dryrun import launch
from mygauhuman_torch.train.checkpoint import load_checkpoint
from test_torch_parallel_train import CPU, close_where
from test_torch_pbr_train import KINK_ENTRIES

torch.set_num_threads(1)


def test_cli_multichip_trains_both_branches_on_two_ranks(tmp_path):
    """`cli.train --multichip` past `--pbr_iteration` on 2 gloo ranks (mesh
    (1, 1, 2)) against the single-process run of the same command: branch A
    for 4 iterations, the bake on every rank, branch B for 2 through the
    sharded PBR step. The alive set and the losses as the single-process
    run's (loss within 2e-3 relative, the JAX loop test's bound), the light
    and the materials within the branch-B loop bound 1e-3 of their largest
    values, but for KINK_ENTRIES roughness entries (roughness starts at 1,
    the BRDF LUT's edge, where a gradient near zero may take either sign
    from float rounding and Adam moves the entry a whole step, opacity_lr,
    either way), the geometry frozen in branch B (bit-equal to the run's own
    snapshot at iteration 4) and within 5e-3 of the single-process run's.
    Each rank gets its own --model_path: rank 0 writes the directory, rank 1
    leaves its own unmade. Each rank holds half the per-Gaussian state's
    bytes at the start and at the end (StateSharding; the returned state is
    gathered whole)."""
    argv = ["--synthetic", "--synthetic_size", "32", "--iterations", "6", "--pbr_iteration",
            "4", "--test_iterations", "6", "--save_iterations", "4", "6", "--skip_galleries",
            "--bake_cells", "16", "--bake_single_sweep", "--device", CPU]
    want = train_main(argv + ["--model_path", str(tmp_path / "single")])
    torch.save(dict(argv=argv + ["--multichip", "--model_path", str(tmp_path / "mc{rank}")]),
               tmp_path / "inputs.pt")
    res = launch("cli", 2, tmp_path / "ranks", inputs=tmp_path / "inputs.pt", device=CPU)
    wp = want["state"].gauss.params
    snap = load_checkpoint(str(tmp_path / "mc0"), 4, want["state"])
    for r in res:
        assert r["mesh"] == {"data": 1, "gauss": 1, "tiles": 2}
        assert r["pbr"]["iterations"] == 2 and r["last_iteration"] == 6
        for when in ("start", "end"):
            b = r["state_bytes"][when]
            assert b["capacity"] == want["capacity"] and 2 * b["rank"] == b["whole"] > 0
        assert torch.equal(r["alive"], want["state"].gauss.alive)
        assert abs(r["final_loss"] - want["final_loss"]) < 2e-3 * abs(want["final_loss"])
        assert torch.equal(r["xyz"], snap.gauss.params.xyz)
        np.testing.assert_allclose(r["xyz"].numpy(), wp.xyz.numpy(), rtol=0, atol=5e-3)
        for got, ref, name in ((r["light"], want["pbr_state"].light["base"], "light"),
                               (r["albedo"], wp.albedo, "albedo")):
            close_where(got, ref.numpy(), np.ones(ref.shape, bool), 1e-3, name)
        err = (r["roughness"] - wp.roughness).abs()
        assert int((err > 1e-3 * wp.roughness.abs().max()).sum()) <= KINK_ENTRIES
        assert float(err.max()) <= 2 * 2 * OptimizationConfig().opacity_lr    # 2 steps
        assert torch.equal(r["light"], res[0]["light"])
    assert not torch.equal(res[0]["albedo"], snap.gauss.params.albedo)
    assert res[0]["test_psnr"] > 0 and res[1]["test_psnr"] == 0.0     # rank 0 evaluates
    assert (tmp_path / "mc0" / "envmap_6.npy").exists()
    assert not (tmp_path / "mc1").exists()
