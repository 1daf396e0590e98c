"""The port's tile-sharded branch-B step (mygauhuman_torch/parallel/train.py
::make_tile_sharded_pbr_step) against the JAX package.

make_tile_sharded_pbr_step runs on 4 gloo ranks, mesh (1, 2, 2), as
processes (`parallel/dryrun.py::launch`, a `file://` store under tmp_path)
that write their results for this process to compare, against the JAX
single-device branch-B step on tests/test_torch_pbr_train.py's setup (the
JAX package's own test holds its sharded step to that step), with that
file's tolerances: the metrics within 1e-4 relative, albedo within 1e-4 of
its largest value, roughness too but at KINK_ENTRIES entries (the BRDF
LUT's bilinear slope jumps at texel edges), none past 1e-3, the light
within 1e-4; the geometry and the MLPs bit-equal to the input (the port
freezes them, ROADMAP Queue 3). Each rank holds its capacity slice of the
state and of the occlusion colour (`parallel/mesh.py::StateSharding`) and
gathers its result whole before it writes it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygauhuman_tpu.config import OptimizationConfig as JOptCfg
from mygauhuman_tpu.data.synthetic import make_synthetic_scene as jscene
from mygauhuman_tpu.pbr.light import prefilter_weight_set as jprefilter
from mygauhuman_tpu.train import pbr as JPB
from mygauhuman_tpu.train import trainer as JT
from mygauhuman_torch import interop
from mygauhuman_torch.config import OptimizationConfig
from mygauhuman_torch.ops.rasterize import RasterizerConfig
from mygauhuman_torch.parallel.dryrun import launch
from mygauhuman_torch.parallel.train import stack_batches
from mygauhuman_torch.pbr.light import prefilter_weight_set
from mygauhuman_torch.train import optim as TO
from mygauhuman_torch.train import pbr as TPB
from test_torch_parallel_train import as_np, close_where, port_batches, t
from test_torch_pbr_train import KINK_ENTRIES, close_but, jinit_lbs, jinit_pose

torch.set_num_threads(1)
CPU = "cpu"


@pytest.fixture(scope="module")
def pbr_pair(tmp_path_factory):
    """The JAX single-device branch-B step and the port's sharded one on 4
    ranks, mesh (1, 2, 2), from the same state."""
    tmp_path = tmp_path_factory.mktemp("pbr")
    js = jscene(n_views=2, width=48, height=48, n_verts=150, capacity=256)
    jcfg = JOptCfg(pbr_iteration=0)
    rng = np.random.RandomState(0)
    mats = js.gt_state.params._replace(
        albedo=jnp.asarray(rng.randn(256, 3).astype(np.float32)),
        roughness=jnp.asarray(rng.randn(256, 1).astype(np.float32)))
    jts, jtx = JT.create_train_state(jcfg, js.gt_state._replace(params=mats),
                                     jinit_pose(jax.random.PRNGKey(0)),
                                     jinit_lbs(jax.random.PRNGKey(1)))
    jpbr, jltx = JPB.create_pbr_state(jcfg, base_res=16)
    knn3 = JPB.compute_knn3(jts.gauss)
    occ = np.random.RandomState(1).rand(256, 3).astype(np.float32)
    jstep = JPB.make_pbr_train_step(js.smpl_model, jtx, jltx, jcfg, js.raster_config,
                                    bg=jnp.zeros(3))
    jts2, jpbr2, jm = jstep(jts, jpbr, js.batches[0], knn3, jnp.asarray(occ), jprefilter(16), 0)

    cfg = OptimizationConfig(pbr_iteration=0)
    _, ltx = TPB.create_pbr_state(cfg, base_res=16, device=CPU)
    ts = interop.train_state(as_np(jts), CPU)
    torch.save(dict(smpl_model=interop.smpl_model(js.smpl_model, CPU), tx=TO.Adam(cfg),
                    light_tx=ltx, cfg=cfg, raster_config=RasterizerConfig(tile_capacity=512),
                    bg=torch.zeros(3), exchange_capacity=4096, ts=ts,
                    pbr_state=interop.pbr_state(as_np(jpbr), CPU),
                    batch=stack_batches(port_batches(js)[:1]), knn3=t(knn3).long(),
                    occ=t(occ)[None], prefilter_w=prefilter_weight_set(16, CPU)),
               tmp_path / "inputs.pt")
    res = launch("pbr_step", 4, tmp_path / "ranks", inputs=tmp_path / "inputs.pt",
                 mesh=(1, 2, 2), device=CPU)
    return ts, jts2, jpbr2, jm, res


def test_tile_sharded_pbr_step_matches_jax(pbr_pair):
    ts, jts2, jpbr2, jm, res = pbr_pair
    want = interop.train_state(as_np(jts2), CPU)
    want_pbr = interop.pbr_state(as_np(jpbr2), CPU)
    for r in res:
        for k in ("loss", "l1", "ssim", "brdf_tv", "entropy", "smooth", "lamb", "psnr"):
            np.testing.assert_allclose(float(r["metrics"][k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-8, err_msg=k)
        got = r["ts"]
        close_but(got.gauss.params.albedo, want.gauss.params.albedo, 0, "albedo")
        close_but(got.gauss.params.roughness, want.gauss.params.roughness, KINK_ENTRIES,
                  "roughness")
        close_where(r["pbr_state"].light["base"], want_pbr.light["base"].numpy(),
                    np.ones(want_pbr.light["base"].shape, bool), 1e-4, "light")
        assert float(r["pbr_state"].light["base"].min()) >= 0.0
        for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity"):
            assert torch.equal(getattr(got.gauss.params, f), getattr(ts.gauss.params, f)), f
        for a, b in zip(TO.tree_leaves((got.pose_refiner, got.lbs_offset)),
                        TO.tree_leaves((ts.pose_refiner, ts.lbs_offset))):
            assert torch.equal(a, b)
        assert not torch.equal(got.gauss.params.albedo, ts.gauss.params.albedo)
        assert torch.equal(got.gauss.params.albedo, res[0]["ts"].gauss.params.albedo)


def test_tile_sharded_pbr_step_keeps_capacity_slices(pbr_pair):
    """The material slices and their moments stay on their rank (capacity /
    4 rows of every per-Gaussian leaf after the step); nothing per-Gaussian
    is gathered inside the step but the smoothness term's alive, albedo and
    roughness (`knn_gather`): cap x 5 values, the slice's 64 x 4 floats
    and 64 bools from each rank."""
    *_, res = pbr_pair
    for r in res:
        assert {tuple(v) for v in r["rows"].values()} == {(64, 64)}, r["rows"]
        assert "opt_state/mu/gaussians/albedo" in r["rows"]
        assert "state_gather" not in r["kinds"], r["kinds"]
        assert r["knn_gather_bytes"] == 64 * (3 + 1) * 4 + 64
