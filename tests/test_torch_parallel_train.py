"""The port's tile-sharded train step (mygauhuman_torch/parallel/train.py)
against the JAX package's, and its train loop against the port's
single-device loop: tests/test_determinism_multichip.py's cases.

The JAX step runs on a (2, 1, 2) mesh of the 8 virtual CPU devices of
tests/conftest.py, its kernels in interpret mode; the port's ranks run as
processes over gloo on the same mesh (`parallel/dryrun.py::launch`, a
`file://` store under tmp_path), from the JAX scene carried across through
`interop`, and write their results for this process to compare. Each rank
holds its capacity slice of the state (`parallel/mesh.py::StateSharding`);
a rank gathers its results whole before it writes them.

Tolerances:
  * the loss within 1e-4 relative and each Adam first moment (0.1 x the
    gradient after one step) within 1e-3 of its leaf's largest value, as
    tests/test_torch_train.py holds the single-device step. The JAX step's
    gradients are n_data times those of the mean loss it reports (its
    pmean over "data" transposes to a sum under check_vma=False; ROADMAP
    Queue 3), so its moments are held over n_data = 2; Adam's update does
    not see a common factor;
  * the updated parameters: Adam's first update is lr g / |g|, so an entry
    whose gradient is below 1e-3 of its leaf's largest may take the other
    sign in float32; the others within 1e-3 of the largest update;
  * the densify statistics: the JAX step multiplies dL/dmeans2D by
    n_shards B_total where the all_gather's backward has already summed the
    n_shards loss copies back to one, and its dL/dmeans2D carries the
    n_data factor above, so its xyz_grad_accum is n_shards n_data times the
    single-device one (ROADMAP Queue 3); the port's (the single-device
    scale) is held to the JAX one over n_shards n_data = 4 within 1e-3, and
    the visible counts and radii exactly;
  * the loop: the densify events equal, `alive` equal, xyz within 5e-3 and
    the loss within 2e-3 relative (the JAX loop test's criteria);
  * the sharded state: each rank's per-Gaussian leaves (parameters, both
    moments, densify statistics) hold capacity / n_raster rows, and gathered
    they equal the whole-state update on the gathered gradients bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygauhuman_tpu.config import OptimizationConfig as JOptCfg
from mygauhuman_tpu.data.synthetic import make_synthetic_scene as jscene
from mygauhuman_tpu.models.mlps import init_lbs_offset as jinit_lbs
from mygauhuman_tpu.models.mlps import init_pose_refiner as jinit_pose
from mygauhuman_tpu.ops.rasterize import RasterizerConfig as JRasterizerConfig
from mygauhuman_tpu.parallel.train import make_tile_sharded_train_step as jax_tile_step
from mygauhuman_tpu.parallel.train import stack_batches as jax_stack
from mygauhuman_tpu.train import trainer as JT
from mygauhuman_torch import interop
from mygauhuman_torch.config import OptimizationConfig
from mygauhuman_torch.data.camera import Camera
from mygauhuman_torch.data.synthetic import make_synthetic_scene
from mygauhuman_torch.ops.rasterize import RasterizerConfig
from mygauhuman_torch.parallel.dryrun import launch
from mygauhuman_torch.parallel.train import stack_batches
from mygauhuman_torch.render import FrameInputs
from mygauhuman_torch.train import optim as TO
from mygauhuman_torch.train import trainer as TT

torch.set_num_threads(1)
CPU = "cpu"
JRC = JRasterizerConfig(tile_capacity=128, max_tiles_per_gaussian=8, pallas_interpret=True)
RC = RasterizerConfig(tile_capacity=128, max_tiles_per_gaussian=8)


def t(a):
    return torch.as_tensor(np.array(a))


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def port_batches(js):
    """The JAX scene's batches as the port's (the same numbers)."""
    out = []
    for jb in js.batches:
        c = jb.camera
        cam = Camera(w2c=t(c.w2c), full_proj=t(c.full_proj), cam_center=t(c.cam_center),
                     tan_fovx=c.tan_fovx, tan_fovy=c.tan_fovy, width=c.width, height=c.height)
        frame = FrameInputs(smpl_param=interop.tensor_tree(as_np(jb.frame.smpl_param), CPU),
                            big_pose_param=interop.tensor_tree(as_np(jb.frame.big_pose_param), CPU),
                            big_pose_verts=t(jb.frame.big_pose_verts))
        out.append(TT.TrainBatch(camera=cam, frame=frame, gt_image=t(jb.gt_image),
                                 gt_normal=t(jb.gt_normal), bkgd_mask=t(jb.bkgd_mask),
                                 bound_mask=t(jb.bound_mask)))
    return out


def scene_pair(cfg_kw=None, raster=JRC, **scene_kw):
    """A JAX synthetic scene, its fresh JAX TrainState, and the same in the
    port (interop: the same numbers)."""
    js = jscene(raster_config=raster, **scene_kw)
    jcfg = JOptCfg(**(cfg_kw or {}))
    jts, jtx = JT.create_train_state(jcfg, js.init_state, jinit_pose(jax.random.PRNGKey(0)),
                                     jinit_lbs(jax.random.PRNGKey(1)))
    cfg = OptimizationConfig(**(cfg_kw or {}))
    port = dict(smpl_model=interop.smpl_model(js.smpl_model, CPU), tx=TO.Adam(cfg), cfg=cfg,
                ts=interop.train_state(as_np(jts), CPU), batches=port_batches(js),
                bg=torch.zeros(3))
    return js, jcfg, jts, jtx, port


def close_where(got, want, mask, rel, msg):
    """Within rel of the largest |want| where mask holds."""
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want)
    atol = rel * float(np.abs(want).max(initial=0.0)) + 1e-12
    assert float(err[mask].max(initial=0.0)) <= atol, (msg, float(err[mask].max()) / atol)


def jax_step_case(tmp):
    """One tile-sharded JAX step on the (2, 1, 2) mesh, two views (one per
    data rank), and the port's inputs for the same step written to
    tmp/inputs.pt: (JAX state before, JAX state after in the port's trees,
    JAX metrics, the port's inputs, their path)."""
    js, jcfg, jts, jtx, port = scene_pair(raster=JRC._replace(pallas_interpret=False,
                                                              use_pallas=False),
                                          n_views=2, width=64, height=64, n_verts=100,
                                          capacity=256)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 1, 2),
                             ("data", "gauss", "tiles"))
    jstep = jax_tile_step(js.smpl_model, jtx, jcfg, JRC, bg=jnp.zeros(3), mesh=mesh,
                          exchange_capacity=512)
    jts1, jm = jstep(jts, jax_stack(js.batches[:2]), 0)
    torch.save(dict(port, raster_config=RC, exchange_capacity=512,
                    batch=stack_batches(port["batches"][:2])), tmp / "inputs.pt")
    return jts, interop.train_state(as_np(jts1), CPU), jm, port, tmp / "inputs.pt"


def assert_step_matches_jax(r, want, jm, port):
    """A rank's result of the train_step case against the JAX step (the
    module docstring's tolerances)."""
    assert r["mesh"] == {"data": 2, "gauss": 1, "tiles": 2}
    np.testing.assert_allclose(float(r["m1"]["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(r["loss"]), float(jm["loss"]), rtol=1e-4)
    got = r["ts1"]
    start = TT.trainable_params(port["ts"])
    for i, (gm, wm, p0, gp, wp) in enumerate(zip(
            *(TO.tree_leaves(x) for x in (got.opt_state.mu, want.opt_state.mu, start,
                                          TT.trainable_params(got),
                                          TT.trainable_params(want))))):
        wm, p0 = wm.numpy(), p0.numpy()
        close_where(gm, wm / 2, np.ones(wm.shape, bool), 1e-3, f"first moment {i}")
        big = np.abs(wm) >= 1e-3 * np.abs(wm).max(initial=0.0)
        close_where(gp.numpy() - p0, wp.numpy() - p0, big, 1e-3, f"update {i}")
    assert float(want.opt_state.mu.gaussians.xyz.abs().max()) > 0
    # the densify statistics: the single-device scale (the JAX step's over
    # n_shards n_data = 4)
    close_where(got.gauss.xyz_grad_accum, want.gauss.xyz_grad_accum.numpy() / 4,
                np.ones(256, bool), 1e-3, "xyz_grad_accum")
    assert torch.equal(got.gauss.denom, want.gauss.denom)
    assert torch.equal(got.gauss.max_radii2d, want.gauss.max_radii2d)
    assert float(want.gauss.denom.sum()) > 0


@pytest.fixture(scope="module")
def step_pair(tmp_path_factory):
    """The JAX step and the port's on the same (2, 1, 2) mesh; the port's
    step twice."""
    tmp = tmp_path_factory.mktemp("step")
    jts, want, jm, port, inputs = jax_step_case(tmp)
    res = launch("train_step", 4, tmp / "ranks", inputs=inputs, mesh=(2, 1, 2), device=CPU)
    return jts, want, jm, port, res


def test_tile_sharded_step_matches_jax(step_pair):
    jts, want, jm, port, res = step_pair
    assert_step_matches_jax(res[0], want, jm, port)


def test_tile_sharded_step_twice_same_bits_on_every_rank(step_pair):
    """The same step twice from one state: the same bits (deterministic
    exchange, fixed-order sums over ranks and Gaussians), and every rank
    gathers the same whole state."""
    *_, res = step_pair
    for r in res:
        for a, b, c in zip(TO.tree_leaves(TT.trainable_params(r["ts1"])),
                           TO.tree_leaves(TT.trainable_params(r["ts2"])),
                           TO.tree_leaves(TT.trainable_params(res[0]["ts1"]))):
            assert torch.equal(a, b) and torch.equal(a, c)
        assert torch.equal(r["ts1"].gauss.xyz_grad_accum, r["ts2"].gauss.xyz_grad_accum)
        assert float(r["m1"]["loss"]) == float(r["m2"]["loss"])


def test_sharded_step_keeps_capacity_slices(step_pair):
    """After a step on mesh (2, 1, 2) each rank's per-Gaussian leaves (the
    parameters, both Adam moments, alive and the densify statistics) hold
    capacity / 2 rows, in storage of their own."""
    *_, res = step_pair
    for r in res:
        assert r["capacity"] == 256
        # 9 parameters, alive, smpl_normal, 3 statistics; 9 rows of each moment
        assert len(r["rows"]) == 9 + 5 + 2 * 9, sorted(r["rows"])
        assert {tuple(v) for v in r["rows"].values()} == {(128, 128)}, r["rows"]
        assert "gauss/alive" in r["rows"] and "opt_state/nu/gaussians/xyz" in r["rows"]


def test_sharded_step_equals_whole_state_update(step_pair):
    """The gathered state after a sharded step equals, bit for bit, the
    whole-state update: `tx.step` on the gathered gradients, and the
    gathered densify increments added to the whole statistics."""
    _, _, _, port, res = step_pair
    ts, tx, cfg = port["ts"], port["tx"], port["cfg"]
    for r in res:
        mask = TO.geometry_freeze_mask(r["grads"], ts.step >= cfg.pbr_iteration)
        grads = TO.tree_map(lambda g, m: g * m, r["grads"], mask)
        new_p, opt = tx.step(TT.trainable_params(ts), grads, ts.opt_state)
        stats, denom, max_r = r["stats"]
        want = TT.TrainState(
            gauss=ts.gauss._replace(params=new_p.gaussians,
                                    xyz_grad_accum=ts.gauss.xyz_grad_accum + stats,
                                    denom=ts.gauss.denom + denom,
                                    max_radii2d=torch.maximum(ts.gauss.max_radii2d, max_r)),
            pose_refiner=new_p.pose_refiner, lbs_offset=new_p.lbs_offset, opt_state=opt,
            step=ts.step + 1)
        got = r["ts1"]
        assert got.step == want.step and got.opt_state.count == want.opt_state.count
        for a, b in zip(TO.tree_leaves(got), TO.tree_leaves(want), strict=True):
            assert a.shape == b.shape and torch.equal(a, b)
        assert float(grads.gaussians.xyz.abs().max()) > 0


def test_no_state_gather_inside_a_step(step_pair):
    """Nothing per-Gaussian is gathered inside the step or its
    loss_and_grads: mesh.STATS records no `state_gather` there, only the
    exchange, the strip all_gather, the psums and the pmax."""
    *_, res = step_pair
    for r in res:
        for call in ("loss_and_grads", "step"):
            assert "state_gather" not in r["kinds"][call], r["kinds"]
            assert "all_to_all" in r["kinds"][call] and "psum" in r["kinds"][call]


def test_loop_with_densify_and_growth_matches_single_device(tmp_path):
    """train_loop over the sharded step and state (one view per iteration,
    stacked to a batch of one, as cli.train --multichip runs it) on 4 ranks
    against the single-device loop: capacity 128 grows to 512 at the densify
    events and the trajectory is the single-device one. Each rank ends with
    capacity / 4 rows, and the state was gathered once per densify event and
    never inside a step."""
    scene = make_synthetic_scene(n_views=2, width=64, height=64, n_verts=100, capacity=128,
                                 raster_config=RC, device=CPU)
    cfg = OptimizationConfig(iterations=22, densify_from_iter=5, densify_until_iter=21,
                             densification_interval=7)

    def fresh():
        return TT.create_train_state(
            cfg, scene.init_state,
            *(interop.tensor_tree(as_np(m), CPU) for m in (jinit_pose(jax.random.PRNGKey(0)),
                                                           jinit_lbs(jax.random.PRNGKey(1)))))

    ts, tx = fresh()
    single = TT.make_train_step(scene.smpl_model, tx, cfg, RC, bg=torch.zeros(3))
    events = []
    ts_s, m_s = TT.train_loop(ts, tx, single, scene.batches, cfg, extent=scene.extent,
                              smpl_vertices=scene.big_pose_verts, max_sh_degree=0, seed=11,
                              callback=lambda it, t2, m2: events.append(
                                  (it, int(t2.gauss.capacity), int(t2.gauss.num_alive))))
    ts, tx = fresh()
    torch.save(dict(smpl_model=scene.smpl_model, tx=tx, cfg=cfg, raster_config=RC,
                    bg=torch.zeros(3), exchange_capacity=1024, ts=ts, batches=scene.batches,
                    extent=scene.extent, smpl_vertices=scene.big_pose_verts, seed=11),
               tmp_path / "inputs.pt")
    res = launch("train_loop", 4, tmp_path / "ranks", inputs=tmp_path / "inputs.pt",
                 mesh=(1, 2, 2), device=CPU)
    caps = [c for _, c, _ in events]
    assert caps[0] == 128 and caps[-1] >= 512
    assert events[-1][2] != events[0][2]
    n_events = sum(it % cfg.densification_interval == 0
                   for it in range(cfg.densify_from_iter, cfg.densify_until_iter))
    for r in res:
        assert r["capacity"] == caps[-1]
        assert {tuple(v) for v in r["rows"].values()} == {(caps[-1] // 4,) * 2}
        assert r["gathers"] == n_events == 2 and r["gathers_in_steps"] == 0
        assert [tuple(e) for e in r["events"]] == events
        assert torch.equal(r["alive"], ts_s.gauss.alive)
        np.testing.assert_allclose(r["xyz"].numpy(), ts_s.gauss.params.xyz.detach().numpy(),
                                   rtol=0, atol=5e-3)
        assert abs(r["loss"] - float(m_s["loss"])) < 2e-3 * max(1.0, abs(float(m_s["loss"])))
        assert torch.equal(r["xyz"], res[0]["xyz"])
