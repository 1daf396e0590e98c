"""The port's branch-B chunk program (train/pbr.py: `make_pbr_train_step(...,
donate=True)`, `GraphedPbrStep.chunk`, `train_loop_pbr(scan_chunk=,
callback_iters=, occ_budget_mb=)`) on the CPU, where the graphed step runs
eagerly with the staging and the in-place update of the card:

  * the chunked loop (scan_chunk 6, callback_iters (7,), 12 iterations)
    against the JAX chunked loop: the same view order, callbacks at
    iterations 1-12 on both sides, the light and the albedo within 1e-3 of
    the largest value (the bakes pass through uint8 and the render chain
    runs in float32 in other orders, as in tests/test_torch_pbr_train.py);
  * the chunked loop against the port's own unchunked loop (the eager
    step), bit for bit: every leaf of both states and every iteration's
    metrics;
  * a starved `occ_budget_mb` (one camera's slot): the chunks split where
    the JAX loop splits them (its `idx` lists, the JAX side with a stub
    `.chunk`, so nothing compiles), and the run is still the unchunked
    loop bit for bit;
  * a call of the donated step (the occlusion colour staged) is the eager
    step bit for bit, and consumes its states;
  * the staged light-Adam row gives `LightAdam.step`'s bits at counts 1-50;
  * `cli.train --scan_chunk 5` through branch B ends in the state of
    `--scan_chunk 1`.

The card's side (graphs bit-equal to the eager step) is in
tests/test_torch_kernels.py.
Sizes: tests/test_pbr_training.py's scene, 48^2, 150 Gaussians (60 alive)
at capacity 256, light base_res 16, bakes of 8 x 16.
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygauhuman_tpu.config import OptimizationConfig as JOptCfg
from mygauhuman_tpu.data.synthetic import make_synthetic_scene as jscene
from mygauhuman_tpu.models.mlps import init_lbs_offset as jinit_lbs, init_pose_refiner as jinit_pose
from mygauhuman_tpu.occlusion import baking as JBK
from mygauhuman_tpu.train import pbr as JPB
from mygauhuman_tpu.train import trainer as JT
from mygauhuman_torch import interop
from mygauhuman_torch.cli.train import main as train_main
from mygauhuman_torch.config import OptimizationConfig
from mygauhuman_torch.data.camera import Camera
from mygauhuman_torch.ops.rasterize import RasterizerConfig
from mygauhuman_torch.render import FrameInputs
from mygauhuman_torch.train import optim as TO
from mygauhuman_torch.train import pbr as TPB
from mygauhuman_torch.train import trainer as TT

torch.set_num_threads(1)
CPU = "cpu"
ITERS, SEED, CHUNK, OBSERVED = 12, 5, 6, (7,)
BAKE = dict(bake_height=8, bake_width=16)
# 256 slots x 8 x 16 = 32,768 bytes per camera: 0.04 MB holds one camera
STARVED_MB, STARVED_CHUNK = 0.04, 5


def t(a):
    return torch.as_tensor(np.array(a))


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, rel, msg=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()),
                               err_msg=msg)


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


@pytest.fixture(scope="module")
def setup():
    """tests/test_pbr_training.py's scene in both packages, 60 of its 150
    Gaussians alive (fewer cells to bake), seeded materials."""
    js = jscene(n_views=2, width=48, height=48, n_verts=150, capacity=256)
    jcfg = JOptCfg(pbr_iteration=0)
    rng = np.random.RandomState(0)
    gauss = js.gt_state._replace(
        params=js.gt_state.params._replace(
            albedo=jnp.asarray(rng.randn(256, 3).astype(np.float32)),
            roughness=jnp.asarray(rng.randn(256, 1).astype(np.float32))),
        alive=jnp.arange(256) < 60)
    jts, jtx = JT.create_train_state(jcfg, gauss, jinit_pose(jax.random.PRNGKey(0)),
                                     jinit_lbs(jax.random.PRNGKey(1)))
    jpbr, jltx = JPB.create_pbr_state(jcfg, base_res=16)
    cfg = OptimizationConfig(pbr_iteration=0)
    _, ltx = TPB.create_pbr_state(cfg, base_res=16, device=CPU)
    return dict(js=js, jcfg=jcfg, jts=jts, jtx=jtx, jpbr=jpbr, jltx=jltx, cfg=cfg,
                tx=TO.Adam(cfg), ltx=ltx, smpl=interop.smpl_model(js.smpl_model, CPU),
                batches=port_batches(js),
                raster=RasterizerConfig(tile_capacity=512, chunk_tiles=16),
                ts=interop.train_state(as_np(jts), CPU),
                pbr=interop.pbr_state(as_np(jpbr), CPU))


def make_step(s, donate):
    return TPB.make_pbr_train_step(s["smpl"], s["tx"], s["ltx"], s["cfg"], s["raster"],
                                   bg=torch.zeros(3), donate=donate)


def run_port(s, scan_chunk, occ_budget_mb=1024.0):
    """The port's loop from the fixture's states -> (ts, pbr_state,
    {iteration: metrics}, the views in step order, the chunks' idx lists)."""
    order, chunks, seen = [], [], {}
    step = make_step(s, donate=scan_chunk > 1)
    if scan_chunk > 1:
        chunk = step.chunk

        def recording_chunk(ts, pbr, views, occ_buf, knn3, pw, idx, bidx, deg, pad_to=0):
            chunks.append(list(idx))
            order.extend(idx)
            return chunk(ts, pbr, views, occ_buf, knn3, pw, idx, bidx, deg, pad_to)

        step.chunk = recording_chunk
        step_fn = step
    else:
        def step_fn(ts, pbr, batch, *a):
            order.append(next(v for v, b in enumerate(s["batches"]) if b is batch))
            return step(ts, pbr, batch, *a)

    ts, pbr, _ = TPB.train_loop_pbr(
        s["ts"], s["pbr"], step_fn, s["batches"], s["smpl"], s["cfg"], start_iteration=0,
        num_iterations=ITERS, max_sh_degree=0, seed=SEED, scan_chunk=scan_chunk,
        callback_iters=OBSERVED, occ_budget_mb=occ_budget_mb, **BAKE,
        callback=lambda it, ts, p, m: seen.__setitem__(it, {k: v.clone() if isinstance(
            v, torch.Tensor) else v for k, v in m.items()}))
    return ts, pbr, seen, order, chunks


@pytest.fixture(scope="module")
def unchunked(setup):
    return run_port(setup, 1)


@pytest.fixture(scope="module")
def chunked(setup):
    return run_port(setup, CHUNK)


def assert_same_run(got, want):
    (ts2, pbr2, seen2, order2, _), (ts1, pbr1, seen1, order1, _) = got, want
    assert order2 == order1
    assert ts2.step == ts1.step == ITERS
    assert ts2.opt_state.count == ts1.opt_state.count
    assert pbr2.opt_state.count == pbr1.opt_state.count == ITERS
    for i, (a, b) in enumerate(zip(TO.tree_leaves((ts2, pbr2)), TO.tree_leaves((ts1, pbr1)),
                                   strict=True)):
        assert torch.equal(a, b), f"state leaf {i} {tuple(a.shape)}"
    assert sorted(seen2) == sorted(seen1) == list(range(1, ITERS + 1))
    for it, m in seen1.items():
        assert m.keys() == seen2[it].keys()
        for k, v in m.items():
            assert torch.equal(torch.as_tensor(seen2[it][k]), torch.as_tensor(v)), (it, k)


def test_chunked_loop_is_the_unchunked_loop_bit_for_bit(chunked, unchunked):
    assert_same_run(chunked, unchunked)
    # chunks end at the callback iteration and every CHUNK iterations
    assert [len(c) for c in chunked[4]] == [6, 1, 5]


def test_chunked_loop_matches_the_jax_chunked_loop(setup, chunked):
    s = setup
    jstep = JPB.make_pbr_train_step(s["js"].smpl_model, s["jtx"], s["jltx"], s["jcfg"],
                                    s["js"].raster_config, bg=jnp.zeros(3))
    order, seen = [], []

    def step_fn(*a):
        raise AssertionError("a chunked loop steps through .chunk")

    def chunk(ts, pbr, views, occ_buf, knn3, pw, idx, bidx, deg, pad_to=0):
        order.extend(int(i) for i in idx)
        return jstep.chunk(ts, pbr, views, occ_buf, knn3, pw, idx, bidx, deg, pad_to)

    step_fn.chunk = chunk
    jts, jpbr, _ = JPB.train_loop_pbr(
        s["jts"], s["jpbr"], step_fn, s["js"].batches, s["js"].smpl_model, s["jcfg"],
        start_iteration=0, num_iterations=ITERS, max_sh_degree=0, seed=SEED,
        scan_chunk=CHUNK, callback_iters=OBSERVED, **BAKE,
        callback=lambda it, ts, p, m: seen.append(it))
    ts, pbr, tseen, torder, _ = chunked
    assert torder == order and len(set(order)) == 2
    assert sorted(tseen) == seen == list(range(1, ITERS + 1))
    close(pbr.light["base"], jpbr.light["base"], 1e-3, "light")
    close(ts.gauss.params.albedo, jts.gauss.params.albedo, 1e-3, "albedo")


class _Out(NamedTuple):
    transforms: jnp.ndarray
    translation: jnp.ndarray


def test_starved_budget_splits_chunks_as_the_jax_loop(setup, unchunked, monkeypatch):
    s = setup
    starved = run_port(s, STARVED_CHUNK, STARVED_MB)
    assert_same_run(starved, unchunked)
    jchunks = []

    def step_fn(*a):
        raise AssertionError("a chunked loop steps through .chunk")

    def chunk(ts, pbr, views, occ_buf, knn3, pw, idx, bidx, deg, pad_to=0):
        assert occ_buf.shape[0] == 1          # k_max = 1
        jchunks.append([int(i) for i in idx])
        return ts, pbr, ({"loss": jnp.zeros(max(pad_to, len(idx)))}, len(idx))

    step_fn.chunk = chunk
    # no bake and no render: only the schedule is compared here
    cap = 256
    monkeypatch.setattr(JBK, "bake_occlusion_full", lambda m, c6, op, wn, alive, height,
                        width, sweep_cells: (jnp.zeros((cap, height, width, 1)), 0, 1))
    import mygauhuman_tpu.render as jrender
    monkeypatch.setattr(jrender, "render_frame", lambda *a, **k: _Out(
        jnp.broadcast_to(jnp.eye(3), (cap, 3, 3)), jnp.zeros((cap, 3))))
    JPB.train_loop_pbr(s["jts"], s["jpbr"], step_fn, s["js"].batches, s["js"].smpl_model,
                       s["jcfg"], start_iteration=0, num_iterations=ITERS, max_sh_degree=0,
                       seed=SEED, scan_chunk=STARVED_CHUNK, callback_iters=OBSERVED,
                       occ_budget_mb=STARVED_MB, **BAKE)
    assert starved[4] == jchunks
    assert len(jchunks) > -(-ITERS // STARVED_CHUNK) + 1     # split by the budget
    assert all(len(set(c)) == 1 for c in jchunks)


def test_donated_step_call_is_the_eager_step(setup):
    s = setup
    knn3 = TPB.compute_knn3(s["ts"].gauss)
    pw = TPB.prefilter_weight_set(16, CPU)
    occ = torch.as_tensor(np.random.RandomState(1).rand(256, 3).astype(np.float32))
    eager, donated = make_step(s, False), make_step(s, True)
    ts1, pbr1 = s["ts"], s["pbr"]
    ts2, pbr2 = s["ts"], s["pbr"]
    for v in (0, 1, 0):
        ts1, pbr1, m1 = eager(ts1, pbr1, s["batches"][v], knn3, occ, pw, 0)
        ts2, pbr2, m2 = donated(ts2, pbr2, s["batches"][v], knn3, occ, pw, 0)
        for k, x in m1.items():
            assert torch.equal(m2[k], x), k
    for a, b in zip(TO.tree_leaves((ts2, pbr2)), TO.tree_leaves((ts1, pbr1)), strict=True):
        assert torch.equal(a, b)
    assert (ts2.step, pbr2.opt_state.count, ts2.opt_state.count) == \
        (ts1.step, pbr1.opt_state.count, ts1.opt_state.count)
    # the donated step wrote into its own tensors, never into the caller's
    assert not torch.equal(s["pbr"].light["base"], pbr2.light["base"])
    assert donated.captures == 0 and not donated.graphed


def test_stacked_views_keep_each_leafs_values_and_layout():
    """A chunk's views are copied from the stack: each keeps its view's
    values and strides (the synthetic scene's images are planar), since on
    the card a step's bits can depend on its inputs' layout."""
    from mygauhuman_torch.data.synthetic import make_synthetic_scene
    from mygauhuman_torch.train.graph import stack_views

    s = make_synthetic_scene(n_views=3, width=32, height=32, n_verts=50, capacity=64,
                             device=CPU).batches
    views = stack_views(s)
    assert any(b.gt_image.stride() != b.gt_image.contiguous().stride() for b in s)
    for b, v in zip(s, views.views, strict=True):
        for x, y in zip(TO.tree_leaves(b), TO.tree_leaves(v), strict=True):
            assert torch.equal(x, y) and x.stride() == y.stride()


def test_staged_light_adam_row_gives_the_host_counts_bits():
    rng = np.random.RandomState(3)
    leaf = lambda *shape: torch.as_tensor(rng.randn(*shape).astype(np.float32))  # noqa: E731
    params = {"light": {"base": leaf(6, 4, 4, 3)}, "volumes": leaf(5, 9)}
    tx = TPB.LightAdam(0.05)
    state = tx.init(params)
    for count in range(1, 51):
        grads = TO.tree_map(lambda p: torch.as_tensor(rng.randn(*p.shape).astype(np.float32)),
                            params)
        row = torch.from_numpy(tx.staged_rows(state.count, 1)[0])
        p1, s1 = tx.step(params, grads, state)
        p2, s2 = tx.step(params, grads, state, staged=row)
        assert s1.count == s2.count == count
        for a, b in zip(TO.tree_leaves((p1, s1)), TO.tree_leaves((p2, s2)), strict=True):
            assert torch.equal(a, b), count
        params, state = p1, s1


def test_cli_branch_b_chunks_end_in_the_unchunked_state(tmp_path):
    def run(chunk):
        return train_main(["--synthetic", "--synthetic_size", "32", "--synthetic_verts", "120",
                           "--synthetic_views", "2", "--iterations", "9", "--pbr_iteration",
                           "3", "--test_iterations", "9", "--save_iterations", "9",
                           "--skip_galleries", "--disable_lpips", "--bake_cells", "16",
                           "--bake_single_sweep", "--scan_chunk", str(chunk),
                           "--model_path", str(tmp_path / f"c{chunk}"), "--device", "cpu"])

    one, five = run(1), run(5)
    assert five["pbr"]["graph"]["captures"] == 0 and five["pbr"]["iterations"] == 6
    assert (five["first_iteration"], five["last_iteration"]) == (1, 9)
    for a, b in zip(TO.tree_leaves((five["state"], five["pbr_state"])),
                    TO.tree_leaves((one["state"], one["pbr_state"])), strict=True):
        assert torch.equal(a, b)
