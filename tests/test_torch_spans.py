"""The program's spans and phase counters (utils/profiling.py) at the host
boundaries of the chunked training loop and the graphed frame, on the CPU:

  * a chunked donated `train_loop` across a densify event, under a CPU
    profiler, records `mgh.train.{chunk,loss_check,densify,adopt,rows,
    stage,replay}`, and ends in the same state bit for bit as the same loop
    with no profiler running;
  * `PHASES` counts one `mgh.train.densify` per event, and nothing per
    step;
  * a `GraphedRenderer` call records `mgh.render.stage` and
    `mgh.render.replay`, and renders the same bits as with no profiler
    running;
  * with no profiler running, `annotate` is one shared null context.
"""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mygauhuman_torch.config import OptimizationConfig
from mygauhuman_torch.data.synthetic import make_synthetic_scene
from mygauhuman_torch.models.mlps import init_lbs_offset, init_pose_refiner
from mygauhuman_torch.ops.rasterize import RasterizerConfig
from mygauhuman_torch.render.graph import GraphedRenderer
from mygauhuman_torch.train import optim as TO
from mygauhuman_torch.train import trainer as TT
from mygauhuman_torch.utils import profiling

torch.set_num_threads(1)

# one densify event, at 6, which ends the first chunk
SCHEDULE = dict(iterations=8, densify_from_iter=4, densify_until_iter=8,
                densification_interval=3, opacity_reset_interval=3000)
TRAIN_SPANS = {"mgh.train.chunk", "mgh.train.loss_check", "mgh.train.densify",
               "mgh.train.adopt", "mgh.train.rows", "mgh.train.stage", "mgh.train.replay"}


@pytest.fixture(scope="module")
def scene():
    return make_synthetic_scene(n_views=3, width=32, height=32, n_verts=120, capacity=256,
                                raster_config=RasterizerConfig(tile_capacity=128,
                                                               instance_capacity=2048),
                                device="cpu")


def span_names(prof, path) -> list:
    """The names of the spans in the profiler's Chrome trace, in order."""
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


def run_loop(scene):
    """The chunked donated loop from a fresh state -> (final state, the
    step, PHASES' summary of the run)."""
    cfg = OptimizationConfig(**SCHEDULE)
    gen = torch.Generator().manual_seed(0)
    ts, tx = TT.create_train_state(cfg, scene.init_state, init_pose_refiner(gen, device="cpu"),
                                   init_lbs_offset(gen, device="cpu"))
    step = TT.make_train_step(scene.smpl_model, tx, cfg, scene.raster_config,
                              bg=torch.zeros(3), donate=True)
    profiling.PHASES.reset()
    ts, _ = TT.train_loop(ts, tx, step, scene.batches, cfg, extent=scene.extent,
                          smpl_vertices=scene.big_pose_verts, max_sh_degree=0, seed=3,
                          scan_chunk=4)
    return ts, step, profiling.PHASES.summary()


@pytest.fixture(scope="module")
def loops(scene, tmp_path_factory):
    """(plain run, (profiled run, the span names it recorded))."""
    plain = run_loop(scene)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = run_loop(scene)
    return plain, (traced, span_names(prof, tmp_path_factory.mktemp("spans") / "loop.json"))


def test_chunked_loop_records_the_train_spans(loops):
    _, (_, names) = loops
    assert TRAIN_SPANS <= set(names), TRAIN_SPANS - set(names)
    # chunks 1-4, 5-6 (the event ends it), 7-8: one loss check per chunk
    assert names.count("mgh.train.chunk") == names.count("mgh.train.loss_check") == 3
    assert names.count("mgh.train.densify") == 1
    assert names.count("mgh.train.stage") == names.count("mgh.train.replay") == 8


def test_phases_count_densify_events(loops):
    for ts, step, phases in (loops[0], loops[1][0]):
        assert set(phases) == {"mgh.train.densify"}
        assert phases["mgh.train.densify"]["count"] == 1
        assert step.record()["captures"] == 0     # the CPU runs eagerly
        assert ts.step == SCHEDULE["iterations"]


def test_chunked_loop_is_bit_equal_under_a_profiler(loops):
    (ts1, _, _), ((ts2, _, _), _) = loops
    assert ts1.opt_state.count == ts2.opt_state.count
    for i, (a, b) in enumerate(zip(TO.tree_leaves(ts1), TO.tree_leaves(ts2))):
        assert torch.equal(a, b), f"state leaf {i} {tuple(a.shape)}"


def test_graphed_renderer_records_spans_and_renders_the_same(scene, tmp_path):
    renderer = GraphedRenderer(scene.gt_state, scene.smpl_model, bg=torch.zeros(3),
                               active_sh_degree=0, config=scene.raster_config)
    b = scene.batches[0]
    plain = renderer(b.camera, b.frame, opacity_eps=1e-12)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = renderer(b.camera, b.frame, opacity_eps=1e-12)
    names = span_names(prof, tmp_path / "frame.json")
    assert names.count("mgh.render.stage") == names.count("mgh.render.replay") == 1
    assert "mgh.render.capture" not in names and renderer.captures == 0
    assert torch.equal(plain.render, traced.render)
    assert torch.equal(plain.render_alpha, traced.render_alpha)


def test_annotate_is_the_shared_null_context_without_a_profiler(tmp_path):
    assert profiling.annotate("mgh.a") is profiling.annotate("mgh.b")
    with profiling.annotate("mgh.a"):
        with profiling.annotate("mgh.a"):      # the null context nests
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        span = profiling.annotate("mgh.a")
        with span:
            torch.ones(2).sum()
    assert span is not profiling.annotate("mgh.a")
    assert span_names(prof, tmp_path / "trace.json") == ["mgh.a"]
