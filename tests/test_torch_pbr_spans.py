"""Branch B's spans and counters (utils/profiling.py) in the chunked
`train_loop_pbr` on the CPU:

  * under a CPU profiler the loop records `mgh.pbr.bake` once per camera
    (a view is baked on its first visit), `mgh.pbr.sweep` once per sweep of
    each bake and `mgh.pbr.chunk` once per chunk;
  * `PHASES` counts one `mgh.pbr.bake` per camera, and `COUNTERS` the
    sweeps, the faces they rasterize (on the CPU, 6 per occupied cell of
    each sweep's window) and the blend calls those faces take (one a sweep
    here: every window's faces in one group), the same with or without the
    profiler;
  * the traced loop ends in the untraced loop's state bit for bit;
  * with no profiler running every span of the loop is the shared null
    context.
"""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mygauhuman_torch.config import OptimizationConfig
from mygauhuman_torch.data.synthetic import make_synthetic_scene
from mygauhuman_torch.models.mlps import init_lbs_offset, init_pose_refiner
from mygauhuman_torch.occlusion import baking
from mygauhuman_torch.ops.rasterize import RasterizerConfig
from mygauhuman_torch.train import optim as TO
from mygauhuman_torch.train import pbr as TPB
from mygauhuman_torch.train import trainer as TT
from mygauhuman_torch.utils import profiling

torch.set_num_threads(1)
ITERS, CHUNK, OBSERVED, CELLS = 6, 4, (2,), 6
BAKE = dict(bake_height=8, bake_width=16, bake_max_cells=CELLS)


@pytest.fixture(scope="module")
def scene():
    return make_synthetic_scene(n_views=3, width=32, height=32, n_verts=30, capacity=64,
                                raster_config=RasterizerConfig(tile_capacity=64,
                                                               instance_capacity=512),
                                device="cpu")


def span_names(prof, path) -> list:
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


def run_loop(scene):
    """The chunked branch-B loop from a fresh state -> (final states, the
    views of each chunk, PHASES' summary, COUNTERS with the occupied cells
    of each bake under "occupied")."""
    cfg = OptimizationConfig(pbr_iteration=0)
    gen = torch.Generator().manual_seed(0)
    ts, tx = TT.create_train_state(cfg, scene.init_state, init_pose_refiner(gen, device="cpu"),
                                   init_lbs_offset(gen, device="cpu"))
    pbr, ltx = TPB.create_pbr_state(cfg, base_res=16, device="cpu")
    step = TPB.make_pbr_train_step(scene.smpl_model, tx, ltx, cfg, scene.raster_config,
                                   bg=torch.zeros(3), donate=True)
    profiling.PHASES.reset()
    profiling.COUNTERS.clear()
    views, occupied = [], []
    real_chunk, real_count = step.chunk, baking.count_occupied

    def chunk(*args, **kw):
        views.append(list(args[6]))
        return real_chunk(*args, **kw)

    def count(*args, **kw):
        occupied.append(real_count(*args, **kw))
        return occupied[-1]

    step.chunk = chunk
    baking.count_occupied = count
    try:
        ts, pbr, _ = TPB.train_loop_pbr(ts, pbr, step, scene.batches, scene.smpl_model, cfg,
                                        start_iteration=0, num_iterations=ITERS,
                                        max_sh_degree=0, seed=3, scan_chunk=CHUNK,
                                        callback_iters=OBSERVED, **BAKE)
    finally:
        baking.count_occupied = real_count
    return (ts, pbr), views, profiling.PHASES.summary(), {**profiling.COUNTERS,
                                                          "occupied": occupied}


@pytest.fixture(scope="module")
def loops(scene, tmp_path_factory):
    plain = run_loop(scene)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = run_loop(scene)
    return plain, traced, span_names(prof, tmp_path_factory.mktemp("spans") / "pbr.json")


def test_traced_loop_records_a_bake_per_camera_a_sweep_per_sweep_and_a_chunk_per_chunk(loops):
    _, (_, views, phases, counters), names = loops
    cameras = {v for chunk in views for v in chunk}
    assert len(cameras) == 3
    # chunks 1-2 (the observed iteration ends it), 3-6
    assert len(views) == names.count("mgh.pbr.chunk") == 2
    assert names.count("mgh.pbr.bake") == len(cameras) == phases["mgh.pbr.bake"]["count"]
    assert names.count("mgh.pbr.sweep") == counters["mgh.pbr.sweeps"] >= len(cameras)


def test_phases_and_counters_count_bakes_sweeps_and_faces(loops):
    (_, _, phases, counters), (_, _, t_phases, t_counters), _ = loops
    assert counters == t_counters and set(phases) == {"mgh.pbr.bake"}
    assert phases["mgh.pbr.bake"]["count"] == t_phases["mgh.pbr.bake"]["count"] == 3
    # each camera's occupied cells, in windows of CELLS, 6 faces a cell on the CPU
    occupied = counters["occupied"]
    assert len(occupied) == 3 and min(occupied) > CELLS
    assert counters["mgh.pbr.sweeps"] == sum(-(-n // CELLS) for n in occupied)
    assert counters["mgh.pbr.faces"] == 6 * sum(occupied)
    assert counters["mgh.pbr.face_batches"] == counters["mgh.pbr.sweeps"]


def test_traced_loop_ends_in_the_untraced_state(loops):
    ((ts1, pbr1), v1, _, _), ((ts2, pbr2), v2, _, _), _ = loops
    assert v1 == v2
    for i, (a, b) in enumerate(zip(TO.tree_leaves((ts1, pbr1.light)),
                                   TO.tree_leaves((ts2, pbr2.light)))):
        assert torch.equal(a, b), f"state leaf {i}"


def test_spans_are_the_shared_null_context_without_a_profiler():
    null = profiling.annotate("mgh.pbr.bake")
    assert all(profiling.annotate(n) is null
               for n in ("mgh.pbr.sweep", "mgh.pbr.chunk", "mgh.train.chunk"))
    before = dict(profiling.PHASES.counts)
    with profiling.PHASES.phase("mgh.pbr.bake", wait=True):
        pass
    assert profiling.PHASES.counts["mgh.pbr.bake"] == before.get("mgh.pbr.bake", 0) + 1
