"""The port's donated step and chunk program (train/graph.py,
`make_train_step(..., donate=True)`, `train_loop(scan_chunk=...)`) on the
CPU, where the graphed step runs eagerly with the staging and the in-place
update of the card:

  * `train_loop(scan_chunk=8)` on the donated step is bit for bit the
    eager `scan_chunk=1` loop (final state, Adam moments and counts, the
    losses at every callback, the view order) across two densify events, a
    capacity growth, an opacity reset and `callback_iters=(13,)`;
  * its callback iterations and view order are those of the JAX
    `train_loop` under the same cfg, seed and scan_chunk (the JAX side
    runs a stub step with a `.chunk`, so nothing compiles);
  * the staged Adam scalars give `adam_leaf`'s bits;
  * `cli.train --scan_chunk 4` ends in the state of `--scan_chunk 1`.

The card's side (graphs bit-equal to the eager step, no host sync, a
capture per capacity, launch counts) is in tests/test_torch_kernels.py.
"""
from typing import Any, NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygauhuman_tpu.config import OptimizationConfig as JOptCfg
from mygauhuman_tpu.models import gaussians as JG
from mygauhuman_tpu.train import optim as JO
from mygauhuman_tpu.train import trainer as JT
from mygauhuman_torch.cli.train import main as train_main
from mygauhuman_torch.config import OptimizationConfig
from mygauhuman_torch.data.synthetic import make_synthetic_scene
from mygauhuman_torch.models.mlps import init_lbs_offset, init_pose_refiner
from mygauhuman_torch.ops.rasterize import RasterizerConfig
from mygauhuman_torch.train import optim as TO
from mygauhuman_torch.train import trainer as TT
from mygauhuman_torch.utils import logging as tlogging

torch.set_num_threads(1)

# densify at 10 and 15 (the first one doubles the capacity: 120 Gaussians
# leave fewer than 256 of 256 slots free), an opacity reset at 20
SCHEDULE = dict(iterations=25, densify_from_iter=6, densify_until_iter=20,
                densification_interval=5, opacity_reset_interval=20)
SEED, CHUNK, OBSERVED = 3, 8, (13,)


@pytest.fixture(scope="module")
def scene():
    # a small tile capacity: the plain blend's cost grows with it
    return make_synthetic_scene(n_views=3, width=32, height=32, n_verts=120, capacity=256,
                                raster_config=RasterizerConfig(tile_capacity=128,
                                                               instance_capacity=2048),
                                device="cpu")


def run_loop(scene, donate, scan_chunk):
    """The loop from a fresh state -> (final state, {iteration: loss} at the
    callbacks, the views the steps took in order)."""
    cfg = OptimizationConfig(**SCHEDULE)
    gen = torch.Generator().manual_seed(0)
    ts, tx = TT.create_train_state(cfg, scene.init_state, init_pose_refiner(gen, device="cpu"),
                                   init_lbs_offset(gen, device="cpu"))
    step = TT.make_train_step(scene.smpl_model, tx, cfg, scene.raster_config,
                              bg=torch.zeros(3), donate=donate)
    order: list = []
    if donate:
        chunk = step.chunk

        def recording_chunk(ts, views, idx, deg, pad_to=0):
            order.extend(idx)
            return chunk(ts, views, idx, deg, pad_to)

        step.chunk = recording_chunk
        step_fn = step
    else:
        def step_fn(ts, batch, deg):
            order.append(next(v for v, b in enumerate(scene.batches) if b is batch))
            return step(ts, batch, deg)

    losses = {}
    ts, _ = TT.train_loop(ts, tx, step_fn, scene.batches, cfg, extent=scene.extent,
                          smpl_vertices=scene.big_pose_verts, max_sh_degree=0, seed=SEED,
                          scan_chunk=scan_chunk, callback_iters=OBSERVED,
                          callback=lambda it, ts, m: losses.__setitem__(it, m["loss"].clone()))
    return ts, losses, order


@pytest.fixture(scope="module")
def runs(scene):
    return run_loop(scene, False, 1), run_loop(scene, True, CHUNK)


def test_chunked_donated_loop_is_the_eager_loop_bit_for_bit(runs):
    (ts1, loss1, order1), (ts2, loss2, order2) = runs
    assert ts2.gauss.capacity == 512 and ts1.gauss.capacity == 512     # grew once
    assert ts2.step == ts1.step == SCHEDULE["iterations"]
    assert ts2.opt_state.count == ts1.opt_state.count
    leaves1, leaves2 = TO.tree_leaves(ts1), TO.tree_leaves(ts2)
    assert len(leaves1) == len(leaves2)
    for i, (a, b) in enumerate(zip(leaves1, leaves2)):
        assert torch.equal(a, b), f"state leaf {i} {tuple(a.shape)}"
    assert order2 == order1
    # chunks end at the densify events, the callback iteration, the reset
    # and every CHUNK iterations between them
    assert sorted(loss2) == [8, 10, 13, 15, 20, 25]
    assert sorted(loss1) == list(range(1, SCHEDULE["iterations"] + 1))
    for it, loss in loss2.items():
        assert torch.equal(loss, loss1[it]), it


class _StubState(NamedTuple):
    gauss: Any
    opt_state: Any


class _StubGauss(NamedTuple):
    capacity: int


def test_callback_iterations_and_view_order_are_the_jax_loops(runs, scene, monkeypatch):
    _, (_, loss2, order2) = runs
    seen, order = [], []

    def step(ts, batch, deg):
        raise AssertionError("a chunked loop steps through .chunk")

    def chunk(ts, views, idx, deg, pad_to=0):
        order.extend(int(i) for i in idx)
        return ts, ({"loss": jnp.zeros(max(pad_to, len(idx)))}, len(idx))

    step.chunk = chunk
    # the events' own work is not what is compared here
    monkeypatch.setattr(JT, "maybe_grow_capacity", lambda ts: ts)
    monkeypatch.setattr(JT, "densify_event", lambda ts, *a: (ts, {}))
    monkeypatch.setattr(JG, "reset_opacity", lambda g: g)
    monkeypatch.setattr(JO, "reset_opacity_moments", lambda s: s)
    JT.train_loop(_StubState(_StubGauss(0), None), None, step,
                  [jnp.zeros(1)] * len(scene.batches), JOptCfg(**SCHEDULE), extent=1.0,
                  smpl_vertices=None, max_sh_degree=0, seed=SEED, scan_chunk=CHUNK,
                  callback_iters=OBSERVED, callback=lambda it, ts, m: seen.append(it))
    assert seen == sorted(loss2)
    assert order == order2


@pytest.mark.parametrize("count", [1, 2, 7, 250, 5000])
def test_staged_adam_scalars_give_adam_leafs_bits(count):
    rng = np.random.RandomState(count)
    p, g, mu = (torch.as_tensor(rng.randn(64, 3).astype(np.float32)) for _ in range(3))
    nu = torch.as_tensor(rng.rand(64, 3).astype(np.float32))
    lr = 1.6e-4 * (1 + 0.37 * np.sin(count))
    want = TO.adam_leaf(p, g, mu, nu, lr, count, 1e-15)
    got = TO.adam_leaf_staged(p, g, mu, nu, torch.as_tensor(TO.staged_row(lr, count)), 1e-15)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_staged_rows_drive_adam_step_bit_for_bit(scene):
    """Three updates of the whole tree (every group, xyz on its decaying lr)
    from one table of rows against the host counts."""
    cfg = OptimizationConfig()
    gen = torch.Generator().manual_seed(0)
    ts, tx = TT.create_train_state(cfg, scene.init_state, init_pose_refiner(gen, device="cpu"),
                                   init_lbs_offset(gen, device="cpu"))
    params, state = TT.trainable_params(ts), ts.opt_state
    rows = torch.as_tensor(tx.staged_rows(state.count, 3))
    assert rows.shape == (3, len(TO.GROUPS), len(TO.STAGED))
    p1 = p2 = params
    s1 = s2 = state
    for t in range(3):
        grads = TO.tree_map(lambda x, t=t: torch.sin(x * (t + 1.5)), params)
        p1, s1 = tx.step(p1, grads, s1)
        p2, s2 = tx.step(p2, grads, s2, staged=rows[t])
        assert s1.count == s2.count
        for a, b in zip(TO.tree_leaves((p1, s1.mu, s1.nu)), TO.tree_leaves((p2, s2.mu, s2.nu))):
            assert torch.equal(a, b)


def test_cli_scan_chunk_ends_in_the_unchunked_state(tmp_path, monkeypatch):
    # the JSONL log only: TensorBoard's import is most of a small run's time
    logger = tlogging.MetricLogger
    monkeypatch.setattr(tlogging, "MetricLogger", lambda d: logger(d, use_tensorboard=False))
    base = ["--synthetic", "--synthetic_size", "32", "--synthetic_verts", "120",
            "--iterations", "8", "--test_iterations", "8", "--save_iterations", "8",
            "--skip_galleries", "--disable_lpips", "--device", "cpu"]
    runs = {k: train_main(base + ["--scan_chunk", str(k), "--model_path", str(tmp_path / str(k))])
            for k in (4, 1)}
    for r in runs.values():
        assert (r["first_iteration"], r["last_iteration"]) == (1, 8)
        assert r["state"].step == 8 and r["graph"]["captures"] == 0     # eager on the CPU
    assert runs[4]["final_loss"] == runs[1]["final_loss"]
    for a, b in zip(TO.tree_leaves(runs[4]["state"]), TO.tree_leaves(runs[1]["state"])):
        assert torch.equal(a, b)
