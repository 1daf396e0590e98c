"""The port's checkpoints (mygauhuman_torch/train/checkpoint.py) against the
JAX package's: the same directory layout and `latest_step`, snapshots
saved and loaded bit for bit (a JAX TrainState carried over with its Adam
moments and counts), a restore into a larger capacity, orbax snapshots
refused, the npz replay cache read both ways exactly, unversioned caches
rejected, and the diverged-state snapshot of `train_loop`.

Tolerances: none. Every comparison is exact (the same float32 bits; host
ints equal)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygauhuman_tpu.config import Config as JConfig, OptimizationConfig as JOptCfg
from mygauhuman_tpu.data.synthetic import make_synthetic_scene as jscene
from mygauhuman_tpu.models.mlps import init_lbs_offset, init_pose_refiner
from mygauhuman_tpu.train import checkpoint as JC
from mygauhuman_tpu.train import trainer as JT
from mygauhuman_torch import interop
from mygauhuman_torch.config import Config, OptimizationConfig
from mygauhuman_torch.train import checkpoint as TC
from mygauhuman_torch.train import trainer as TT
from mygauhuman_torch.train.optim import tree_map

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def states():
    """A JAX TrainState after two optax updates on seeded gradients (moments
    and counts off zero), and the port's copy of it."""
    scene = jscene(n_views=1, width=32, height=32, n_verts=60, capacity=64)
    ts, tx = JT.create_train_state(JOptCfg(), scene.init_state,
                                   init_pose_refiner(jax.random.PRNGKey(0)),
                                   init_lbs_offset(jax.random.PRNGKey(1)))
    params = JT.trainable_params(ts)
    rng = np.random.RandomState(0)
    opt_state = ts.opt_state
    update = jax.jit(tx.update)
    for _ in range(2):
        grads = jax.tree.map(lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32)),
                             params)
        upd, opt_state = update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, upd)
    jts = ts._replace(gauss=ts.gauss._replace(params=params.gaussians),
                      pose_refiner=params.pose_refiner, lbs_offset=params.lbs_offset,
                      opt_state=opt_state, step=jnp.asarray(2, jnp.int32))
    return jts, interop.train_state(jax.tree.map(np.asarray, jts), "cpu")


def _leaves(tree):
    """Every leaf (tensors and host numbers) in field order."""
    if isinstance(tree, torch.Tensor) or not isinstance(tree, (tuple, list, dict)):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for item in items for leaf in _leaves(item)]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def test_interop_train_state_is_exact(states):
    jts, ts = states
    assert ts.step == 2 and set(ts.opt_state.count.values()) == {2}
    inner = jts.opt_state.inner_states
    for field, group in (("xyz", "xyz"), ("opacity", "opacity")):
        for kind in ("mu", "nu"):
            want = np.asarray(getattr(getattr(inner[group].inner_state[0], kind).gaussians,
                                      field))
            got = getattr(getattr(ts.opt_state, kind).gaussians, field)
            np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ts.pose_refiner["layers"][0]["w"].numpy(),
                                  np.asarray(jts.pose_refiner["layers"][0]["w"]))


def test_save_load_bit_exact(states, tmp_path):
    _, ts = states
    d = str(tmp_path / "ckpt")
    path = TC.save_checkpoint(d, 100, ts, Config(optim=OptimizationConfig()))
    assert path == os.path.join(os.path.abspath(d), "chkpnt100")
    assert os.path.exists(os.path.join(path, "state.pt"))
    # the JAX package reads the config written beside the snapshots
    assert JConfig.load(os.path.join(d, "cfg_args.json")).optim == JOptCfg()
    fresh = ts._replace(step=0, opt_state=ts.opt_state._replace(
        count={k: 0 for k in ts.opt_state.count}))
    fresh = fresh._replace(**{f: tree_map(torch.zeros_like, getattr(fresh, f))
                              for f in ("gauss", "pose_refiner", "lbs_offset")})
    back = TC.load_checkpoint(d, 100, fresh)
    _assert_trees_equal(back, ts)
    assert back.step == ts.step and back.opt_state.count == ts.opt_state.count
    assert type(back) is type(ts) and type(back.gauss.params) is type(ts.gauss.params)


def test_restore_like_into_larger_capacity(states, tmp_path):
    _, ts = states
    grown = TT.maybe_grow_capacity(ts, min_free=10**6)     # 64 -> 128
    assert grown.gauss.capacity == 2 * ts.gauss.capacity
    d = str(tmp_path / "ckpt")
    TC.save_checkpoint(d, 7, grown)
    back = TC.restore_checkpoint_like(d, 7, ts)
    _assert_trees_equal(back, grown)
    assert back.opt_state.mu.gaussians.xyz.shape[0] == 128
    with pytest.raises(ValueError, match="expected"):
        TC.load_checkpoint(d, 7, ts)


def test_latest_step_matches_jax(states, tmp_path):
    _, ts = states
    d = str(tmp_path / "ckpt")
    assert TC.latest_step(d) is None and JC.latest_step(d) is None
    for step in (3, 120, 40):
        TC.save_checkpoint(d, step, ts.gauss.alive)
    os.makedirs(os.path.join(d, "chkpnt_old"))
    assert TC.latest_step(d) == JC.latest_step(d) == 120


def test_orbax_snapshot_is_refused(states, tmp_path):
    jts, ts = states
    d = str(tmp_path / "jax_ckpt")
    JC.save_checkpoint(d, 5, jts)
    with pytest.raises(ValueError, match="orbax"):
        TC.load_checkpoint(d, 5, ts)
    with pytest.raises(ValueError, match="orbax"):
        TC.restore_checkpoint_like(d, 5, ts)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_eval_cache_crosses_packages(tmp_path, writer):
    rng = np.random.RandomState(3)
    cache = {str(p): {"transforms": rng.randn(8, 3, 3).astype(np.float32),
                      "translation": rng.randn(8, 3).astype(np.float32)} for p in (0, 30, 510)}
    path = str(tmp_path / "smpl_rot_1200.npz")
    save, load = ((JC.save_eval_cache, TC.load_eval_cache) if writer == "jax"
                  else (TC.save_eval_cache, JC.load_eval_cache))
    save(path, cache)
    back = load(path)
    assert sorted(back) == sorted(cache)
    for k in cache:
        for kind in ("transforms", "translation"):
            np.testing.assert_array_equal(back[k][kind], cache[k][kind])
            assert back[k][kind].dtype == np.float32
    assert TC.EVAL_CACHE_VERSION == JC.EVAL_CACHE_VERSION


def test_unversioned_cache_is_rejected(tmp_path):
    p = str(tmp_path / "smpl_rot_legacy.npz")
    np.savez(p, **{"0_transforms": np.zeros((4, 3, 3)), "0_translation": np.zeros((4, 3))})
    with pytest.raises(ValueError, match="unversioned"):
        TC.load_eval_cache(p)


def test_nan_loss_snapshots_then_raises(states, tmp_path, monkeypatch):
    """A non-finite loss at a checked iteration (every 50th) writes
    output/diverged/chkpnt<it> and then raises, as the JAX train_loop."""
    _, ts = states
    monkeypatch.chdir(tmp_path)

    def step(ts, batch, deg):
        loss = torch.tensor(float("nan") if ts.step + 1 >= 50 else 1.0)
        return ts._replace(step=ts.step + 1), {"loss": loss}

    cfg = OptimizationConfig(iterations=60, densify_from_iter=1000)
    with pytest.raises(FloatingPointError, match="iteration 50"):
        TT.train_loop(ts._replace(step=0), None, step, [None], cfg, extent=1.0,
                      smpl_vertices=None)
    snap = tmp_path / "output" / "diverged" / "chkpnt50" / "state.pt"
    assert snap.exists()
    back = TC.load_checkpoint(str(tmp_path / "output" / "diverged"), 50, ts)
    _assert_trees_equal(back, ts._replace(step=50))
