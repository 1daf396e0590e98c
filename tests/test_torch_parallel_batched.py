"""The port's batched (data-parallel) train step
(mygauhuman_torch/parallel/train.py::make_batched_train_step) against the
JAX package's vmapped step, on tests/test_determinism_multichip.py's scene.

Two views: over 2 gloo ranks on mesh (2, 1, 1), as processes
(`parallel/dryrun.py::launch`, a `file://` store under tmp_path) that write
their results for this process to compare, and both on one process.
Tolerances: the loss within 1e-4 relative, the first moments (0.1 x the
gradient) and xyz_grad_accum within 1e-3 of their largest values, the
visible counts and radii exactly.
"""
import jax.numpy as jnp
import numpy as np
import torch

from mygauhuman_tpu.parallel.train import make_batched_train_step as jax_batched
from mygauhuman_tpu.parallel.train import stack_batches as jax_stack
from mygauhuman_torch import interop
from mygauhuman_torch.ops.rasterize import RasterizerConfig
from mygauhuman_torch.parallel.dryrun import launch
from mygauhuman_torch.parallel.train import make_batched_train_step, stack_batches
from mygauhuman_torch.train import optim as TO
from test_torch_parallel_train import as_np, close_where, scene_pair

torch.set_num_threads(1)
CPU = "cpu"


def test_batched_step_matches_jax(tmp_path):
    """Two views: one per data rank (mesh (2, 1, 1)) and both on one
    process, against the JAX vmapped step."""
    js, jcfg, jts, jtx, port = scene_pair(raster=None, n_views=2, width=32, height=32,
                                          n_verts=100, capacity=128)
    jts1, jm = jax_batched(js.smpl_model, jtx, jcfg, js.raster_config, bg=jnp.zeros(3))(
        jts, jax_stack(js.batches), 0)
    want = interop.train_state(as_np(jts1), CPU)
    rc = RasterizerConfig(tile_capacity=512, chunk_tiles=16)
    batch = stack_batches(port["batches"])
    torch.save(dict(port, raster_config=rc, batch=batch), tmp_path / "inputs.pt")
    res = launch("batched", 2, tmp_path / "ranks", inputs=tmp_path / "inputs.pt",
                 mesh=(2, 1, 1), device=CPU)
    local = make_batched_train_step(port["smpl_model"], port["tx"], port["cfg"], rc,
                                    bg=torch.zeros(3))(port["ts"], batch, 0)
    for got, m in [(r["ts"], r["metrics"]) for r in res] + [local]:
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        for i, (a, b) in enumerate(zip(TO.tree_leaves(got.opt_state.mu),
                                       TO.tree_leaves(want.opt_state.mu))):
            close_where(a, b.numpy(), np.ones(b.shape, bool), 1e-3, f"first moment {i}")
        close_where(got.gauss.xyz_grad_accum, want.gauss.xyz_grad_accum.numpy(),
                    np.ones(128, bool), 1e-3, "xyz_grad_accum")
        assert torch.equal(got.gauss.denom, want.gauss.denom)
        assert torch.equal(got.gauss.max_radii2d, want.gauss.max_radii2d)
    assert float(want.gauss.denom.max()) == 2.0           # both views see some Gaussians
    assert torch.equal(res[0]["ts"].gauss.params.xyz, res[1]["ts"].gauss.params.xyz)
