"""The port's multi-host layout (mygauhuman_torch/parallel/mesh.py::
make_hybrid_mesh under emulated hosts, as parallel/dryrun.py::run_multihost
runs it) against the JAX package.

Hosts are emulated through LOCAL_WORLD_SIZE: 4 gloo ranks as 2 hosts of 2
lay "data" across the hosts, mesh (2, 1, 2), with no mesh forced by the
caller. One tile-sharded train step on that mesh is held against the JAX
step on the (2, 1, 2) mesh of the 8 virtual CPU devices, with
tests/test_torch_parallel_train.py's tolerances (the JAX step's moments over
n_data, its xyz_grad_accum over n_shards n_data: ROADMAP Queue 3). The dry
run (`dryrun_multichip`) lays its ranks out the same way: two "data" hosts.
"""
import math

import torch

from mygauhuman_torch.parallel.dryrun import dryrun_multichip, launch
from mygauhuman_torch.parallel.mesh import hybrid_mesh_shape
from test_torch_parallel_train import CPU, assert_step_matches_jax, jax_step_case

torch.set_num_threads(1)


def test_emulated_hosts_lay_data_across_hosts():
    assert hybrid_mesh_shape(4, 2) == (2, 1, 2)
    assert hybrid_mesh_shape(8, 4) == (2, 2, 2)
    assert hybrid_mesh_shape(4, 4) == (1, 2, 2)


def test_two_emulated_hosts_step_matches_jax(tmp_path):
    jts, want, jm, port, inputs = jax_step_case(tmp_path)
    res = launch("train_step", 4, tmp_path / "ranks", inputs=inputs, local_world=2,
                 device=CPU)
    for r in res:
        assert_step_matches_jax(r, want, jm, port)
        assert not r["jax_imported"]


def test_dryrun_multichip_on_four_ranks():
    """One tile-sharded branch-A step and one branch-B step on 4 ranks (mesh
    (2, 1, 2), as the JAX dry run's (2, 2, 2) on 8), at 64^2."""
    r = dryrun_multichip(4, device=CPU, size=64, verts=256)
    assert r["mesh"] == {"data": 2, "gauss": 1, "tiles": 2}
    assert math.isfinite(r["loss"]) and math.isfinite(r["pbr_loss"])
    assert not r["jax_imported"]
