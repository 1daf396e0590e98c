"""The port's tile-sharded rasterizer (mygauhuman_torch/parallel/raster.py)
against the JAX package's (parallel/raster.py), the cases of
tests/test_raster_sharded.py.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py, its
kernels in interpret mode. The port runs its ranks as processes over gloo
(`parallel/dryrun.py::launch`, a `file://` store under tmp_path), on the
same mesh shapes, from the same seeded numpy inputs; the ranks write their
results and this process compares them. Every rank passes the whole scene
and gets the whole output and gradient (`rasterize_sharded`), so every
rank's result is checked.

The forward and the gradients are held against the JAX rasterize_sharded
on the same 2 x 2 mesh; the planar and truncation cases, as the JAX test
holds its own, against the single-device JAX rasterize (its jnp path).

Tolerances, the JAX test's: image, alpha and final_t within 2e-5, depth
within 1e-4, radii and counters equal; gradients within rtol 1e-4 + atol
1e-5 (both packages sum per-instance rows per Gaussian in their own order).
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygauhuman_tpu.data.camera import make_camera
from mygauhuman_tpu.ops.projection import compute_cov3d
from mygauhuman_tpu.ops.rasterize import RasterizerConfig as JRasterizerConfig
from mygauhuman_tpu.ops.rasterize import rasterize as jax_rasterize
from mygauhuman_tpu.parallel.mesh import make_hybrid_mesh as jax_hybrid_mesh
from mygauhuman_tpu.parallel.raster import rasterize_sharded as jax_sharded
from mygauhuman_torch.ops.rasterize import RasterizerConfig
from mygauhuman_torch.parallel.dryrun import launch
from mygauhuman_torch.parallel.mesh import hybrid_mesh_shape
from mygauhuman_torch.parallel.raster import strip_planar_ok

torch.set_num_threads(1)
CPU = "cpu"


def make_scene(n=64, seed=0, width=64, height=48, squeeze=False):
    """tests/test_raster_sharded.py's scene: numpy inputs and the JAX
    camera and covariances."""
    rng = np.random.default_rng(seed)
    cam = make_camera(R=np.eye(3), t=np.zeros(3), width=width, height=height,
                      fovx=np.deg2rad(60), fovy=np.deg2rad(50))
    pts = np.concatenate([rng.uniform(-0.8, 0.8, size=(n, 2)),
                          2.0 + rng.uniform(size=(n, 1))], axis=-1).astype(np.float32)
    scales = np.exp(rng.uniform(np.log(0.02), np.log(0.1), size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, size=(n,)).astype(np.float32)
    feat = rng.uniform(size=(n, 3)).astype(np.float32)
    if squeeze:   # all of them in about one tile: one deep list
        pts[:, :2] *= 0.05
    cov6 = np.asarray(compute_cov3d(jnp.asarray(scales), jnp.asarray(quats)))
    return cam, dict(means3d=pts, cov3d6=cov6, opacities=opac, features=feat)


def jax_run(cam, x, cfg, shape=None, **kw):
    """JAX rasterize_sharded on a ("gauss", "tiles") mesh of `shape` (None:
    the single-device rasterize), with the loss case_raster differentiates:
    its outputs and its gradients."""
    geo = dict(width=cam.width, height=cam.height, tan_fovx=float(cam.tan_fovx),
               tan_fovy=float(cam.tan_fovy), config=cfg, **kw)
    if shape is not None:
        geo["mesh"] = jax.sharding.Mesh(
            np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(shape), ("gauss", "tiles"))
    fn = jax_rasterize if shape is None else jax_sharded
    args = [jnp.asarray(x[k]) for k in ("means3d", "cov3d6")]
    w2c, proj = jnp.asarray(cam.w2c), jnp.asarray(cam.full_proj)
    n = x["means3d"].shape[0]

    def loss(op, ft, off):
        o = fn(*args, op, ft, w2c, proj, jnp.zeros(3), means2d_offset=off, **geo)
        return (jnp.sum((o.image - 0.3) ** 2) + jnp.sum(o.alpha ** 2)
                + 0.1 * jnp.sum(o.depth)), o

    (_, out), g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x["opacities"]), jnp.asarray(x["features"]), jnp.zeros((n, 2)))
    return out, g


def port_run(tmp_path, cam, x, cfg, shape, grads=True, **kw):
    """The port's ranks on mesh (1, *shape): each rank's results."""
    camd = dict(width=cam.width, height=cam.height, tan_fovx=float(cam.tan_fovx),
                tan_fovy=float(cam.tan_fovy))
    scene = {k: torch.as_tensor(np.array(v)) for k, v in x.items()}
    scene.update(w2c=torch.as_tensor(np.asarray(cam.w2c)),
                 full_proj=torch.as_tensor(np.asarray(cam.full_proj)), bg=torch.zeros(3))
    path = tmp_path / "raster_inputs.pt"
    torch.save(dict(scene=scene, camera=camd, config=cfg, grads=grads, **kw), path)
    return launch("raster", shape[0] * shape[1], tmp_path / "ranks", inputs=path,
                  mesh=(1,) + tuple(shape), device=CPU)


def assert_outputs(res, out, check_radii=True):
    for k, atol in (("image", 2e-5), ("alpha", 2e-5), ("depth", 1e-4), ("final_t", 2e-5)):
        np.testing.assert_allclose(res[k].numpy(), np.asarray(getattr(out, k)), rtol=0,
                                   atol=atol, err_msg=k)
    if check_radii:
        np.testing.assert_array_equal(res["radii"].numpy(), np.asarray(out.radii))


def assert_grads(res, g):
    for name, want in zip(("g_opacities", "g_features", "g_offset"), g):
        np.testing.assert_allclose(res[name].numpy(), np.asarray(want), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The 64 x 48 scene on a 2 x 2 raster mesh (T = 12 tiles, strips of 3:
    the tile-major path), in both packages, with gradients."""
    cam, x = make_scene()
    cfg_j = JRasterizerConfig(pallas_interpret=True)
    out, g = jax_run(cam, x, cfg_j, (2, 2))
    res = port_run(tmp_path_factory.mktemp("raster4"), cam, x, RasterizerConfig(), (2, 2))
    return out, g, res


def test_forward_matches_jax_on_every_rank(four_ranks):
    out, _, res = four_ranks
    assert not strip_planar_ok(3, 4, 16, 16)
    for r in res:
        assert_outputs(r, out)
        assert int(r["overflow_inst"]) == int(out.overflow_inst) == 0
        assert torch.equal(r["image"], res[0]["image"])   # every rank holds the same image
        assert r["jax_imported"] is False
    assert float(out.alpha.max()) > 0.5


def test_gradients_match_jax(four_ranks):
    out, g, res = four_ranks
    for r in res:
        assert_grads(r, g)
        assert torch.equal(r["g_opacities"], res[0]["g_opacities"])
    assert float(np.abs(np.asarray(g[0])).max()) > 1e-2


def test_means2d_offset_gradients_route_back(four_ranks):
    """d loss / d means2d_offset lands on every Gaussian's own rank (the
    densify statistics' input) and matches the JAX package's."""
    _, g, res = four_ranks
    off = res[0]["g_offset"].numpy()
    assert np.isfinite(off).all() and np.abs(off).sum() > 0
    np.testing.assert_allclose(off, np.asarray(g[2]), rtol=1e-4, atol=1e-5)


def test_bounded_exchange_counts_overflow(tmp_path):
    """exchange_capacity=2 drops instances and counts them (the sum over the
    ranks of each window's excess, the same on every rank)."""
    cam, x = make_scene()
    res = port_run(tmp_path, cam, x, RasterizerConfig(), (2, 2), grads=False,
                   exchange_capacity=2)
    assert int(res[0]["overflow_inst"]) > 0
    assert all(int(r["overflow_inst"]) == int(res[0]["overflow_inst"]) for r in res)


def test_exchange_truncation_drops_deepest_per_tile(tmp_path):
    """With K = 4 and an exchange window of 4K (strips of 4 tiles), a deep
    stack of ~64 instances that the uncapped window would overflow loses
    only what the K cap drops (its deepest instances per tile), as the
    single-device rasterizer does: the image matches, nothing is counted as
    an exchange drop, and the K-cap count is the single-device one. At
    80 x 48 (15 tiles) the last strip runs one tile past the grid; that
    tile is empty, so the exchange's padding (tile id T) is not counted.
    (The JAX rasterize_sharded blends that padding into the phantom tile
    and counts it in overflow_tiles: ROADMAP Queue 3.)"""
    cam, x = make_scene(seed=3, width=80, squeeze=True)
    out, _ = jax_run(cam, x, JRasterizerConfig(tile_capacity=4))
    res = port_run(tmp_path, cam, x, RasterizerConfig(tile_capacity=4), (2, 2), grads=False,
                   exchange_capacity=16)
    for r in res:
        assert int(r["overflow_inst"]) == 0
        assert int(r["overflow_tiles"]) == int(out.overflow_tiles) > 0
        assert_outputs(r, out)


def test_planar_strips_selected_and_match_jax(tmp_path):
    """128 x 128 on 2 ranks: strips of 4 whole tile rows take the planar
    layout (kernel C's planar output at tile_base 32 on rank 1); forward
    and gradients as the JAX package's single-device ones."""
    assert strip_planar_ok(32, 8, 16, 16)
    cam, x = make_scene(seed=5, width=128, height=128)
    out, g = jax_run(cam, x, JRasterizerConfig())
    res = port_run(tmp_path, cam, x, RasterizerConfig(), (1, 2))
    for r in res:
        assert_outputs(r, out)
        assert_grads(r, g)


@pytest.mark.parametrize("world,local", [(2, 2), (4, 4), (8, 8), (4, 2), (8, 4)])
def test_hybrid_mesh_axis_sizes(world, local):
    """make_hybrid_mesh's sizes: "data" spans the hosts, the local ranks
    split evenly between "gauss" and "tiles" (JAX's rule; on one host of 8
    the JAX mesh over the 8 virtual devices)."""
    shape = hybrid_mesh_shape(world, local)
    assert shape[0] == world // local and shape[1] * shape[2] == local
    assert shape[1] <= shape[2] <= 2 * shape[1]
    if (world, local) == (8, 8):
        assert shape == tuple(jax_hybrid_mesh().shape.values())


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of the port, parallel/ included, and not chip_smoke.py
    imports jax or mygauhuman_tpu (the ranks above also report that neither
    was loaded)."""
    repo = Path(__file__).resolve().parents[1]
    files = sorted((repo / "mygauhuman_torch").rglob("*.py")) + [repo / "chip_smoke.py"]
    assert any(f.parent.name == "parallel" for f in files)
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "mygauhuman_tpu"), (f, name)


def test_single_process_meshes():
    """One process, no launcher: init_distributed is a no-op and every
    group has one rank (the collectives are the identity)."""
    from mygauhuman_torch.parallel.mesh import Mesh, init_distributed, make_mesh, psum

    rt = init_distributed(device="cpu")
    assert rt.world_size == 1 and rt.backend is None
    m = make_mesh(rt=rt)
    assert m.shape == {"data": 1, "gauss": 1} and m.rank_coords == {"data": 0, "gauss": 0}
    mesh = Mesh((1, 1, 1), rt=rt)
    g = mesh.group(("gauss", "tiles"))
    assert (g.size, g.index) == (1, 0)
    x = torch.arange(3.0)
    assert torch.equal(psum(x, g), x)
