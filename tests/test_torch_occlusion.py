"""Port vs JAX package: occlusion — SH volumes and the ambient-occlusion bake
(mygauhuman_torch/occlusion/).

Tolerances, each stated where it is used:
  * SH bases, interpolation, reconstruction and the volumes: 1e-5 (float32,
    the same formulas); their gradients within 1e-4 of the largest
    |jax.grad|;
  * the voxel grid: cell indices, occupancy and the cell ranking exact,
    centers 1e-6;
  * the bake's visibility before quantizing: 1e-5 (each face is one
    rasterize through the spec blend on both sides), the out-of-budget count
    and the sweep count exact;
  * the batched sweep, its faces' projection and binning, and kernel C's
    plain version over stacked faces: bit for bit against the per-cell
    program and each face's own calls.
Sizes: 300 alive Gaussians at capacity 320, bake grid_res 3-4, face_res 16,
latlong 8 x 16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygauhuman_tpu.occlusion import baking as JBK
from mygauhuman_tpu.occlusion import volumes as JV
from mygauhuman_tpu.ops.rasterize import RasterizerConfig as JRasterizerConfig
from mygauhuman_tpu.utils.transforms import covariance_from_scaling_rotation, strip_symmetric
from mygauhuman_torch.occlusion import baking as TBK
from mygauhuman_torch.occlusion import volumes as TV
from mygauhuman_torch.ops.rasterize import RasterizerConfig

torch.set_num_threads(1)
ATOL = 1e-5
GRAD_RTOL = 1e-4


def t(a):
    return torch.as_tensor(np.array(a))


def close(got, want, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol, err_msg=msg)


def unit(rng, n):
    d = rng.randn(n, 3).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


# ---- SH volumes ---------------------------------------------------------------------

@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_components_match_jax(degree):
    d = unit(np.random.RandomState(degree), 200)
    close(TV.sh_components(degree, t(d)), JV.sh_components(degree, jnp.asarray(d)))


def test_envmap_from_sh_and_dilate_match_jax():
    rng = np.random.RandomState(1)
    coeffs = rng.randn(2, 9, 3).astype(np.float32)
    dirs = unit(rng, 8 * 16).reshape(8, 16, 3)
    close(TV.reconstruct_envmap_from_sh(t(coeffs), t(dirs)),
          JV.reconstruct_envmap_from_sh(jnp.asarray(coeffs), jnp.asarray(dirs)))
    ids = np.where(rng.rand(5, 5, 5) > 0.7, rng.randint(0, 50, (5, 5, 5)), -1).astype(np.int32)
    for it in (1, 2):
        np.testing.assert_array_equal(TV.dilate_occlusion_ids(t(ids), it).numpy(),
                                      np.asarray(JV.dilate_occlusion_ids(jnp.asarray(ids), it)))


def test_trilinear_interpolation_and_gradients_match_jax():
    rng = np.random.RandomState(2)
    grid = rng.randn(5, 5, 5, 4, 2).astype(np.float32)
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    pts = (rng.rand(60, 3) * 2.4 - 1.2).astype(np.float32)     # some outside the box
    close(TV.trilinear_interpolate(t(grid), t(aabb), t(pts)),
          JV.trilinear_interpolate(jnp.asarray(grid), jnp.asarray(aabb), jnp.asarray(pts)))
    cot = rng.randn(60, 4, 2).astype(np.float32)
    jg = jax.grad(lambda g, p: jnp.sum(JV.trilinear_interpolate(g, jnp.asarray(aabb), p) * cot),
                  argnums=(0, 1))(jnp.asarray(grid), jnp.asarray(pts))
    g_t = t(grid).requires_grad_(True)
    p_t = t(pts).requires_grad_(True)
    tg = torch.autograd.grad((TV.trilinear_interpolate(g_t, t(aabb), p_t) * t(cot)).sum(),
                             (g_t, p_t))
    for name, a, b in zip(("grid", "points"), tg, jg):
        close(a, b, GRAD_RTOL * float(np.abs(np.asarray(b)).max()), name)


def test_sparse_interpolation_and_recon_match_jax():
    rng = np.random.RandomState(3)
    res = 4
    ids = np.where(rng.rand(res, res, res) > 0.3, np.arange(res ** 3).reshape(res, res, res),
                   -1).astype(np.int32)
    coeffs = (rng.rand(res ** 3, 16, 1) * 0.6).astype(np.float32)
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    pts = (rng.rand(40, 3) * 1.8 - 0.9).astype(np.float32)
    nrm = unit(rng, 40)
    args_j = [jnp.asarray(a) for a in (coeffs, ids, aabb, pts)]
    args_t = [t(a) for a in (coeffs, ids, aabb, pts)]
    close(TV.sparse_interpolate_coefficients(*args_t),
          JV.sparse_interpolate_coefficients(*args_j))
    rough = rng.rand(40, 1).astype(np.float32)
    c = rng.randn(40, 16, 1).astype(np.float32)
    close(TV.sh_reconstruction(t(c), t(nrm), t(rough), 64),
          JV.sh_reconstruction(jnp.asarray(c), jnp.asarray(nrm), jnp.asarray(rough), 64))
    close(TV.recon_occlusion(t(pts), t(nrm), t(coeffs), t(ids), t(aabb), 1.0, 64),
          JV.recon_occlusion(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(coeffs),
                             jnp.asarray(ids), jnp.asarray(aabb), 1.0, 64))


def test_irradiance_volumes_match_jax():
    rng = np.random.RandomState(4)
    aabb = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]
    tv = TV.init_irradiance_volumes(aabb, grid_res=6, device="cpu")
    jv = JV.init_irradiance_volumes(aabb, grid_res=6)
    close(tv.coefficients, jv.coefficients, 0)
    close(tv.aabb, jv.aabb, 0)
    coeffs = (rng.rand(6, 6, 6, 9, 1) + 0.2).astype(np.float32)
    pts = (rng.rand(30, 3) * 2 - 1).astype(np.float32)
    nrm = unit(rng, 30)
    jq = lambda c: JV.query_irradiance(jv._replace(coefficients=c), jnp.asarray(pts),  # noqa: E731
                                       jnp.asarray(nrm))
    c_t = t(coeffs).requires_grad_(True)
    got = TV.query_irradiance(tv._replace(coefficients=c_t), t(pts), t(nrm))
    close(got, jq(jnp.asarray(coeffs)))
    jg = jax.grad(lambda c: jnp.sum(jq(c)))(jnp.asarray(coeffs))
    (tg,) = torch.autograd.grad(got.sum(), c_t)
    close(tg, jg, GRAD_RTOL * float(np.abs(np.asarray(jg)).max()))


# ---- voxel grid and bake --------------------------------------------------------------

def _cloud(seed=5, n=300, cap=320):
    """A seeded cloud of two clusters (a body and an occluding slab above
    it) with 20 dead slots: world positions, covariances, opacities,
    normals, alive."""
    rng = np.random.RandomState(seed)
    body = rng.randn(n - 60, 3) * np.array([0.25, 0.45, 0.2])
    slab = rng.randn(60, 3) * np.array([0.3, 0.05, 0.3]) + np.array([0.0, 0.8, 0.0])
    pts = np.concatenate([body, slab, rng.randn(cap - n, 3) * 5.0]).astype(np.float32)
    scales = (rng.rand(cap, 3) * 0.06 + 0.03).astype(np.float32)
    quats = rng.randn(cap, 4).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    cov6 = np.asarray(strip_symmetric(covariance_from_scaling_rotation(
        jnp.asarray(scales), jnp.asarray(quats))))
    opac = (rng.rand(cap) * 0.6 + 0.35).astype(np.float32)
    alive = np.arange(cap) < n
    return pts, cov6, opac, unit(rng, cap), alive


def test_voxel_grid_and_cell_ranking_match_jax():
    pts, _, _, _, alive = _cloud()
    for res in (3, 4, 10):
        jg = JBK.pc_to_grid(jnp.asarray(pts), jnp.asarray(alive), res)
        tg = TBK.pc_to_grid(t(pts), t(alive), res)
        np.testing.assert_array_equal(tg.cell_of_point.numpy(), np.asarray(jg.cell_of_point))
        np.testing.assert_array_equal(tg.occupied.numpy(), np.asarray(jg.occupied))
        close(tg.centers, jg.centers, 1e-6)
        np.testing.assert_array_equal(TBK.rank_cells(tg.occupied).numpy(),
                                      np.asarray(jnp.argsort(~jg.occupied)))
        assert TBK.count_occupied(t(pts), t(alive), res) == int(
            JBK.count_occupied(jnp.asarray(pts), jnp.asarray(alive), res))


def test_face_cameras_match_the_jax_sweep():
    """The w2c of each face is the JAX sweep's R_c2w^T | -R_c2w^T c."""
    c = np.array([0.3, -0.2, 0.7], np.float32)
    cams = TBK.face_cameras(c[None])
    for s in range(6):
        right, down, fwd = JBK._face_camera_axes(s)
        R = np.stack([right, down, fwd], axis=1).astype(np.float32)
        np.testing.assert_array_equal(cams[0, s, 0, :3, :3], R.T)
        np.testing.assert_allclose(cams[0, s, 0, :3, 3], -(R.T @ c), rtol=0, atol=1e-7)


BAKE_KW = dict(height=8, width=16, face_res=16)
JCFG = JRasterizerConfig(tile_capacity=256, chunk_tiles=4, max_tiles_per_gaussian=4)
TCFG = RasterizerConfig(tile_capacity=256, chunk_tiles=4, max_tiles_per_gaussian=4)


@pytest.mark.parametrize("grid_res,max_cells", [(3, 27), (4, 10)],
                         ids=["every_cell", "starved_budget"])
def test_bake_occlusion_matches_jax(grid_res, max_cells):
    cloud = _cloud()
    want, want_oob = JBK.bake_occlusion(*[jnp.asarray(a) for a in cloud], grid_res=grid_res,
                                        max_cells=max_cells, config=JCFG, **BAKE_KW)
    got, got_oob = TBK.bake_occlusion(*[t(a) for a in cloud], grid_res=grid_res,
                                      max_cells=max_cells, config=TCFG, **BAKE_KW)
    assert got_oob == int(want_oob)
    assert (got_oob > 0) == (max_cells < TBK.count_occupied(t(cloud[0]), t(cloud[4]), grid_res))
    close(got, want)
    # quantized as train_loop_pbr caches it (round half to even on both sides)
    q_t = torch.round(got * 255.0).to(torch.uint8).numpy()
    q_j = np.asarray(jnp.round(want * 255.0).astype(jnp.uint8))
    assert int((q_t != q_j).sum()) <= 2, int((q_t != q_j).sum())
    if got_oob == 0:   # the body under the slab sees less looking up (+y)
        assert float(got[:240, 0:2].mean()) < float(got[:240].mean())


def test_bake_occlusion_full_matches_jax():
    cloud = _cloud(6)
    want, want_oob, want_sweeps = JBK.bake_occlusion_full(
        *[jnp.asarray(a) for a in cloud], grid_res=4, sweep_cells=5, config=JCFG, **BAKE_KW)
    got, got_oob, got_sweeps = TBK.bake_occlusion_full(
        *[t(a) for a in cloud], grid_res=4, sweep_cells=5, config=TCFG, **BAKE_KW)
    assert got_sweeps == want_sweeps > 1
    assert got_oob == int(want_oob) == 0
    close(got, want)
    # the sweeps bake what one window over every cell bakes
    one, one_oob = TBK.bake_occlusion(*[t(a) for a in cloud], grid_res=4, max_cells=64,
                                      config=TCFG, **BAKE_KW)
    assert one_oob == 0 and torch.equal(one, got)


def test_device_face_cameras_are_the_host_ones():
    """The sweep's face cameras, built from the cells' centers with device
    ops, are `face_cameras`' numbers bit for bit."""
    c = np.random.RandomState(2).randn(40, 3).astype(np.float32)
    np.testing.assert_array_equal(TBK.face_cameras_torch(t(c)).numpy(), TBK.face_cameras(c))


def test_bake_sweep_with_a_clamped_window_matches_jax():
    """Two sweeps of 36 over 39 occupied cells of 64: the second window's
    offset is clamped to res^3 - max_cells = 28, and the window holds 25
    cells that are not occupied. The sweep alone and the whole bake against
    the JAX package's."""
    cloud = _cloud(5)
    grid_res, m = 4, 36
    n_occ = TBK.count_occupied(t(cloud[0]), t(cloud[4]), grid_res)
    assert n_occ == 39 and 2 * m > grid_res ** 3
    jargs, targs = [jnp.asarray(a) for a in cloud], [t(a) for a in cloud]
    kw = dict(grid_res=grid_res, max_cells=m, **BAKE_KW)
    vis0 = np.ones((cloud[0].shape[0], 8, 16, 1), np.float32)
    jv, jn = JBK._bake_sweep(*jargs[:3], jargs[4], jnp.asarray(vis0), jnp.int32(m), config=JCFG,
                             **kw)
    tv, tn = TBK._bake_sweep(*targs[:3], targs[4], t(vis0), m, config=TCFG, **kw)
    assert int(tn) == int(jn) == 0
    close(tv, jv)
    assert not torch.equal(tv, t(vis0))
    want, want_oob, want_sweeps = JBK.bake_occlusion_full(
        *jargs, grid_res=grid_res, sweep_cells=m, config=JCFG, **BAKE_KW)
    got, got_oob, got_sweeps = TBK.bake_occlusion_full(
        *targs, grid_res=grid_res, sweep_cells=m, config=TCFG, **BAKE_KW)
    assert got_sweeps == want_sweeps == 2 and int(got_oob) == int(want_oob) == 0
    close(got, want)


@pytest.mark.parametrize("offset,face_res,group_cells", [
    (0, 16, None), (36, 16, None), (0, 32, None), (36, 32, None), (0, 32, 10), (36, 32, 4)],
    ids=["first_16", "clamped_16", "first_32", "clamped_32", "grouped_first_32",
         "grouped_clamped_32"])
def test_batched_sweep_is_the_per_cell_program_bit_for_bit(offset, face_res, group_cells,
                                                           monkeypatch):
    """A sweep of 36 of the 64 cells (39 occupied) as the batched program
    (`_bake_cells`: every face of the window's occupied cells projected,
    binned in one sort and blended by one plain-blend call per group)
    against the per-cell program (`eager=True`: one `rasterize` a face)
    bit for bit: the first window, and the second, whose offset clamps to
    28 and which holds 25 unoccupied cells; faces of 1 and 4 tiles; groups
    of `group_cells` cells where GROUP_SLOTS is cut to hold that many."""
    from mygauhuman_torch.utils.profiling import COUNTERS

    cloud = _cloud(5)
    args = [t(a) for a in cloud]
    if group_cells:
        monkeypatch.setattr(TBK, "GROUP_SLOTS", 6 * 320 * 4 * group_cells)
    kw = dict(height=8, width=16, face_res=face_res, grid_res=4, max_cells=36, config=TCFG)
    vis0 = torch.ones((320, 8, 16, 1))
    want, want_n = TBK._bake_sweep(*args[:3], args[4], vis0, offset, eager=True, **kw)
    COUNTERS.clear()
    got, got_n = TBK._bake_sweep(*args[:3], args[4], vis0, offset, **kw)
    assert torch.equal(got, want) and int(got_n) == int(want_n)
    occupied = 36 if offset == 0 else 39 - 28
    assert COUNTERS["mgh.pbr.faces"] == 6 * occupied
    assert COUNTERS["mgh.pbr.face_batches"] == -(-occupied // (group_cells or occupied))
    assert float((1.0 - got).max()) > 0.5


def _window_faces(face_res, n_cells=5):
    """The six faces of the first n_cells occupied cells of the cloud's 4^3
    grid: (points, opacities, faces' projection as `_bake_cells` makes
    it, alive & visible [F, N], face cameras [F, 2, 4, 4])."""
    pts, cov6, opac, _, alive = [t(a) for a in _cloud(5)]
    grid = TBK.pc_to_grid(pts, alive, 4)
    cells = torch.nonzero(grid.occupied).reshape(-1)[:n_cells]
    cams = TBK.face_cameras_torch(grid.centers[cells]).reshape(-1, 2, 4, 4)
    proj = TBK._project_faces(pts, cov6, cams, face_res)
    return pts, cov6, opac, proj, proj.visible & alive, cams


@pytest.mark.parametrize("face_res", [16, 32])
def test_bin_faces_is_each_faces_projection_and_bin_gaussians(face_res):
    """The batched bake's projection of 30 stacked faces is `preprocess`
    of each face bit for bit, and `bin_faces` of them is `bin_gaussians`
    of each face alone (every instance kept): the same tile counts, and
    each tile's slice of the sorted instances the same Gaussians in the
    same order."""
    from mygauhuman_torch.ops.binning import bin_faces, bin_gaussians
    from mygauhuman_torch.ops.projection import preprocess

    pts, cov6, _, proj, visible, cams = _window_faces(face_res)
    F, N = visible.shape
    S = TCFG.max_tiles_per_gaussian
    lists = bin_faces(proj.means2d, proj.radii, proj.depths, visible, width=face_res,
                      height=face_res, max_tiles_per_gaussian=S)
    T = (face_res // 16) ** 2
    assert lists.starts.shape == (F * T,) and lists.src.shape == (F * S * N,)
    for f in range(F):
        one = preprocess(pts, cov6, cams[f, 0], cams[f, 1], face_res, face_res, 1.0, 1.0)
        for name, got in proj._asdict().items():
            assert torch.equal(got[f], getattr(one, name)), (f, name)
        b = bin_gaussians(one.means2d, one.radii, one.depths, visible[f], width=face_res,
                          height=face_res, max_tiles_per_gaussian=S, tile_capacity=N)
        assert torch.equal(lists.counts[f * T:(f + 1) * T], b.counts.long()), f
        for tile in range(T):
            s0, c, w0 = int(lists.starts[f * T + tile]), int(b.counts[tile]), int(b.starts[tile])
            assert torch.equal(lists.src[s0:s0 + c] - f * N, b.sorted_gid[w0:w0 + c].long())
    assert int(lists.counts.sum()) > 1000


def test_plain_kernel_c_of_stacked_faces_is_each_faces_launch():
    """Kernel C's plain version over 30 faces' tiles at 4 tiles an image
    (`tiles_per_image`, the bake's launch) is each face's own 4-tile launch
    bit for bit; a launch that does not hold whole images from tile 0, and
    checkpoints of several images, are refused."""
    from mygauhuman_torch.ops import pallas_blend as tpb
    from mygauhuman_torch.ops.binning import bin_faces

    _, _, opac, proj, visible, _ = _window_faces(32)
    F, N = visible.shape
    lists = bin_faces(proj.means2d, proj.radii, proj.depths, visible, width=32, height=32,
                      max_tiles_per_gaussian=TCFG.max_tiles_per_gaussian)
    data = tpb.attr_matrix(proj.means2d.reshape(-1, 2), proj.conics.reshape(-1, 3),
                           opac.expand(F, N).reshape(-1), proj.depths.reshape(-1),
                           torch.zeros((F * N, 1)), pad=False)[:, lists.src]
    assert data.shape[0] == tpb.HDR + 1
    kw = dict(tiles_x=2, n_channels=1)
    got = tpb.blend_instances_plain(data, lists.starts, lists.counts, 0, n_tiles=4 * F,
                                    tiles_per_image=4, **kw)
    want = torch.cat([tpb.blend_instances_plain(data, lists.starts[4 * f:4 * f + 4],
                                                lists.counts[4 * f:4 * f + 4], 0, n_tiles=4,
                                                **kw) for f in range(F)])
    assert torch.equal(got, want)
    assert float(got[:, 1].max()) > 0.5
    with pytest.raises(ValueError, match="whole images"):
        tpb.blend_instances_plain(data, lists.starts[:6], lists.counts[:6], 0, n_tiles=6,
                                  tiles_per_image=4, **kw)
    with pytest.raises(ValueError, match="one image"):
        tpb.blend_instances_plain(data, lists.starts, lists.counts, 0, n_tiles=4 * F,
                                  tiles_per_image=4, checkpoints=True, **kw)


def test_occlusion_color_matches_jax():
    rng = np.random.RandomState(7)
    occ = rng.rand(20, 8, 16, 1).astype(np.float32)
    env = (rng.rand(8, 16, 1) * 0.02).astype(np.float32)
    close(TBK.occlusion_color(t(occ)), JBK.occlusion_color(jnp.asarray(occ)), 1e-4)
    close(TBK.occlusion_color(t(occ), t(env)),
          JBK.occlusion_color(jnp.asarray(occ), jnp.asarray(env)))
