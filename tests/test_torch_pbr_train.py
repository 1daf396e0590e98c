"""Port vs JAX package: PBR training branch B (mygauhuman_torch/train/pbr.py).
The entry points past `--pbr_iteration` and with `--relight` are
tests/test_torch_pbr_cli.py's.

Tolerances, each stated where it is used:
  * compute_losses_pbr on the same G-buffers: each term within 1e-5
    relative, its gradients (light, albedo / roughness G-buffers, per-point
    materials) within 1e-4 of the largest |jax.grad|;
  * one step from the same state (interop.train_state / interop.pbr_state):
    metrics 1e-4 relative, every leaf of the state after the step within
    1e-4 of its largest value (the render chain runs in float32 on both
    sides in other orders), but for at most 2 entries of the roughness
    leaves (the LUT's bilinear kinks; those within 1e-3); geometry
    bit-equal to the input;
  * the 4-iteration loop: the same view order and bake count, losses within
    1e-3 relative (the baked maps pass through uint8, where a texel may
    round the other way).
Sizes: 48^2, 150 Gaussians at capacity 256, light base_res 16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygauhuman_tpu.config import OptimizationConfig as JOptCfg
from mygauhuman_tpu.data.synthetic import make_synthetic_scene as jscene
from mygauhuman_tpu.models.mlps import init_lbs_offset as jinit_lbs, init_pose_refiner as jinit_pose
from mygauhuman_tpu.occlusion import baking as JBK
from mygauhuman_tpu.pbr.light import prefilter_weight_set as jprefilter
from mygauhuman_tpu.pbr.shade import compute_brdf_lut as jlut
from mygauhuman_tpu.train import pbr as JPB
from mygauhuman_tpu.train import trainer as JT
from mygauhuman_torch import interop
from mygauhuman_torch.config import OptimizationConfig
from mygauhuman_torch.data.camera import Camera
from mygauhuman_torch.occlusion import baking as TBK
from mygauhuman_torch.ops.rasterize import RasterizerConfig
from mygauhuman_torch.pbr.light import prefilter_weight_set
from mygauhuman_torch.render import FrameInputs
from mygauhuman_torch.train import optim as TO
from mygauhuman_torch.train import pbr as TPB
from mygauhuman_torch.train import trainer as TT

torch.set_num_threads(1)
CPU = "cpu"


def t(a):
    return torch.as_tensor(np.array(a))


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, rel, abs_=0.0, msg=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    atol = rel * float(np.abs(want).max(initial=0.0)) + abs_
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=msg)


KINK_ENTRIES = 2


def close_but(got, want, n_out, msg):
    """Within 1e-4 of the largest |want| at all but n_out entries, and those
    within 1e-3."""
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want)
    scale = float(np.abs(want).max(initial=0.0))
    assert int((err > 1e-4 * scale).sum()) <= n_out and float(err.max()) <= 1e-3 * scale, (
        msg, int((err > 1e-4 * scale).sum()), float(err.max()) / max(scale, 1e-30))


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
    """tests/test_pbr_training.py's setup in both packages: the JAX states
    carried into the port through interop."""
    js = jscene(n_views=2, width=48, height=48, n_verts=150, capacity=256)
    jcfg = JOptCfg(pbr_iteration=0)
    # seeded materials: no two neighbours share a value, so the smoothness
    # term's |a - b| is away from its kink (test_smoothness_tie_subgradient)
    rng = np.random.RandomState(0)
    mats = js.gt_state.params._replace(
        albedo=jnp.asarray(rng.randn(256, 3).astype(np.float32)),
        roughness=jnp.asarray(rng.randn(256, 1).astype(np.float32)))
    jts, jtx = JT.create_train_state(jcfg, js.gt_state._replace(params=mats),
                                     jinit_pose(jax.random.PRNGKey(0)),
                                     jinit_lbs(jax.random.PRNGKey(1)))
    jpbr, jltx = JPB.create_pbr_state(jcfg, base_res=16)
    cfg = OptimizationConfig(pbr_iteration=0)
    _, ltx = TPB.create_pbr_state(cfg, base_res=16, device=CPU)
    jstep = JPB.make_pbr_train_step(js.smpl_model, jtx, jltx, jcfg, js.raster_config,
                                    bg=jnp.zeros(3))
    return dict(js=js, jcfg=jcfg, jts=jts, jtx=jtx, jpbr=jpbr, jltx=jltx, jstep=jstep,
                cfg=cfg, tx=TO.Adam(cfg), ltx=ltx,
                smpl=interop.smpl_model(js.smpl_model, CPU), batches=port_batches(js),
                raster=RasterizerConfig(tile_capacity=512, chunk_tiles=16),
                ts=interop.train_state(as_np(jts), CPU),
                pbr=interop.pbr_state(as_np(jpbr), CPU))


def test_interop_states_and_knn3_match_jax(setup):
    s = setup
    assert s["pbr"].opt_state.count == 0
    for a, b in zip(TO.tree_leaves({"l": s["pbr"].light, "v": s["pbr"].volumes.coefficients}),
                    jax.tree_util.tree_leaves({"l": s["jpbr"].light,
                                               "v": s["jpbr"].volumes.coefficients})):
        assert torch.equal(a, t(b))
    np.testing.assert_array_equal(TPB.compute_knn3(s["ts"].gauss).numpy(),
                                  np.asarray(JPB.compute_knn3(s["jts"].gauss)))
    for jb, tb in zip(s["js"].batches, s["batches"]):
        close(TPB.canonical_view_dirs(tb.camera), JPB.canonical_view_dirs(jb.camera), 0, 1e-6)


class _Out:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_losses_pbr_terms_and_gradients_match_jax():
    rng = np.random.RandomState(0)
    H, W, cap = 24, 20, 64
    nrm = rng.randn(H, W, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    view = rng.randn(H, W, 3).astype(np.float32)
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    g = dict(world_normal=nrm * 0.5 + 0.5, albedo=rng.rand(H, W, 3).astype(np.float32),
             roughness=rng.rand(H, W).astype(np.float32),
             occlusion=rng.rand(H, W, 3).astype(np.float32),
             render_alpha=np.where(rng.rand(H, W) > 0.3, rng.rand(H, W), 0).astype(np.float32))
    gt = rng.rand(H, W, 3).astype(np.float32)
    bm = (rng.rand(H, W) > 0.2).astype(np.float32)
    base = (rng.rand(6, 16, 16, 3) * 1.2).astype(np.float32)
    alb = rng.rand(cap, 3).astype(np.float32)
    rough = rng.rand(cap, 1).astype(np.float32)
    alive = (rng.rand(cap) > 0.1).astype(np.float32)
    knn3 = np.stack([np.arange(cap), rng.randint(0, cap, cap), rng.randint(0, cap, cap)], 1)
    lut = np.asarray(jlut(32, 64))
    names = ("base", "albedo", "roughness", "albedo_pts", "rough_pts")

    def jloss(base_, albedo_, rough_img, alb_, rough_):
        out = _Out(**{k: jnp.asarray(v) for k, v in g.items()})
        out.albedo, out.roughness = albedo_, rough_img
        return JPB.compute_losses_pbr(out, _Out(gt_image=jnp.asarray(gt), bound_mask=jnp.asarray(bm)),
                                      {"base": base_}, alb_, rough_, jnp.asarray(alive),
                                      jnp.asarray(knn3), jnp.asarray(view), jnp.asarray(lut),
                                      None, jprefilter(16))

    jin = [jnp.asarray(a) for a in (base, g["albedo"], g["roughness"], alb, rough)]
    (_, jm), jg = jax.jit(jax.value_and_grad(jloss, argnums=tuple(range(5)),
                                             has_aux=True))(*jin)
    tin = [t(a).requires_grad_(True) for a in (base, g["albedo"], g["roughness"], alb, rough)]
    out = _Out(**{k: t(v) for k, v in g.items()})
    out.albedo, out.roughness = tin[1], tin[2]
    total, tm = TPB.compute_losses_pbr(out, _Out(gt_image=t(gt), bound_mask=t(bm)),
                                       {"base": tin[0]}, tin[3], tin[4], t(alive), t(knn3),
                                       t(view), t(lut), None, prefilter_weight_set(16, CPU))
    for k in ("loss", "l1", "ssim", "brdf_tv", "entropy", "smooth", "lamb", "env_tv", "psnr"):
        close(tm[k], jm[k], 1e-5, 1e-8, k)
    tg = torch.autograd.grad(total, tin)
    for name, a, b in zip(names, tg, jg):
        assert float(np.abs(np.asarray(b)).max()) > 0, name
        close(a, b, 1e-4, 0, name)


def test_smoothness_tie_subgradient():
    """Queue 3: at the branch-B transition albedo and roughness are still
    their uniform init, so every |a - b| of the KNN smoothness term is 0.
    jnp.abs takes the subgradient 1 there, PyTorch's abs (the reference's)
    0: the JAX step moves the materials by the tie, the port does not."""
    from mygauhuman_tpu.train import losses as JL
    from mygauhuman_torch.train import losses as TL

    vals = np.full((8, 3), 0.5, np.float32)
    nn = np.full((8, 2, 3), 0.5, np.float32)
    jg = jax.grad(lambda v: JL.relative_smooth_loss(v, jnp.asarray(nn)))(jnp.asarray(vals))
    v = t(vals).requires_grad_(True)
    (tg,) = torch.autograd.grad(TL.relative_smooth_loss(v, t(nn)), v)
    assert float(jnp.abs(jg).min()) > 0 and float(tg.abs().max()) == 0.0


def test_pbr_step_matches_jax(setup):
    s = setup
    knn3 = JPB.compute_knn3(s["jts"].gauss)
    occ = np.random.RandomState(1).rand(256, 3).astype(np.float32)
    jstep = s["jstep"]
    jts2, jpbr2, jm = jstep(s["jts"], s["jpbr"], s["js"].batches[0], knn3, jnp.asarray(occ),
                            jprefilter(16), 0)
    step = TPB.make_pbr_train_step(s["smpl"], s["tx"], s["ltx"], s["cfg"], s["raster"],
                                   bg=torch.zeros(3))
    ts, pbr = s["ts"], s["pbr"]
    ts2, pbr2, m = step(ts, pbr, s["batches"][0], t(knn3).long(), t(occ),
                        prefilter_weight_set(16, CPU), 0)
    for k in ("loss", "l1", "ssim", "brdf_tv", "entropy", "smooth", "lamb", "env_tv", "psnr"):
        close(m[k], jm[k], 1e-4, 1e-8, k)
    want = interop.train_state(as_np(jts2), CPU)
    for f in ("albedo", "roughness", "normal"):
        # roughness reaches the loss through the BRDF LUT's bilinear weights
        # and the mip-level clamps, whose slopes jump at texel edges: a
        # G-buffer value 5e-7 off can take the other slope, so up to
        # KINK_ENTRIES of its entries may lie beyond 1e-4 (none beyond 1e-3)
        n_out = KINK_ENTRIES if f == "roughness" else 0
        close_but(getattr(ts2.gauss.params, f), getattr(want.gauss.params, f), n_out, f)
        for kind in ("mu", "nu"):
            close_but(getattr(getattr(ts2.opt_state, kind).gaussians, f),
                      getattr(getattr(want.opt_state, kind).gaussians, f), n_out, f"{kind} {f}")
    assert not torch.equal(ts2.gauss.params.albedo, ts.gauss.params.albedo)
    # geometry untouched: the parameters, moments and counts of its groups
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity"):
        assert torch.equal(getattr(ts2.gauss.params, f), getattr(ts.gauss.params, f)), f
        assert torch.equal(getattr(ts2.opt_state.mu.gaussians, f),
                           getattr(ts.opt_state.mu.gaussians, f)), f
    for a, b in zip(TO.tree_leaves((ts2.pose_refiner, ts2.lbs_offset)),
                    TO.tree_leaves((ts.pose_refiner, ts.lbs_offset))):
        assert torch.equal(a, b)
    assert ts2.opt_state.count["albedo"] == ts.opt_state.count["albedo"] + 1
    assert ts2.opt_state.count["xyz"] == ts.opt_state.count["xyz"] and ts2.step == ts.step + 1
    # the light and its optimizer
    wp = interop.pbr_state(as_np(jpbr2), CPU)
    close(pbr2.light["base"], wp.light["base"], 1e-4, 0, "light")
    assert float(pbr2.light["base"].min()) >= 0.0
    assert not torch.equal(pbr2.light["base"], pbr.light["base"])
    assert torch.equal(pbr2.volumes.coefficients, wp.volumes.coefficients)
    assert pbr2.opt_state.count == wp.opt_state.count == 1
    close(pbr2.opt_state.mu["light"]["base"], wp.opt_state.mu["light"]["base"], 1e-4)
    close(pbr2.opt_state.nu["light"]["base"], wp.opt_state.nu["light"]["base"], 1e-4)
    # the same step twice: the same bits
    ts3, pbr3, _ = step(ts, pbr, s["batches"][0], t(knn3).long(), t(occ),
                        prefilter_weight_set(16, CPU), 0)
    assert torch.equal(ts3.gauss.params.albedo, ts2.gauss.params.albedo)
    assert torch.equal(pbr3.light["base"], pbr2.light["base"])


def test_geometry_stays_frozen_where_the_jax_step_drifts(setup):
    """Queue 3: the JAX step feeds the frozen geometry groups zero gradients,
    so their branch-A momentum keeps moving them; the port's step leaves them
    as the reference's lr-0 freeze does. The state carries non-zero moments,
    as after branch A."""
    s = setup
    moments = lambda tree, v: jax.tree.map(  # noqa: E731
        lambda x: jnp.full_like(x, v) if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)
    adam = {g: st.inner_state[0] for g, st in s["jts"].opt_state.inner_states.items()}
    inner = {g: st._replace(inner_state=(adam[g]._replace(mu=moments(adam[g].mu, 1e-3),
                                                          nu=moments(adam[g].nu, 1e-6),
                                                          count=adam[g].count + 10),)
                            + tuple(st.inner_state[1:]))
             for g, st in s["jts"].opt_state.inner_states.items()}
    jts_a = s["jts"]._replace(opt_state=s["jts"].opt_state._replace(inner_states=inner))
    knn3 = JPB.compute_knn3(jts_a.gauss)
    occ = jnp.ones((256, 3))
    jts_b, _, _ = s["jstep"](jts_a, s["jpbr"], s["js"].batches[0], knn3, occ, jprefilter(16), 0)
    drift = float(jnp.abs(jts_b.gauss.params.xyz - jts_a.gauss.params.xyz).max())
    assert drift > 1e-6
    ts_a = interop.train_state(as_np(jts_a), CPU)
    step = TPB.make_pbr_train_step(s["smpl"], s["tx"], s["ltx"], s["cfg"], s["raster"],
                                   bg=torch.zeros(3))
    ts_b, _, _ = step(ts_a, s["pbr"], s["batches"][0], t(knn3).long(), t(occ),
                      prefilter_weight_set(16, CPU), 0)
    for f in ("xyz", "scaling", "rotation", "opacity", "features_dc"):
        assert torch.equal(getattr(ts_b.gauss.params, f), getattr(ts_a.gauss.params, f)), f


def test_train_loop_pbr_matches_jax(setup, monkeypatch):
    """4 iterations: JAX's view order (RandomState(seed + 7)), one full bake
    per camera visited, the same losses."""
    s = setup
    seen = {"jax": [], "port": []}
    bakes = {"jax": 0, "port": 0}

    def counting(module, who):
        orig = module.bake_occlusion_full

        def wrapper(*a, **k):
            bakes[who] += 1
            return orig(*a, **k)
        monkeypatch.setattr(module, "bake_occlusion_full", wrapper)

    counting(JBK, "jax")
    counting(TBK, "port")
    jstep = s["jstep"]
    jlog, tlog = [], []
    # 60 of the 150 Gaussians alive: fewer occupied cells to bake, the same
    # shapes (the JAX step compiled by the other tests is reused)
    jts = s["jts"]._replace(gauss=s["jts"].gauss._replace(alive=jnp.arange(256) < 60))
    ts = interop.train_state(as_np(jts), CPU)
    _, jpbr, _ = JPB.train_loop_pbr(
        jts, s["jpbr"],
        lambda ts, p, b, *a: (seen["jax"].append(id(b)), jstep(ts, p, b, *a))[1],
        s["js"].batches, s["js"].smpl_model, s["jcfg"], start_iteration=0, num_iterations=4,
        bake_height=8, bake_width=16, callback=lambda it, ts, p, m: jlog.append(float(m["loss"])))
    step = TPB.make_pbr_train_step(s["smpl"], s["tx"], s["ltx"], s["cfg"], s["raster"],
                                   bg=torch.zeros(3))
    _, pbr, m = TPB.train_loop_pbr(
        ts, s["pbr"],
        lambda ts, p, b, *a: (seen["port"].append(id(b)), step(ts, p, b, *a))[1],
        s["batches"], s["smpl"], s["cfg"], start_iteration=0, num_iterations=4,
        bake_height=8, bake_width=16, callback=lambda it, ts, p, m: tlog.append(float(m["loss"])))
    order = lambda ids, batches: [[id(b) for b in batches].index(i) for i in ids]  # noqa: E731
    assert order(seen["port"], s["batches"]) == order(seen["jax"], s["js"].batches)
    assert len(set(order(seen["port"], s["batches"]))) == 2
    assert bakes["port"] == bakes["jax"] == 2 and m["bake_out_of_budget"] == 0
    close(tlog, jlog, 1e-3)
    close(pbr.light["base"], jpbr.light["base"], 1e-3)
