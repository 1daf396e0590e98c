"""Port vs JAX package: branch-A training. Losses, LPIPS, the per-group Adam
and its slot helpers, the densify / prune / merge suite, one whole train
step, and the train loop's own checks (tests/test_train.py) on the port.

Tolerances, each stated where it is used:
  * losses, SSIM, PSNR, TV, expon_lr: 1e-5 relative (float32 rounding of the
    same formulas; SSIM's blur is a convolution here, banded matmuls there);
  * LPIPS: 3e-2 relative, because the JAX package runs the VGG trunk in bf16
    (about 3 significant digits) and the port in float32;
  * Adam against optax with the same gradients: 1e-6 relative plus 1e-9;
  * densify / prune / merge: masks and counters exact, parameters 1e-6;
  * the whole step: loss and metrics 1e-4 relative, each gradient leaf and
    the densify statistics within 1e-3 max|JAX| (the render chain runs in
    float32 on both sides with different reduction orders; measured errors
    are near 1e-6 of the leaf's scale); with an LPIPS term, the term's own
    share of each leaf (the gradient less the gradient without it) within
    LPIPS' gradient tolerance: cosine above 0.99, norm 3e-2 relative;
  * the port's LPIPS pairs apart against the four-image stack: the same bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mygauhuman_tpu.config import OptimizationConfig as JOptCfg
from mygauhuman_tpu.data.synthetic import make_synthetic_scene as jscene
from mygauhuman_tpu.eval import lpips as jlpips
from mygauhuman_tpu.models import gaussians as JG
from mygauhuman_tpu.models.mlps import init_lbs_offset as jinit_lbs, init_pose_refiner as jinit_pose
from mygauhuman_tpu.render import render_frame as jrender
from mygauhuman_tpu.train import losses as JL
from mygauhuman_tpu.train import optim as JO
from mygauhuman_tpu.train import trainer as JT
from mygauhuman_torch import interop
from mygauhuman_torch.config import OptimizationConfig
from mygauhuman_torch.data.camera import Camera
from mygauhuman_torch.data.synthetic import make_synthetic_scene
from mygauhuman_torch.eval import lpips as tlpips
from mygauhuman_torch.eval.metrics import evaluate_images
from mygauhuman_torch.models import gaussians as TG
from mygauhuman_torch.models.mlps import init_lbs_offset, init_pose_refiner
from mygauhuman_torch.ops.rasterize import RasterizerConfig
from mygauhuman_torch.render import FrameInputs, render_frame
from mygauhuman_torch.train import losses as TL
from mygauhuman_torch.train import optim as TO
from mygauhuman_torch.train import trainer as TT

torch.set_num_threads(1)


def t(a):
    return torch.as_tensor(np.array(a))


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, rel, abs_=0.0, msg=""):
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    atol = rel * float(np.abs(want).max(initial=0.0)) + abs_
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=msg)


# ---- losses -----------------------------------------------------------------

def _imgs(seed=0, h=24, w=20):
    rng = np.random.RandomState(seed)
    x = rng.rand(h, w, 3).astype(np.float32)
    y = np.clip(x + 0.1 * rng.randn(h, w, 3), 0, 1).astype(np.float32)
    m = (rng.rand(h, w) > 0.4).astype(np.float32)
    return x, y, m


LOSS_CASES = {
    "l1": lambda L, x, y, m: L.l1_loss(x, y),
    "l2": lambda L, x, y, m: L.l2_loss(x, y),
    "masked_l1": lambda L, x, y, m: L.masked_l1(x, y, m),
    "masked_l2_channels": lambda L, x, y, m: L.masked_l2(x, y, m),
    "masked_l2_plane": lambda L, x, y, m: L.masked_l2(x[..., 0], y[..., 0], m),
    "psnr": lambda L, x, y, m: L.psnr(x, y),
    "ssim": lambda L, x, y, m: L.ssim(x, y),
    "ssim_masked": lambda L, x, y, m: L.ssim(x, y, m),
    "ssim_map": lambda L, x, y, m: L.ssim_map(x, y),
    "tv": lambda L, x, y, m: L.tv_loss(x),
    "masked_tv": lambda L, x, y, m: L.masked_tv_loss(m, x),
    "entropy": lambda L, x, y, m: L.gaussian_entropy(x.reshape(-1, 3)),
    "smooth": lambda L, x, y, m: L.relative_smooth_loss(
        x.reshape(-1, 3)[:40], y.reshape(-1, 3)[:80].reshape(40, 2, 3), m.reshape(-1)[:40]),
    "predicted_normal": lambda L, x, y, m: L.predicted_normal_loss(x, y, m),
    "latent_kl": lambda L, x, y, m: L.latent_kl_loss(x.reshape(-1)[:320].reshape(10, 32) - 0.5),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_matches_jax(name):
    """1e-5 relative: the same formulas in float32."""
    x, y, m = _imgs()
    fn = LOSS_CASES[name]
    want = fn(JL, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m))
    got = fn(TL, t(x), t(y), t(m))
    close(got, want, 1e-5, 1e-7, name)


def test_ssim_window_and_gradient_match_jax():
    np.testing.assert_allclose(TL._gaussian_window(11, 1.5), JL._gaussian_window(11, 1.5),
                               rtol=1e-7)
    x, y, m = _imgs(1, 33, 17)
    want = jax.grad(lambda a: JL.ssim(a, jnp.asarray(y), jnp.asarray(m)))(jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    TL.ssim(xt, t(y), t(m)).backward()
    close(xt.grad, want, 1e-5, 1e-9)


@pytest.mark.parametrize("kw", [dict(), dict(lr_delay_steps=50, lr_delay_mult=0.01)])
def test_expon_lr_matches_jax(kw):
    for step in (0, 1, 7, 50, 99, 100, 150):
        want = float(JO.expon_lr(step, 1.6e-4, 1.6e-6, max_steps=100, **kw))
        got = TO.expon_lr(step, 1.6e-4, 1.6e-6, max_steps=100, **kw)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert TO.expon_lr(5, 0.0, 1.0) == 0.0


# ---- LPIPS --------------------------------------------------------------------

@pytest.fixture(scope="module")
def lp():
    jp = jlpips.init_lpips(jax.random.PRNGKey(0))
    return jp, interop.lpips_params(as_np(jp), device="cpu")


def test_lpips_random_backbone_matches_jax(lp):
    """3e-2 relative: the JAX trunk runs in bf16, the port's in float32."""
    jp, tp = lp
    rng = np.random.RandomState(4)
    a = rng.rand(2, 16, 16, 3).astype(np.float32)
    b = np.clip(a + 0.2 * rng.randn(2, 16, 16, 3), 0, 1).astype(np.float32)
    jfn = jax.jit(jax.value_and_grad(
        lambda x: jlpips.lpips_distance(jp, x, jnp.asarray(b)).sum()))
    _, gw = jfn(jnp.asarray(a))
    want = np.asarray(jax.jit(lambda x: jlpips.lpips_distance(jp, x, jnp.asarray(b)))(
        jnp.asarray(a)))
    got = tlpips.lpips_distance(tp, t(a), t(b))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-2)
    single = tlpips.lpips_distance(tp, t(a[0]), t(b[0]))
    np.testing.assert_allclose(float(single), float(got[0]), rtol=1e-6)
    assert float(tlpips.lpips_distance(tp, t(a[0]), t(a[0]))) < 1e-6
    # the gradient the training term sends back through the trunk: bf16
    # rounding moves single entries by up to ~20% of the largest, so hold the
    # direction (cosine) and the norm
    gw = np.asarray(gw).ravel()
    at = t(a).requires_grad_(True)
    tlpips.lpips_distance(tp, at, t(b)).sum().backward()
    gt = at.grad.numpy().ravel()
    assert gt @ gw / (np.linalg.norm(gt) * np.linalg.norm(gw)) > 0.99
    np.testing.assert_allclose(np.linalg.norm(gt), np.linalg.norm(gw), rtol=3e-2)


def test_lpips_weights_file_and_metrics(tmp_path, lp):
    """The .npz weights format loads into the same params as interop gives."""
    jp, tp = lp
    arrs = {f"conv{i}_w": np.asarray(c["w"]) for i, c in enumerate(jp.convs)}
    arrs.update({f"conv{i}_b": np.asarray(c["b"]) for i, c in enumerate(jp.convs)})
    arrs.update({f"lin{i}": np.asarray(x) for i, x in enumerate(jp.lins)})
    np.savez(tmp_path / "w.npz", **arrs)
    loaded = tlpips.LPIPS(weights_file=str(tmp_path / "w.npz"), device="cpu")
    assert loaded.metric_name == "lpips"
    for a, b in zip(loaded.params.convs, tp.convs):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    rng = np.random.RandomState(5)
    r = [t(rng.rand(24, 24, 3).astype(np.float32)) for _ in range(2)]
    g = [t(rng.rand(24, 24, 3).astype(np.float32)) for _ in range(2)]
    res = evaluate_images(r, g, lpips_model=loaded)
    for i in range(2):
        assert res["per_image"][str(i)]["psnr"] == pytest.approx(float(TL.psnr(r[i], g[i])))
        np.testing.assert_allclose(res["per_image"][str(i)]["ssim"],
                                   float(JL.ssim(jnp.asarray(r[i]), jnp.asarray(g[i]))),
                                   rtol=1e-5)
    rand = tlpips.LPIPS(device="cpu")
    assert rand.metric_name == "lpips_rand"
    assert "lpips_rand" in evaluate_images(r, g, lpips_model=rand)


def test_lpips_crop_matches_jax():
    bm = np.zeros((48, 40), np.float32)
    bm[5:30, 12:36] = 1
    stack = np.random.RandomState(6).rand(4, 48, 40, 3).astype(np.float32)
    for crop in (16, 32, 64):
        want = np.asarray(JT._lpips_crop(jnp.asarray(stack), jnp.asarray(bm), crop))
        got, = TT._lpips_crop((t(stack),), t(bm), crop)
        np.testing.assert_array_equal(got.numpy(), want)
        # two stacks share the one window
        a, b = TT._lpips_crop((t(stack[:1]), t(stack[1:])), t(bm), crop)
        np.testing.assert_array_equal(np.concatenate([a.numpy(), b.numpy()]), want)
    masks = [bm, np.zeros((48, 40), np.float32)]
    assert TT.scene_lpips_crop(masks) == JT.scene_lpips_crop(masks)
    assert TT.scene_lpips_crop([t(bm)], pad=2, align=8) == JT.scene_lpips_crop([bm], 2, 8)


# ---- the optimizer --------------------------------------------------------------

CAP = 16


def _params(seed=0):
    """A small JAX TrainableParams (capacity 16 + the two MLPs)."""
    rng = np.random.RandomState(seed)
    n = 12
    st = JG.create_from_pcd(rng.randn(n, 3).astype(np.float32),
                            rng.rand(n, 3).astype(np.float32),
                            rng.randn(n, 3).astype(np.float32), capacity=CAP)
    return JO.TrainableParams(st.params, jinit_pose(jax.random.PRNGKey(0)),
                              jinit_lbs(jax.random.PRNGKey(1)))


def _grads(params, rng):
    def one(x):
        g = rng.randn(*np.shape(x)).astype(np.float32) * 10.0 ** rng.randint(-6, 1)
        g.reshape(-1)[:3] = [1e-12, -1e-12, 0.0]   # near-zero of either sign
        return g
    return jax.tree.map(one, as_np(params))


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_adam_matches_optax_with_slot_helpers():
    """The same gradients into optax and the port: 1e-6 relative + 1e-9 on
    every parameter after each update, through slot resets, an opacity
    moment reset, a capacity growth and a frozen step."""
    jcfg = JOptCfg(pbr_iteration=4)
    cfg = OptimizationConfig(pbr_iteration=4)
    jp = _params()
    jtx = JO.make_optimizer(jcfg, jp, spatial_lr_scale=2.5)
    jst = jtx.init(jp)
    jupdate = jax.jit(jtx.update)
    tp = interop.trainable_params(as_np(jp), device="cpu")
    tx = TO.Adam(cfg, spatial_lr_scale=2.5)
    tst = tx.init(tp)
    rng = np.random.RandomState(7)
    cap = CAP
    for k in range(6):
        if k == 2:
            written = rng.rand(cap) > 0.5
            jst = JO.reset_adam_slots(jst, jnp.asarray(written), cap)
            tst = TO.reset_adam_slots(tst, t(written), cap)
            jst = JO.reset_opacity_moments(jst)
            tst = TO.reset_opacity_moments(tst)
        if k == 3:
            jst = JO.grow_opt_state(jst, cap, 2 * cap)
            jp = jp._replace(gaussians=JG.grow_capacity(
                JG.GaussianState(jp.gaussians, *([jnp.zeros(cap)] * 5)), 2 * cap).params)
            tst = TO.grow_opt_state(tst, cap, 2 * cap)
            tp = tp._replace(gaussians=interop.trainable_params(as_np(jp), "cpu").gaussians)
            cap *= 2
        g = _grads(jp, rng)
        frozen = k >= 4
        jmask = JO.geometry_freeze_mask(jp, jnp.asarray(frozen))
        g_j = jax.tree.map(lambda a, m: jnp.asarray(a) * m, g, jmask)
        tmask = TO.geometry_freeze_mask(tp, frozen)
        g_t = TO.tree_map(lambda a, m: a * m, interop.trainable_params(g, "cpu"), tmask)
        upd, jst = jupdate(g_j, jst, jp)
        jp = optax.apply_updates(jp, upd)
        tp, tst = tx.step(tp, g_t, tst)
        for a, b in zip(TO.tree_leaves(tp), _leaves(jp)):
            close(a, b, 1e-6, 1e-9, f"update {k}")
    assert tst.count["xyz"] == 6


# ---- densify / prune / merge -------------------------------------------------

@pytest.fixture(scope="module")
def dstate():
    """A 400-capacity state with varied scales, opacities and grad stats."""
    rng = np.random.RandomState(8)
    n = 300
    st = JG.create_from_pcd(rng.randn(n, 3).astype(np.float32) * 0.3,
                            rng.rand(n, 3).astype(np.float32),
                            rng.randn(n, 3).astype(np.float32), capacity=512)
    p = st.params
    scaling = np.asarray(p.scaling) + rng.randn(512, 3).astype(np.float32)
    opacity = rng.randn(512, 1).astype(np.float32) * 3
    st = st._replace(
        params=p._replace(scaling=jnp.asarray(scaling), opacity=jnp.asarray(opacity),
                          rotation=jnp.asarray(rng.randn(512, 4).astype(np.float32))),
        xyz_grad_accum=jnp.asarray(rng.rand(512).astype(np.float32) * 4e-4),
        denom=jnp.asarray(rng.randint(0, 3, 512).astype(np.float32)),
        max_radii2d=jnp.asarray(rng.rand(512).astype(np.float32) * 40))
    st = st._replace(alive=st.alive & jnp.asarray(rng.rand(512) > 0.1))
    # a near-duplicate pair for the merge
    xyz = np.asarray(st.params.xyz).copy()
    xyz[1] = xyz[0] + 1e-4
    st = st._replace(params=st.params._replace(xyz=jnp.asarray(xyz)),
                     alive=st.alive.at[:2].set(True))
    noise = jax.random.normal(jax.random.PRNGKey(3), (2, 512, 3))
    verts = rng.randn(200, 3).astype(np.float32) * 0.3
    return st, interop.gaussian_state(as_np(st), "cpu"), noise, verts


def assert_state_close(got, want):
    for f in want.params._fields:
        close(getattr(got.params, f), getattr(want.params, f), 0.0, 1e-6, f)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    for f in ("xyz_grad_accum", "denom", "max_radii2d"):
        close(getattr(got, f), getattr(want, f), 0.0, 1e-6, f)


DENSIFY_CASES = {
    "clone": (lambda M, s, nz: M.densify_and_clone(s, 2e-4, 1.0, 0.1),) * 2,
    "split": (lambda M, s, nz: M.densify_and_split(s, 2e-4, 1.0, nz[0], 2, 0.1),
              lambda M, s, nz: M.densify_and_split(s, 2e-4, 1.0, nz[1], 0.1)),
    "kl_clone": (lambda M, s, nz: M.kl_densify_and_clone(s, 2e-4, 1.0, 0.4, 0.1),) * 2,
    "kl_split": (lambda M, s, nz: M.kl_densify_and_split(s, 2e-4, 1.0, nz[0], 0.4, 2, 0.1),
                 lambda M, s, nz: M.kl_densify_and_split(s, 2e-4, 1.0, nz[1], 0.4, 0.1)),
    "kl_merge": (lambda M, s, nz: M.kl_merge(s, 1e-4, 1.0, 5.0, 0.5),) * 2,
}


@pytest.mark.parametrize("name", sorted(DENSIFY_CASES))
def test_densify_functions_match_jax(dstate, name):
    """Masks and counters exact, parameters 1e-6 (same noise both sides)."""
    js, ts, noise, _ = dstate
    fj, ft = DENSIFY_CASES[name]
    want, w_j, d_j = fj(JG, js, (jax.random.PRNGKey(3), None))
    got, w_t, d_t = ft(TG, ts, (None, t(noise)))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    assert int(d_t) == int(d_j)
    assert int(w_t.sum()) > 0, "nothing written: the case is vacuous"
    assert_state_close(got, want)


@pytest.mark.parametrize("use_kl", [False, True])
def test_densify_and_prune_matches_jax(dstate, use_kl):
    js, ts, noise, verts = dstate
    kw = dict(max_grad=2e-4, min_opacity=0.005, extent=1.0, kl_threshold=0.4,
              use_kl=use_kl, percent_dense=0.1)
    want, w_j, info_j = JG.densify_and_prune(js, jax.random.PRNGKey(3),
                                             smpl_vertices=jnp.asarray(verts), **kw)
    got, w_t, info_t = TG.densify_and_prune(ts, None, smpl_vertices=t(verts), noise=t(noise),
                                            **kw)
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    assert {k: int(v) for k, v in info_t.items()} == {k: int(v) for k, v in info_j.items()}
    assert int(info_t["pruned"]) > 0
    assert_state_close(got, want)


def test_stats_prune_and_opacity_reset_match_jax(dstate):
    js, ts, _, verts = dstate
    rng = np.random.RandomState(9)
    g = rng.randn(512, 2).astype(np.float32) * 1e-3
    radii = rng.randint(-1, 20, 512).astype(np.int32)
    assert_state_close(TG.add_densification_stats(ts, t(g), t(radii)),
                       JG.add_densification_stats(js, jnp.asarray(g), jnp.asarray(radii)))
    for mss in (None, 20.0):
        want = JG.prune(js, 0.3, 1.0, mss, jnp.asarray(verts), 0.2)
        got = TG.prune(ts, 0.3, 1.0, mss, t(verts), 0.2)
        np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    assert_state_close(TG.reset_opacity(ts), JG.reset_opacity(js))
    assert_state_close(TG.reset_densification_stats(ts), JG.reset_densification_stats(js))
    sel = t(rng.rand(512) > 0.7) & ts.alive
    for a, b in zip(TG._alloc_slots(ts.alive, sel),
                    JG._alloc_slots(js.alive, jnp.asarray(sel.numpy()))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---- the whole step ----------------------------------------------------------

@pytest.fixture(scope="module")
def scenes():
    """test_train.py's scene in both packages; the port's batches carry the
    JAX scene's inputs, so both steps see the same numbers."""
    js = jscene(n_views=2, width=48, height=48, n_verts=200, capacity=256)
    tscene = make_synthetic_scene(n_views=2, width=48, height=48, n_verts=200, capacity=256,
                                  device="cpu")
    batches = []
    for jb in js.batches:
        c = jb.camera
        cam = Camera(w2c=t(c.w2c), full_proj=t(c.full_proj), cam_center=t(c.cam_center),
                     tan_fovx=c.tan_fovx, tan_fovy=c.tan_fovy, width=c.width, height=c.height)
        frame = FrameInputs(smpl_param=interop.tensor_tree(as_np(jb.frame.smpl_param), "cpu"),
                            big_pose_param=interop.tensor_tree(as_np(jb.frame.big_pose_param),
                                                               "cpu"),
                            big_pose_verts=t(jb.frame.big_pose_verts))
        batches.append(TT.TrainBatch(camera=cam, frame=frame, gt_image=t(jb.gt_image),
                                     gt_normal=t(jb.gt_normal), bkgd_mask=t(jb.bkgd_mask),
                                     bound_mask=t(jb.bound_mask)))
    mlps = (jinit_pose(jax.random.PRNGKey(0)), jinit_lbs(jax.random.PRNGKey(1)))
    return js, tscene._replace(batches=batches,
                               init_state=interop.gaussian_state(as_np(js.init_state), "cpu")), mlps


@pytest.mark.parametrize("with_lpips", [False, True], ids=["plain", "lpips"])
def test_train_step_matches_jax(scenes, lp, with_lpips):
    """With LPIPS: the same random VGG on a 40-pixel window of the 48-pixel
    frame, the JAX trunk in bf16 and the port's in float32."""
    js, ts_scene, (jpose, jlbs) = scenes
    jcfg, cfg = JOptCfg(), OptimizationConfig()
    jts, _ = JT.create_train_state(jcfg, js.init_state, jpose, jlbs)
    jb = js.batches[0]
    jp, tp = lp
    crop = TT.scene_lpips_crop([b.bound_mask for b in ts_scene.batches], pad=2, align=8)
    assert crop < jb.gt_image.shape[0]
    jlpips_fn = (lambda a, b: jlpips.lpips_distance(jp, a, b)) if with_lpips else None
    tlpips_fn = (lambda a, b: tlpips.lpips_distance(tp, a, b)) if with_lpips else None

    def jax_grads(lpips_fn):
        def loss_fn(params, m2d):
            out = jrender(jts.gauss._replace(params=params.gaussians), jb.camera, jb.frame,
                          js.smpl_model, bg=jnp.zeros(3), active_sh_degree=1,
                          mlp_params={"pose_refiner": params.pose_refiner,
                                      "lbs_offset": params.lbs_offset},
                          config=js.raster_config, means2d_offset=m2d)
            alive = jts.gauss.alive.astype(jnp.float32)
            sm = jnp.sum(JG.get_scaling(params.gaussians) * alive[:, None]) / jnp.maximum(
                jnp.sum(alive) * 3, 1.0)
            total, metrics = JT.compute_losses_a(out, jb, sm, lpips_fn, crop)
            return total, (metrics, out.radii)

        return jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))(
            JT.trainable_params(jts), jnp.zeros((256, 2)))

    (_, (jm, jradii)), (jg, jg2d) = jax_grads(jlpips_fn)

    tts, tx = TT.create_train_state(cfg, ts_scene.init_state,
                                    interop.tensor_tree(as_np(jpose), "cpu"),
                                    interop.tensor_tree(as_np(jlbs), "cpu"))
    # a whole JAX TrainState's params carry across in one call
    for a, b in zip(TO.tree_leaves(interop.trainable_params(as_np(jts), "cpu")),
                    TO.tree_leaves(TT.trainable_params(tts))):
        assert torch.equal(a, b)
    step = TT.make_train_step(ts_scene.smpl_model, tx, cfg, ts_scene.raster_config,
                              bg=torch.zeros(3), lpips_fn=tlpips_fn, lpips_crop=crop)
    total, metrics, grads, g2d, radii = step.loss_and_grads(tts, ts_scene.batches[0], 1)
    for k in ("loss", "l1", "mask", "normal", "axis", "ssim", "tv", "scaling_mean", "psnr"):
        close(metrics[k], jm[k], 1e-4, 1e-7, k)
    if with_lpips:
        assert float(jm["lpips_term"]) > 0
        np.testing.assert_allclose(float(metrics["lpips_term"]), float(jm["lpips_term"]),
                                   rtol=3e-2)
        # at 0.01 of the loss the term moves each gradient leaf by less than
        # the step's 1e-3: hold its own share of every leaf, the gradient less
        # the gradient without it, at the LPIPS gradient's tolerance
        _, (jg0, jg2d0) = jax_grads(None)
        plain = TT.make_train_step(ts_scene.smpl_model, tx, cfg, ts_scene.raster_config,
                                   bg=torch.zeros(3))
        _, _, g0, g2d0, _ = plain.loss_and_grads(tts, ts_scene.batches[0], 1)
        shares = []
        for a, a0, b, b0 in zip(TO.tree_leaves(grads) + [g2d], TO.tree_leaves(g0) + [g2d0],
                                jax.tree_util.tree_leaves(jg) + [jg2d],
                                jax.tree_util.tree_leaves(jg0) + [jg2d0]):
            shares.append(((a - a0).numpy().ravel().astype(np.float64),
                           (np.asarray(b) - np.asarray(b0)).ravel().astype(np.float64)))
        largest = max(np.linalg.norm(dj) for _, dj in shares)
        assert largest > 0
        for i, (dt, dj) in enumerate(shares):
            nt, nj = np.linalg.norm(dt), np.linalg.norm(dj)
            if nj == 0:
                assert nt <= 1e-6 * largest, f"LPIPS share of leaf {i}"
                continue
            assert dt @ dj / (nt * nj) > 0.99, f"LPIPS share of leaf {i}"
            np.testing.assert_allclose(nt, nj, rtol=3e-2, err_msg=f"LPIPS share of leaf {i}")
    np.testing.assert_array_equal(radii.numpy(), np.asarray(jradii))
    jleaves = jax.tree_util.tree_leaves(jg)
    tleaves = TO.tree_leaves(grads)
    assert len(jleaves) == len(tleaves)
    for i, (a, b) in enumerate(zip(tleaves, jleaves)):
        close(a, b, 1e-3, 1e-10, f"gradient leaf {i}")
    close(g2d, jg2d, 1e-3, 1e-10, "means2d_offset")
    assert float(np.abs(np.asarray(jg.gaussians.xyz)).max()) > 0

    # the whole step: its densify statistics are the JAX package's
    # add_densification_stats of the same gradients
    tts2, tm2 = step(tts, ts_scene.batches[0], 1)
    close(tm2["loss"], jm["loss"], 1e-4)
    want = JG.add_densification_stats(jts.gauss, jg2d * jnp.asarray([24.0, 24.0]), jradii)
    close(tts2.gauss.xyz_grad_accum, want.xyz_grad_accum, 1e-3)
    np.testing.assert_array_equal(tts2.gauss.denom.numpy(), np.asarray(want.denom))
    np.testing.assert_array_equal(tts2.gauss.max_radii2d.numpy(),
                                  np.asarray(want.max_radii2d))
    assert tts2.step == 1 and tts.step == 0


# ---- the train loop's own checks (tests/test_train.py) on the port ------------

@pytest.fixture(scope="module")
def tscene():
    return make_synthetic_scene(n_views=2, width=48, height=48, n_verts=200, capacity=256,
                                device="cpu")


def _start(scene, cfg):
    gen = torch.Generator().manual_seed(0)
    return TT.create_train_state(cfg, scene.init_state,
                                 init_pose_refiner(gen, device="cpu"),
                                 init_lbs_offset(gen, device="cpu"))


def test_loss_decreases(tscene):
    cfg = OptimizationConfig(iterations=40, densify_from_iter=10_000)
    ts, tx = _start(tscene, cfg)
    step = TT.make_train_step(tscene.smpl_model, tx, cfg, tscene.raster_config,
                              bg=torch.zeros(3))
    first = None
    for it in range(30):
        ts, m = step(ts, tscene.batches[it % 2], 0)
        first = float(m["loss"]) if first is None else first
    assert np.isfinite(float(m["loss"])) and float(m["loss"]) < first
    assert float(ts.gauss.denom.sum()) > 0


def test_full_loop_with_densify_and_psnr(tscene):
    cfg = OptimizationConfig(iterations=60, densify_from_iter=20, densify_until_iter=60,
                             densification_interval=20)
    ts, tx = _start(tscene, cfg)
    step = TT.make_train_step(tscene.smpl_model, tx, cfg, tscene.raster_config,
                              bg=torch.zeros(3))
    psnrs, events = [], []

    def cb(it, ts, m):
        psnrs.append(float(m["psnr"]))
        if "densify_alive" in m:
            events.append((it, m["densify_alive"], m["capacity"]))

    ts, m = TT.train_loop(ts, tx, step, tscene.batches, cfg, extent=tscene.extent,
                          smpl_vertices=tscene.big_pose_verts, max_sh_degree=0, callback=cb)
    assert int(ts.gauss.num_alive) > 0
    assert np.all(np.isfinite(psnrs))
    assert np.mean(psnrs[-10:]) > psnrs[0] - 1.0, (psnrs[0], psnrs[-10:])
    assert [e[0] for e in events] == [20, 40]
    assert events[-1][1] == int(ts.gauss.num_alive)


def test_geometry_frozen_past_pbr_iteration(tscene):
    cfg = OptimizationConfig(pbr_iteration=0)
    ts, tx = _start(tscene, cfg)
    step = TT.make_train_step(tscene.smpl_model, tx, cfg, tscene.raster_config,
                              bg=torch.zeros(3))
    ts2, _ = step(ts, tscene.batches[0], 0)
    assert torch.equal(ts2.gauss.params.xyz, ts.gauss.params.xyz)
    assert torch.equal(ts2.gauss.params.opacity, ts.gauss.params.opacity)
    assert not torch.equal(ts2.gauss.params.normal, ts.gauss.params.normal)


def test_densify_event_resets_moments_and_loop_raises_on_nan(tscene, tmp_path, monkeypatch):
    cfg = OptimizationConfig(iterations=40, densify_from_iter=10_000)
    ts, tx = _start(tscene, cfg)
    step = TT.make_train_step(tscene.smpl_model, tx, cfg, tscene.raster_config,
                              bg=torch.zeros(3))
    for _ in range(3):
        ts, _ = step(ts, tscene.batches[0], 0)
    alive = ts.gauss.alive
    ts = ts._replace(gauss=ts.gauss._replace(xyz_grad_accum=alive.float(),
                                             denom=alive.float()))
    ts2, info = TT.densify_event(ts, torch.Generator().manual_seed(2), cfg, tscene.extent,
                                 tscene.big_pose_verts, iteration=100)
    assert int(info["alive"]) == int(ts2.gauss.num_alive)
    assert float(ts2.gauss.xyz_grad_accum.sum()) == 0.0
    written = ts2.gauss.alive & ~ts.gauss.alive
    assert int(written.sum()) > 0
    for m in (ts2.opt_state.mu, ts2.opt_state.nu):
        assert float(m.gaussians.xyz[written].abs().sum()) == 0.0
    # growth doubles the state and the moments together
    grown = TT.maybe_grow_capacity(ts2, min_free=10 ** 6)
    assert grown.gauss.capacity == 512 and grown.opt_state.mu.gaussians.xyz.shape[0] == 512

    def nan_step(ts, batch, deg):
        return ts, {"loss": torch.tensor(float("nan"))}

    monkeypatch.chdir(tmp_path)    # the loop snapshots to output/diverged before raising
    with pytest.raises(FloatingPointError):
        TT.train_loop(ts2, tx, nan_step, tscene.batches,
                      dataclasses.replace(cfg, iterations=50), extent=tscene.extent,
                      smpl_vertices=tscene.big_pose_verts, max_sh_degree=0)


# ---- the LPIPS term of the step -----------------------------------------------

@pytest.fixture(scope="module")
def rendered_view(tscene):
    """A render of the small scene's first view and the view."""
    ts, _ = _start(tscene, OptimizationConfig())
    batch = tscene.batches[0]
    with torch.no_grad():
        out = render_frame(ts.gauss, batch.camera, batch.frame, tscene.smpl_model,
                           bg=torch.zeros(3), active_sh_degree=0,
                           mlp_params={"pose_refiner": ts.pose_refiner,
                                       "lbs_offset": ts.lbs_offset},
                           config=tscene.raster_config)
    return out, batch


_LOSS_INPUTS = ("render", "render_alpha", "normal", "render_axis")


def _losses(rendered_view, lpips_fn, crop, fn=TT.compute_losses_a):
    """(total, metrics, the images the losses read as leaves that take grad)."""
    out, batch = rendered_view
    leaves = [getattr(out, k).clone().requires_grad_(True) for k in _LOSS_INPUTS]
    out = out._replace(**dict(zip(_LOSS_INPUTS, leaves)))
    total, metrics = fn(out, batch, torch.tensor(0.25), lpips_fn, crop)
    return total, metrics, leaves


def _four_image_losses(out, batch, scaling_mean, lpips_fn, lpips_crop):
    """compute_losses_a with both LPIPS pairs in one stack of four images,
    ground truth included, cropped as one: the yardstick for the loss and
    the gradients."""
    bm = batch.bound_mask.float()
    ll1 = TL.masked_l1(out.render, batch.gt_image, bm)
    mask_loss = TL.masked_l2(out.render_alpha, batch.bkgd_mask.float(), bm)
    normal_loss = TL.masked_l1(out.normal, batch.gt_normal, bm)
    axis_loss = TL.masked_l1(out.render_axis, batch.gt_normal, bm)
    ssim_val = TL.ssim(out.render, batch.gt_image, bm) + TL.ssim(out.normal, batch.gt_normal, bm)
    bm3 = bm[..., None]
    stack = torch.stack([out.render * bm3, batch.gt_image * bm3,
                         out.normal * bm3, batch.gt_normal * bm3])
    crop, = TT._lpips_crop((stack,), bm, lpips_crop)
    lpips_val = lpips_fn(crop[0::2], crop[1::2]).sum()
    tv = TL.masked_tv_loss(out.render_alpha, out.normal)
    total = (ll1 + 0.1 * mask_loss + normal_loss + axis_loss + 0.01 * lpips_val
             + 0.01 * (2.0 - ssim_val) + 0.01 * tv + scaling_mean)
    return total, {"lpips_term": lpips_val.detach()}


def test_lpips_ground_truth_pair_takes_no_grad(lp, rendered_view):
    _, tp = lp
    seen = []

    def spy(a, b):
        seen.append((a.requires_grad, b.requires_grad, tuple(a.shape), tuple(b.shape)))
        return tlpips.lpips_distance(tp, a, b)

    _losses(rendered_view, spy, 40)
    assert seen == [(True, False, (2, 40, 40, 3), (2, 40, 40, 3))]


def test_lpips_backward_runs_the_rendered_trunk_only(lp, rendered_view):
    """One backward through the 13 VGG convolutions and 4 max-pools of the
    rendered pair; SSIM's separable blurs (11-tap windows) are told apart
    by the weight's shape."""
    _, tp = lp
    total, _, leaves = _losses(rendered_view, lambda a, b: tlpips.lpips_distance(tp, a, b), 40)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        torch.autograd.grad(total, leaves)
    convs = [e.input_shapes[2] for e in prof.events() if e.name == "aten::convolution_backward"]
    trunk = [w for w in convs if list(w[-2:]) == [3, 3]]
    assert len(trunk) == 13
    assert sorted({tuple(w) for w in convs} - {tuple(w) for w in trunk}) == [
        (1, 1, 1, 11), (1, 1, 11, 1)]
    pools = [e for e in prof.events() if e.name == "aten::max_pool2d_with_indices_backward"]
    assert len(pools) == 4


@pytest.mark.parametrize("crop", [40, 48], ids=["window", "whole_frame"])
def test_lpips_pairs_apart_equal_the_four_image_stack(lp, rendered_view, crop):
    """The loss and its gradients in the images are the same bits as with
    the ground truth stacked among the renders."""
    _, tp = lp

    def lpips_fn(a, b):
        return tlpips.lpips_distance(tp, a, b)

    total, metrics, leaves = _losses(rendered_view, lpips_fn, crop)
    want, want_metrics, want_leaves = _losses(rendered_view, lpips_fn, crop,
                                              fn=_four_image_losses)
    assert float(metrics["lpips_term"]) > 0
    assert torch.equal(metrics["lpips_term"], want_metrics["lpips_term"])
    assert torch.equal(total, want)
    for name, g, w in zip(_LOSS_INPUTS, torch.autograd.grad(total, leaves),
                          torch.autograd.grad(want, want_leaves)):
        assert torch.equal(g, w), name
