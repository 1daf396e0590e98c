"""Port vs JAX package: PBR shading — cubemap sampling, prefiltering, the
cubemap light, the BSDF suite and split-sum shading (mygauhuman_torch/pbr/).

Tolerances, each stated where it is used:
  * values: 1e-5 absolute (float32, the same formulas; the JAX planar
    samplers contract one-hot matrices where the port gathers);
  * gradients of shading with respect to the light and the albedo: within
    1e-4 of the largest |jax.grad| (another summation order of the same
    float32 terms);
  * the port's planar and channel-minor forms: 1e-6 (the same gathers);
  * the specular prefilter at roughness 0.08: 1e-4 of the max (the sharp
    GGX lobe amplifies the 1-ulp differences of the two packages' texel
    grids; both lie ~1.5e-4 from float64).
Sizes: light base_res 16, 24 x 20 G-buffers, seeded numpy inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygauhuman_tpu.pbr import bsdf as JB
from mygauhuman_tpu.pbr import cubemap as JC
from mygauhuman_tpu.pbr import light as JLi
from mygauhuman_tpu.pbr import prefilter as JP
from mygauhuman_tpu.pbr import shade as JS
from mygauhuman_torch.pbr import bsdf as TB
from mygauhuman_torch.pbr import cubemap as TC
from mygauhuman_torch.pbr import light as TLi
from mygauhuman_torch.pbr import prefilter as TP
from mygauhuman_torch.pbr import shade as TS

torch.set_num_threads(1)
CPU = "cpu"
ATOL = 1e-5
GRAD_RTOL = 1e-4
SHARP_LOBE_RTOL = 1e-4


def t(a):
    return torch.as_tensor(np.array(a))


def close(got, want, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol, err_msg=msg)


def unit(rng, *shape):
    d = rng.randn(*shape, 3).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def cubemap(rng, R=16, C=3):
    return (rng.rand(6, R, R, C) * 2.0).astype(np.float32)


# ---- cubemap ----------------------------------------------------------------------

def test_dir_to_cube_uv_and_face_tables_match_jax():
    rng = np.random.RandomState(0)
    d = unit(rng, 500)
    jf, jgx, jgy = JC.dir_to_cube_uv(jnp.asarray(d))
    tf, tgx, tgy = TC.dir_to_cube_uv(t(d))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    close(tgx, jgx)
    close(tgy, jgy)
    for s in range(6):
        gx, gy = (rng.rand(2, 7) * 2 - 1).astype(np.float32)
        close(TC.cube_to_dir(s, t(gx), t(gy)), JC.cube_to_dir(s, jnp.asarray(gx), jnp.asarray(gy)))
    for res in (8, 16):
        close(TC.face_directions(res, CPU), JC.face_directions(res))
        close(TC.texel_solid_angles(res, CPU), JC.texel_solid_angles(res), 1e-8)
    close(TC.latlong_dirs(8, 16, CPU), JC.latlong_dirs(8, 16))


def test_cubemap_samplers_match_jax():
    rng = np.random.RandomState(1)
    cm = cubemap(rng)
    d = unit(rng, 24, 20)
    close(TC.sample_cubemap(t(cm), t(d)), JC.sample_cubemap(jnp.asarray(cm), jnp.asarray(d)))
    planes = [t(d[..., c]) for c in range(3)]
    got = TC.sample_cubemap_planar(t(cm), *planes)
    want = JC.sample_cubemap_planar(jnp.asarray(cm), *[jnp.asarray(d[..., c]) for c in range(3)])
    assert isinstance(got, tuple) and len(got) == 3
    for g, w in zip(got, want):
        close(g, w)
    mips = [cm, cubemap(rng, 8), cubemap(rng, 4)]
    level = (rng.rand(24, 20) * 3.0 - 0.3).astype(np.float32)
    want = JC.sample_cubemap_mips([jnp.asarray(m) for m in mips], jnp.asarray(d),
                                  jnp.asarray(level))
    got = TC.sample_cubemap_mips([t(m) for m in mips], t(d), t(level))
    close(got, want)
    got_p = TC.sample_cubemap_mips_planar([t(m) for m in mips], *planes, t(level))
    want_p = JC.sample_cubemap_mips_planar([jnp.asarray(m) for m in mips],
                                           *[jnp.asarray(d[..., c]) for c in range(3)],
                                           jnp.asarray(level))
    for c in range(3):
        close(got_p[c], want_p[c])
        close(got_p[c], got[..., c], 1e-6)


def test_2d_and_latlong_samplers_match_jax():
    rng = np.random.RandomState(2)
    tex = rng.rand(12, 10, 2).astype(np.float32)
    uv = (rng.rand(24, 20, 2) * 1.2 - 0.1).astype(np.float32)
    want = JC.sample_2d(jnp.asarray(tex), jnp.asarray(uv))
    close(TC.sample_2d(t(tex), t(uv)), want)
    got_p = TC.sample_2d_planar(t(tex), t(uv[..., 0]), t(uv[..., 1]))
    want_p = JC.sample_2d_planar(jnp.asarray(tex), jnp.asarray(uv[..., 0]),
                                 jnp.asarray(uv[..., 1]))
    for c in range(2):
        close(got_p[c], want_p[c])
    cm = cubemap(rng)
    close(TC.cubemap_to_latlong(t(cm), 8, 16), JC.cubemap_to_latlong(jnp.asarray(cm), 8, 16))
    ll = rng.rand(8, 16, 3).astype(np.float32)
    close(TC.latlong_to_cubemap(t(ll), 8), JC.latlong_to_cubemap(jnp.asarray(ll), 8))
    close(TC.avg_pool_cubemap(t(cm)), JC.avg_pool_cubemap(jnp.asarray(cm)))


def test_gather_rows_backward_is_the_scatter_sum():
    """The fixed-order backward sums every cotangent row into its texel:
    against autograd of plain indexing and jax.grad of the JAX sampler."""
    rng = np.random.RandomState(3)
    table = t(rng.rand(40, 3).astype(np.float32)).requires_grad_(True)
    idx = t(rng.randint(0, 40, size=(5000,)))
    g = t(rng.randn(5000, 3).astype(np.float32))
    (got,) = torch.autograd.grad(TC.gather_rows(table, idx), table, g)
    (want,) = torch.autograd.grad(table[idx], table, g)
    close(got, want, 1e-5)
    cm = cubemap(rng)
    d = unit(rng, 24, 20)
    cot = rng.randn(24, 20, 3).astype(np.float32)
    jg = jax.grad(lambda c: jnp.sum(JC.sample_cubemap(c, jnp.asarray(d)) * cot))(jnp.asarray(cm))
    tc = t(cm).requires_grad_(True)
    (tg,) = torch.autograd.grad((TC.sample_cubemap(tc, t(d)) * t(cot)).sum(), tc)
    close(tg, jg, GRAD_RTOL * float(np.abs(np.asarray(jg)).max()))
    (tg2,) = torch.autograd.grad((TC.sample_cubemap(tc, t(d)) * t(cot)).sum(), tc)
    assert torch.equal(tg, tg2)


# ---- prefilter and light -------------------------------------------------------------

def test_prefilter_matches_jax():
    rng = np.random.RandomState(4)
    cm = cubemap(rng, 8)
    close(TP.diffuse_weights(8, CPU), JP.diffuse_weights(8), 1e-7)
    close(TP.diffuse_cubemap(t(cm)), JP.diffuse_cubemap(jnp.asarray(cm)))
    for rough, out_res in ((0.3, None), (1.0, 4)):
        tw, tn = TP.specular_weights(8, rough, out_res, CPU)
        jw, jn = JP.specular_weights(8, rough, out_res)
        close(tw, jw, 1e-5 * float(np.abs(np.asarray(jw)).max()))
        close(tn, jn, 1e-5 * float(np.abs(np.asarray(jn)).max()))
        close(TP.specular_cubemap(t(cm), rough, out_res),
              JP.specular_cubemap(jnp.asarray(cm), rough, out_res))


def test_light_matches_jax():
    rng = np.random.RandomState(5)
    assert [TLi.num_levels(r) for r in (8, 16, 32, 64)] == [JLi.num_levels(r)
                                                             for r in (8, 16, 32, 64)]
    assert TLi.level_roughness(32) == JLi.level_roughness(32)
    close(TLi.init_cubemap_light(16, device=CPU)["base"], JLi.init_cubemap_light(16)["base"], 0)
    base = (rng.randn(6, 16, 16, 3) * 0.6 + 0.4).astype(np.float32)
    close(TLi.clamp_light({"base": t(base)}, 0.0, 0.9)["base"],
          JLi.clamp_light({"base": jnp.asarray(base)}, 0.0, 0.9)["base"], 0)
    tw = TLi.prefilter_weight_set(16, CPU)
    jw = JLi.prefilter_weight_set(16)
    tl = TLi.build_mips({"base": t(base)}, tw)
    jl = JLi.build_mips({"base": jnp.asarray(base)}, jw)
    jl_none = JLi.build_mips({"base": jnp.asarray(base)})
    close(tl.diffuse, jl.diffuse)
    close(TLi.build_mips({"base": t(base)}).diffuse, jl_none.diffuse)
    assert len(tl.specular) == len(jl.specular) == 2
    # level 0 prefilters at roughness 0.08: the GGX lobe's 1 / d^2 turns the
    # 1-ulp differences of the two linspace grids into ~1e-5 relative, and
    # both sides lie ~1.5e-4 from a float64 evaluation, so 1e-4 of the max
    close(tl.specular[0], jl.specular[0], SHARP_LOBE_RTOL * float(jnp.abs(jl.specular[0]).max()))
    close(tl.specular[1], jl.specular[1])
    r = rng.rand(50).astype(np.float32)
    close(TLi.get_mip(t(r), 3), JLi.get_mip(jnp.asarray(r), 3), 1e-6)
    close(TLi.export_envmap({"base": t(base)}, 8, 16),
          JLi.export_envmap({"base": jnp.asarray(base)}, 8, 16))


# ---- BSDF ----------------------------------------------------------------------------

def _bsdf_inputs(seed=6, n=64):
    rng = np.random.RandomState(seed)
    pos = rng.randn(n, 3).astype(np.float32)
    return dict(pos=pos, view=pos + 3.0 * unit(rng, n), light=pos + 2.0 * unit(rng, n),
                nrm=unit(rng, n), tng=unit(rng, n), geom=unit(rng, n),
                pert=(rng.randn(n, 3) * 0.3 + [0, 0, 1]).astype(np.float32),
                kd=rng.rand(n, 3).astype(np.float32), arm=rng.rand(n, 3).astype(np.float32),
                wi=unit(rng, n), wo=unit(rng, n), rough=rng.rand(n, 1).astype(np.float32),
                img=(rng.rand(8, 6, 3) * 2).astype(np.float32),
                tgt=(rng.rand(8, 6, 3) * 2).astype(np.float32),
                mat=rng.randn(4, 4).astype(np.float32))


BSDF_CASES = {
    "prepare_shading_normal": lambda M, x: M.prepare_shading_normal(
        x["pos"], x["view"], x["pert"], x["nrm"], x["tng"], x["geom"]),
    "prepare_shading_normal_one_sided": lambda M, x: M.prepare_shading_normal(
        x["pos"], x["view"], x["pert"], x["nrm"], x["tng"], x["geom"], False, False),
    "lambert": lambda M, x: M.lambert(x["nrm"], x["wi"]),
    "frostbite": lambda M, x: M.frostbite_diffuse(x["nrm"], x["wi"], x["wo"], x["rough"]),
    "pbr_specular": lambda M, x: M.pbr_specular(x["kd"], x["nrm"], x["wo"], x["wi"], x["rough"]),
    "phong": lambda M, x: M.phong(x["nrm"], x["wo"], x["wi"], 8.0),
    "pbr_bsdf_lambert": lambda M, x: M.pbr_bsdf(x["kd"], x["arm"], x["pos"], x["nrm"],
                                                x["view"], x["light"]),
    "pbr_bsdf_frostbite": lambda M, x: M.pbr_bsdf(x["kd"], x["arm"], x["pos"], x["nrm"],
                                                  x["view"], x["light"], bsdf="frostbite"),
    "xfm_points": lambda M, x: M.xfm_points(x["pos"], x["mat"]),
    "xfm_vectors": lambda M, x: M.xfm_vectors(x["nrm"], x["mat"]),
    "loss_l1": lambda M, x: M.image_loss(x["img"], x["tgt"]),
    "loss_mse_log_srgb": lambda M, x: M.image_loss(x["img"], x["tgt"], "mse", "log_srgb"),
    "loss_smape": lambda M, x: M.image_loss(x["img"], x["tgt"], "smape"),
    "loss_relmse": lambda M, x: M.image_loss(x["img"], x["tgt"], "relmse"),
}


@pytest.mark.parametrize("name", sorted(BSDF_CASES))
def test_bsdf_matches_jax(name):
    x = _bsdf_inputs()
    want = BSDF_CASES[name](JB, {k: jnp.asarray(v) for k, v in x.items()})
    got = BSDF_CASES[name](TB, {k: t(v) for k, v in x.items()})
    close(got, want, 1e-5 * max(1.0, float(np.abs(np.asarray(want)).max())), name)


# ---- shading ----------------------------------------------------------------------------

def test_brdf_lut_and_tone_curves_match_jax():
    close(TS.compute_brdf_lut(32, 64, device=CPU), JS.compute_brdf_lut(32, 64), 1e-7)
    rng = np.random.RandomState(7)
    x = (rng.rand(50) * 2).astype(np.float32)
    close(TS.aces_film(t(x)), JS.aces_film(jnp.asarray(x)), 1e-6)
    close(TS.linear_to_srgb(t(x)), JS.linear_to_srgb(jnp.asarray(x)), 1e-6)
    r = rng.rand(50, 1).astype(np.float32)
    nov = rng.rand(50, 1).astype(np.float32)
    close(TS.envBRDF_approx(t(r), t(nov)), JS.envBRDF_approx(jnp.asarray(r), jnp.asarray(nov)),
          1e-6)


def _gbuffers(seed=8, H=24, W=20):
    rng = np.random.RandomState(seed)
    n = unit(rng, H, W)
    v = unit(rng, H, W)
    v = np.where((n * v).sum(-1, keepdims=True) < 0, -v, v)   # mostly front-facing
    return dict(
        base=(rng.rand(6, 16, 16, 3) * 1.5).astype(np.float32), normals=n, view=v,
        albedo=rng.rand(H, W, 3).astype(np.float32),
        rough=(0.04 + 0.96 * rng.rand(H, W)).astype(np.float32),
        mask=(rng.rand(H, W) > 0.3).astype(np.float32),
        occ=rng.rand(H, W).astype(np.float32),
        metal=rng.rand(H, W).astype(np.float32),
        lut=np.asarray(JS.compute_brdf_lut(32, 64)), cot=rng.randn(H, W, 3).astype(np.float32))


def _jax_shade(x, base, albedo, planar, **kw):
    light = JLi.build_mips({"base": base}, JLi.prefilter_weight_set(16))
    a = lambda k: jnp.asarray(x[k])   # noqa: E731
    if planar:
        out = JS.pbr_shading_planar(
            light, tuple(a("normals")[..., c] for c in range(3)),
            tuple(a("view")[..., c] for c in range(3)), tuple(albedo[..., c] for c in range(3)),
            a("rough"), a("mask"), a("lut"), occlusion=a("occ"), **kw)
        return {k: jnp.stack(v, axis=-1) for k, v in out.items()}
    return JS.pbr_shading(light, a("normals"), a("view"), albedo, a("rough")[..., None],
                          a("mask")[..., None], a("lut"), occlusion=a("occ")[..., None], **kw)


def _torch_shade(x, base, albedo, planar, **kw):
    light = TLi.build_mips({"base": base}, TLi.prefilter_weight_set(16, CPU))
    a = lambda k: t(x[k])   # noqa: E731
    if planar:
        out = TS.pbr_shading_planar(
            light, tuple(a("normals")[..., c] for c in range(3)),
            tuple(a("view")[..., c] for c in range(3)), tuple(albedo[..., c] for c in range(3)),
            a("rough"), a("mask"), a("lut"), occlusion=a("occ"), **kw)
        return {k: torch.stack(v, dim=-1) for k, v in out.items()}
    return TS.pbr_shading(light, a("normals"), a("view"), albedo, a("rough")[..., None],
                          a("mask")[..., None], a("lut"), occlusion=a("occ")[..., None], **kw)


SHADE_KW = {"plain": {}, "tone_gamma": {"tone": True, "gamma": True}}


@pytest.mark.parametrize("planar", [False, True], ids=["channel_minor", "planar"])
@pytest.mark.parametrize("kw", sorted(SHADE_KW))
def test_shading_matches_jax(planar, kw):
    x = _gbuffers()
    want = _jax_shade(x, jnp.asarray(x["base"]), jnp.asarray(x["albedo"]), planar, **SHADE_KW[kw])
    got = _torch_shade(x, t(x["base"]), t(x["albedo"]), planar, **SHADE_KW[kw])
    other = _torch_shade(x, t(x["base"]), t(x["albedo"]), not planar, **SHADE_KW[kw])
    for k in ("render_rgb", "diffuse_rgb", "specular_rgb", "diffuse_light"):
        close(got[k], want[k], msg=k)
        close(got[k], other[k], 1e-6, msg=f"{k}: planar vs channel-minor")


def test_shading_metallic_matches_jax():
    x = _gbuffers(9)
    metal = x["metal"]
    want = _jax_shade(x, jnp.asarray(x["base"]), jnp.asarray(x["albedo"]), True,
                      metallic=jnp.asarray(metal))
    got = _torch_shade(x, t(x["base"]), t(x["albedo"]), True, metallic=t(metal))
    close(got["render_rgb"], want["render_rgb"])
    got_c = _torch_shade(x, t(x["base"]), t(x["albedo"]), False, metallic=t(metal)[..., None])
    close(got_c["render_rgb"], got["render_rgb"], 1e-6)


@pytest.mark.parametrize("planar", [False, True], ids=["channel_minor", "planar"])
def test_shading_gradients_match_jax(planar):
    """d(sum(render_rgb * cot)) / d(light base, albedo, roughness): within
    1e-4 of the largest |jax.grad|."""
    x = _gbuffers(10)
    cot = x["cot"]

    def jloss(base, albedo, rough):
        y = dict(x, rough=rough)
        return jnp.sum(_jax_shade(y, base, albedo, planar)["render_rgb"] * cot)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x["base"]), jnp.asarray(x["albedo"]),
                                            jnp.asarray(x["rough"]))
    base = t(x["base"]).requires_grad_(True)
    albedo = t(x["albedo"]).requires_grad_(True)
    rough = t(x["rough"]).requires_grad_(True)
    light = TLi.build_mips({"base": base}, TLi.prefilter_weight_set(16, CPU))
    a = lambda k: t(x[k])   # noqa: E731
    if planar:
        out = TS.pbr_shading_planar(
            light, tuple(a("normals")[..., c] for c in range(3)),
            tuple(a("view")[..., c] for c in range(3)), tuple(albedo[..., c] for c in range(3)),
            rough, a("mask"), a("lut"), occlusion=a("occ"))
        rgb = torch.stack(out["render_rgb"], dim=-1)
    else:
        rgb = TS.pbr_shading(light, a("normals"), a("view"), albedo, rough[..., None],
                             a("mask")[..., None], a("lut"),
                             occlusion=a("occ")[..., None])["render_rgb"]
    tg = torch.autograd.grad((rgb * t(cot)).sum(), (base, albedo, rough))
    for name, g, w in zip(("light", "albedo", "roughness"), tg, jg):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        close(g, w, GRAD_RTOL * float(np.abs(w).max()), msg=name)


# ---- depth-derived normals and the latent BRDF MLP --------------------------------------

def test_depth_normals_match_jax():
    from mygauhuman_tpu.render import depth_normal as JD
    from mygauhuman_torch.render import depth_normal as TD

    rng = np.random.RandomState(11)
    depth = (2.0 + 0.3 * rng.rand(12, 10)).astype(np.float32)
    K = np.array([[20.0, 0, 5.2], [0, 21.0, 6.1], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
    c2w[:3, 3] = rng.randn(3)
    pts = TD.depth_to_world_points(t(depth), t(K), t(c2w))
    close(pts, JD.depth_to_world_points(jnp.asarray(depth), jnp.asarray(K), jnp.asarray(c2w)))
    close(TD.normal_from_depth_image(t(depth), t(K), t(c2w)),
          JD.normal_from_depth_image(jnp.asarray(depth), jnp.asarray(K), jnp.asarray(c2w)))


def test_brdf_mlp_matches_jax():
    from mygauhuman_tpu.models import brdf_mlp as JM
    from mygauhuman_torch import interop
    from mygauhuman_torch.models import brdf_mlp as TM

    jp = JM.init_brdf_mlp(jax.random.PRNGKey(0))
    tp = interop.tensor_tree(jax.tree.map(np.asarray, jp), "cpu")
    init = TM.init_brdf_mlp(device=CPU)
    assert jax.tree.map(np.shape, jp) == {k: {n: tuple(v.shape) for n, v in d.items()}
                                          for k, d in init.items()}
    latent = np.random.RandomState(12).randn(40, 32).astype(np.float32)
    want = JM.apply_brdf_mlp(jp, jnp.asarray(latent))
    got = TM.apply_brdf_mlp(tp, t(latent))
    for k in ("albedo", "roughness", "specular"):
        close(got[k], want[k], 1e-6, k)
    close(TM.latent_kl_loss(t(latent)), JM.latent_kl_loss(jnp.asarray(latent)), 1e-6)
