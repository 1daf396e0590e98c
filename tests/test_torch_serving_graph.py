"""The captured serving frame (`render/graph.py::GraphedRenderer`), the
capturable slot count of `ops/binning.py` and `bench_torch.py`, against the
JAX package and the port's eager `render_frame`.

On the CPU the renderer stages every request into its static buffers and
runs the frame eagerly (the CUDA graphs are held on the card by
tests/test_torch_kernels.py and chip_smoke.py). Five requests, views
interleaved and opacity epsilons distinct, go through one renderer on each
branch: each is held to a jitted JAX `render_frame` of the same request
within RENDER_ATOL = 1e-3 (tests/test_torch_render.py's bound: the chain
runs in fp32 on both sides with other rounding), and bit for bit to the
port's eager `render_frame`. The slot count is integer arithmetic, so it
equals `torch.bincount` exactly. `bench_torch.py` at 64^2: its last line is
bench.py's JSON, its sweep checksums equal an eager port loop bit for bit
and a loop of JAX `render_frame` with the same epsilons within 1e-3.
"""
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mygauhuman_tpu.data.camera import Camera as JCamera
from mygauhuman_tpu.data.camera import make_camera as jmake_camera
from mygauhuman_tpu.models import gaussians as JG
from mygauhuman_tpu.models import mlps as jmlps
from mygauhuman_tpu.models.smpl import big_pose_params as jbig, smpl_forward as jfwd
from mygauhuman_tpu.models.smpl import synthetic_smpl as jsmpl
from mygauhuman_tpu.ops.rasterize import RasterizerConfig as JConfig
from mygauhuman_tpu.render import FrameInputs as JFrame, render_frame as jrender
from mygauhuman_torch import interop
from mygauhuman_torch.data.camera import make_camera
from mygauhuman_torch.models.smpl import big_pose_params, synthetic_smpl
from mygauhuman_torch.ops.binning import slot_counts
from mygauhuman_torch.ops.rasterize import RasterizerConfig
from mygauhuman_torch.render import FrameInputs, render_frame
from mygauhuman_torch.render.graph import GraphedRenderer

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 64
N_VERTS = 300
RENDER_ATOL = 1e-3
JCFG = JConfig(tile_capacity=256, chunk_tiles=16, instance_capacity=4 * 512)
TCFG = RasterizerConfig(tile_capacity=256, chunk_tiles=16, instance_capacity=4 * 512)
REQUESTS = [(0, 0.0), (1, 3e-12), (0, 1e-3), (3, 2e-12), (2, -1e-3)]   # (view, epsilon)
IMAGE_FIELDS = ("render", "render_depth", "render_alpha", "normal", "world_normal",
                "albedo", "occlusion", "roughness", "render_axis")
EXACT_FIELDS = IMAGE_FIELDS + ("radii", "transforms", "translation", "overflow_tiles",
                               "overflow_gauss", "overflow_inst")


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def look_at(theta, center, radius=3.0):
    """(R c2w, t w2c) of a camera on a circle around `center`, looking at it."""
    eye = center + radius * np.array([np.sin(theta), 0.0, np.cos(theta)])
    fwd = (center - eye) / np.linalg.norm(center - eye)
    right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    return R, -R.T @ eye


@pytest.fixture(scope="module")
def setup():
    """One 300-vertex scene and 4 views (one more at another fov) in both
    packages, from the same numpy inputs."""
    jm = jsmpl(num_vertices=N_VERTS, seed=0)
    big = jbig()
    verts = np.asarray(jfwd(jm, big["poses"], big["shapes"])[0])
    rng = np.random.RandomState(0)
    colors = rng.rand(N_VERTS, 3).astype(np.float32)
    normals = rng.randn(N_VERTS, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    jstate = JG.create_from_pcd(verts, colors, normals, capacity=512)
    p = jstate.params
    jstate = jstate._replace(params=p._replace(
        features_rest=jnp.asarray(0.2 * rng.randn(*p.features_rest.shape), jnp.float32),
        opacity=jnp.asarray(rng.randn(512, 1) + 1.0, jnp.float32)))
    pose = (0.2 * rng.randn(72)).astype(np.float32)
    smpl_param = {"poses": pose, "shapes": np.zeros(10, np.float32),
                  "R": np.eye(3, dtype=np.float32), "Th": np.array([0.0, 0.1, 0.0], np.float32)}
    center = verts.mean(axis=0)
    poses = [look_at(2 * np.pi * v / 4, center) for v in range(4)]
    fovs = [1.0] * 4 + [0.8]
    jmlp = {"pose_refiner": jmlps.init_pose_refiner(jax.random.PRNGKey(0)),
            "lbs_offset": jmlps.init_lbs_offset(jax.random.PRNGKey(1))}
    return dict(
        jm=jm, tm=synthetic_smpl(num_vertices=N_VERTS, seed=0, device="cpu"),
        jstate=jstate, tstate=interop.gaussian_state(as_np(jstate), device="cpu"),
        jframe=JFrame(smpl_param={k: jnp.asarray(v) for k, v in smpl_param.items()},
                      big_pose_param=big, big_pose_verts=jnp.asarray(verts)),
        tframe=FrameInputs(smpl_param=interop.tensor_tree(smpl_param, "cpu"),
                           big_pose_param=big_pose_params(device="cpu"),
                           big_pose_verts=torch.as_tensor(verts.copy())),
        jcams=[jmake_camera(R, t, W, H, fovx=f, fovy=f) for (R, t), f in
               zip(poses + poses[:1], fovs)],
        tcams=[make_camera(R, t, W, H, fovx=f, fovy=f, device="cpu") for (R, t), f in
               zip(poses + poses[:1], fovs)],
        jmlp=jmlp, tmlp=interop.tensor_tree(as_np(jmlp), "cpu"),
    )


def jax_frame(jm, mlp_params, bg):
    """JAX render_frame as one jitted program per branch (the camera's
    matrices and fovs traced, as the JAX serving path runs it)."""
    @jax.jit
    def run(state, cam, frame, eps, tfs, tls):
        st = state._replace(params=state.params._replace(opacity=state.params.opacity + eps))
        return jrender(st, cam, frame, jm, bg=bg, active_sh_degree=3, config=JCFG,
                       mlp_params=mlp_params, transforms=tfs, translation=tls)
    return run


def eager(s, cam, eps, mlp_params, bg, replay):
    p = s["tstate"].params
    st = s["tstate"]._replace(params=p._replace(opacity=p.opacity + eps))
    with torch.no_grad():
        return render_frame(st, cam, s["tframe"], s["tm"], bg=bg, active_sh_degree=3,
                            config=TCFG, mlp_params=mlp_params, **replay)


@pytest.mark.parametrize("branch", ["deform", "deform_mlps", "replay"])
def test_graphed_requests_match_jax_and_eager(setup, branch):
    s = setup
    bg_np = np.array([0.1, 0.3, 0.6], np.float32)
    bg = torch.as_tensor(bg_np)
    tmlp = s["tmlp"] if branch == "deform_mlps" else None
    jmlp = s["jmlp"] if branch == "deform_mlps" else None
    rows = {}
    if branch == "replay":
        # each view's transforms from a deform render, as a server caches them
        for v in range(4):
            d = eager(s, s["tcams"][v], 0.0, None, bg, {})
            rows[v] = dict(transforms=d.transforms, translation=d.translation)
    renderer = GraphedRenderer(s["tstate"], s["tm"], bg=bg, active_sh_degree=3, config=TCFG,
                               mlp_params=tmlp)
    run_jax = jax_frame(s["jm"], jmlp, jnp.asarray(bg_np))
    for v, eps in REQUESTS:
        replay = rows.get(v, {})
        got = renderer(s["tcams"][v], s["tframe"], opacity_eps=eps, **replay)
        want = eager(s, s["tcams"][v], eps, tmlp, bg, replay)
        for f in EXACT_FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), (v, eps, f)
        if tmlp is not None:
            assert torch.equal(got.correct_Rs, want.correct_Rs)
        jreplay = {k: jnp.asarray(t.numpy()) for k, t in replay.items()}
        jwant = run_jax(s["jstate"], s["jcams"][v], s["jframe"], jnp.float32(eps),
                        jreplay.get("transforms"), jreplay.get("translation"))
        for f in IMAGE_FIELDS:
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(jwant, f)),
                                       atol=RENDER_ATOL, err_msg=f"view {v} eps {eps} {f}")
        np.testing.assert_array_equal(got.radii.numpy(), np.asarray(jwant.radii))
        assert float(got.render_alpha.max()) > 0.5
    # one graph key per branch so far; a camera at another fov is a new key
    assert len(renderer.slots) == 1
    got = renderer(s["tcams"][4], s["tframe"], opacity_eps=0.0, **rows.get(0, {}))
    assert len(renderer.slots) == 2
    want = eager(s, s["tcams"][4], 0.0, tmlp, bg, rows.get(0, {}))
    for f in EXACT_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    (key_a, key_b) = renderer.slots
    assert key_a.branch == key_b.branch == ("replay" if rows else "deform")
    assert key_a.tan_fovx != key_b.tan_fovx
    assert renderer.captures == 0 and renderer.launches == {}   # no graphs on the CPU


@pytest.mark.parametrize("case", ["random", "all_dead", "one_tile"])
def test_slot_counts_match_bincount(case):
    T = 37
    rng = np.random.RandomState(3)
    n = 16 * 500
    if case == "random":
        flat = rng.randint(0, T + 1, size=n)
    elif case == "all_dead":
        flat = np.full(n, T)
    else:
        flat = np.where(rng.rand(n) < 0.5, 11, T)
    flat = torch.as_tensor(flat, dtype=torch.int32)
    got = slot_counts(flat, T)
    want = torch.bincount(flat.long(), minlength=T + 1)[:T].to(torch.int32)
    assert got.dtype == torch.int32 and got.shape == (T,)
    assert torch.equal(got, want)
    if case == "one_tile":
        assert int(got[11]) == int((flat == 11).sum()) and int(got.sum()) == int(got[11])


def test_bench_torch_cpu_run(capsys):
    sys.path.insert(0, REPO)
    try:
        import bench_torch
    finally:
        sys.path.remove(REPO)
    frames = 5
    res = bench_torch.main(["--device", "cpu", "--frames", str(frames), "--size", str(W),
                            "--verts", str(N_VERTS), "--capacity", "1024",
                            "--tile_capacity", "256"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    line = json.loads(last)
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "render_fps_512" and line["unit"] == "frames/s"
    assert line["value"] > 0 and math.isclose(line["vs_baseline"],
                                              line["value"] / bench_torch.BASELINE_FPS,
                                              abs_tol=2e-3)

    # the same sweep through the port's eager render_frame, bit for bit
    scene, views, cfg = res["scene"], res["views"], res["config"]
    state = scene.gt_state
    V = len(scene.batches)
    acc = torch.zeros(())
    img = torch.zeros(())
    outs = []
    with torch.no_grad():
        for i in range(frames):
            b = scene.batches[i % V]
            p = state.params
            st = state._replace(params=p._replace(
                opacity=p.opacity + bench_torch.frame_eps(i)))
            out = render_frame(st, b.camera, b.frame, scene.smpl_model, bg=torch.zeros(3),
                               active_sh_degree=0, config=cfg, **views[i % V]).render
            acc = acc + out[0, 0, 0]
            img = img + out.sum()
            outs.append(out)
    assert float(acc) == res["checksum"] and float(img) == res["image_checksum"]

    # and through JAX render_frame with the same epsilons
    jcfg = JConfig(tile_capacity=256, chunk_tiles=64, instance_capacity=4 * 1024)
    leaves = lambda t: jax.tree.map(lambda x: jnp.asarray(x.numpy()), t)  # noqa: E731
    pf = state.params
    jstate = JG.GaussianState(
        params=JG.GaussianParams(**{f: jnp.asarray(getattr(pf, f).numpy())
                                    for f in JG.GaussianParams._fields}),
        **{f: jnp.asarray(getattr(state, f).numpy()) for f in JG.GaussianState._fields
           if f != "params"})
    jm = jsmpl(num_vertices=N_VERTS, seed=0)

    @jax.jit
    def run(cam, frame, eps, tfs, tls):
        st = jstate._replace(params=jstate.params._replace(opacity=jstate.params.opacity + eps))
        return jrender(st, cam, frame, jm, bg=jnp.zeros(3), active_sh_degree=0, config=jcfg,
                       transforms=tfs, translation=tls).render

    jacc = jimg = 0.0
    for i in range(frames):
        b = scene.batches[i % V]
        c = b.camera
        jcam = JCamera(w2c=jnp.asarray(c.w2c.numpy()), full_proj=jnp.asarray(c.full_proj.numpy()),
                       cam_center=jnp.asarray(c.cam_center.numpy()), tan_fovx=c.tan_fovx,
                       tan_fovy=c.tan_fovy, width=c.width, height=c.height)
        jframe = JFrame(smpl_param=leaves(b.frame.smpl_param),
                        big_pose_param=leaves(b.frame.big_pose_param),
                        big_pose_verts=jnp.asarray(b.frame.big_pose_verts.numpy()))
        out = np.asarray(run(jcam, jframe, jnp.float32(bench_torch.frame_eps(i)),
                             jnp.asarray(views[i % V]["transforms"].numpy()),
                             jnp.asarray(views[i % V]["translation"].numpy())))
        np.testing.assert_allclose(outs[i].numpy(), out, atol=RENDER_ATOL, err_msg=f"frame {i}")
        jacc += float(out[0, 0, 0])
        jimg += float(out.sum(dtype=np.float64))
    assert abs(jacc - res["checksum"]) <= 1e-3
    assert abs(jimg - res["image_checksum"]) <= 1e-3 * max(1.0, abs(jimg))
