"""The inputs of a cell, made by the benchmark itself: the body, the cameras
and the poses from the configuration's fixed capture stream (one subject
and one rig for every seed), and from the seed the appearance, the ground
truth, the Gaussian states, the correction MLPs and the LPIPS backbone. Both the program and the reference
are handed these; neither makes them. Weights and states are drawn on the
device from one `torch.Generator` in a few large calls; the cameras (a few
4x4 matrices) are built on the host in float64, as the program's own
`data/camera.py` builds them.

The recipes are those of `mygauhuman_torch/data/synthetic.py::
make_synthetic_scene` (SMPL) and `chip_smoke.py::make_smplx_scene`
(SMPL-X): a known Gaussian human, one Gaussian per body vertex at the big
pose, seeded colours and normals, opacity 0.9, rendered at each view's pose
as the ground truth, and the training start from the same geometry with
grey colours and opacity 0.1. The ground truth is rendered by the
reference (`reference/render.py`), so it does not change when the program
does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.reference import body as B
from port_bench.reference.precision import precision
from port_bench.reference.render import Raster, render
from port_bench.reference.sh import C0
from port_bench.reference.transforms import normalize

DEAD_FILLS = {"scaling": -10.0, "opacity": -10.0}


def generator(seed: int, device, stream: int) -> torch.Generator:
    """The generator of one stream of draws (body, scene, weights, ...):
    independent streams keep each input fixed when another changes."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 63), stream])


# ---- cameras -----------------------------------------------------------------

def camera(eye, target, width: int, height: int, focal: float, device) -> dict:
    """A pinhole camera at `eye` looking at `target` (+z forward, y down),
    principal point at the centre: w2c, full_proj (znear 0.001, zfar 1000),
    cam_center, tan_fovx / tan_fovy, width, height."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)          # camera-to-world rotation
    w2c = np.eye(4)
    w2c[:3, :3] = R.T
    w2c[:3, 3] = -R.T @ eye
    w2c = w2c.astype(np.float32).astype(np.float64)
    znear, zfar = 0.001, 1000.0
    P = np.zeros((4, 4))
    P[0, 0], P[1, 1] = 2 * focal / width, 2 * focal / height
    P[2, 2] = (zfar + znear) / (zfar - znear)
    P[2, 3] = -2 * zfar * znear / (zfar - znear)
    P[3, 2] = 1.0
    P = P.astype(np.float32).astype(np.float64)
    c2w = np.linalg.inv(w2c)
    return {"w2c": torch.as_tensor(w2c.astype(np.float32), device=device),
            "full_proj": torch.as_tensor((P @ w2c).astype(np.float32), device=device),
            "cam_center": torch.as_tensor(c2w[:3, 3].astype(np.float32), device=device),
            "tan_fovx": width / (2 * focal), "tan_fovy": height / (2 * focal),
            "width": int(width), "height": int(height)}


def ring_cameras(cfg: dict, center, ring: int, indices, focal_scale, device) -> list:
    """Cameras `indices` of a ring of `ring` positions around `center`, each
    with its own focal length (the configuration's, times its scale)."""
    W, H = cfg["frame"]["width"], cfg["frame"]["height"]
    cams = cfg["cameras"]
    return [camera(B.orbit_eye(center, cams["radius_m"], 2 * math.pi * i / ring), center, W, H,
                   cams["focal_px"] * float(s), device)
            for i, s in zip(indices, focal_scale)]


# ---- Gaussians -----------------------------------------------------------------

def knn_scale(points, k: int = 3, block: int = 4096):
    """log sqrt of the mean squared distance to the k nearest other points
    (`create_from_pcd`'s initial scale)."""
    out = []
    for q0 in range(0, points.shape[0], block):
        d2 = torch.cdist(points[q0:q0 + block], points) ** 2
        rows = torch.arange(q0, q0 + d2.shape[0], device=points.device)
        d2[torch.arange(d2.shape[0], device=points.device), rows] = float("inf")
        out.append(torch.topk(d2, k, dim=1, largest=False).values.mean(dim=1))
    d2 = torch.clamp(torch.cat(out), min=1e-7)
    return torch.log(torch.sqrt(d2))


def pad(p: dict, n: int, capacity: int) -> dict:
    """Rows n..capacity filled as dead slots (log-scale -10, opacity logit
    -10, unit quaternion, zeros elsewhere)."""
    out = {}
    for f, x in p.items():
        full = torch.full((capacity,) + tuple(x.shape[1:]), DEAD_FILLS.get(f, 0.0),
                          dtype=x.dtype, device=x.device)
        full[:n] = x
        if f == "rotation":
            full[n:, 0] = 1.0
        out[f] = full
    return out


def body_gaussians(points, colors, normals, opacity: float, sh_rest: int, capacity: int):
    """One Gaussian per point (`create_from_pcd`'s recipe): SH DC from the
    colour, scale from the 3 nearest points, identity rotation, the given
    opacity, albedo and roughness logits 1."""
    n, dev = points.shape[0], points.device
    p = {"xyz": points, "features_dc": ((colors - 0.5) / C0)[:, None, :],
         "features_rest": torch.zeros((n, sh_rest, 3), device=dev),
         "scaling": knn_scale(points)[:, None].repeat(1, 3),
         "rotation": torch.cat([torch.ones((n, 1), device=dev),
                                torch.zeros((n, 3), device=dev)], dim=1),
         "opacity": torch.full((n, 1), math.log(opacity / (1 - opacity)), device=dev),
         "normal": normals, "albedo": torch.ones((n, 3), device=dev),
         "roughness": torch.ones((n, 1), device=dev)}
    return pad(p, n, capacity), torch.arange(capacity, device=dev) < n


def capacity_for(n: int) -> int:
    """`cli.train --synthetic`'s rule: 1,024 doubled until it holds twice
    the Gaussians."""
    cap = 1024
    while cap < 2 * n:
        cap *= 2
    return cap


# ---- correction MLPs and the LPIPS backbone ------------------------------------

def _linear(gen, fan_in, fan_out, device, gain=math.sqrt(2.0), bound=None):
    bound = gain * math.sqrt(3.0 / fan_in) if bound is None else bound
    w = (2 * torch.rand((fan_in, fan_out), generator=gen, device=device) - 1) * bound
    return {"w": w, "b": torch.zeros(fan_out, device=device)}


def mlps(joints: int, gen, device, head_bound: float = 1e-5) -> dict:
    """The pose refiner (3 (J - 1) -> 128 -> 128 -> 3 (J - 1), its head
    within +-head_bound) and the PE-63 LBS-offset decoder (4 layers of 128,
    the skip after layer 2, a head to J), xavier-uniform with the ReLU gain
    as `models/mlps.py` initialises them."""
    d = 3 * (joints - 1)
    refiner = {"layers": [_linear(gen, d, 128, device), _linear(gen, 128, 128, device),
                          _linear(gen, 128, d, device, bound=head_bound)]}
    layers, d_prev = [], 63
    for i in range(4):
        layers.append(_linear(gen, d_prev, 128, device))
        d_prev = 128 + (63 if i == 2 else 0)
    offset = {"layers": layers, "head": _linear(gen, d_prev, joints, device, gain=1.0)}
    return {"pose_refiner": refiner, "lbs_offset": offset}


VGG_PLAN = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
STAGE_CHANNELS = (64, 128, 256, 512, 512)


def lpips_params(gen, device) -> dict:
    """A He-initialised random VGG16 trunk with 1/C heads (the port's
    deterministic random backbone, `eval/lpips.py::init_lpips`), drawn on
    the device: 13 convolutions of 3 x 3, zero biases."""
    convs, cin = [], 3
    for cout in VGG_PLAN:
        w = torch.randn((cout, cin, 3, 3), generator=gen, device=device) * math.sqrt(
            2.0 / (9 * cin))
        convs.append((w, torch.zeros(cout, device=device)))
        cin = cout
    lins = [torch.full((c,), 1.0 / c, device=device) for c in STAGE_CHANNELS]
    return {"convs": convs, "lins": lins}


# ---- the scene -----------------------------------------------------------------

def masks(alpha, pad_px: int = 4):
    """(person mask, dilated bbox mask) of a rendered alpha
    (`data/synthetic.py::_masks`)."""
    H, W = alpha.shape
    bkgd = (alpha > 0.5).float()
    on = alpha > 0.01
    rows = torch.nonzero(on.any(dim=1)).reshape(-1)
    cols = torch.nonzero(on.any(dim=0)).reshape(-1)
    y0 = max((int(rows[0]) if rows.numel() else H) - pad_px, 0)
    y1 = min((int(rows[-1]) if rows.numel() else 0) + pad_px, H)
    x0 = max((int(cols[0]) if cols.numel() else W) - pad_px, 0)
    x1 = min((int(cols[-1]) if cols.numel() else 0) + pad_px, W)
    yy = torch.arange(H, device=alpha.device)[:, None]
    xx = torch.arange(W, device=alpha.device)[None, :]
    return bkgd, ((yy >= y0) & (yy <= y1) & (xx >= x0) & (xx <= x1)).float()


def raster_of(cfg: dict, capacity: int) -> Raster:
    """The configuration's rasterizer settings at a Gaussian capacity."""
    r = cfg["raster"]
    return Raster(tile_w=r["tile"], tile_h=r["tile"],
                  max_tiles_per_gaussian=r["tiles_per_gaussian"],
                  tile_capacity=r["tile_capacity"],
                  instance_capacity=r["instances_per_slot"] * capacity)


def seeded_pose(rng: np.random.Generator, kind: str, sigma: float) -> tuple:
    """(poses, shapes) of one frame: `make_synthetic_scene`'s 0.1 randn(72)
    for SMPL; `make_smplx_scene`'s 0.1 randn(55, 3) with a zero root and
    0.3 randn(20) shape and expression coefficients for SMPL-X."""
    if kind == "smpl":
        return (sigma * rng.standard_normal(72)).astype(np.float32), np.zeros(10, np.float32)
    pose = (sigma * rng.standard_normal((55, 3))).astype(np.float32)
    pose[0] = 0.0
    return pose.reshape(-1), (0.3 * rng.standard_normal(20)).astype(np.float32)


class Scene:
    """The body and its frames: `body`, `big` (the big pose), `big_verts`,
    `center`, `extent` (half the bbox diagonal: the densify events' scene
    extent)."""

    def __init__(self, cfg: dict, seed: int, device):
        b = cfg["body"]
        self.kind, self.device = b["kind"], device
        self.n_shape = b["shape_coeffs"]
        # the subject is the capture's: the same body for every seed, so
        # that the silhouettes, and with them the LPIPS crop that the
        # program picks, never move with the seed
        self.body = B.make_body(b["kind"], b["vertices"], self.n_shape,
                                generator(cfg["capture_seed"], device, 1), device)
        self.big = B.big_pose(b["kind"], self.n_shape, device)
        with torch.no_grad():
            self.big_verts = B.forward(self.body, self.big["poses"], self.big["shapes"])
        v = self.big_verts.cpu().numpy().astype(np.float64)
        self.center = v.mean(axis=0)
        self.extent = float(np.linalg.norm(v.max(0) - v.min(0))) * 0.5

    def frame(self, poses, shapes) -> dict:
        dev = self.device
        return {"poses": torch.as_tensor(poses, device=dev),
                "shapes": torch.as_tensor(shapes, device=dev),
                "R": torch.eye(3, device=dev), "Th": torch.zeros(3, device=dev),
                "big": self.big, "big_verts": self.big_verts}


def train_inputs(cfg: dict, seed: int, device) -> dict:
    """Everything a training cell hands the program and the reference:
    the scene, its views (camera, frame, ground truth, masks), the initial
    Gaussians, the MLPs, the LPIPS backbone, the raster settings."""
    scene = Scene(cfg, seed, device)
    n = cfg["body"]["vertices"]
    cap = capacity_for(n)
    raster = raster_of(cfg, cap)
    gen = generator(seed, device, 2)
    colors = torch.rand((n, 3), generator=gen, device=device)
    normals = normalize(torch.randn((n, 3), generator=gen, device=device))
    rest = (cfg["sh_degree"] + 1) ** 2 - 1
    with torch.no_grad():
        gt, gt_alive = body_gaussians(scene.big_verts, colors, normals, 0.9, rest, cap)
        init, alive = body_gaussians(scene.big_verts, torch.full_like(colors, 0.5), normals,
                                     0.1, rest, cap)
    cams = cfg["cameras"]
    rng = host_rng(cfg["capture_seed"], 3)
    cameras = ring_cameras(cfg, scene.center, cams["ring"], cams["train"], cams["focal_scale"],
                           device)
    views = []
    bg = torch.zeros(3, device=device)
    for c in cameras:
        for _ in range(cfg["poses"]["train"]):
            frame = scene.frame(*seeded_pose(rng, scene.kind, cfg["poses"]["sigma_rad"]))
            with torch.no_grad(), precision():
                out = render(gt, gt_alive, c, frame, scene.body, sh_degree=0, mlp=None,
                             raster=raster, bg=bg)
            bkgd, bound = masks(out.alpha)
            views.append({"camera": c, "frame": frame, "gt_image": out.render.contiguous(),
                          "gt_normal": out.normal.contiguous(), "bkgd_mask": bkgd,
                          "bound_mask": bound})
    wgen = generator(seed, device, 4)
    joints = len(scene.body["parents"])
    return {"scene": scene, "views": views, "init": init, "alive": alive, "capacity": cap,
            "raster": raster, "mlps": mlps(joints, wgen, device),
            "lpips": lpips_params(wgen, device) if cfg["lpips"] else None,
            "bg": bg, "optim": dict(cfg["optim"]), "sh_degree": cfg["sh_degree"]}


def served_model(cfg: dict, scene: Scene, seed: int, device) -> dict:
    """A trained avatar's stand-in, placed on the body: the configuration's
    `served.gaussians` Gaussians near big-pose vertices (offsets of 1 cm),
    scales 3-15 mm, random rotations, opacities 0.3-0.99 (the capture's
    fixed draws, in an order drawn from the seed), random SH colour to
    degree 3 and seeded corrections (from the seed), compacted to
    `served.capacity` slots as `cli.render` compacts a PLY."""
    s = cfg["served"]
    n, cap = s["gaussians"], s["capacity"]
    geo = generator(cfg["capture_seed"], device, 5)
    gen = generator(seed, device, 5)
    V = scene.big_verts.shape[0]
    rest = (cfg["sh_degree"] + 1) ** 2 - 1

    def u(g, shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)

    vid = torch.randint(0, V, (n,), generator=geo, device=device)
    offset = 0.01 * torch.randn((n, 3), generator=geo, device=device)
    scale = torch.log(u(geo, (n, 3), 0.003, 0.015))
    rot = normalize(torch.randn((n, 4), generator=geo, device=device))
    op = u(geo, (n, 1), 0.3, 0.99)
    order = torch.randperm(n, generator=gen, device=device)
    p = {"xyz": (scene.big_verts[vid] + offset)[order],
         "features_dc": ((u(gen, (n, 3), 0.0, 1.0) - 0.5) / C0)[:, None, :],
         "features_rest": 0.1 * torch.randn((n, rest, 3), generator=gen, device=device),
         "scaling": scale[order], "rotation": rot[order],
         "opacity": torch.log(op / (1 - op))[order],
         "normal": normalize(torch.randn((n, 3), generator=gen, device=device)),
         "albedo": torch.randn((n, 3), generator=gen, device=device),
         "roughness": torch.randn((n, 1), generator=gen, device=device)}
    params = pad(p, n, cap)
    alive = torch.arange(cap, device=device) < n
    joints = len(scene.body["parents"])
    return {"params": params, "alive": alive, "capacity": cap,
            "mlps": mlps(joints, generator(seed, device, 6), device, head_bound=1e-3),
            "raster": raster_of(cfg, cap)}


def motion(cfg: dict, traffic: dict, seed: int, n_frames: int) -> np.ndarray:
    """[n_frames, 3 J] float32: a smooth motion, each non-root pose angle a
    sum of two sinusoids (amplitudes up to `amplitude_rad`, frequencies in
    `freq_hz`) sampled at `fps`; the root stays still. The motion is the
    configuration's (a fixed stream); the seed picks where it starts."""
    m = traffic["motion"]
    J = len(B.SMPL_PARENTS if cfg["body"]["kind"] == "smpl" else B.SMPLX_PARENTS)
    rng = host_rng(cfg["capture_seed"], 7)
    start = int(host_rng(seed, 7).integers(0, n_frames))
    t = (start + np.arange(n_frames))[:, None] / m["fps"]
    out = np.zeros((n_frames, 3 * J))
    lo, hi = m["freq_hz"]
    for _ in range(2):
        amp = m["amplitude_rad"] * rng.random(3 * J) / 2
        f = lo + (hi - lo) * rng.random(3 * J)
        ph = 2 * np.pi * rng.random(3 * J)
        out += amp * np.sin(2 * np.pi * f * t + ph)
    out[:, :3] = 0.0
    return out.astype(np.float32)
