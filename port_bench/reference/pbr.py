"""Branch B's training step of the plain reference (myGauHuman `train.py:
131,145-164,196-198,233-243,294-363`): the geometry frozen, the materials
and the cubemap light learned against the ground truth through split-sum
shading of the rendered G-buffers.

One iteration on a view, from the camera's uint8 baked occlusion maps:
  * occlusion colour: each Gaussian's map (times 1/255) clamped to [0, 1],
    times the light's grayscale 16 x 32 lat-long export, summed over the
    map, clamped to [0, 3], then to [0, 1] (`train.py:196-198`);
  * the G-buffers: world normal, albedo, occlusion, roughness and alpha,
    blended as the frame's 19 channels (`reference/render.py`'s frame with
    the occlusion colour in the occlusion channels);
  * shading (`reference/shade.py`) with roughness remapped to [0.04, 1]
    and the per-pixel view directions of the camera's rays;
  * the loss: L1 (bound mask) + 0.01 (1 - SSIM) + 0.01 LPIPS (the whole
    frame) + BRDF TV + 5e-5 KDE entropy of the albedo and roughness images
    + 0.1 relative smoothness of each Gaussian's albedo and roughness
    against its 2nd and 3rd nearest neighbours + 0.001 mean (1 - roughness)
    over covered pixels + 0.01 TV of the light's 64 x 128 export;
  * gradients of the albedo and roughness leaves and the light's base;
  * the scene's Adam (eps 1e-15) on the albedo and roughness (lr
    `opacity_lr`) and the normals (`normal_lr`, with a zero gradient: the
    shading reads the normal G-buffer without its gradient); every other
    leaf keeps its value, moments and count (`gaussian_model.py:289-307`);
  * the light's own Adam (lr `opacity_lr`, eps 1e-15), then the light
    clamped at 0 (`train.py:423`).

The nearest neighbours are taken once, over the alive Gaussians' canonical
positions (dead slots parked at 1e6), by the squared distance |q|^2 +
|r|^2 - 2 q.r in blocks of 4,096 queries, self excluded, ties to the lower
index: the program's statement, so that a near-tie falls alike.

Departures from the published description: the light's irradiance
volumes (stepped but unread by the loss upstream) are left out; the
gradients of gathers are autograd's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.reference import light as RLI
from port_bench.reference import losses as RLO
from port_bench.reference import raster as RZ
from port_bench.reference import shade as RS
from port_bench.reference.deform import deform
from port_bench.reference.render import min_axis, scaling
from port_bench.reference.sh import eval_sh_color
from port_bench.reference.train import B1, B2
from port_bench.reference.transforms import covariance6_from_scaling_rotation, normalize, rot_apply

R_MIN = 0.04
MATERIALS = ("albedo", "roughness")
#: the scene leaves a branch-B step moves: the materials, and the normals by
#: their momentum alone
STEPPED = ("albedo", "roughness", "normal")
ENTROPY_BINS = 15
#: a masked-L1 residual nearer 0 than this may take the other sign in another
#: float32 evaluation of the frame (one that blends in another order), and
#: |x|'s derivative flips with it: 2 / (3 x masked pixels) on that channel,
#: enough to move a leaf's gradient norm as far as the TF32 control does
L1_TIE = 1e-5
L1_TIES_KEPT = 6


def gbuffers(p: dict, alive, camera: dict, frame: dict, body: dict, *, sh_degree: int,
             mlp: dict, raster, bg, occlusion_color):
    """(image [H, W, 19], alpha [H, W], blend work) of one view: the frame
    of `reference/render.py` with `occlusion_color` [cap, 3] in the
    occlusion channels."""
    xyz = p["xyz"]
    means3d, world_normal, transforms, _ = deform(body, xyz, p["normal"], frame, frame["big"],
                                                  frame["big_verts"], mlp)
    viewdir = normalize(means3d - camera["cam_center"][None, :])
    axis = min_axis(p)
    axis = torch.where((axis * -viewdir).sum(-1, keepdim=True) >= 0.0, axis, -axis)
    world_axis = normalize(rot_apply(transforms, axis))
    world_normal = normalize(world_normal)
    R_w2c = camera["w2c"][:3, :3]
    flip_y = torch.tensor([1.0, -1.0, 1.0], device=xyz.device)

    def to_cam01(v):
        return (v @ R_w2c.T) * flip_y * 0.5 + 0.5

    opacity = torch.sigmoid(p["opacity"])[:, 0]
    sh = torch.cat([p["features_dc"], p["features_rest"]], dim=1).transpose(1, 2)
    features = torch.cat([eval_sh_color(sh_degree, sh, viewdir), to_cam01(world_normal),
                          world_normal * 0.5 + 0.5, torch.sigmoid(p["albedo"]),
                          occlusion_color, torch.sigmoid(p["roughness"]),
                          to_cam01(world_axis)], dim=1)
    features = torch.where(alive[:, None], features, torch.zeros_like(features))
    cov6 = covariance6_from_scaling_rotation(scaling(p), p["rotation"], 1.0, transforms)
    W, H = camera["width"], camera["height"]
    proj = RZ.preprocess(means3d, cov6, camera["w2c"], camera["full_proj"], W, H,
                         camera["tan_fovx"], camera["tan_fovy"])
    visible = proj.visible & alive
    bins = RZ.bin_gaussians(proj.means2d.detach(), proj.radii, proj.depths.detach(), visible,
                            width=W, height=H, tile_w=raster.tile_w, tile_h=raster.tile_h,
                            max_tiles_per_gaussian=raster.max_tiles_per_gaussian,
                            tile_capacity=raster.tile_capacity,
                            instance_capacity=raster.instance_capacity)
    bg_c = bg.float()
    bg19 = torch.cat([bg_c, bg_c, bg_c, bg_c, bg_c, bg_c.mean()[None], bg_c])
    out = RZ.blend(bins, proj.means2d, proj.conics, opacity, features, proj.depths, bg19,
                   width=W, height=H, tile_w=raster.tile_w, tile_h=raster.tile_h)
    return out.image, out.alpha, out.work


def view_dirs(camera: dict):
    """[H, W, 3] unit surface -> camera directions of the camera's pixel
    rays in world space."""
    H, W = camera["height"], camera["width"]
    dev = camera["w2c"].device
    fx, fy = W / (2.0 * camera["tan_fovx"]), H / (2.0 * camera["tan_fovy"])
    x = (torch.arange(W, dtype=torch.float32, device=dev) - W / 2 + 0.5) / fx
    y = (torch.arange(H, dtype=torch.float32, device=dev) - H / 2 + 0.5) / fy
    d = torch.stack([x[None, :].expand(H, W), y[:, None].expand(H, W),
                     torch.ones((H, W), device=dev)], dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return -(d @ camera["w2c"][:3, :3])


def neighbours(xyz, alive, block: int = 4096):
    """[cap, 3] ids of each Gaussian's three nearest other Gaussians."""
    pts = torch.where(alive[:, None], xyz, torch.full_like(xyz, 1e6))
    rn = (pts * pts).sum(dim=-1)[None, :]
    col = torch.arange(pts.shape[0], device=pts.device)
    out = []
    for q0 in range(0, pts.shape[0], block):
        q = pts[q0:q0 + block]
        d2 = torch.clamp((q * q).sum(dim=-1, keepdim=True) + rn - 2.0 * (q @ pts.T), min=0.0)
        rows = torch.arange(q0, q0 + q.shape[0], device=pts.device)
        d2 = torch.where(rows[:, None] == col[None, :], math.inf, d2)
        ids = []
        for _ in range(3):
            m = d2.min(dim=1, keepdim=True).values
            i = torch.where(d2 == m, col, pts.shape[0]).min(dim=1, keepdim=True).values
            ids.append(i)
            d2 = d2.scatter(1, i, math.inf)
        out.append(torch.cat(ids, dim=1))
    return torch.cat(out)


def occlusion_color(occ_u8, base):
    """[cap, 3] occlusion colour of uint8 maps [cap, H, W, 1] under the light."""
    env = RLI.export_envmap(base, occ_u8.shape[1], occ_u8.shape[2]).mean(dim=-1, keepdim=True)
    occ = torch.clamp(occ_u8.float() * (1.0 / 255.0), 0.0, 1.0) * env[None]
    s = torch.clamp(occ.sum(dim=(1, 2)), 0.0, 3.0)
    return torch.clamp(s.mean(dim=-1, keepdim=True), 0.0, 1.0).repeat(1, 3)


def entropy(img):
    """Sum over channels of the entropy of a soft 15-bin histogram on [0, 1]
    (a Gaussian kernel whose width is the channel's variance)."""
    x = img.reshape(-1, img.shape[-1])
    sigma = x.var(dim=0, unbiased=False)
    delta = 1.0 / ENTROPY_BINS
    centres = delta * (torch.arange(ENTROPY_BINS, dtype=x.dtype, device=x.device) + 0.5)
    d = x[None] - centres[:, None, None]
    h = (torch.exp(-0.5 * (d / (sigma + 1e-12)) ** 2)
         / ((sigma + 1e-12) * math.sqrt(2 * math.pi)) * delta).sum(dim=1)
    total = h.sum(dim=0)
    hn = torch.where(total[None] > 1e-6, h / (total[None] + 1e-12) + 1e-6, torch.ones_like(h))
    return (-hn * torch.log(hn)).sum()


def smoothness(values, nb, alive_f):
    """Relative L1 of each Gaussian's values [cap, C] against its 2nd and
    3rd nearest neighbours', over the mean of the 3rd's, alive rows."""
    nn = values[nb[:, 2]][:, None, :]
    rel = (values[nb[:, 1]][:, None, :] - nn).abs() / (nn.mean(dim=1, keepdim=True) + 1e-6)
    m = alive_f[:, None, None]
    return (rel * m).sum() / torch.clamp(m.sum() * rel.shape[1] * rel.shape[2], min=1.0)


def tv(img):
    return ((img[1:] - img[:-1]) ** 2).mean() + ((img[:, 1:] - img[:, :-1]) ** 2).mean()


def loss(p: dict, base, alive, view: dict, occ_u8, nb, body: dict, *, sh_degree: int,
         mlp: dict, raster, bg, lpips_params, lut, keep: dict | None = None):
    """(total, {term: value}, blend work) of one view; `keep`, where given,
    receives the shaded colour [H, W, 3] as "rgb"."""
    occ_col = occlusion_color(occ_u8, base.detach())
    img, alpha, work = gbuffers(p, alive, view["camera"], view["frame"], body,
                                sh_degree=sh_degree, mlp=mlp, raster=raster, bg=bg,
                                occlusion_color=occ_col)
    albedo, rough = img[..., 9:12], img[..., 15]
    light = RLI.Light(base)
    rgb = RS.shade(light, (img[..., 6:9] * 2.0 - 1.0).detach(), view_dirs(view["camera"]),
                   albedo, rough * (1.0 - R_MIN) + R_MIN, alpha, img[..., 12], lut)
    if keep is not None:
        keep["rgb"] = rgb
    gt, bm = view["gt_image"], view["bound_mask"].float()
    rough_img = rough[..., None] * (1.0 - R_MIN) + R_MIN
    covered = (alpha > 0).float()
    alive_f = alive.float()
    terms = {
        "l1": RLO.masked_l1(rgb, gt, bm),
        "ssim": RLO.ssim(rgb, gt, bm),
        "lpips": (RLO.lpips(lpips_params, rgb[None], gt[None])[0] if lpips_params is not None
                  else torch.zeros((), device=rgb.device)),
        "brdf_tv": RLO.masked_tv(alpha, torch.cat([albedo, rough_img], dim=-1)),
        "entropy": entropy(albedo) + entropy(rough_img),
        "smooth": (smoothness(torch.sigmoid(p["albedo"]), nb, alive_f)
                   + smoothness(torch.sigmoid(p["roughness"]), nb, alive_f)),
        "lamb": ((1.0 - rough_img[..., 0]) * covered).sum() / torch.clamp(covered.sum(), min=1.0),
        "env_tv": tv(RLI.export_envmap(base, 64, 128)),
    }
    total = (terms["l1"] + 0.01 * (1.0 - terms["ssim"]) + 0.01 * terms["lpips"]
             + 1.0 * terms["brdf_tv"] + 5.0e-5 * terms["entropy"] + 0.1 * terms["smooth"]
             + 0.001 * terms["lamb"] + 0.01 * terms["env_tv"])
    return total, terms, work


def l1_ties(rgb, view: dict, wrt: tuple, tol: float = L1_TIE, most: int = L1_TIES_KEPT) -> list:
    """The first gradient's other values at the masked L1's residuals within
    `tol` of 0 (the `most` nearest, over shaded channels): for each, a list
    of the changes to the gradients of `wrt` were the residual's sign the
    other (both signs where it is 0). The graph of `rgb` must be kept."""
    mask = view["bound_mask"].float()
    d = (rgb - view["gt_image"]).detach()
    n = float(torch.clamp(mask.sum() * rgb.shape[-1], min=1.0))
    near = (mask[..., None] > 0) & (rgb.detach() != 0) & (d.abs() < tol)
    a = torch.where(near, d.abs(), torch.full_like(d, math.inf)).reshape(-1)
    k = min(most, int(near.sum()))
    out = []
    for i in a.topk(k, largest=False).indices.tolist():
        g = torch.autograd.grad(rgb.reshape(-1)[i], wrt, retain_graph=True)
        sign = float(torch.sign(d.reshape(-1)[i]))
        out.append([[-2.0 * sign * x / n for x in g]] if sign
                   else [[x / n for x in g], [-x / n for x in g]])
    return out


def adam(p, g, mu, nu, lr: float, count: int, eps: float = 1e-15):
    """One Adam update after `count` updates (this one included); the bias
    corrections 1 - b^count in float32, as optax's."""
    mu = (1 - B1) * g + B1 * mu
    nu = (1 - B2) * (g * g) + B2 * nu
    bc1 = float(1 - np.float32(B1) ** count)
    bc2 = float(1 - np.float32(B2) ** count)
    return p - lr * (mu / bc1) / (torch.sqrt(nu / bc2) + eps), mu, nu


def momentum_steps(p, mu, nu, lr: float, count: int, steps: int, eps: float = 1e-15):
    """A leaf after `steps` Adam updates with zero gradients from moments
    (mu, nu) after `count` updates: its momentum alone."""
    for t in range(steps):
        p, mu, nu = adam(p, torch.zeros_like(p), mu, nu, lr, count + t + 1, eps)
    return p


def train_steps(start: dict, views: list, occ: list, nb, body: dict, optim: dict, *,
                counts: dict, sh_degree: int, mlp: dict, raster, bg, lpips_params,
                fault: str | None = None, ties: list | None = None):
    """Steps from `start` ({"params": scene leaves, "mu", "nu": their
    moments, "base": the light}) on `views` with their uint8 maps `occ` ->
    (losses, the first step's gradients {albedo, roughness, light}, the
    scene leaves and light after the last step). `counts`: the scene
    groups' completed updates. A planted `fault` "light_frozen" leaves the
    light as it is. `ties`, where given, receives `l1_ties` of the first
    step."""
    lut = RS.brdf_lut(start["base"].device)
    p = {k: v.detach().clone() for k, v in start["params"].items()}
    mu = {k: start["mu"][k].detach().clone() for k in STEPPED}
    nu = {k: start["nu"][k].detach().clone() for k in STEPPED}
    base = start["base"].detach().clone()
    lmu, lnu = torch.zeros_like(base), torch.zeros_like(base)
    alive = start["alive"]
    lr = {"albedo": optim["opacity_lr"], "roughness": optim["opacity_lr"],
          "normal": optim["normal_lr"]}
    losses, first = [], None
    for t, (view, o) in enumerate(zip(views, occ)):
        leaves = {k: p[k].detach().requires_grad_(True) for k in MATERIALS}
        b = base.detach().requires_grad_(True)
        kept = {}
        total, _, _ = loss({**p, **leaves}, b, alive, view, o, nb, body, sh_degree=sh_degree,
                           mlp=mlp, raster=raster, bg=bg, lpips_params=lpips_params, lut=lut,
                           keep=kept)
        wrt = (leaves["albedo"], leaves["roughness"], b)
        keep_graph = first is None and ties is not None
        ga, gr, gb = torch.autograd.grad(total, wrt, retain_graph=keep_graph)
        losses.append(float(total.detach()))
        if first is None:
            first = {"albedo": ga, "roughness": gr, "light": gb}
            if keep_graph:
                ties.extend(l1_ties(kept["rgb"], view, wrt))
        del kept
        grads = {"albedo": ga, "roughness": gr, "normal": torch.zeros_like(p["normal"])}
        for k in STEPPED:
            p[k], mu[k], nu[k] = adam(p[k], grads[k], mu[k], nu[k], lr[k],
                                      counts[k] + t + 1, optim["adam_eps"])
        new_base, lmu, lnu = adam(base, gb, lmu, lnu, optim["opacity_lr"], t + 1)
        if fault != "light_frozen":
            base = torch.clamp(new_base, min=0.0)
    return losses, first, {**{k: p[k] for k in STEPPED}, "light": base}
