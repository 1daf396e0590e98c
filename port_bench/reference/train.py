"""Branch A's training step of the plain reference: render, loss, autograd,
and the per-group Adam of the reference (one Adam with eps 1e-15, a group
per Gaussian leaf and one per correction MLP, xyz on the exponential
schedule), written from `mygauhuman_torch/train/optim.py`'s statement of
it:

  mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
  p += -lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

The trainable leaves are a flat dict: `gaussians.<field>` and the MLPs'
`pose_refiner.layers.<i>.<w|b>`, `lbs_offset.layers.<i>.<w|b>`,
`lbs_offset.head.<w|b>`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.reference.losses import loss_a
from port_bench.reference.render import render, scaling

B1, B2 = 0.9, 0.999
GAUSS_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity",
                "normal", "albedo", "roughness")


def flatten_mlp(prefix: str, tree: dict) -> dict:
    out = {}
    for i, layer in enumerate(tree["layers"]):
        for k in ("w", "b"):
            out[f"{prefix}.layers.{i}.{k}"] = layer[k]
    if "head" in tree:
        for k in ("w", "b"):
            out[f"{prefix}.head.{k}"] = tree["head"][k]
    return out


def unflatten_mlp(prefix: str, leaves: dict) -> dict:
    n = 1 + max(int(k.split(".")[2]) for k in leaves if k.startswith(f"{prefix}.layers."))
    tree = {"layers": [{k: leaves[f"{prefix}.layers.{i}.{k}"] for k in ("w", "b")}
                       for i in range(n)]}
    if f"{prefix}.head.w" in leaves:
        tree["head"] = {k: leaves[f"{prefix}.head.{k}"] for k in ("w", "b")}
    return tree


def expon_lr(step: int, lr_init: float, lr_final: float, max_steps: int) -> float:
    """The log-lerp schedule (no delay steps, as the program sets it)."""
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1.0 - t) + math.log(max(lr_final, 1e-30)) * t)


def group_lr(name: str, optim: dict, count: int) -> float:
    field = name.split(".")[1] if name.startswith("gaussians.") else name.split(".")[0]
    if field == "xyz":
        return expon_lr(count, optim["position_lr_init"], optim["position_lr_final"],
                        optim["position_lr_max_steps"])
    return {"features_dc": optim["feature_lr"], "features_rest": optim["feature_lr"] / 20.0,
            "opacity": optim["opacity_lr"], "scaling": optim["scaling_lr"],
            "rotation": optim["rotation_lr"], "normal": optim["normal_lr"],
            "albedo": optim["opacity_lr"], "roughness": optim["opacity_lr"],
            "pose_refiner": optim["pose_refine_lr"],
            "lbs_offset": optim["lbs_offset_lr"]}[field]


def loss_and_grads(leaves: dict, alive, view: dict, body: dict, *, sh_degree: int,
                   raster, bg, lpips_params, crop: int):
    """(loss, {name: gradient}) of one view."""
    params = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
    p = {f: params[f"gaussians.{f}"] for f in GAUSS_FIELDS}
    mlp = {"pose_refiner": unflatten_mlp("pose_refiner", params),
           "lbs_offset": unflatten_mlp("lbs_offset", params)}
    frame = render(p, alive, view["camera"], view["frame"], body, sh_degree=sh_degree,
                   mlp=mlp, raster=raster, bg=bg)
    a = alive.float()
    scaling_mean = (scaling(p) * a[:, None]).sum() / torch.clamp(a.sum() * 3, min=1.0)
    total = loss_a(frame, view, scaling_mean, lpips_params, crop)
    names = list(params)
    grads = torch.autograd.grad(total, [params[n] for n in names], allow_unused=True)
    return total.detach(), {n: (torch.zeros_like(params[n]) if g is None else g)
                            for n, g in zip(names, grads)}


def half_view(view: dict) -> dict:
    """The view with the bottom half of its rows left out of the loss: the
    masked means are taken over the rest (a planted fault)."""
    bm = view["bound_mask"].clone()
    bm[bm.shape[0] // 2:] = 0
    return dict(view, bound_mask=bm)


def train_steps(leaves: dict, alive, views: list, body: dict, optim: dict, *, raster, bg,
                lpips_params, crop: int, sh_degrees: list, fault: str | None = None,
                moments: tuple | None = None, first_step: int = 0):
    """Steps from `leaves` on `views` in order -> (losses, the first step's
    gradients, the leaves after the last step). The first step is number
    `first_step` + 1, from the Adam moments `moments` = (mu, nu) (zero when
    not given). `fault` plants one of the faults the checks must catch:
    "half" (half of each view left out of the loss), "unchanged" (the state
    returned as it came)."""
    leaves = {k: v.detach().clone() for k, v in leaves.items()}
    if moments is None:
        mu = {k: torch.zeros_like(v) for k, v in leaves.items()}
        nu = {k: torch.zeros_like(v) for k, v in leaves.items()}
    else:
        mu, nu = ({k: m[k].detach().clone() for k in leaves} for m in moments)
    losses, first = [], None
    for t, (view, deg) in enumerate(zip(views, sh_degrees), start=first_step):
        if fault == "half":
            view = half_view(view)
        loss, grads = loss_and_grads(leaves, alive, view, body, sh_degree=deg, raster=raster,
                                     bg=bg, lpips_params=lpips_params, crop=crop)
        losses.append(float(loss))
        if first is None:
            first = grads
        count = t + 1
        bc1 = float(1 - np.float32(B1) ** count)
        bc2 = float(1 - np.float32(B2) ** count)
        for k in leaves:
            g = grads[k]
            mu[k] = (1 - B1) * g + B1 * mu[k]
            nu[k] = (1 - B2) * (g * g) + B2 * nu[k]
            lr = group_lr(k, optim, t)
            if fault != "unchanged":
                leaves[k] = leaves[k] - lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2)
                                                              + optim["adam_eps"])
    return losses, first, leaves
