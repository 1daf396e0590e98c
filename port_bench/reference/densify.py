"""One scheduled densify-and-prune event of the plain reference, written
from GauHuman's `scene/gaussian_model.py` (densify_and_clone :546-564,
densify_and_split :517-544, the prune of densify_and_prune :710-736) and
the schedule's settings in the configuration's `optim`:

- the average screen-space gradient of each live Gaussian is its
  accumulated norm over its count (0 where never seen);
- a live Gaussian at or over `densify_grad_threshold` whose largest scale
  is at most `percent_dense` x extent is cloned (an exact copy);
- one over the threshold with a larger scale is replaced by two children
  at xyz + R(q) (noise_i * scale), with log-scale less log(0.8 * 2);
- then every Gaussian with opacity under 0.005, or farther than 0.05 from
  the nearest vertex of the big-pose body, dies (no screen-size rule
  before iteration 3000);
- new Gaussians start with zero Adam moments; the statistics restart.

The event acts on a set of Gaussians: the result is the set of live rows,
in no particular order. The split noise is the configuration's stream,
handed to both sides: [2, slots, 3] standard normals from a CPU
`torch.Generator` seeded with the loop's seed (its first draw), `slots`
being the capacity after a growth that doubles it when fewer than
max(256, capacity / 8) slots are free; child i of the Gaussian in slot c
takes row c of draw i.
"""
from __future__ import annotations

import math

import torch

from port_bench.reference.render import scaling
from port_bench.reference.transforms import quat_to_rotmat_cols

MIN_OPACITY = 0.005
SMPL_DIST = 0.05
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity",
          "normal", "albedo", "roughness")


def slots_after_growth(capacity: int, alive: int) -> int:
    return capacity * 2 if capacity - alive < max(256, capacity // 8) else capacity


def split_noise(loop_seed: int, capacity: int, alive: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(loop_seed)
    return torch.randn((2, slots_after_growth(capacity, alive), 3), generator=gen)


def nearest_dist2(points, verts, block: int = 4096):
    """Squared distance to the nearest vertex, |q|^2 + |r|^2 - 2 q.r clamped
    at 0 (the statement that a near-tie at the threshold shares)."""
    rn = (verts * verts).sum(-1)
    out = []
    for q0 in range(0, points.shape[0], block):
        q = points[q0:q0 + block]
        d = (q * q).sum(-1, keepdim=True) + rn - 2.0 * (q @ verts.T)
        out.append(torch.clamp(d, min=0.0).min(dim=1).values)
    return torch.cat(out) if out else points.new_zeros(0)


def event(g: dict, alive, grad_accum, denom, moments: dict, *, optim: dict, extent: float,
          smpl_vertices, noise, fault: str | None = None) -> dict:
    """The event on the Gaussians `g` ({field: [slots, ...]}) -> {"rows":
    {field: [M, ...]}, "moments": {name: [M, ...]}, "count": M}. `moments`
    maps `<mu|nu>.<field>` to per-slot rows. `fault` plants "split_scale"
    (children keep their parent's scale)."""
    avg = torch.where(denom > 0, grad_accum / torch.clamp(denom, min=1e-12),
                      torch.zeros_like(grad_accum))
    big = scaling(g).max(dim=1).values > optim["percent_dense"] * extent
    hot = alive & (avg >= optim["densify_grad_threshold"])
    clone, split = hot & ~big, hot & big
    keep = alive & ~split
    noise = noise.to(alive.device)
    s = scaling(g)
    r = quat_to_rotmat_cols(g["rotation"])
    parts = [{f: g[f][keep] for f in FIELDS}, {f: g[f][clone] for f in FIELDS}]
    for i in range(2):
        n = noise[i, :alive.shape[0]] * s
        off = torch.stack([r[0] * n[:, 0] + r[1] * n[:, 1] + r[2] * n[:, 2],
                           r[3] * n[:, 0] + r[4] * n[:, 1] + r[5] * n[:, 2],
                           r[6] * n[:, 0] + r[7] * n[:, 1] + r[8] * n[:, 2]], dim=-1)
        child = {f: g[f][split] for f in FIELDS}
        child["xyz"] = (g["xyz"] + off)[split]
        if fault != "split_scale":
            child["scaling"] = child["scaling"] - math.log(0.8 * 2)
        parts.append(child)
    rows = {f: torch.cat([p[f] for p in parts]) for f in FIELDS}
    fresh = int(clone.sum()) + 2 * int(split.sum())
    mom = {k: torch.cat([v[keep], v.new_zeros((fresh,) + tuple(v.shape[1:]))])
           for k, v in moments.items()}
    opacity = torch.sigmoid(rows["opacity"][:, 0])
    dead = (opacity < MIN_OPACITY) | (nearest_dist2(rows["xyz"], smpl_vertices) > SMPL_DIST ** 2)
    live = ~dead
    return {"rows": {f: v[live] for f, v in rows.items()},
            "moments": {k: v[live] for k, v in mom.items()}, "count": int(live.sum())}
