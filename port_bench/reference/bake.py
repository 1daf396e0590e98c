"""Branch B's occlusion bake of the plain reference (myGauHuman `baking.py:
104-309`, `bake_set`): the posed Gaussians voxelised into a 10^3 grid over
their bounding box; from each occupied cell's centre six 32 x 32 opacity
images (fov 90) of every alive Gaussian outside the cell; the opacity
cubemap read at the nearest texel of each direction of a 16 x 32
lat-long map; each Gaussian of the cell inheriting 1 - that map, zeroed
where the direction leaves its normal's hemisphere (dot > 0 kept) and for
dead slots; then rounded to uint8 (round half to even, in 1/255 steps) as
the training loop caches it.

The faces are rasterized by `reference/raster.py` with no caps: each
face's tile lists hold every Gaussian that lands on the tile (a face of 4
tiles, each Gaussian at most once per tile), as the published CUDA
rasterizer, which has no lists of fixed length. The cube faces follow the
published `cube_to_dir` convention (+x, -x, +y, -y, +z, -z; gx, gy at
texel centres), the face cameras the published `fov_to_proj` (znear 0.01,
zfar 100) at each cell centre. The nearest-texel index truncates
(gy + 1) / 2 * 32 (a non-negative number) to an integer, clamped to the
face.

The hemisphere test takes the dot of every direction with every world
normal in one product, as the program states it, so that a dot within
rounding of 0 falls alike on both sides.

Departures from the published description: the posed rows are those of
the frame's LBS deformation with the learned corrections (the program's
`_pose_for_bake`), not a separate mesh; the grid's cell of a Gaussian is
clamped into the grid, so a Gaussian on the box's far faces belongs to the
last cell (the published code indexes the same way).
"""
from __future__ import annotations

import math

import torch

from port_bench.reference import light as RL
from port_bench.reference import raster as RZ

GRID = 10
FACE = 32
MAP_H, MAP_W = 16, 32
#: c2w (right, down, forward) of each cube face: d(dir)/d(gx), d(dir)/d(gy)
#: and dir(0, 0) of `cube_to_dir` (+x, -x, +y, -y, +z, -z)
FACE_AXES = (((0, 0, -1), (0, -1, 0), (1, 0, 0)),
             ((0, 0, 1), (0, -1, 0), (-1, 0, 0)),
             ((1, 0, 0), (0, 0, 1), (0, 1, 0)),
             ((1, 0, 0), (0, 0, -1), (0, -1, 0)),
             ((1, 0, 0), (0, -1, 0), (0, 0, 1)),
             ((-1, 0, 0), (0, -1, 0), (0, 0, -1)))


def grid(points, alive, res: int = GRID) -> tuple:
    """(cell of each point [N] int64, cell centres [res^3, 3], occupied
    [res^3] bool) of a res^3 grid over the alive points' bounding box."""
    a = alive[:, None]
    lo = torch.where(a, points, torch.full_like(points, math.inf)).min(dim=0).values
    hi = torch.where(a, points, torch.full_like(points, -math.inf)).max(dim=0).values
    cell = (hi - lo) / res
    ijk = torch.clamp(torch.floor((points - lo) / torch.clamp(cell, min=1e-12)).long(),
                      0, res - 1)
    of = ijk[:, 0] * res * res + ijk[:, 1] * res + ijk[:, 2]
    r = torch.arange(res, device=points.device)
    cells = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)
    centres = lo[None, :] + (cells + 0.5) * cell[None, :]
    occupied = torch.zeros(res ** 3, dtype=torch.bool, device=points.device)
    occupied[of[alive]] = True
    return of, centres, occupied


def face_camera(centre, face: int) -> dict:
    """The fov-90 camera of one cube face at a cell centre (the reference
    raster's camera dict)."""
    dev = centre.device
    R = torch.tensor(FACE_AXES[face], dtype=torch.float32, device=dev).T   # columns r, d, f
    w2c = torch.eye(4, device=dev)
    w2c[:3, :3] = R.T
    w2c[:3, 3] = -(R.T @ centre)
    znear, zfar = 0.01, 100.0
    P = torch.zeros((4, 4), device=dev)
    P[0, 0] = P[1, 1] = 1.0 / math.tan(math.pi / 4)
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -2.0 * zfar * znear / (zfar - znear)
    P[3, 2] = 1.0
    return {"w2c": w2c, "full_proj": P @ w2c, "tan_fovx": 1.0, "tan_fovy": 1.0,
            "width": FACE, "height": FACE}


def texel_of(height: int = MAP_H, width: int = MAP_W, face_res: int = FACE, device=None):
    """(face, row, column) [H, W] of the nearest cube texel of each lat-long
    direction."""
    face, gx, gy = RL.cube_coords(RL.latlong_dirs(height, width, device))
    row = torch.clamp(((gy + 1.0) * 0.5 * face_res).long(), 0, face_res - 1)
    col = torch.clamp(((gx + 1.0) * 0.5 * face_res).long(), 0, face_res - 1)
    return face, row, col


def cube_opacity(means, cov6, opacity, alive, centre, fault: str | None = None) -> tuple:
    """([6, 32, 32] opacity of the alive Gaussians `alive` seen from `centre`,
    the six faces' blend work and the instances each tile would hold). A
    planted `fault` "skipped_face" leaves the face that sees the most
    opacity empty."""
    faces, work, counts = [], [], []
    n = means.shape[0]
    feat = torch.zeros((n, 1), device=means.device)
    for f in range(6):
        cam = face_camera(centre, f)
        proj = RZ.preprocess(means, cov6, cam["w2c"], cam["full_proj"], FACE, FACE, 1.0, 1.0)
        visible = proj.visible & alive
        bins = RZ.bin_gaussians(proj.means2d, proj.radii, proj.depths, visible, width=FACE,
                                height=FACE, max_tiles_per_gaussian=4, tile_capacity=n,
                                instance_capacity=None)
        out = RZ.blend(bins, proj.means2d, proj.conics, opacity, feat, proj.depths,
                       torch.zeros(1, device=means.device), width=FACE, height=FACE,
                       chunk_tiles=4)
        faces.append(out.alpha)
        work.append(out.work)
        counts.append(bins.counts)
    cube = torch.stack(faces)
    if fault == "skipped_face":
        cube[int(cube.sum(dim=(1, 2)).argmax())] = 0.0
    return cube, work, torch.stack(counts)


def bake_cell(means, cov6, opacity, normals, alive, of, centres, cell: int,
              fault: str | None = None) -> tuple:
    """The uint8 maps [m, 16, 32] of the m Gaussians of `cell`, their ids,
    the six faces' work and tile counts. Planted faults: "skipped_face",
    "no_hemisphere" (the normal-hemisphere mask left out)."""
    inside = alive & (of == cell)
    ids = torch.nonzero(inside).reshape(-1)
    cube, work, counts = cube_opacity(means, cov6, opacity, alive & (of != cell),
                                      centres[cell], fault)
    face, row, col = texel_of(device=means.device)
    vis = 1.0 - cube[face, row, col]                                   # [H, W]
    # the dot as the program takes it, one product over every slot: a dot
    # within rounding of 0 then falls alike
    dots = torch.einsum("hwc,nc->nhw", RL.latlong_dirs(MAP_H, MAP_W, means.device), normals)
    up = dots[ids] > 0                                                  # [m, H, W]
    maps = vis[None].expand(len(ids), MAP_H, MAP_W)
    if fault != "no_hemisphere":
        maps = torch.where(up, maps, torch.zeros_like(maps))
    return torch.round(maps * 255.0).to(torch.uint8), ids, work, counts
