"""Gaussian scene model: fixed-capacity tensors + an alive mask.

Port of models/gaussians.py: the state tuples, the activations and getters,
`create_from_pcd`, `grow_capacity`, `compact_state`, and the training part:
densification statistics, clone / split (and their KL-gated variants),
`kl_merge`, `prune`, opacity reset and `densify_and_prune`. Dead slots
carry safe fills (log-scale -10, opacity logit -10, unit quaternion) and
are masked by `alive` in the rasterizer. New Gaussians are written into
dead slots found by a stable prefix ranking, never concatenated; every
event returns the mask of rewritten slots, whose Adam moments the trainer
resets. Split noise is an input (or drawn from a `torch.Generator`), so a
test can hand both packages the same numbers.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mygauhuman_torch.device import DEFAULT_DEVICE, resolve_device
from mygauhuman_torch.ops.knn import knn, mean_knn_dist2
from mygauhuman_torch.ops.sh import num_sh_coeffs, rgb2sh
from mygauhuman_torch.utils.transforms import (
    covariance6_from_scaling_rotation,
    inverse_sigmoid,
    normalize,
    quat_to_rotmat,
    quat_to_rotmat_cols,
)

# leaf -> fill of a dead slot (0 elsewhere; rotation gets a unit quaternion)
DEAD_FILLS = {"scaling": -10.0, "opacity": -10.0}


class GaussianParams(NamedTuple):
    """Trainable per-Gaussian parameters (raw, pre-activation). [cap, ...]"""

    xyz: torch.Tensor            # [cap, 3] canonical big-pose positions
    features_dc: torch.Tensor    # [cap, 1, 3] SH DC
    features_rest: torch.Tensor  # [cap, (deg+1)^2-1, 3]
    scaling: torch.Tensor        # [cap, 3] log-scale
    rotation: torch.Tensor       # [cap, 4] unnormalized quaternion (w,x,y,z)
    opacity: torch.Tensor        # [cap, 1] logit
    normal: torch.Tensor         # [cap, 3] canonical normals
    albedo: torch.Tensor         # [cap, 3] logit
    roughness: torch.Tensor      # [cap, 1] logit


class GaussianState(NamedTuple):
    """Scene state: params + alive mask + densification statistics."""

    params: GaussianParams
    alive: torch.Tensor           # [cap] bool
    smpl_normal: torch.Tensor     # [cap, 3]
    xyz_grad_accum: torch.Tensor  # [cap]
    denom: torch.Tensor           # [cap]
    max_radii2d: torch.Tensor     # [cap]

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()


def get_scaling(p: GaussianParams) -> torch.Tensor:
    # the clamp to [-15, 8] only guards against inf covariances
    return torch.exp(torch.clamp(p.scaling, -15.0, 8.0))


def get_rotation(p: GaussianParams) -> torch.Tensor:
    return normalize(p.rotation)


def get_opacity(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.opacity)


def get_albedo(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.albedo)


def get_roughness(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.roughness)


def get_features(p: GaussianParams) -> torch.Tensor:
    """[cap, (deg+1)^2, 3] concatenated SH features."""
    return torch.cat([p.features_dc, p.features_rest], dim=1)


def get_covariance6(p: GaussianParams, scaling_modifier: float = 1.0,
                    transforms: torch.Tensor | None = None) -> torch.Tensor:
    """Symmetric 6-vector covariance, optionally LBS-conjugated (T S T^T)."""
    return covariance6_from_scaling_rotation(get_scaling(p), p.rotation,
                                             scaling_modifier, transforms)


def get_minimum_axis(p: GaussianParams) -> torch.Tensor:
    """Unit axis (rotation column) of the smallest scale."""
    scales = get_scaling(p)
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = quat_to_rotmat_cols(p.rotation)
    idx = torch.argmin(scales, dim=-1)
    pick0 = idx == 0
    pick1 = idx == 1

    def col(c0, c1, c2):
        return torch.where(pick0, c0, torch.where(pick1, c1, c2))

    return torch.stack([col(r00, r01, r02), col(r10, r11, r12), col(r20, r21, r22)],
                       dim=-1)


def flip_align_view(normal: torch.Tensor, viewdir: torch.Tensor):
    """Flip normals to face the viewer; returns (flipped, positive_mask)."""
    positive = (normal * (-viewdir)).sum(dim=-1, keepdim=True) >= 0.0
    return torch.where(positive, normal, -normal), positive


def _round_capacity(n: int) -> int:
    cap = 1024
    while cap < n:
        cap *= 2
    return cap


def _pad_rows(x: torch.Tensor, cap: int, fill: float = 0.0) -> torch.Tensor:
    pad = torch.full((cap - x.shape[0],) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=0)


def _unit_quat_rows(rotation: torch.Tensor, n: int) -> torch.Tensor:
    rotation = rotation.clone()
    rotation[n:, 0] = 1.0
    return rotation


def create_from_pcd(
    points: np.ndarray,
    colors: np.ndarray,
    normals: np.ndarray,
    sh_degree: int = 3,
    capacity: int | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> GaussianState:
    """Init the scene from a point cloud: colours to SH DC, scales from the
    log sqrt mean 3-NN squared distance, identity quaternions, opacity 0.1,
    albedo / roughness logits 1."""
    dev = resolve_device(device)
    n = points.shape[0]
    cap = capacity if capacity is not None else _round_capacity(n)
    rest = num_sh_coeffs(sh_degree) - 1
    f32 = torch.float32

    pts = torch.tensor(np.asarray(points, np.float32), device=dev)
    dist2 = torch.clamp(mean_knn_dist2(pts, k=3), min=1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    fdc = rgb2sh(torch.tensor(np.asarray(colors, np.float32), device=dev))[:, None, :]
    quats = torch.cat([torch.ones((n, 1), dtype=f32, device=dev),
                       torch.zeros((n, 3), dtype=f32, device=dev)], dim=1)
    opac = inverse_sigmoid(0.1 * torch.ones((n, 1), dtype=f32, device=dev))
    nrm = torch.tensor(np.asarray(normals, np.float32), device=dev)

    params = GaussianParams(
        xyz=_pad_rows(pts, cap),
        features_dc=_pad_rows(fdc, cap),
        features_rest=_pad_rows(torch.zeros((n, rest, 3), dtype=f32, device=dev), cap),
        scaling=_pad_rows(scales, cap, DEAD_FILLS["scaling"]),
        rotation=_unit_quat_rows(_pad_rows(quats, cap), n),
        opacity=_pad_rows(opac, cap, DEAD_FILLS["opacity"]),
        normal=_pad_rows(nrm, cap),
        albedo=_pad_rows(torch.ones((n, 3), dtype=f32, device=dev), cap),
        roughness=_pad_rows(torch.ones((n, 1), dtype=f32, device=dev), cap),
    )
    return GaussianState(
        params=params,
        alive=torch.arange(cap, device=dev) < n,
        smpl_normal=_pad_rows(nrm, cap),
        xyz_grad_accum=torch.zeros(cap, dtype=f32, device=dev),
        denom=torch.zeros(cap, dtype=f32, device=dev),
        max_radii2d=torch.zeros(cap, dtype=f32, device=dev),
    )


def grow_capacity(state: GaussianState, new_capacity: int) -> GaussianState:
    """Pad every leaf to a larger capacity with the dead-slot fills."""
    cap = state.capacity
    if new_capacity < cap:
        raise ValueError(f"grow_capacity cannot shrink {cap} -> {new_capacity}")
    params = GaussianParams(**{
        f: _pad_rows(getattr(state.params, f), new_capacity, DEAD_FILLS.get(f, 0.0))
        for f in GaussianParams._fields
    })
    params = params._replace(rotation=_unit_quat_rows(params.rotation, cap))
    return GaussianState(
        params=params,
        alive=_pad_rows(state.alive, new_capacity, False),
        smpl_normal=_pad_rows(state.smpl_normal, new_capacity),
        xyz_grad_accum=_pad_rows(state.xyz_grad_accum, new_capacity),
        denom=_pad_rows(state.denom, new_capacity),
        max_radii2d=_pad_rows(state.max_radii2d, new_capacity),
    )


def compact_state(state: GaussianState, capacity: int | None = None,
                  multiple: int = 256) -> GaussianState:
    """Repack alive Gaussians to the front of a tight capacity: the next
    `multiple` above the alive count (or above `capacity` when given)."""
    idx = torch.nonzero(state.alive).reshape(-1)
    n = int(idx.numel())
    want = capacity if capacity is not None else n
    cap = max(multiple, -(-want // multiple) * multiple)
    if cap < n:
        raise ValueError(f"capacity {cap} below the {n} alive Gaussians")

    def take(x, fill=0.0):
        out = torch.full((cap,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        out[:n] = x[idx]
        return out

    params = GaussianParams(**{
        f: take(getattr(state.params, f), DEAD_FILLS.get(f, 0.0))
        for f in GaussianParams._fields
    })
    params = params._replace(rotation=_unit_quat_rows(params.rotation, n))
    return GaussianState(
        params=params,
        alive=torch.arange(cap, device=state.alive.device) < n,
        smpl_normal=take(state.smpl_normal),
        xyz_grad_accum=take(state.xyz_grad_accum),
        denom=take(state.denom),
        max_radii2d=take(state.max_radii2d),
    )


# ---- densification statistics (reference add_densification_stats) ----------

def add_densification_stats(state: GaussianState, means2d_grad_ndc: torch.Tensor,
                            radii: torch.Tensor) -> GaussianState:
    """Accumulate ||dL/dmean2D|| (reference NDC units) of visible Gaussians."""
    visible = radii > 0
    norm = torch.sqrt((means2d_grad_ndc * means2d_grad_ndc).sum(dim=-1))
    zero = torch.zeros_like(norm)
    return state._replace(
        xyz_grad_accum=state.xyz_grad_accum + torch.where(visible, norm, zero),
        denom=state.denom + visible.float(),
        max_radii2d=torch.where(visible, torch.maximum(state.max_radii2d, radii.float()),
                                state.max_radii2d),
    )


# ---- slot allocation: scatter selected source rows into dead slots ---------

def _alloc_slots(alive: torch.Tensor, selected: torch.Tensor):
    """(dest [cap] int32, ok [cap] bool, dropped int32): selected row i with
    rank r among the selected goes to the (r+1)-th dead slot; rows beyond
    the free slots are dropped (and counted)."""
    cap = alive.shape[0]
    order = torch.argsort(alive.to(torch.uint8), stable=True)   # dead slots first
    rank = torch.cumsum(selected.to(torch.int64), 0) - 1
    ok = selected & (rank < (~alive).sum())
    dest = order[torch.clamp(rank, 0, cap - 1)]
    dropped = selected.sum() - ok.sum()
    return dest.to(torch.int32), ok, dropped.to(torch.int32)


def _safe_dest(dest: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Destinations with the rows that are not written sent to row `cap`."""
    return torch.where(ok, dest, ok.shape[0]).long()


def _scatter_params(params: GaussianParams, src_params: GaussianParams,
                    dest: torch.Tensor, ok: torch.Tensor) -> GaussianParams:
    """Write src rows (where ok) into the dest slots of every leaf. Rows not
    written go to a scratch row past the end, which is dropped."""
    idx = _safe_dest(dest, ok)

    def scat(leaf, src):
        out = torch.cat([leaf, leaf[:1]], dim=0)
        out[idx] = src
        return out[:-1]

    return GaussianParams(*(scat(a, b) for a, b in zip(params, src_params)))


def _written_mask(dest: torch.Tensor, ok: torch.Tensor, cap: int) -> torch.Tensor:
    m = torch.zeros(cap + 1, dtype=torch.bool, device=ok.device)
    m[_safe_dest(dest, ok)] = True
    return m[:cap]


# ---- densify / prune: state -> (state, written mask, dropped) --------------

def _avg_grads(state: GaussianState) -> torch.Tensor:
    g = state.xyz_grad_accum / torch.clamp(state.denom, min=1e-12)
    return torch.where(state.denom > 0, g, torch.zeros_like(g))


def _clone(state: GaussianState, selected: torch.Tensor):
    dest, ok, dropped = _alloc_slots(state.alive, selected)
    params = _scatter_params(state.params, state.params, dest, ok)
    written = _written_mask(dest, ok, state.capacity)
    return state._replace(params=params, alive=state.alive | written), written, dropped


def densify_and_clone(state: GaussianState, grad_threshold: float, scene_extent: float,
                      percent_dense: float = 0.01):
    """Copy small high-gradient Gaussians (gaussian_model.py:546-564)."""
    small = get_scaling(state.params).max(dim=1).values <= percent_dense * scene_extent
    return _clone(state, state.alive & (_avg_grads(state) >= grad_threshold) & small)


def _split(state: GaussianState, selected: torch.Tensor, noise: torch.Tensor):
    """Resample each selected Gaussian into n = noise.shape[0] Gaussians at
    noise-scaled offsets with scale / (0.8 n); the original dies."""
    p = state.params
    n_split = noise.shape[0]
    offsets = torch.einsum("cij,ncj->nci", quat_to_rotmat(p.rotation),
                           noise * get_scaling(p)[None])
    new_scaling = p.scaling - torch.log(torch.tensor(0.8 * n_split))
    alive = state.alive & ~selected
    written_all = torch.zeros_like(alive)
    dropped_all = torch.zeros((), dtype=torch.int32, device=alive.device)
    params = p
    for i in range(n_split):
        src = params._replace(xyz=p.xyz + offsets[i], scaling=new_scaling)
        dest, ok, dropped = _alloc_slots(alive, selected)
        params = _scatter_params(params, src, dest, ok)
        w = _written_mask(dest, ok, state.capacity)
        alive = alive | w
        written_all = written_all | w
        dropped_all = dropped_all + dropped
    return state._replace(params=params, alive=alive), written_all, dropped_all


def densify_and_split(state: GaussianState, grad_threshold: float, scene_extent: float,
                      noise: torch.Tensor, percent_dense: float = 0.01):
    """Split big high-gradient Gaussians (gaussian_model.py:517-544). noise:
    [n_split, cap, 3] standard normal."""
    big = get_scaling(state.params).max(dim=1).values > percent_dense * scene_extent
    return _split(state, state.alive & (_avg_grads(state) >= grad_threshold) & big, noise)


def kl_div_diag(mu0, rot0_q, scale0, mu1, rot1_q, scale1) -> torch.Tensor:
    """Closed-form KL(N0 || N1) for quaternion-rotated diagonal covariances
    (gaussian_model.py:740-762)."""
    R0 = quat_to_rotmat(rot0_q)
    R1 = quat_to_rotmat(rot1_q)
    cov0 = torch.einsum("nij,nj,nkj->nik", R0, scale0 ** 2, R0)
    cov1_inv = torch.einsum("nij,nj,nkj->nik", R1, 1.0 / (scale1 ** 2 + 1e-12), R1)
    dmu = mu0 - mu1
    t0 = torch.einsum("nij,nji->n", cov1_inv, cov0)
    t1 = torch.einsum("ni,nij,nj->n", dmu, cov1_inv, dmu)
    t2 = torch.log((scale1 / torch.clamp(scale0, min=1e-12)) ** 2).sum(dim=1)
    return 0.5 * (t0 + t1 + t2 - 3.0)


def _neighbor_kl(state: GaussianState):
    """KL to each Gaussian's nearest alive neighbour (self excluded)."""
    p = state.params
    far = torch.where(state.alive[:, None], p.xyz, torch.full_like(p.xyz, 1e6))
    _, idx = knn(far, far, k=2)
    nn = idx[:, 1].long()
    scales = get_scaling(p)
    return kl_div_diag(p.xyz, p.rotation, scales, p.xyz[nn], p.rotation[nn], scales[nn]), nn


def kl_densify_and_clone(state, grad_threshold, scene_extent, kl_threshold=0.4,
                         percent_dense=0.01):
    """Clone gated also by KL(neighbour) > threshold (gaussian_model.py:570-610)."""
    kl, _ = _neighbor_kl(state)
    small = get_scaling(state.params).max(dim=1).values <= percent_dense * scene_extent
    return _clone(state, state.alive & (_avg_grads(state) >= grad_threshold) & small
                  & (kl > kl_threshold))


def kl_densify_and_split(state, grad_threshold, scene_extent, noise, kl_threshold=0.4,
                         percent_dense=0.01):
    """Split gated also by KL(neighbour) > threshold (gaussian_model.py:618-666)."""
    kl, _ = _neighbor_kl(state)
    big = get_scaling(state.params).max(dim=1).values > percent_dense * scene_extent
    return _split(state, state.alive & (_avg_grads(state) >= grad_threshold) & big
                  & (kl > kl_threshold), noise)


def kl_merge(state, grad_threshold, scene_extent, kl_threshold=0.1, percent_dense=0.01):
    """Replace each near-duplicate neighbour pair (KL < threshold) by its
    midpoint Gaussian and kill both (the working form of
    gaussian_model.py:670-708)."""
    kl, nn = _neighbor_kl(state)
    p = state.params
    cap = state.capacity
    ids = torch.arange(cap, device=nn.device)
    small = get_scaling(p).max(dim=1).values <= percent_dense * scene_extent
    cand = state.alive & (_avg_grads(state) >= grad_threshold) & small & (kl < kl_threshold)
    # one merge per symmetric pair: keep i only if i < nn[i] and both are candidates
    selected = cand & cand[nn] & (nn != ids) & (ids < nn)

    def mid(leaf):
        return 0.5 * (leaf + leaf[nn])

    scales = get_scaling(p)
    src = GaussianParams(
        xyz=mid(p.xyz), features_dc=mid(p.features_dc), features_rest=mid(p.features_rest),
        scaling=torch.log(torch.clamp(0.5 * (scales + scales[nn]), min=1e-12))
        - torch.log(torch.tensor(0.8)),
        rotation=mid(p.rotation), opacity=mid(p.opacity), normal=mid(p.normal),
        albedo=mid(p.albedo), roughness=mid(p.roughness))
    kill = selected | _written_mask(nn, selected, cap)
    alive = state.alive & ~kill
    dest, ok, dropped = _alloc_slots(alive, selected)
    params = _scatter_params(p, src, dest, ok)
    written = _written_mask(dest, ok, cap)
    return state._replace(params=params, alive=alive | written), written, dropped


def prune(state: GaussianState, min_opacity: float, scene_extent: float,
          max_screen_size: float | None, smpl_vertices: torch.Tensor | None = None,
          smpl_dist_threshold: float = 0.05) -> GaussianState:
    """Kill low-opacity / oversized / far-from-SMPL Gaussians
    (gaussian_model.py:710-736)."""
    p = state.params
    mask = get_opacity(p)[:, 0] < min_opacity
    if max_screen_size:
        mask = mask | (state.max_radii2d > max_screen_size)
        mask = mask | (get_scaling(p).max(dim=1).values > 0.1 * scene_extent)
    if smpl_vertices is not None:
        d2, _ = knn(p.xyz, smpl_vertices, k=1)
        mask = mask | (d2[:, 0] > smpl_dist_threshold ** 2)
    return state._replace(alive=state.alive & ~mask)


def reset_opacity(state: GaussianState) -> GaussianState:
    """Clamp opacity to <= 0.01 (gaussian_model.py:348-351)."""
    p = state.params
    return state._replace(params=p._replace(
        opacity=inverse_sigmoid(torch.clamp(get_opacity(p), max=0.01))))


def reset_densification_stats(state: GaussianState) -> GaussianState:
    z = torch.zeros_like(state.xyz_grad_accum)
    return state._replace(xyz_grad_accum=z, denom=z.clone(), max_radii2d=z.clone())


def densify_and_prune(state: GaussianState, generator: torch.Generator | None, *,
                      max_grad: float, min_opacity: float, extent: float,
                      max_screen_size: float = 0.0, max_screen_size_on: bool = False,
                      kl_threshold: float = 0.4, smpl_vertices: torch.Tensor | None = None,
                      use_kl: bool = False, percent_dense: float = 0.01,
                      noise: torch.Tensor | None = None):
    """One densification event (reference densify_and_prune, :710-736).

    The split noise [2, cap, 3] is `noise` when given, else drawn from
    `generator` (a CPU generator, so a CPU and a CUDA run draw the same
    numbers). Returns (state, written, info): `written` marks the slots
    whose Adam moments must be reset, `info` the event's counters (0-d
    tensors: cloned, split_new, merged, dropped, pruned, alive, grew)."""
    if noise is None:
        noise = torch.randn((2, state.capacity, 3), generator=generator)
    noise = noise.to(state.alive.device)
    alive_before = state.alive.sum()
    if use_kl:
        state, w1, d1 = kl_densify_and_clone(state, max_grad, extent, kl_threshold,
                                             percent_dense)
        state, w2, d2 = kl_densify_and_split(state, max_grad, extent, noise, kl_threshold,
                                             percent_dense)
        state, w3, d3 = kl_merge(state, max_grad, extent, 0.1, percent_dense)
        written = w1 | w2 | w3
        info = {"cloned": w1.sum(), "split_new": w2.sum(), "merged": w3.sum(),
                "dropped": d1 + d2 + d3}
    else:
        state, w1, d1 = densify_and_clone(state, max_grad, extent, percent_dense)
        state, w2, d2 = densify_and_split(state, max_grad, extent, noise, percent_dense)
        written = w1 | w2
        info = {"cloned": w1.sum(), "split_new": w2.sum(),
                "merged": torch.zeros((), dtype=torch.int64, device=written.device),
                "dropped": d1 + d2}
    alive_grown = state.alive.sum()
    state = prune(state, min_opacity, extent, max_screen_size if max_screen_size_on else None,
                  smpl_vertices)
    info["pruned"] = alive_grown - state.alive.sum()
    info["alive"] = state.alive.sum()
    info["grew"] = state.alive.sum() - alive_before
    return reset_densification_stats(state), written, info
