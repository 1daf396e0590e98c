"""The `pbr` mix: branch B of one relightable avatar through the port's
`train_loop_pbr` and its donated (graphed) step, from a trained-size start
state, over a fixed stretch of the branch.

Set-up makes the inputs (the `train` mix's views and backbone, and the
start: a trained avatar's stand-in at the configuration's size, its Adam
moments and counts at `start.iteration`), builds the TrainState, the light
and the step as `cli.train` does, and drives that same object through the
branch's first three iterations (callbacks there end their chunks; each
visits a new view, so each bakes its camera first): the program's loss at
each, its first gradient (Adam's first moments after one step over 1 -
b1; the materials' and the light's moments start at 0), the baked maps it
stepped on and the materials after the third are kept. The window opens
there and runs in the same loop to the configuration's last iteration of
the window (`window.last_iteration` at `window.run_seconds`, scaled by
`--seconds`): `cli.train`'s chunks (ending at every 100th iteration), the
other views' bakes (every view is first visited within the first V
iterations, V the number of views) and the steps. The views' order is the
capture's (`train_loop_pbr`'s seed is `capture_seed`), as are the start's
correction MLPs and slot order, so every seed bakes the same views posed
alike from the same layout: a view's bake takes 2 or 3 sweeps by its posed
cells, and with the view order and the MLPs drawn from the seed a window's
sweeps ranged from 31 to 38 and `train_it_per_s` spread by 7-8% between
seeds (H100; 32-37 with the view order alone fixed); with the slot order
from the seed a sweep took 0.58-0.64 s by seed at fixed sweeps (2.8%). `train_it_per_s` is the
window's iterations over its seconds, bakes included. A traced run
profiles the stretch from `trace_from` to `trace_to` (a callback at
`trace_from` ends a chunk there) and takes the profiler's seconds out of
the window.

After the window the peak memory is read, the program is freed and the
plain reference (`reference/pbr.py`, `reference/bake.py`) follows: the
first three iterations on the same views from the same start with the
program's baked maps; 8 (view, cell) pairs of the window's bakes, drawn
from the seed, baked again; and the geometry held to the start. `compare`
gives the numbers the limits hold.

A program whose bake keeps 256 instances per tile list (older than
`occlusion/baking.py::bake_config`) cannot run this configuration, whose
bake keeps every Gaussian: the run exits at once with code 6.
"""
from __future__ import annotations

import gc
import itertools
import statistics
import sys
import time

import torch

from port_bench.counts import bake as CB
from port_bench.counts import pbr as CP
from port_bench.harness import inputs as I
from port_bench.harness import pbr_program as PP
from port_bench.harness.record import Run, leaf_gaps
from port_bench.harness.trace import Trace
from port_bench.reference import bake as RB
from port_bench.reference import pbr as RP
from port_bench.reference import train as RT
from port_bench.reference.deform import deform
from port_bench.reference.precision import precision
from port_bench.reference.render import scaling
from port_bench.reference.transforms import covariance6_from_scaling_rotation, rot_apply

FIRST_STEPS = 3
PAIRS = 8
MOMENT = 1e-4           # the start's Adam moments: mu ~ N(0, MOMENT^2), nu ~ MOMENT^2 (z^2 + 0.01)
OLD_TILE_CAPACITY = 256  # the tile lists of a bake before they were sized from the model


# ---- inputs ----------------------------------------------------------------------

def pbr_inputs(cfg: dict, seed: int, device) -> dict:
    """The `train` mix's inputs (scene, views, ground truth, LPIPS backbone)
    and the start: `start.gaussians` Gaussians in `start.capacity` slots
    placed on the body as `inputs.py::served_model` places a trained avatar
    (geometry, its slot order and the correction MLPs from the capture's
    stream; appearance, materials and normals from the seed), every group's
    Adam count at `start.iteration`,
    seeded moments for every leaf but the albedo and the roughness (which
    branch A's loss never reads, so theirs are 0), dead rows 0."""
    inp = I.train_inputs(cfg, seed, device)
    s = cfg["start"]
    model = I.served_model({**cfg, "served": {"gaussians": s["gaussians"],
                                              "capacity": s["capacity"]}},
                           inp["scene"], seed, device)
    # the geometry is posed, projected and binned by every bake, so its slot
    # order and the MLPs that pose it are the capture's too: every seed then
    # poses the same cells and bakes them from the same memory layout
    # (`served_model` orders the slots by the seed)
    joints = len(inp["scene"].body["parents"])
    model["mlps"] = I.mlps(joints, I.generator(cfg["capture_seed"], device, 6), device,
                           head_bound=1e-3)
    n = s["gaussians"]
    rows = torch.argsort(model["params"]["xyz"][:n, 0], stable=True)
    rows = rows[torch.randperm(n, generator=I.generator(cfg["capture_seed"], device, 10),
                               device=device)]
    for v in model["params"].values():
        v[:n] = v[:n][rows]
    flat = {f"gaussians.{f}": v for f, v in model["params"].items()}
    for k in ("pose_refiner", "lbs_offset"):
        flat.update(RT.flatten_mlp(k, model["mlps"][k]))
    gen = I.generator(seed, device, 9)
    alive = model["alive"]
    mu, nu = {}, {}
    for k, v in flat.items():
        if k in ("gaussians.albedo", "gaussians.roughness"):
            mu[k], nu[k] = torch.zeros_like(v), torch.zeros_like(v)
            continue
        z1 = torch.randn(v.shape, generator=gen, device=device)
        z2 = torch.randn(v.shape, generator=gen, device=device)
        mu[k], nu[k] = MOMENT * z1, MOMENT ** 2 * (z2 * z2 + 0.01)
        if k.startswith("gaussians."):
            rows = alive.reshape((-1,) + (1,) * (v.dim() - 1)).float()
            mu[k], nu[k] = mu[k] * rows, nu[k] * rows
    inp.update(start={"params": flat, "alive": alive, "mu": mu, "nu": nu,
                      "iteration": s["iteration"], "active_sh_degree": s["active_sh_degree"]},
               raster=I.raster_of(cfg, s["capacity"]), pbr=dict(cfg["pbr"]))
    del inp["init"], inp["alive"], inp["mlps"]
    return inp


def window_last(cfg: dict, seconds: float) -> int:
    """The window's last iteration: `window.last_iteration` at
    `window.run_seconds`, the iterations past set-up's scaled by
    `--seconds`."""
    w = cfg["window"]
    first = cfg["start"]["iteration"] + FIRST_STEPS
    return first + max(1, round((w["last_iteration"] - first) * seconds / w["run_seconds"]))


# ---- the program -----------------------------------------------------------------

class Fed:
    """The program's chunked step, passed through, with what the reference
    must follow: the views of every chunk, the maps of the first steps, the
    slot of each camera in the occlusion buffer, the buffer and the
    neighbours."""

    def __init__(self, step, trace: Trace | None):
        self.step = step
        self.trace = trace
        self.fed: list = []
        self.first_occ: list = []
        self.slot_of: dict = {}
        self.occ_buf = None
        self.knn3 = None
        self.baked_after: dict = {}   # view -> the steps taken before its camera's bake

    def chunk(self, ts, pbr_state, views, occ_buf, knn3, prefilter_w, idx, bidx, deg,
              pad_to=0):
        for i in idx:
            self.baked_after.setdefault(int(i), len(self.fed))
        for i, b in zip(idx, bidx):
            if len(self.fed) < FIRST_STEPS:
                self.first_occ.append(occ_buf[b].clone())
            self.fed.append(int(i))
            for v in [v for v, s in self.slot_of.items() if s == b and v != i]:
                del self.slot_of[v]
            self.slot_of[int(i)] = int(b)
        self.occ_buf, self.knn3 = occ_buf, knn3
        args = (ts, pbr_state, views, occ_buf, knn3, prefilter_w, idx, bidx, deg)
        if self.trace is not None and self.trace.prof is not None:
            with Trace.span("chunk"):
                return self.step.chunk(*args, pad_to=pad_to)
        return self.step.chunk(*args, pad_to=pad_to)


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def drive(trainer: PP.PbrTrainer, traffic: dict, order_seed: int, last: int,
          trace: Trace | None, cuda: bool) -> dict:
    """Run branch B from the start through iteration `last`, the views in
    the order `train_loop_pbr` draws from `order_seed`, and keep what the
    comparison and the metrics read."""
    start = trainer.inp["start"]["iteration"]
    first = start + FIRST_STEPS
    ts, pbr_state, step = trainer.subject()
    fed = Fed(step, trace)
    t_from, t_to = traffic["trace_from"], traffic["trace_to"]
    traced = trace is not None and first < t_from and t_to <= last
    st = {"losses": [], "grad": None, "after": None, "t0": None, "t1": None, "fed": fed.fed,
          "phases": {}, "traced_units": 0}
    cb = {*range(start + 1, first + 1), *range(100, last + 1, 100), last}
    if traced:
        cb |= {t_from, t_to}

    def mark(name: str) -> None:
        _sync(cuda)
        st["phases"][name] = PP.phases()

    def callback(it, ts, pbr_state, metrics):
        if it not in cb:
            return
        if it <= first:
            st["losses"].append(float(metrics["loss"]))
            if it == start + 1:
                st["grad"] = PP.first_gradient(ts, pbr_state)
            if it == first:
                st["after"] = PP.materials(ts, pbr_state)
                mark("t0")
                st["t0"] = time.perf_counter()
            return
        if traced and it == t_from:
            mark("trace_from")
            st["traced_from"] = it - start
            trace.start()
        elif traced and it == t_to and trace.prof is not None:
            trace.stop()
            mark("trace_to")
            st["traced_units"] = t_to - t_from
        if it == last:
            mark("t1")
            st["t1"] = time.perf_counter()
        print(f"[window] iteration {it} at {time.perf_counter() - st['t0']:.3f} s",
              file=sys.stderr)

    ts, pbr_state, _ = trainer.loop(ts, pbr_state, fed, seed=order_seed,
                                    callback=callback, scan_chunk=traffic["scan_chunk"],
                                    num_iterations=last - start,
                                    callback_iters=tuple(sorted(cb)))
    st.update(geometry=PP.geometry(ts), occ_buf=fed.occ_buf, slot_of=dict(fed.slot_of),
              first_occ=fed.first_occ, knn3=fed.knn3.clone(), baked_after=fed.baked_after)
    return st


# ---- the reference -----------------------------------------------------------------

def _start_params(inp: dict) -> dict:
    flat = inp["start"]["params"]
    return {f: flat[f"gaussians.{f}"] for f in RT.GAUSS_FIELDS}


def _mlp(inp: dict) -> dict:
    flat = inp["start"]["params"]
    return {k: RT.unflatten_mlp(k, flat) for k in ("pose_refiner", "lbs_offset")}


def posed(inp: dict, view: int, steps: int = 0) -> tuple:
    """(world means, covariances, opacities, world normals) of the start's
    Gaussians at view `view`'s frame, the normals as `steps` branch-B steps
    leave them (their momentum moves them)."""
    s = inp["start"]
    p = _start_params(inp)
    f = inp["views"][view]["frame"]
    normal = RP.momentum_steps(p["normal"], s["mu"]["gaussians.normal"],
                               s["nu"]["gaussians.normal"], inp["optim"]["normal_lr"],
                               s["iteration"], steps, inp["optim"]["adam_eps"])
    with torch.no_grad():
        _, _, transforms, translation = deform(inp["scene"].body, p["xyz"], normal, f,
                                               f["big"], f["big_verts"], _mlp(inp))
        return (rot_apply(transforms, p["xyz"]) + translation,
                covariance6_from_scaling_rotation(scaling(p), p["rotation"], 1.0, transforms),
                torch.sigmoid(p["opacity"])[:, 0], rot_apply(transforms, normal))


def bake_pairs(inp: dict, views: list, seed: int) -> tuple[list, dict]:
    """(`PAIRS` (view, cell) pairs drawn from the seed among the occupied
    cells of the handed views, in the reference's grid of each; {view: its
    occupied cells})."""
    alive = inp["start"]["alive"]
    pairs, cells = [], {}
    for v in views:
        means = posed(inp, v)[0]
        occupied = torch.nonzero(RB.grid(means, alive, inp["pbr"]["grid"])[2]).reshape(-1)
        cells[v] = occupied.numel()
        pairs += [(v, int(c)) for c in occupied.tolist()]
    pick = I.host_rng(seed, 11).choice(len(pairs), size=min(PAIRS, len(pairs)), replace=False)
    return [pairs[i] for i in sorted(pick)], cells


def reference_bakes(inp: dict, pairs: list, baked_after: dict, tf32: bool = False,
                    fault: str | None = None) -> dict:
    """{(view, cell): (uint8 maps of the cell's Gaussians, their ids, the
    faces' work, the faces' tile counts)}, each view posed (after the steps
    `baked_after` gives it) and gridded in the precision asked for."""
    alive = inp["start"]["alive"]
    out = {}
    with torch.no_grad(), precision(tf32):
        for v in sorted({v for v, _ in pairs}):
            means, cov6, op, normals = posed(inp, v, baked_after[v])
            of, centres, _ = RB.grid(means, alive, inp["pbr"]["grid"])
            for pv, c in pairs:
                if pv == v:
                    out[(v, c)] = RB.bake_cell(means, cov6, op, normals, alive, of, centres, c,
                                               fault)
    return out


def map_gaps(got: dict, want: dict) -> tuple[float, float]:
    """(the largest gap in 1/255 steps, the share of texels off) of the
    maps `got` against `want` ({pair: (maps, ids, ...)}), over the ids of
    `want`; a Gaussian missing from `got`'s cell counts 255 on each texel."""
    worst, off, total = 0, 0, 0
    for pair, (maps, ids, *_) in want.items():
        g_maps, g_ids = got[pair][0], got[pair][1]
        where = {int(i): k for k, i in enumerate(g_ids.tolist())}
        for k, i in enumerate(ids.tolist()):
            n = maps[k].numel()
            total += n
            if i not in where:
                worst, off = 255, off + n
                continue
            d = (g_maps[where[i]].int() - maps[k].int()).abs()
            worst = max(worst, int(d.max()))
            off += int((d > 0).sum())
    return float(worst), off / max(total, 1)


def program_bakes(st: dict, ref: dict) -> dict:
    """The program's maps of the reference's pairs, from its buffer."""
    return {pair: (st["occ_buf"][st["slot_of"][pair[0]]][ids][..., 0], ids)
            for pair, (_, ids, *_) in ref.items()}


def reference_steps(inp: dict, st: dict, tf32: bool = False, fault: str | None = None,
                    ties: list | None = None):
    s = inp["start"]
    p = _start_params(inp)
    start = {"params": p, "alive": s["alive"], "base": _light(inp),
             "mu": {f: s["mu"][f"gaussians.{f}"] for f in RP.STEPPED},
             "nu": {f: s["nu"][f"gaussians.{f}"] for f in RP.STEPPED}}
    with precision(tf32):
        nb = RP.neighbours(p["xyz"], s["alive"])
        return RP.train_steps(start, [inp["views"][i] for i in st["fed"][:FIRST_STEPS]],
                              st["first_occ"], nb, inp["scene"].body, inp["optim"],
                              counts={k: s["iteration"] for k in RP.STEPPED},
                              sh_degree=s["active_sh_degree"], mlp=_mlp(inp),
                              raster=inp["raster"], bg=inp["bg"], lpips_params=inp["lpips"],
                              fault=fault, ties=ties), nb


def _light(inp: dict):
    r = inp["pbr"]["light_res"]
    return torch.full((6, r, r, 3), 0.5, device=inp["bg"].device)


def drift(inp: dict, steps: int) -> dict:
    """The geometry after `steps` updates of its groups with zero gradients
    from the start's moments (the JAX step's momentum: a planted fault)."""
    s = inp["start"]
    out = {}
    for k, v in s["params"].items():
        if k.split(".")[0] == "gaussians" and k.split(".")[1] not in PP.GEOMETRY:
            continue
        p, mu, nu = v.clone(), s["mu"][k].clone(), s["nu"][k].clone()
        for t in range(steps):
            p, mu, nu = RP.adam(p, torch.zeros_like(p), mu, nu,
                                RT.group_lr(k, inp["optim"], s["iteration"] + t),
                                s["iteration"] + t + 1, inp["optim"]["adam_eps"])
        out[k] = p
    return out


def frozen_gap(after: dict, before: dict) -> float:
    """The largest relative change of a geometry entry (0 where it is
    unchanged to the bit)."""
    return max(float(((after[k] - before[k]).abs() / before[k].abs().clamp(min=1e-30)).max())
               for k in after)


def tied_grad_gap(prog: dict, ref: dict, ties: list) -> tuple[float, str]:
    """`leaf_gaps` of the first gradients, the least over the reference's
    gradients at each choice of sign of its masked-L1 residuals within
    `reference/pbr.py::L1_TIE` of 0 (`ties`: each residual's changes to the
    gradients were its sign the other)."""
    best = None
    for choice in itertools.product(*[[None, *alts] for alts in ties]):
        grad = dict(ref)
        for alt in choice:
            if alt is not None:
                grad = {k: grad[k] + a for k, a in zip(grad, alt)}
        gap = leaf_gaps(prog, grad)
        if best is None or gap[0] < best[0]:
            best = gap
    return best


def compare(prog: dict, ref: dict) -> dict:
    """The numbers the limits hold.

    `first_loss_gap`: the first step's relative loss gap; `grad_gap`: the
    worst of the albedo's, the roughness' and the light's gaps of the first
    gradient's norms over the larger of that leaf's and the median leaf's
    reference norm, where a masked-L1 residual lies within rounding of 0
    at the reference's gradient for the sign the program's is nearest
    (`tied_grad_gap`); `change_gap`: the same for their change after three
    steps; `bake_gap`: the largest gap of the sampled cells' Gaussians'
    baked maps, in 1/255 steps, and `bake_off_share` the share of their
    texels that differ; `frozen_gap`: the largest relative change of a
    geometry entry over the window."""
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    grad_gap, grad_leaf = tied_grad_gap(prog["grad"], ref["grad"], ref["ties"])
    d_prog = {k: prog["after"][k] - ref["start"][k] for k in ref["grad"]}
    d_ref = {k: ref["after"][k] - ref["start"][k] for k in ref["grad"]}
    change_gap, change_leaf = leaf_gaps(d_prog, d_ref)
    bake_gap, off_share = map_gaps(prog["bakes"], ref["bakes"])
    print(f"[check] loss gap at each step {gaps}; worst leaf: gradient {grad_leaf} "
          f"({len(ref['ties'])} masked-L1 residuals within rounding of 0), change "
          f"{change_leaf}", file=sys.stderr)
    return {"first_loss_gap": gaps[0], "grad_gap": grad_gap, "change_gap": change_gap,
            "bake_gap": bake_gap, "bake_off_share": off_share,
            "frozen_gap": frozen_gap(prog["geometry"], ref["geometry"])}


def program_readings(st: dict, ref_bakes: dict) -> dict:
    return {"losses": st["losses"], "grad": st["grad"], "after": st["after"],
            "bakes": program_bakes(st, ref_bakes), "geometry": st["geometry"]}


def reference_readings(inp: dict, st: dict, pairs: list, tf32: bool = False,
                       fault: str | None = None) -> dict:
    """The reference's side of `compare`, in TF32 for the control or with a
    planted `fault`: "light_frozen" (the light's Adam does not step),
    "skipped_face" (a cube face left empty), "no_hemisphere" (the normal
    mask left out), "geometry_drift" (the geometry moved by its momentum)."""
    ties = []
    (losses, grad, after), _ = reference_steps(inp, st, tf32, fault, ties)
    start = {**{k: v for k, v in _start_params(inp).items() if k in RP.STEPPED},
             "light": _light(inp)}
    geometry = {k: v for k, v in inp["start"]["params"].items()
                if k.split(".")[0] != "gaussians" or k.split(".")[1] in PP.GEOMETRY}
    if fault == "geometry_drift":
        geometry = drift(inp, len(st["fed"]))
    return {"losses": losses, "grad": grad, "ties": ties, "after": after, "start": start,
            "bakes": reference_bakes(inp, pairs, st["baked_after"], tf32, fault),
            "geometry": geometry}


# ---- the run -----------------------------------------------------------------------

def _free(cuda: bool) -> None:
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def _setup(cfg: dict, seed: int, device):
    if not PP.bakes_every_instance():
        print("port_bench: this program's bake keeps 256 instances per tile list; the "
              "configuration bakes every Gaussian (occlusion/baking.py::bake_config)",
              file=sys.stderr)
        raise SystemExit(6)
    inp = pbr_inputs(cfg, seed, device)
    cuda = device.type == "cuda"
    if cuda:
        PP.cuda_build()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    return inp, PP.PbrTrainer(inp), cuda


def window_views(st: dict) -> list:
    """The views first visited after set-up (their cameras baked in the
    window), whose maps the buffer still holds."""
    seen = set(st["fed"][:FIRST_STEPS])
    out = []
    for v in st["fed"][FIRST_STEPS:]:
        if v not in seen:
            seen.add(v)
            if v in st["slot_of"]:
                out.append(v)
    return out


def check(inp: dict, st: dict, seed: int) -> tuple:
    """(numbers, the reference's readings, the bake pairs, {window view:
    its occupied cells})."""
    pairs, cells = bake_pairs(inp, window_views(st), seed)
    ref = reference_readings(inp, st, pairs)
    s = inp["start"]
    nb = RP.neighbours(_start_params(inp)["xyz"], s["alive"])
    differ = (nb[:, 1:] != st["knn3"][:, 1:].to(nb.device)).any(dim=1) & s["alive"]
    print(f"[check] neighbours: {int(differ.sum())} alive rows differ from the program's; "
          f"window bakes of {len(cells)} views, {sum(cells.values())} occupied cells",
          file=sys.stderr)
    return compare(program_readings(st, ref["bakes"]), ref), ref, pairs, cells


def bake_record(ref_bakes: dict, n_alive: int) -> dict:
    """The sampled faces' least time and the tile lists' lengths."""
    least, counts = [], []
    for _, _, work, tile_counts in ref_bakes.values():
        least += [CB.face_least_s(w, n_alive) for w in work]
        counts.append(tile_counts)
    c = torch.cat(counts).reshape(-1).long()
    dropped = torch.clamp(c - OLD_TILE_CAPACITY, min=0)
    rec = {"face_least_s": statistics.median(least), "faces_sampled": len(least),
           "longest_list": int(c.max()), "instances": int(c.sum()),
           "dropped_at_256": int(dropped.sum()),
           "most_dropped_of_a_face": int(dropped.reshape(-1, 4).sum(dim=1).max())}
    print(f"[bake] {rec['faces_sampled']} sampled faces: tile lists up to "
          f"{rec['longest_list']} instances, {rec['instances']} in all; lists of "
          f"{OLD_TILE_CAPACITY} would drop {rec['dropped_at_256']} (up to "
          f"{rec['most_dropped_of_a_face']} of a face); the program's lists hold every one",
          file=sys.stderr)
    return rec


def run(cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool, device,
        t_process: float) -> tuple[Run, dict]:
    inp, trainer, cuda = _setup(cfg, seed, device)
    trace = Trace() if traced else None
    last = window_last(cfg, seconds)
    st = drive(trainer, traffic, cfg["capture_seed"], last, trace, cuda)
    window_s = st["t1"] - st["t0"] - (trace.overhead_s if trace is not None else 0.0)
    peak = PP.peak_bytes(device)
    del trainer
    _free(cuda)
    numbers, ref, pairs, cells = check(inp, st, seed)
    print(f"[check] {numbers}", file=sys.stderr)
    n_alive = int(inp["start"]["alive"].sum())
    run_ = Run(kind="train", seconds=window_s, setup_s=st["t0"] - t_process,
               units=last - cfg["start"]["iteration"] - FIRST_STEPS,
               trace=trace if st["traced_units"] else None, traced_units=st["traced_units"],
               vertices=cfg["body"]["vertices"], live=n_alive)
    run_.extra.update(peak_bytes=peak, **bake_record(ref["bakes"], n_alive))
    ph = st["phases"]
    if ph.get("t0") is not None and ph.get("t1") is not None:
        window = {k: ph["t1"][k] - ph["t0"][k] for k in ph["t0"]}
        traced = {k: ph["trace_to"][k] - ph["trace_from"][k] for k in window} \
            if "trace_to" in ph else dict.fromkeys(window, 0)
        timed = {k: v - traced[k] for k, v in window.items()}
        run_.extra.update(bake_s=window["bake_s"], bakes=window["bakes"],
                          sweeps=window["sweeps"], faces=window["faces"],
                          face_s=timed["bake_s"] / timed["faces"] if timed["faces"] else None)
        print(f"[bake] window: {window['bakes']} bakes, {window['sweeps']} sweeps, "
              f"{window['faces']} faces, {window['bake_s']:.3f} s of {window_s:.3f} s",
              file=sys.stderr)
    if st["traced_units"]:
        count_traced(run_, inp, st, ref["bakes"], cfg, sum(cells.values()))
    return run_, numbers


def count_traced(run_: Run, inp: dict, st: dict, ref: dict, cfg: dict, cells: int,
                 sample: int = 4) -> None:
    """The step's blend work on a sample of the traced chunk's views at the
    start state, the window bakes' counted faces (6 per occupied cell of
    each window view, `cells` in all) and the window's counted operations
    per iteration."""
    s = inp["start"]
    p = _start_params(inp)
    occ = torch.zeros((p["xyz"].shape[0], 3), device=p["xyz"].device)
    idx = st["fed"][st["traced_from"]:st["traced_from"] + st["traced_units"]]
    with torch.no_grad(), precision():
        for i in idx[::max(1, len(idx) // sample)][:sample]:
            v = inp["views"][i]
            run_.work.append(RP.gbuffers(p, s["alive"], v["camera"], v["frame"],
                                         inp["scene"].body, sh_degree=s["active_sh_degree"],
                                         mlp=_mlp(inp), raster=inp["raster"], bg=inp["bg"],
                                         occlusion_color=occ)[2])
    work = {k: statistics.median(w[k] for w in run_.work) for k in run_.work[0]}
    step_ops = CP.pbr_step(height=cfg["frame"]["height"], width=cfg["frame"]["width"],
                           lpips=inp["lpips"] is not None, work=work, n=run_.live,
                           vertices=cfg["body"]["vertices"],
                           joints=len(inp["scene"].body["parents"]),
                           light_res=inp["pbr"]["light_res"])
    face_ops = statistics.median(CB.face(w, run_.live)[0] for _, _, ws, _ in ref.values()
                                 for w in ws)
    bake_ops = 6 * cells * face_ops
    run_.flops_per_unit = (run_.units * step_ops + bake_ops) / run_.units
    print(f"[count] a step {step_ops:.4g} operations; the window's bakes {cells} occupied "
          f"cells, {bake_ops:.4g} operations", file=sys.stderr)


def readings(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """`control.py`'s readings of one seed: the program from the start
    through set-up and three window iterations (three window bakes),
    compared with the reference as a run compares it (`program`), and the
    reference put in the program's place in TF32 (`tf32`, the control) and
    with each planted fault."""
    inp, trainer, cuda = _setup(cfg, seed, device)
    first = cfg["start"]["iteration"] + FIRST_STEPS
    st = drive(trainer, traffic, cfg["capture_seed"], first + 3, None, cuda)
    del trainer
    _free(cuda)
    out = {}
    numbers, ref, pairs, _ = check(inp, st, seed)
    out["program"] = numbers
    for name, tf32, fault in (("tf32", True, None), ("light_frozen", False, "light_frozen"),
                              ("skipped_face", False, "skipped_face"),
                              ("no_hemisphere", False, "no_hemisphere"),
                              ("geometry_drift", False, "geometry_drift")):
        t0 = time.perf_counter()
        out[name] = compare(reference_readings(inp, st, pairs, tf32, fault), ref)
        out[name]["seconds"] = time.perf_counter() - t0
    return out

