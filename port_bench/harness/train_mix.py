"""The `train` mix: the start of one `cli.train` subject through the port's
`train_loop` and its donated (graphed) step, over a fixed stretch of its
1,200-iteration budget.

Set-up makes the inputs, builds the TrainState and the step as `cli.train`
does (the LPIPS crop by `cli.train`'s own rule on the views), and drives
that same object through its first three iterations (callbacks at 1, 2
and 3 end its first chunks there): the program's loss at each, its first
gradient (Adam's first moment after one step over 1 - b1) and its
parameters after the third are kept. The window opens there and runs on
in the same loop to the configuration's last iteration of the window
(`window.last_iteration` at `window.run_seconds`, scaled by `--seconds`),
so the work timed is fixed: `train_it_per_s` is its iterations over its
seconds. A traced run profiles the chunk from `trace_from` to `trace_to`
inside the window and takes the profiler's seconds out of it.

Where the window reaches a densify event E (and E + 1), the program's
state is copied as the chunk that ends at E returns (before the event),
after the event (the callback at E) and after step E + 1 (the callback
there, which ends a chunk of one iteration).

After the window the peak memory is read, the program is freed, and the
reference (`reference/`) follows: the first three iterations on the same
views from the same start; the event on the program's state before it
(`reference/densify.py`, the split noise drawn from the loop's seed as the
program draws it); step E + 1 from the program's state after the event
(its Adam moments included). `compare` gives the numbers the limits hold.
"""
from __future__ import annotations

import gc
import sys
import time

import torch

from port_bench.counts import step as FL
from port_bench.harness import inputs as I
from port_bench.harness import program as P
from port_bench.harness.record import Run, leaf_gaps, median_work
from port_bench.harness.trace import Trace
from port_bench.reference import densify as RD
from port_bench.reference import losses as RL
from port_bench.reference import render as RR
from port_bench.reference import train as RT
from port_bench.reference.precision import precision

FIRST_STEPS = 3
STATS = ("xyz_grad_accum", "denom", "max_radii2d")


def window_last(cfg: dict, seconds: float) -> int:
    """The window's last iteration: `window.last_iteration` at
    `window.run_seconds`, the iterations past the first three scaled by
    `--seconds`, within the budget."""
    w = cfg["window"]
    n = round((w["last_iteration"] - FIRST_STEPS) * seconds / w["run_seconds"])
    return min(FIRST_STEPS + max(1, n), cfg["optim"]["iterations"])


def first_event(optim: dict, last: int) -> int | None:
    """The first densify iteration E of the window with E + 1 in it."""
    for it in range(max(optim["densify_from_iter"], FIRST_STEPS + 1), last):
        if it < optim["densify_until_iter"] and it % optim["densification_interval"] == 0:
            return it
    return None


def sh_degree_at(it: int, inp: dict) -> int:
    return min(it // 1000, inp["sh_degree"])


class Fed:
    """The program's step, passed through, with the view indices of every
    chunk it is fed (what the reference must follow), and the state as
    the chunk that ends at `event` returns it."""

    def __init__(self, step, trace: Trace | None, event: int | None):
        self.step = step
        self.trace = trace
        self.event = event
        self.fed: list = []
        self.pre = None

    def __call__(self, ts, batch, deg):
        return self.step(ts, batch, deg)

    def chunk(self, ts, views, idx, deg, pad_to=0):
        self.fed.extend(int(i) for i in idx)
        if self.trace is not None and self.trace.prof is not None:
            with Trace.span("chunk"):
                out = self.step.chunk(ts, views, idx, deg, pad_to=pad_to)
        else:
            out = self.step.chunk(ts, views, idx, deg, pad_to=pad_to)
        if self.event is not None and len(self.fed) == self.event:
            self.pre = P.state_rows(out[0])
        return out


def _clone_flat(tree) -> dict:
    return {k: v.detach().clone() for k, v in P.flat_leaves(tree).items()}


def drive(trainer: P.Trainer, traffic: dict, seed: int, last: int, trace: Trace | None,
          cuda: bool) -> dict:
    """Run the program from the seeded start through iteration `last` and
    keep what the comparison and the metrics read."""
    inp = trainer.inp
    ts, tx, step = trainer.subject()
    event = first_event(inp["optim"], last)
    fed = Fed(step, trace, event)
    t_from, t_to = traffic["trace_from"], traffic["trace_to"]
    traced = trace is not None and FIRST_STEPS < t_from and t_to <= last
    st = {"losses": [], "grad": None, "params": None, "t0": None, "t1": None,
          "capture_base": 0.0, "event": event, "post": None, "after": None,
          "event_loss": None, "snapshot": None, "traced_units": 0, "fed": fed.fed}
    cb = {*range(1, FIRST_STEPS + 1), *range(100, last + 1, 100), last}
    if traced:
        cb |= {t_from, t_to}
    if event is not None:
        cb |= {event, event + 1}

    def callback(it, ts, metrics):
        if it <= FIRST_STEPS:
            st["losses"].append(float(metrics["loss"]))
            if it == 1:
                mu = P.flat_leaves(ts.opt_state.mu)
                st["grad"] = {k: v.detach().clone() / (1 - P.B1) for k, v in mu.items()}
            if it == FIRST_STEPS:
                st["params"] = _clone_flat(P.trainable_params(ts))
                if cuda:
                    torch.cuda.synchronize()
                st["t0"] = time.perf_counter()
                st["capture_base"] = step.record()["capture_s"]
            return
        if traced and it == t_from:
            st["snapshot"] = (_clone_flat(P.trainable_params(ts)), ts.gauss.alive.clone(),
                              len(fed.fed))
            trace.start()
        elif traced and it == t_to and trace.prof is not None:
            trace.stop()
            st["traced_units"] = t_to - t_from
        if it == event:
            st["post"] = P.state_rows(ts)
            st["post_leaves"] = _clone_flat(P.trainable_params(ts))
            st["post_moments"] = (_clone_flat(ts.opt_state.mu), _clone_flat(ts.opt_state.nu))
        elif event is not None and it == event + 1:
            st["after"] = _clone_flat(P.trainable_params(ts))
            st["event_loss"] = float(metrics["loss"])
        if it == last:
            if cuda:
                torch.cuda.synchronize()
            st["t1"] = time.perf_counter()
        print(f"[window] iteration {it} at {time.perf_counter() - st['t0']:.3f} s"
              + (f", capacity {metrics['capacity']}" if "capacity" in metrics else ""),
              file=sys.stderr)

    trainer.loop(ts, tx, fed, seed=int(seed) % (2 ** 32), callback=callback,
                 scan_chunk=traffic["scan_chunk"], num_iterations=last,
                 callback_iters=tuple(sorted(cb)))
    st["capture_s"] = step.record()["capture_s"] - st["capture_base"]
    st["pre"] = fed.pre
    return st


def program_readings(st: dict) -> dict:
    """The program's side of `compare`."""
    out = {"losses": st["losses"], "grad": st["grad"], "params": st["params"]}
    if st["event"] is not None:
        post = st["post"]
        alive = post["alive"]
        out["event"] = {
            "rows": {f: post[f][alive] for f in RD.FIELDS},
            "moments": {f"{m}.{f}": post[f"{m}.{f}"][alive] for m in ("mu", "nu")
                        for f in RD.FIELDS},
            "stats": {k: post[k] for k in STATS}, "count": int(alive.sum()),
            "loss": st["event_loss"], "params": st["after"]}
    return out


def reference_leaves(inp: dict) -> dict:
    leaves = {f"gaussians.{f}": inp["init"][f] for f in RT.GAUSS_FIELDS}
    leaves.update(RT.flatten_mlp("pose_refiner", inp["mlps"]["pose_refiner"]))
    leaves.update(RT.flatten_mlp("lbs_offset", inp["mlps"]["lbs_offset"]))
    return leaves


def reference_crop(inp: dict) -> int:
    return RL.scene_lpips_crop([v["bound_mask"] for v in inp["views"]])


def reference_readings(inp: dict, st: dict, seed: int, tf32: bool = False,
                       fault: str | None = None) -> dict:
    """The reference's side of `compare`, computed in TF32 for the control
    or with a planted `fault` ("half": half of each view left out of the
    loss; "split_scale": an event's children keep their parent's scale)."""
    body, optim = inp["scene"].body, inp["optim"]
    kw = dict(raster=inp["raster"], bg=inp["bg"], lpips_params=inp["lpips"],
              crop=reference_crop(inp))
    step_fault = fault if fault == "half" else None
    views = [inp["views"][i] for i in st["fed"][:FIRST_STEPS]]
    with precision(tf32):
        losses, grad, params = RT.train_steps(
            reference_leaves(inp), inp["alive"], views, body, optim, fault=step_fault,
            sh_degrees=[sh_degree_at(t, inp) for t in range(1, FIRST_STEPS + 1)], **kw)
    out = {"losses": losses, "grad": grad, "params": params}
    E = st["event"]
    if E is None:
        return out
    pre = st["pre"]
    n_pre = int(pre["alive"].sum())
    noise = RD.split_noise(int(seed) % (2 ** 32), pre["alive"].shape[0], n_pre)
    with torch.no_grad(), precision(tf32):
        ev = RD.event({f: pre[f] for f in RD.FIELDS}, pre["alive"], pre["xyz_grad_accum"],
                      pre["denom"], {f"{m}.{f}": pre[f"{m}.{f}"] for m in ("mu", "nu")
                                     for f in RD.FIELDS},
                      optim=optim, extent=inp["scene"].extent,
                      smpl_vertices=inp["scene"].big_verts, noise=noise,
                      fault=fault if fault == "split_scale" else None)
    ev["stats"] = {k: torch.zeros_like(pre[k]) for k in STATS}
    ev["pre_count"] = n_pre
    view = inp["views"][st["fed"][E]]
    with precision(tf32):
        loss, grad_e, after = RT.train_steps(
            st["post_leaves"], st["post"]["alive"], [view], body, optim, fault=step_fault,
            sh_degrees=[sh_degree_at(E + 1, inp)], moments=st["post_moments"],
            first_step=E, **kw)
    ev.update(loss=loss[0], grad=grad_e, params=after, start=st["post_leaves"])
    out["event"] = ev
    return out


def _change_gap(prog_after: dict, ref_after: dict, start: dict, ref_grad: dict) -> tuple:
    """The worst leaf's gap of the change's norms, over the leaves whose
    reference gradient is at least a thousandth of the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref_grad.items()}
    med = sorted(norms.values())[len(norms) // 2]
    counted = {k for k, v in norms.items() if v >= 1e-3 * med}
    d_prog = {k: prog_after[k] - start[k] for k in start}
    d_ref = {k: ref_after[k] - start[k] for k in start}
    gap, leaf = leaf_gaps(d_prog, d_ref, counted)
    return gap, leaf, sorted(set(start) - counted)


def compare(prog: dict, ref: dict, start: dict) -> dict:
    """The numbers the limits hold.

    `first_loss_gap`: the first step's relative loss gap (the loss is
    compared at the first step only: Adam's first update moves each entry by
    about its learning rate whatever the gradient's size, so an entry whose
    gradient is zero to rounding moves either way on either side, and the
    later steps' losses carry that noise; each step's gap is printed).
    `grad_gap`: the worst leaf's gap of the first gradient's norms over the
    larger of that leaf's and the median leaf's reference norm;
    `change_gap`: the same for the change after three steps.
    Where the window reaches an event: `densify_count_gap`, the gap of the
    live Gaussians' counts after it over the reference's change of the
    count; `densify_leaf_gap`, the worst leaf's gap of norms over the live
    rows (parameters, Adam moments) and the restarted statistics;
    `event_loss_gap` and `event_change_gap`, the first and last numbers
    again for step E + 1 from the program's state after the event."""
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    grad_gap, grad_leaf = leaf_gaps(prog["grad"], ref["grad"])
    change_gap, change_leaf, left_out = _change_gap(prog["params"], ref["params"], start,
                                                    ref["grad"])
    print(f"[check] loss gap at each step {gaps}; worst leaf: gradient {grad_leaf}, change "
          f"{change_leaf}; leaves left out of the change (reference gradient under 1e-3 of "
          f"the median leaf's): {left_out}", file=sys.stderr)
    out = {"first_loss_gap": gaps[0], "grad_gap": grad_gap, "change_gap": change_gap}
    if "event" not in ref:
        return out
    pe, re = prog["event"], ref["event"]
    out["densify_count_gap"] = abs(pe["count"] - re["count"]) / max(
        abs(re["count"] - re["pre_count"]), 1)
    out["densify_leaf_gap"], dleaf = leaf_gaps({**pe["rows"], **pe["moments"], **pe["stats"]},
                                               {**re["rows"], **re["moments"], **re["stats"]})
    out["event_loss_gap"] = abs(pe["loss"] - re["loss"]) / max(abs(re["loss"]), 1e-30)
    out["event_change_gap"], eleaf, _ = _change_gap(pe["params"], re["params"], re["start"],
                                                    re["grad"])
    print(f"[check] event: live {re['pre_count']} -> program {pe['count']}, reference "
          f"{re['count']}; worst leaf: event {dleaf}, step after it {eleaf}", file=sys.stderr)
    return out


def _free(cuda: bool) -> None:
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def _setup(cfg: dict, seed: int, device):
    inp = I.train_inputs(cfg, seed, device)
    cuda = device.type == "cuda"
    if cuda:
        P.cuda_lib.build()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    trainer = P.Trainer(inp)
    print(f"[port_bench] LPIPS crop: program {trainer.crop}, reference {reference_crop(inp)}",
          file=sys.stderr)
    return inp, trainer, cuda


def run(cfg: dict, traffic: dict, seed: int, seconds: float, traced: bool, device,
        t_process: float) -> tuple[Run, dict]:
    inp, trainer, cuda = _setup(cfg, seed, device)
    trace = Trace() if traced else None
    last = window_last(cfg, seconds)
    st = drive(trainer, traffic, seed, last, trace, cuda)
    window_s = st["t1"] - st["t0"] - (trace.overhead_s if trace is not None else 0.0)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del trainer
    _free(cuda)
    numbers = compare(program_readings(st), reference_readings(inp, st, seed),
                      reference_leaves(inp))
    print(f"[check] {numbers}", file=sys.stderr)
    run_ = Run(kind="train", seconds=window_s, setup_s=st["t0"] - t_process,
               units=last - FIRST_STEPS, capture_s=st["capture_s"],
               trace=trace if st["traced_units"] else None, traced_units=st["traced_units"],
               vertices=cfg["body"]["vertices"])
    run_.extra["peak_bytes"] = peak
    if st["snapshot"] is not None and st["traced_units"]:
        leaves_t, alive_t, n_fed = st["snapshot"]
        count_traced(run_, inp, reference_crop(inp), leaves_t, alive_t,
                     st["fed"][n_fed:n_fed + st["traced_units"]], cfg)
    return run_, numbers


def readings(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """`control.py`'s readings of one seed: the program from the seeded start
    to the window's first event and the step after it (or its first three
    steps where the window reaches none), compared with the reference as a
    run compares it (`program`), and the reference put in the program's
    place in TF32 (`tf32`, the control) and with each planted fault."""
    inp, trainer, cuda = _setup(cfg, seed, device)
    last = window_last(cfg, cfg["window"]["run_seconds"])
    E = first_event(inp["optim"], last)
    st = drive(trainer, traffic, seed, FIRST_STEPS if E is None else E + 1, None, cuda)
    del trainer
    _free(cuda)
    start = reference_leaves(inp)
    ref = reference_readings(inp, st, seed)
    out = {"program": compare(program_readings(st), ref, start)}
    for name, tf32, fault in (("tf32", True, None), ("half", False, "half"),
                              ("split_scale", False, "split_scale")):
        if fault == "split_scale" and E is None:
            continue
        t0 = time.perf_counter()
        out[name] = compare(reference_readings(inp, st, seed, tf32, fault), ref, start)
        out[name]["seconds"] = time.perf_counter() - t0
    return out


def count_traced(run_: Run, inp: dict, crop: int, leaves: dict, alive, idx: list, cfg: dict,
                 sample: int = 8) -> None:
    """The blend work of the traced chunk's views (a sample of them) on the
    state at its start, and the step's counted operations."""
    p = {f: leaves[f"gaussians.{f}"] for f in RT.GAUSS_FIELDS}
    mlp = {"pose_refiner": RT.unflatten_mlp("pose_refiner", leaves),
           "lbs_offset": RT.unflatten_mlp("lbs_offset", leaves)}
    step = max(1, len(idx) // sample)
    with torch.no_grad(), precision():
        for i in idx[::step][:sample]:
            v = inp["views"][i]
            f = RR.render(p, alive, v["camera"], v["frame"], inp["scene"].body, sh_degree=0,
                          mlp=mlp, raster=inp["raster"], bg=inp["bg"])
            run_.work.append(f.work)
    run_.live = int(alive.sum())
    joints = len(inp["scene"].body["parents"])
    run_.flops_per_unit = FL.train_step(
        height=cfg["frame"]["height"], width=cfg["frame"]["width"], crop=crop,
        lpips=inp["lpips"] is not None, work=median_work(run_.work), n=run_.live,
        vertices=cfg["body"]["vertices"], joints=joints)
