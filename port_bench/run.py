#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port, `mygauhuman_torch`, on NVIDIA GPUs.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of `BENCHMARK.json` (a configuration under a traffic mix,
run by the driver that the mix's file names, such as `harness/train_mix.py`)
on the GPU it starts on:
makes the inputs from the seed, warms up (set-up), measures for `--seconds`
seconds, and checks what the timed path produced against the plain
reference (`reference/`). Its last line on standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer metrics, each read by the file
of its name under `end_to_end/` or `layer_metrics/`), `device`, with
`--trace 1` a `breakdown`, and last `checks`: each number compared beside
its limit (also the last lines on standard error).

It exits non-zero and prints no result when there is no CUDA card, fewer
cards than the cell asks for, or, once the window has closed, a module of
JAX or of the JAX package in this process. The program builds its kernels
inside the checkout (`build/`).
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mygauhuman_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def measure(spec, cell: dict, seed: int, seconds: float, traced: bool, device,
            t_process: float):
    """Run the cell's mix by its driver -> (Run, numbers compared)."""
    traffic = spec.traffic(cell["traffic"])
    return spec.mix(traffic).run(spec.config(cell["config"]), traffic, seed, seconds, traced,
                                 device, t_process)


def result(spec, cell: dict, run, numbers: dict, traced: bool, device) -> dict:
    """The result line's object (see the module docstring)."""
    import torch

    from port_bench.harness.record import verdict

    name = cell["name"]
    ok, checks = verdict(numbers, spec.limits(name))
    kind = "layer_metrics" if traced else "end_to_end"
    metrics = {}
    for m in (spec.per_layer(name) if traced else spec.end_to_end(name)):
        value = spec.reader(kind, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(run.extra.get("peak_bytes", 0))}
    out = {"correct": ok, "attempted": int(run.extra.get("attempted", run.units)),
           "failed": int(run.extra.get("failed", 0)), "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench.harness.spec import Spec

    spec = Spec(ROOT)
    cell = spec.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"port_bench: needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(2)
    run, numbers = measure(spec, cell, args.seed, args.seconds, bool(args.trace), device,
                           T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: modules of JAX or of the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 4
    out = result(spec, cell, run, numbers, bool(args.trace), device)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
