#!/usr/bin/env python3
"""The readings that set each limit: the program's sound readings and,
put in the program's place and compared with the plain reference as a run
compares the program, the control and the planted faults (not run by the
benchmark's runs).

    python3 port_bench/control.py --workload <cell> --seeds 11 12 13

For each seed, one JSON line of the readings that the cell's mix driver
gives (`readings(cfg, traffic, seed, device)` in `harness/<driver>.py`):
the control `tf32` (the reference computed with TF32 on for matmuls and
convolutions, the nearest precision below the configuration's float32)
and the faults that the cell can have; a training cell also reads the
program itself (`program`) from the seeded start through the window's
first densify event and the step after it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="control and fault readings of a cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench.harness.spec import Spec

    spec = Spec(ROOT)
    cell = spec.workload(args.workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
    torch.set_num_threads(2)
    for seed in args.seeds:
        out = spec.mix(traffic).readings(cfg, traffic, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
