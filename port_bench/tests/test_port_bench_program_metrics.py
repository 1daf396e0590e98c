"""The per-layer metrics that read the program's own counters: each entry
has its reader, its cells and a program source; a traced run reads the
densify events' share from the program's `PHASES`; against a program that
keeps no such counter the reader gives nothing and does not raise."""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

from port_bench import run as R
from port_bench.harness.record import Run
from port_bench.harness.spec import Spec

ROOT = Path(__file__).resolve().parents[2]
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
PROGRAM_METRICS = {"train.densify_share": ["train.smpl_zju_512"]}


def test_program_counter_entries_have_readers_and_cells():
    by_name = {m["name"]: m for m in DOC["per_layer"]}
    for name, cells in PROGRAM_METRICS.items():
        m = by_name[name]
        assert m["workloads"] == cells and m["source"] == "program_counter"
        assert (ROOT / "port_bench" / "layer_metrics" / f"{name}.py").is_file()
        assert m["layer"] == "entry: training (train/trainer.py::train_loop)"


def test_traced_run_reads_the_densify_share(tiny):
    from mygauhuman_torch.utils import profiling

    spec = Spec(*tiny)
    cell = spec.workload("train.smpl_zju_512")
    dev = torch.device("cpu")
    profiling.PHASES.reset()
    run, numbers = R.measure(spec, cell, 2 ** 31 + 11, 0.5, True, dev, time.perf_counter())
    out = R.result(spec, cell, run, numbers, True, dev)
    assert out["correct"], out["checks"]
    # the tiny configuration densifies at 6 and 9, inside the window 4-10
    assert profiling.PHASES.counts["mgh.train.densify"] == 2
    share = out["metrics"]["train.densify_share"]
    assert share["unit"] == "%" and 0 < share["value"] < 100


def test_reader_gives_nothing_without_the_programs_counter(monkeypatch):
    read = Spec().reader("layer_metrics", "train.densify_share")
    run = Run(kind="train", seconds=1.0, setup_s=0.0, trace=object())
    monkeypatch.setitem(sys.modules, "mygauhuman_torch.utils.profiling", None)
    assert read(run) is None
    monkeypatch.delitem(sys.modules, "mygauhuman_torch.utils.profiling")
    assert read(run) is None
