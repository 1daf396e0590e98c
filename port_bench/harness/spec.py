"""What `BENCHMARK.json` names, found by name: a cell's configuration file,
its traffic mix (`traffic/<name>.json`, run by the driver module it
names), its limits (`limits/<cell>.json`),
and the readers of its metrics (`end_to_end/<metric>.py`,
`layer_metrics/<metric>.py`). A later cell, configuration, mix or metric is
new files and new entries; no file here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent          # port_bench/
ROOT = HERE.parent


class Spec:
    def __init__(self, root: Path = ROOT, bench: Path = HERE):
        self.root = Path(root)
        self.bench = Path(bench)
        with open(self.root / "BENCHMARK.json") as f:
            self.doc = json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(self.bench / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def mix(self, traffic: dict):
        """The driver module that runs a mix: `harness/<driver>.py`, named by
        the traffic file's `driver` (`run(...)` for the benchmark,
        `readings(...)` for `control.py`)."""
        name = traffic["driver"]
        if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
            raise ValueError(f"bad driver name {name!r}")
        return importlib.import_module(f"port_bench.harness.{name}")

    def limits(self, cell: str) -> dict:
        """{number: limit} of the cell's comparison (empty when the cell has
        no limits file: then nothing can be judged correct)."""
        path = self.bench / "limits" / f"{cell}.json"
        if not path.exists():
            return {}
        with open(path) as f:
            return {k: float(v["limit"]) for k, v in json.load(f)["numbers"].items()}

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.doc["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> list:
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.doc["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def reader(self, kind: str, name: str):
        """The `read(ctx)` of metric `name` (kind: "end_to_end" or
        "layer_metrics")."""
        path = self.bench / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"port_bench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
