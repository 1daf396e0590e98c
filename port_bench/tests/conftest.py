"""Fixtures of the benchmark's own tests (run: python -m pytest port_bench/tests -q).

`tiny` is a temporary copy of the benchmark's data (BENCHMARK.json, the
configurations, mixes, limits and readers) with every configuration and mix
cut to a size the CPU runs in seconds: the same code runs on it, on the
CPU, with the program's plain paths. `cuda` skips a test without a card.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_BODY = {"smpl": 300, "smplx": 400}


def shrink(cfg: dict) -> dict:
    cfg["body"]["vertices"] = TINY_BODY[cfg["body"]["kind"]]
    cfg["frame"] = {"width": 64, "height": 48}
    cfg["poses"]["train"] = 2
    cfg["poses"]["test"] = 3
    cfg["raster"]["tile_capacity"] = 256
    if "served" in cfg:
        cfg["served"] = {"gaussians": 500, "capacity": 512}
    if cfg["name"] == "smpl_zju_512":
        # a densify event at 6 inside the window (4-10 at --seconds 0.5)
        cfg["optim"].update(densify_from_iter=6, densification_interval=3)
    return cfg


def shrink_traffic(t: dict) -> dict:
    if t["driver"] == "train_mix":
        t.update(scan_chunk=4, trace_from=4, trace_to=8)
    else:
        t.update(warmup_frames=2, check_frames=3, trace_frames=3)
        if "motion" in t:
            t["motion"]["frames"] = 50
    return t


@pytest.fixture
def tiny(tmp_path):
    """(root, bench) of a tiny copy of the benchmark's data."""
    bench = tmp_path / "port_bench"
    shutil.copytree(ROOT / "port_bench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for f in (bench / "configs").glob("*.json"):
        f.write_text(json.dumps(shrink(json.loads(f.read_text()))))
    for f in (bench / "traffic").glob("*.json"):
        f.write_text(json.dumps(shrink_traffic(json.loads(f.read_text()))))
    return tmp_path, bench


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest port_bench/tests on the GPU")
    return torch.device("cuda")
