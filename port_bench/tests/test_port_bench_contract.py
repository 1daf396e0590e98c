"""The benchmark's definition: names, units and files as its contract
allows them; counts against hand-counted cases; no module of JAX or of the
JAX package loaded, and nothing of the program in the reference."""
from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import run as R
from port_bench.counts import kernels as K
from port_bench.counts import step as S
from port_bench.harness.spec import Spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "port_bench"
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= len(DOC["paths"]) <= 16 and all(PATH.match(p) for p in DOC["paths"])
    assert len(DOC["command"]) <= 32 and all(one_line(w) for w in DOC["command"])
    assert DOC["command"][1].startswith(DOC["paths"][0] + "/")
    assert isinstance(DOC["run_seconds"], int) and 1 <= DOC["run_seconds"] <= 51
    assert len(json.dumps(DOC)) <= 64 * 1024


def test_names_units_and_one_line_fields():
    names = []
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("port_bench/")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) == set(cfg["reduced"])
        names.append(c["name"])
    pairs = set()
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(DOC["workloads"])
    assert sum(w["chips"] == 4 for w in DOC["workloads"]) <= max(1, len(DOC["workloads"]) // 4)
    metrics = DOC["end_to_end"] + DOC["per_layer"]
    all_names = [m["name"] for m in metrics] + names + [w["name"] for w in DOC["workloads"]]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in DOC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (BENCH / "end_to_end" / f"{m['name']}.py").is_file()
    for m in DOC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"])
        assert m["moves"] in {e["name"] for e in DOC["end_to_end"]}
        assert (BENCH / "layer_metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert any(m["name"] == "setup_s" for m in DOC["end_to_end"])
    assert all(NAME.match(n) for n in all_names)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    spec = Spec()
    for w in DOC["workloads"]:
        e2e = {m["name"] for m in spec.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = spec.per_layer(w["name"])
        assert layer and all(m["moves"] in e2e for m in layer)


def test_bound_takes_the_larger_of_operations_and_bytes():
    assert K.bound_s(67e12, 0.0) == pytest.approx(1.0)
    assert K.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert K.bound_s(67e12, 6.7e12) == pytest.approx(2.0)


def test_kernel_counts_by_hand():
    # 2 queries x 3 references: 6 pairs of 11 operations; 12 B per point,
    # 8 B per (query, neighbour)
    assert K.knn(2, 3) == (66.0, 12.0 * 5 + 16.0)
    # one Gaussian: 297 operations, 54 floats in and out, 32 scalars
    assert K.deform(1) == (297.0, 54 * 4.0 + 128.0)
    work = {"pairs_evaluated": 10, "pairs_included": 4, "instances_read": 3,
            "busy_tiles": 1, "tiles": 2, "chunks": 1, "channels": 1, "tile_pixels": 4,
            "pixels": 8}
    # 20 per evaluated pair, 2 (C + 2) + 4 = 10 per included one
    assert K.blend_fwd(work)[0] == 240.0
    # (7 + 1) rows of 4 B for 3 instances, 8 B per tile, (1 + 3) planes of 8 pixels
    assert K.blend_fwd(work)[1] == 96.0 + 16.0 + 128.0
    # checkpoints: T per (chunk, pixel) and stop, T_final per busy-tile pixel
    assert K.blend_fwd(work, checkpoints=True)[1] == 240.0 + 4.0 * 3 * 4 + 8.0
    # 40 per evaluated pair, 3 C + 30 = 33 per included one
    assert K.blend_bwd(work)[0] == 400.0 + 132.0
    assert K.blend_bwd(work)[1] == 2 * 8 * 4.0 * 3 + 1 * 4 * 4 * 4.0 + 16.0


def test_step_counts_by_hand():
    # a 2 x 2 image through the first conv alone would be 2 * 9 * 3 * 64 * 4;
    # the whole trunk at side 16: each stage at its side
    want = 0.0
    for (cin, cout), stage in zip(S.VGG_PLAN, S.STAGE_OF):
        r = 16 // 2 ** stage
        want += 2 * 9 * cin * cout * r * r
    assert S.vgg_flops(16) == want
    assert S.vgg_flops(16) > 2 * 9 * 3 * 64 * 256
    # five maps, two 11-tap passes of 2 operations, 3 channels
    assert S.ssim_flops(2, 3) == 5 * 2 * 2 * 11 * 3 * 6
    assert S.lbs_offset_flops(1, 24) == 2 * (63 * 128 + 128 * 128 * 2 + 191 * 128 + 128 * 24)


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.x": 1, "flax": 1, "mygauhuman_tpu.ops": 1,
            "mygauhuman_torch": 1, "jaxtyping": 1, "mygauhuman_tpu_extra": 1}
    assert R.forbidden_modules(mods) == ["flax", "jax", "jax.numpy", "jaxlib.x",
                                         "mygauhuman_tpu.ops"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_or_the_jax_package():
    for f in BENCH.rglob("*.py"):
        assert not _imports(f) & set(R.FORBIDDEN), f


def test_the_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").glob("*.py"):
        assert "mygauhuman_torch" not in _imports(f), f
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import port_bench.reference.train, port_bench.reference.render;"
            "import port_bench.reference.precision, port_bench.reference.deform;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('mygauhuman_torch', 'mygauhuman_tpu', 'jax', 'jaxlib', 'flax'));"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_harness_loads_no_module_of_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import port_bench.run, port_bench.harness.train_mix, port_bench.harness.serve_mix;"
            "import port_bench.control;"
            "from port_bench.run import forbidden_modules; bad = forbidden_modules();"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
