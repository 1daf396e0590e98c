"""Each mix end to end at a tiny size on the CPU (the program's plain
paths), held to the reference; the planted faults each make `correct`
false; a configuration added as files and entries is found by name."""
from __future__ import annotations

import json
import time

import pytest
import torch

from port_bench import run as R
from port_bench.harness.spec import Spec

torch.set_num_threads(2)
CELLS = ("train.smpl_zju_512", "render.smpl_zju_512.novel_pose",
         "render.smpl_zju_512.replay", "train.smplx_dna_1224x1024")
SEED = 2 ** 31 + 11       # more than 32 signed bits hold


def run_cell(root, bench, cell, traced=False, seconds=0.5):
    spec = Spec(root, bench)
    w = spec.workload(cell)
    dev = torch.device("cpu")
    run, numbers = R.measure(spec, w, SEED, seconds, traced, dev, time.perf_counter())
    return R.result(spec, w, run, numbers, traced, dev), run


@pytest.mark.parametrize("cell", CELLS)
def test_mix_runs_and_agrees_with_the_reference(tiny, cell):
    out, run = run_cell(*tiny, cell)
    assert out["correct"], out["checks"]
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(out)[-1] == "checks"
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    # the plain paths on the CPU agree with the reference to rounding
    assert max(c["value"] for c in out["checks"].values()) < 1e-4


@pytest.mark.parametrize("cell", ["train.smpl_zju_512", "render.smpl_zju_512.novel_pose"])
def test_traced_run_reports_per_layer_metrics(tiny, cell):
    out, run = run_cell(*tiny, cell, traced=True)
    assert out["correct"], out["checks"]
    assert run.trace is not None and run.trace.window_s > 0
    assert "busy_s" in out["device"] and "window_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    spec = Spec(*tiny)
    names = {m["name"] for m in spec.per_layer(cell)}
    # the CPU trace has no device operations: only host-side metrics read
    assert set(out["metrics"]) <= names
    assert "setup_s" not in out["metrics"]


def _unchanged_step(monkeypatch):
    from mygauhuman_torch.train import optim

    real = optim.Adam.step

    def step(self, params, grads, state, groups=None, staged=None):
        _, new_state = real(self, params, grads, state, groups=groups, staged=staged)
        return params, new_state

    monkeypatch.setattr(optim.Adam, "step", step)


def _half_batch(monkeypatch):
    from mygauhuman_torch.train import trainer

    real = trainer.compute_losses_a

    def losses(out, batch, *a, **k):
        bm = batch.bound_mask.clone()
        bm[bm.shape[0] // 2:] = 0
        return real(out, batch._replace(bound_mask=bm), *a, **k)

    monkeypatch.setattr(trainer, "compute_losses_a", losses)


def _altered_pixel(monkeypatch):
    from mygauhuman_torch.render import graph

    real = graph.GraphedRenderer.__call__

    def call(self, *a, **k):
        out = real(self, *a, **k)
        out.render[out.render.shape[0] // 2, out.render.shape[1] // 2, 0] += 0.25
        return out

    monkeypatch.setattr(graph.GraphedRenderer, "__call__", call)


def _event_skipped(monkeypatch):
    from mygauhuman_torch.train import trainer

    monkeypatch.setattr(trainer, "densify_event", lambda ts, *a, **k: (ts, {}))


def _split_children_altered(monkeypatch):
    from mygauhuman_torch.models import gaussians

    real = gaussians._split

    def split(state, selected, noise):
        return real(state, selected, noise * 2.0)

    monkeypatch.setattr(gaussians, "_split", split)


@pytest.mark.parametrize("cell,fault", [
    ("train.smpl_zju_512", _unchanged_step),
    ("train.smpl_zju_512", _half_batch),
    ("train.smpl_zju_512", _event_skipped),
    ("train.smpl_zju_512", _split_children_altered),
    ("render.smpl_zju_512.novel_pose", _altered_pixel),
    ("render.smpl_zju_512.replay", _altered_pixel),
])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    out, _ = run_cell(*tiny, cell)
    assert out["correct"] is False, out["checks"]


def test_a_configuration_added_as_files_is_found_by_name(tiny):
    root, bench = tiny
    cfg = json.loads((bench / "configs" / "smpl_zju_512.json").read_text())
    cfg["name"] = "smpl_other"
    cfg["cameras"]["train"] = [1, 7]
    (bench / "configs" / "smpl_other.json").write_text(json.dumps(cfg))
    (bench / "limits" / "train.smpl_other.json").write_text(
        (bench / "limits" / "train.smpl_zju_512.json").read_text())
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "smpl_other", "source": "https://example.org/other",
                           "file": "port_bench/configs/smpl_other.json", "reduced": [],
                           "why": "another rig"})
    doc["workloads"].append({"name": "train.smpl_other", "config": "smpl_other",
                             "traffic": "train", "chips": 1, "why": "another rig"})
    for m in doc["end_to_end"]:
        if m["name"] == "train_it_per_s":
            m["workloads"].append("train.smpl_other")
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    out, run = run_cell(root, bench, "train.smpl_other")
    assert out["correct"], out["checks"]
    assert "train_it_per_s" in out["metrics"]


def test_without_a_card_the_run_exits_non_zero_and_prints_nothing(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = R.main(["--workload", CELLS[0], "--seed", str(SEED), "--seconds", "1",
                 "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_a_cell_runs_on_the_card(cuda):
    """On the card: the replay cell for two seconds, correct, with its
    end-to-end metrics."""
    spec = Spec()
    w = spec.workload("render.smpl_zju_512.replay")
    run, numbers = R.measure(spec, w, SEED, 2.0, False, cuda, time.perf_counter())
    out = R.result(spec, w, run, numbers, False, cuda)
    assert out["correct"], out["checks"]
    assert {"render_fps", "setup_s"} <= set(out["metrics"])


def _limits(bench, cell):
    return {k: v["limit"] for k, v in
            json.loads((bench / "limits" / f"{cell}.json").read_text())["numbers"].items()}


@pytest.mark.parametrize("cell", ["train.smpl_zju_512", "render.smpl_zju_512.novel_pose"])
def test_planted_faults_read_above_the_limits(tiny, cell):
    """`control.py`'s faults, put in the program's place at a tiny size on
    the CPU: each fails at least one of the cell's limits, and the program's
    own readings pass them."""
    root, bench = tiny
    spec = Spec(root, bench)
    w = spec.workload(cell)
    cfg, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    out = spec.mix(traffic).readings(cfg, traffic, SEED, torch.device("cpu"))
    limits = _limits(bench, cell)
    if "program" in out:
        assert all(out["program"][n] <= limits[n] for n in limits), out["program"]
    faults = [k for k in out if k not in ("tf32", "program")]
    assert faults
    for k in faults:
        assert any(out[k][n] > limits[n] for n in limits), (k, out[k])


@pytest.mark.parametrize("cell", ["train.smpl_zju_512", "render.smpl_zju_512.replay"])
def test_the_tf32_control_fails_on_the_card(cuda, tiny, cell):
    """The reference in TF32 (the control) fails the limits on the card, at
    the tiny size (CPU matmuls have no TF32, so it runs only there)."""

    root, bench = tiny
    spec = Spec(root, bench)
    w = spec.workload(cell)
    cfg, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    out = spec.mix(traffic).readings(cfg, traffic, SEED, cuda)
    limits = _limits(bench, cell)
    assert any(out["tf32"][n] > limits[n] for n in limits), out["tf32"]
