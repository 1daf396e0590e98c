"""The `pbr` mix (`train.smpl_zju_512.pbr`) at a tiny size on the CPU (the
program's plain paths) on the `tiny` fixture's pattern, its start cut to
120 Gaussians in 256 slots: a run agrees with the plain reference, a traced
run reads every per-layer metric of the cell, each planted fault in the program
makes `correct` false, the faults and the control that set the limits
read above them, a program whose bake truncates its tile lists fails at
once, and the new readers give nothing without the program's counters."""
from __future__ import annotations

import json
import time

import pytest
import torch

from port_bench import run as R
from port_bench.harness.record import Run
from port_bench.harness.spec import Spec

torch.set_num_threads(2)
CELL = "train.smpl_zju_512.pbr"
SEED = 2 ** 31 + 11       # more than 32 signed bits hold
NEW_METRICS = ("pbr.bake_share", "bake_face_roofline.pbr")
# the training cells' metrics that the cell reads too (convolutions' share: on the card only)
SHARED_METRICS = ("mfu.train", "device_idle.train", "train.loss_conv_share")


@pytest.fixture
def tiny_pbr(tiny):
    root, bench = tiny
    f = bench / "configs" / "smpl_zju_512_pbr.json"
    cfg = json.loads(f.read_text())
    cfg["start"].update(gaussians=120, capacity=256)
    f.write_text(json.dumps(cfg))
    # the traced stretch 1,206-1,208 inside the window 1,204-1,209 (--seconds 1)
    t = bench / "traffic" / "pbr.json"
    t.write_text(json.dumps({**json.loads(t.read_text()), "scan_chunk": 4,
                             "trace_from": 1205, "trace_to": 1208}))
    return root, bench


def run_cell(root, bench, traced=False, seconds=0.5):
    spec = Spec(root, bench)
    w = spec.workload(CELL)
    dev = torch.device("cpu")
    run, numbers = R.measure(spec, w, SEED, seconds, traced, dev, time.perf_counter())
    return R.result(spec, w, run, numbers, traced, dev), run


def _limits(bench):
    return {k: v["limit"] for k, v in
            json.loads((bench / "limits" / f"{CELL}.json").read_text())["numbers"].items()}


def test_pbr_mix_runs_and_agrees_with_the_reference(tiny_pbr):
    out, run = run_cell(*tiny_pbr)
    assert out["correct"], out["checks"]
    assert {"train_it_per_s", "setup_s"} == set(out["metrics"])
    assert set(out["checks"]) == set(_limits(tiny_pbr[1]))
    # the plain paths on the CPU: the same maps, the geometry unchanged, the
    # step to rounding
    c = {k: v["value"] for k, v in out["checks"].items()}
    assert c["bake_gap"] == c["bake_off_share"] == c["frozen_gap"] == 0.0
    assert max(c["first_loss_gap"], c["grad_gap"], c["change_gap"]) < 1e-4
    # set-up's three bakes, then the window's (1,204-1,206): one camera each
    assert run.units == 3 and run.extra["bakes"] == 3 and run.extra["faces"] > 0
    assert run.extra["dropped_at_256"] == 0 and run.extra["longest_list"] > 0


def test_traced_pbr_run_reads_every_new_metric(tiny_pbr):
    out, run = run_cell(*tiny_pbr, traced=True, seconds=1.0)
    assert out["correct"], out["checks"]
    assert run.traced_units == 3 and run.trace is not None
    # the CPU trace holds no kernel, so the convolutions' share reads nothing
    assert set(out["metrics"]) == {*NEW_METRICS, "mfu.train", "device_idle.train"}
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert 0 < m["pbr.bake_share"] < 100
    assert 0 < m["bake_face_roofline.pbr"] < 100 and 0 < m["mfu.train"] < 100
    # the CPU trace holds no device operation
    assert m["device_idle.train"] == 100.0


def _light_frozen(monkeypatch):
    from mygauhuman_torch.train import pbr

    real = pbr.LightAdam.step

    def step(self, params, grads, state, staged=None):
        return params, real(self, params, grads, state, staged=staged)[1]

    monkeypatch.setattr(pbr.LightAdam, "step", step)


def _skipped_face(monkeypatch):
    from mygauhuman_torch.occlusion import baking

    real, calls = baking.rasterize, []

    def rasterize(*a, **k):
        out = real(*a, **k)
        calls.append(1)
        return out._replace(alpha=torch.zeros_like(out.alpha)) if len(calls) % 6 == 1 else out

    monkeypatch.setattr(baking, "rasterize", rasterize)


def _no_hemisphere(monkeypatch):
    from mygauhuman_torch.occlusion import baking

    monkeypatch.setattr(baking, "_finalize",
                        lambda vis, normals, alive, h, w: vis * alive[:, None, None, None])


def _geometry_drift(monkeypatch):
    """The JAX step's update: every group stepped, the geometry's on zero
    gradients, so its momentum moves it."""
    from mygauhuman_torch.train import optim

    real = optim.Adam.step

    def step(self, params, grads, state, groups=None, staged=None):
        g = grads.gaussians._replace(**{
            f: torch.zeros_like(getattr(params.gaussians, f))
            for f in grads.gaussians._fields if getattr(grads.gaussians, f) is None})
        zeros = optim.TrainableParams(g, optim.tree_map(torch.zeros_like, params.pose_refiner),
                                      optim.tree_map(torch.zeros_like, params.lbs_offset))
        return real(self, params, zeros, state, groups=None, staged=staged)

    monkeypatch.setattr(optim.Adam, "step", step)


@pytest.mark.parametrize("fault", [_light_frozen, _skipped_face, _no_hemisphere,
                                   _geometry_drift])
def test_a_broken_branch_b_is_not_correct(tiny_pbr, monkeypatch, fault):
    fault(monkeypatch)
    out, _ = run_cell(*tiny_pbr, seconds=0.1)
    assert out["correct"] is False, out["checks"]


def test_a_program_whose_bake_truncates_its_lists_fails_at_once(tiny_pbr, monkeypatch):
    from mygauhuman_torch.occlusion import baking

    monkeypatch.delattr(baking, "bake_config")
    t0 = time.perf_counter()
    with pytest.raises(SystemExit) as e:
        run_cell(*tiny_pbr)
    assert e.value.code == 6 and time.perf_counter() - t0 < 5


def test_planted_faults_read_above_the_limits(tiny_pbr):
    """`control.py`'s faults, put in the program's place: each fails at
    least one limit, and the program's own readings pass them all."""
    root, bench = tiny_pbr
    spec = Spec(root, bench)
    w = spec.workload(CELL)
    cfg, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    out = spec.mix(traffic).readings(cfg, traffic, SEED, torch.device("cpu"))
    limits = _limits(bench)
    assert all(out["program"][n] <= limits[n] for n in limits), out["program"]
    faults = [k for k in out if k not in ("tf32", "program")]
    assert set(faults) == {"light_frozen", "skipped_face", "no_hemisphere", "geometry_drift"}
    for k in faults:
        assert any(out[k][n] > limits[n] for n in limits), (k, out[k])


def test_the_tf32_control_fails_on_the_card(cuda, tiny_pbr):
    root, bench = tiny_pbr
    spec = Spec(root, bench)
    w = spec.workload(CELL)
    cfg, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    out = spec.mix(traffic).readings(cfg, traffic, SEED, cuda)
    limits = _limits(bench)
    assert any(out["tf32"][n] > limits[n] for n in limits), out["tf32"]


def test_new_metrics_name_only_the_new_cell_and_read_nothing_without_the_counters():
    spec = Spec()
    by_name = {m["name"]: m for m in spec.doc["per_layer"]}
    for name in NEW_METRICS:
        assert by_name[name]["workloads"] == [CELL]
        assert spec.reader("layer_metrics", name)(Run(kind="train", seconds=1.0,
                                                      setup_s=0.0)) is None
    for name in SHARED_METRICS:
        assert by_name[name]["workloads"][-1] == CELL
    assert {m["name"] for m in spec.per_layer(CELL)} == {*NEW_METRICS, *SHARED_METRICS}
    assert CELL in next(m for m in spec.doc["end_to_end"]
                        if m["name"] == "train_it_per_s")["workloads"]
