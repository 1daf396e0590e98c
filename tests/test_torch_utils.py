"""The port's training observability helpers (mygauhuman_torch/utils/
{logging,profiling}.py) against the JAX package's: the same metrics.jsonl
records and EMA from the same metrics (values exact: float32 tensors
read back as Python floats on both sides), PhaseTimer's summary layout,
and a profiler trace that holds an annotated span."""
import json
import os

import jax.numpy as jnp
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mygauhuman_tpu.utils.logging import MetricLogger as JLogger
from mygauhuman_tpu.utils.profiling import PhaseTimer as JTimer
from mygauhuman_torch.utils.logging import MetricLogger
from mygauhuman_torch.utils.profiling import PhaseTimer, annotate

torch.set_num_threads(1)


def test_metric_logger_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    steps = [(1, {"loss": 0.5, "psnr": 20.0}), (100, {"loss": 0.25, "psnr": 23.5}),
             (200, {"loss": float(rng.rand()), "capacity": 16384})]
    loggers = {"jax": JLogger(str(tmp_path / "jax"), use_tensorboard=False),
               "port": MetricLogger(str(tmp_path / "port"), use_tensorboard=False)}
    for step, m in steps:
        loggers["jax"].log(step, {k: jnp.float32(v) for k, v in m.items()})
        loggers["port"].log(step, {k: torch.tensor(v, dtype=torch.float32)
                                   for k, v in m.items()})
        loggers["port"].log(step, {"n_gaussians": 400}, prefix="scene")
        loggers["jax"].log(step, {"n_gaussians": 400}, prefix="scene")
    assert loggers["port"].ema == loggers["jax"].ema
    for lg in loggers.values():
        lg.close()
    rows = {}
    for who in loggers:
        with open(tmp_path / who / "metrics.jsonl") as f:
            rows[who] = [json.loads(line) for line in f]
    for a, b in zip(rows["port"], rows["jax"]):
        a.pop("wall_s")
        b.pop("wall_s")
        assert a == b
    assert len(rows["port"]) == len(rows["jax"]) == 6


def test_phase_timer_summary_layout():
    timers = {"jax": JTimer(), "port": PhaseTimer()}
    for t in timers.values():
        for name in ("eval", "save", "eval"):
            with t.phase(name, sync_on=torch.zeros(2) if t is timers["port"] else None):
                pass
    summaries = {k: t.summary() for k, t in timers.items()}
    assert summaries["port"].keys() == summaries["jax"].keys() == {"eval", "save"}
    for name in ("eval", "save"):
        assert summaries["port"][name].keys() == summaries["jax"][name].keys()
        assert summaries["port"][name]["count"] == summaries["jax"][name]["count"]


def test_trace_records_annotated_span(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("eval_render"):
            torch.ones(8).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "eval_render" for e in events)
    assert os.path.getsize(path) > 0
