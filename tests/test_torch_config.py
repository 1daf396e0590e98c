"""The port's Config (mygauhuman_torch/config.py) against the JAX
package's: the same fields and defaults (less the TPU-only
`pipeline.use_pallas`), and `cfg_args.json` round trips both ways, field
for field, exact."""
import dataclasses
import json

import pytest

from mygauhuman_tpu import config as J
from mygauhuman_torch import config as T
from mygauhuman_torch import interop

GROUPS = {"model": (J.ModelConfig, T.ModelConfig),
          "pipeline": (J.PipelineConfig, T.PipelineConfig),
          "optim": (J.OptimizationConfig, T.OptimizationConfig)}


def _changed(cls, seed):
    """Every field of `cls` moved off its default (bool flipped, numbers
    changed, strings set)."""
    out = {}
    for i, f in enumerate(dataclasses.fields(cls)):
        v = f.default
        if isinstance(v, bool):
            out[f.name] = not v
        elif isinstance(v, int):
            out[f.name] = v + 7 * seed + i
        elif isinstance(v, float):
            out[f.name] = v * 1.5 + 0.25 * seed + i
        else:
            out[f.name] = f"{f.name}-{seed}"
    return out


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_fields_and_defaults_match_jax(group):
    jcls, tcls = GROUPS[group]
    jdef, tdef = _fields(jcls()), _fields(tcls())
    dropped = set(T.TPU_ONLY_KEYS.get(group, ()))
    assert set(jdef) - dropped == set(tdef)
    assert {k: jdef[k] for k in tdef} == tdef


def test_jax_cfg_args_loads_in_port(tmp_path):
    jcfg = J.Config(**{g: jcls(**_changed(jcls, 1)) for g, (jcls, _) in GROUPS.items()})
    path = str(tmp_path / "cfg_args.json")
    jcfg.save(path)
    got = T.Config.load(path)
    for g in GROUPS:
        tg, jg = _fields(getattr(got, g)), _fields(getattr(jcfg, g))
        assert tg == {k: jg[k] for k in tg}, g
    assert got == interop.config(jcfg)


def test_port_cfg_args_loads_in_jax(tmp_path):
    tcfg = T.Config(**{g: tcls(**_changed(tcls, 2)) for g, (_, tcls) in GROUPS.items()})
    path = str(tmp_path / "cfg_args.json")
    tcfg.save(path)
    got = J.Config.load(path)
    for g in GROUPS:
        jg, tg = _fields(getattr(got, g)), _fields(getattr(tcfg, g))
        assert {k: jg[k] for k in tg} == tg, g
    assert got.pipeline.use_pallas is J.PipelineConfig().use_pallas
    # and back through the port: the same object
    assert T.Config.from_json(got.to_json()) == tcfg
    assert json.loads(T.Config.from_json(tcfg.to_json()).to_json()) == json.loads(tcfg.to_json())
