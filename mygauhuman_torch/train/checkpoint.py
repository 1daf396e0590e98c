"""Checkpoint / resume and the eval replay cache (port of
train/checkpoint.py).

The layout on disk is the JAX package's: `<dir>/chkpnt<step>/` per
snapshot, `<dir>/cfg_args.json` beside them, `smpl_rot_<it>.npz` replay
caches. So `latest_step` and `--start_checkpoint <dir>/chkpnt<step>` read
the same. Inside a snapshot directory the port writes one `torch.save`
file, `state.pt`, where the JAX package writes orbax files; neither
package reads the other's snapshot (the port refuses an orbax directory
with an error that says so). The replay cache is numpy npz in both, so
each reads the other's.

`state.pt` holds a flat {path: tensor} dict (CPU tensors) and a JSON
description of the tree: its NamedTuple, dict, list and tuple nodes, and
the host ints and floats (the step, the Adam counts). No Python object is
pickled, so it loads with `weights_only=True`.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from mygauhuman_torch.config import Config

STATE_FILE = "state.pt"
#: files an orbax snapshot directory holds (the JAX package's format)
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt", "_sharding")


def _snapshot_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"chkpnt{step}")


def _flatten(tree, path: str, tensors: dict):
    """The tree's JSON description; its tensors go into `tensors` by path."""
    if isinstance(tree, torch.Tensor):
        tensors[path] = tree.detach().cpu().contiguous()
        return {"tensor": path}
    if hasattr(tree, "_fields"):
        return {"fields": {f: _flatten(getattr(tree, f), f"{path}/{f}", tensors)
                           for f in tree._fields}}
    if isinstance(tree, dict):
        return {"dict": {str(k): _flatten(v, f"{path}/{k}", tensors) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"list": [_flatten(v, f"{path}/{i}", tensors) for i, v in enumerate(tree)]}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"value": tree}
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} at {path or '/'}")


def _unflatten(spec: dict, tensors: dict):
    """Raw tree: NamedTuples as {field: value} dicts, sequences as lists."""
    if "tensor" in spec:
        return tensors[spec["tensor"]]
    if "fields" in spec:
        return {k: _unflatten(v, tensors) for k, v in spec["fields"].items()}
    if "dict" in spec:
        return {k: _unflatten(v, tensors) for k, v in spec["dict"].items()}
    if "list" in spec:
        return [_unflatten(v, tensors) for v in spec["list"]]
    return spec["value"]


def save_checkpoint(ckpt_dir: str, step: int, state: Any,
                    config: Config | None = None) -> str:
    """Snapshot a tree of NamedTuples, dicts, lists, tensors and host
    numbers (a TrainState) to `<ckpt_dir>/chkpnt<step>/state.pt`."""
    path = _snapshot_dir(ckpt_dir, step)
    os.makedirs(path, exist_ok=True)
    tensors: dict = {}
    tree = _flatten(state, "", tensors)
    tmp = os.path.join(path, f".{STATE_FILE}.{os.getpid()}")
    torch.save({"tree": json.dumps(tree), "tensors": tensors}, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if config is not None:
        config.save(os.path.join(os.path.abspath(ckpt_dir), "cfg_args.json"))
    return path


def _device_of(tree) -> torch.device:
    if isinstance(tree, torch.Tensor):
        return tree.device
    children = (tree.values() if isinstance(tree, dict)
                else tree if isinstance(tree, (list, tuple)) else ())
    for child in children:
        dev = _device_of(child)
        if dev is not None:
            return dev
    return None


def _load_raw(ckpt_dir: str, step: int, device: torch.device | None):
    path = _snapshot_dir(ckpt_dir, step)
    file = os.path.join(path, STATE_FILE)
    if not os.path.exists(file):
        if os.path.isdir(path) and any(os.path.exists(os.path.join(path, m))
                                       for m in ORBAX_MARKERS):
            raise ValueError(
                f"{path} is an orbax snapshot (the JAX package's format); the port "
                f"reads only its own torch.save snapshots ({STATE_FILE})")
        raise FileNotFoundError(f"no checkpoint at {file}")
    data = torch.load(file, map_location=device or "cpu", weights_only=True)
    return _unflatten(json.loads(data["tree"]), data["tensors"])


def _rebuild(ex, raw, exact: bool, path: str = ""):
    """`ex`'s structure with the checkpoint's values, matched by field name."""
    if hasattr(ex, "_fields"):
        return type(ex)(*(_rebuild(getattr(ex, f), raw[f], exact, f"{path}/{f}")
                          for f in ex._fields))
    if isinstance(ex, dict):
        return {k: _rebuild(v, raw[str(k)], exact, f"{path}/{k}") for k, v in ex.items()}
    if isinstance(ex, (list, tuple)):
        if len(ex) != len(raw):
            raise ValueError(f"checkpoint {path}: {len(raw)} entries, expected {len(ex)}")
        return type(ex)(_rebuild(e, r, exact, f"{path}/{i}")
                        for i, (e, r) in enumerate(zip(ex, raw)))
    if raw is None:
        return ex
    if exact and isinstance(ex, torch.Tensor) and (raw.shape != ex.shape
                                                  or raw.dtype != ex.dtype):
        raise ValueError(f"checkpoint {path}: {tuple(raw.shape)} {raw.dtype}, expected "
                         f"{tuple(ex.shape)} {ex.dtype}")
    return raw


def load_checkpoint(ckpt_dir: str, step: int, target: Any) -> Any:
    """Restore into the structure of `target` (a freshly built state):
    every tensor's shape and dtype must equal the target's. Tensors land on
    the target's device."""
    return _rebuild(target, _load_raw(ckpt_dir, step, _device_of(target)), exact=True)


def restore_checkpoint_like(ckpt_dir: str, step: int, example: Any) -> Any:
    """Restore into `example`'s STRUCTURE with the checkpoint's VALUES
    (shapes may differ, e.g. a capacity grown mid-training): the
    `--start_checkpoint` path (reference train.py:136-138). Tensors land on
    the example's device."""
    return _rebuild(example, _load_raw(ckpt_dir, step, _device_of(example)), exact=False)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("chkpnt"):
            try:
                steps.append(int(name[len("chkpnt"):]))
            except ValueError:
                pass
    return max(steps) if steps else None


# ----------------------------------------------------------------------------
# Eval replay cache (smpl_rot.pickle parity, train.py:548-552)
# ----------------------------------------------------------------------------

EVAL_CACHE_VERSION = 2  # v2: keys are pose ids (never batch indices)


def save_eval_cache(path: str, cache: dict) -> None:
    """cache: {pose_id: {"transforms": [cap,3,3], "translation": [cap,3]}}"""
    flat = {"__version__": np.int32(EVAL_CACHE_VERSION)}
    for pose_id, d in cache.items():
        flat[f"{pose_id}_transforms"] = np.asarray(d["transforms"])
        flat[f"{pose_id}_translation"] = np.asarray(d["translation"])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_eval_cache(path: str) -> dict:
    """Returns {pose_id: rows}. Versioned: round-1-era caches (no
    `__version__` field) were keyed by batch *index*, a silent
    wrong-transform hazard when an index collides with a real pose id —
    they are rejected with a re-run instruction instead of misread."""
    data = np.load(path)
    if "__version__" not in data.files:
        raise ValueError(
            f"{path} is an unversioned (round-1-era, index-keyed) replay "
            "cache; re-run training to regenerate a pose-keyed cache")
    cache: dict = {}
    for key in data.files:
        if key == "__version__":
            continue
        pose_id, kind = key.rsplit("_", 1)
        cache.setdefault(pose_id, {})[kind] = data[key]
    return cache
