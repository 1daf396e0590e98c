"""Carry the JAX package's parameters and state into the port.

The inputs are numpy arrays (a JAX pytree converted with `np.asarray`, or
any object with the same attribute names); nothing here imports JAX or the
JAX package. A served checkpoint crosses over as a PLY instead
(`models/io.py::load_ply` reads the JAX package's `save_ply` output).
"""
from __future__ import annotations

import numpy as np
import torch

from mygauhuman_torch.device import DEFAULT_DEVICE, resolve_device
from mygauhuman_torch.models.gaussians import GaussianParams, GaussianState
from mygauhuman_torch.models.smpl import SMPLModel, model_from_arrays


def tensor_tree(tree, device: str | torch.device = DEFAULT_DEVICE):
    """Nested dicts / lists / tuples of arrays -> the same nesting of
    tensors (float arrays as float32, bool and int arrays kept)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tensor_tree(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tensor_tree(v, dev) for v in tree)
    a = np.array(tree)   # a writable copy (JAX hands out read-only views)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=dev)


def gaussian_state(state, device: str | torch.device = DEFAULT_DEVICE) -> GaussianState:
    """GaussianState from the JAX package's GaussianState (numpy leaves)."""
    dev = resolve_device(device)
    params = GaussianParams(**{
        f: tensor_tree(getattr(state.params, f), dev) for f in GaussianParams._fields})
    return GaussianState(
        params=params,
        **{f: tensor_tree(getattr(state, f), dev)
           for f in GaussianState._fields if f != "params"},
    )


def smpl_model(model, device: str | torch.device = DEFAULT_DEVICE) -> SMPLModel:
    """SMPLModel from the JAX package's SMPLModel (numpy leaves)."""
    arrays = {f: np.asarray(getattr(model, f))
              for f in ("v_template", "shapedirs", "posedirs", "j_regressor", "weights")}
    return model_from_arrays(arrays, np.asarray(model.parents),
                             np.asarray(model.faces), device)
