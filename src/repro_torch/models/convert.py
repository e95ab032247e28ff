"""Carry the reference's parameters into the port's :class:`Model`.

:func:`params_from_numpy` takes the JAX package's parameter pytree
(``repro.models.Model(cfg).init(key)``) as nested dicts of numpy arrays,
leaves stacked per layer along axis 0, and copies it leaf for leaf into a
port ``Model`` of the same config, so both packages compute the same thing.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.models.model import Model


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


def params_from_numpy(model: Model, tree: Mapping) -> Model:
    """Copy ``tree`` into ``model``'s parameters (same names, shapes; values
    cast to ``param_dtype``).  Raises on a missing, extra or misshapen leaf.
    Returns the model."""
    leaves = _flatten(tree)
    params = dict(model.named_parameters())
    if set(leaves) != set(params):
        raise KeyError(f"parameter trees differ: missing {sorted(set(params) - set(leaves))}, "
                       f"extra {sorted(set(leaves) - set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            a = np.asarray(leaves[name])
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {a.shape} != {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))
    return model
