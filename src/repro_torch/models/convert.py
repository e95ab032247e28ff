"""Carry the reference's parameters and train state into the port.

:func:`params_from_numpy` takes the JAX package's parameter pytree
(``repro.models.Model(cfg).init(key)``) as nested dicts of numpy arrays,
leaves stacked per layer along axis 0, and copies it leaf for leaf into a
port ``Model`` of the same config, so both packages compute the same thing.
:func:`state_from_numpy` does the same for a whole train state
(``repro.train.init_state``: step, parameters, optimizer moments).
:func:`shards_from_numpy` takes the parameter tree straight to one rank's
slices on a mesh (``param_specs``), never building the whole tree as
tensors.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.distributed.sharding import layout_of
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, dtype_of, param_specs
from repro_torch.train.step import init_state
from repro_torch.train.tree import leaves_with_paths, tree_map


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


def state_from_numpy(model: Model, opt_cfg, tree: Mapping) -> dict:
    """The port's train state (``repro_torch.train.step.init_state``) over
    ``model`` holding the reference's train state ``tree`` (``{"step",
    "params", "opt"}`` as nested dicts of numpy arrays): the parameters
    copied into the model, the step and every optimizer moment into the
    state's tensors.  Raises on a missing, extra or misshapen leaf."""
    params_from_numpy(model, tree["params"])
    state = init_state(model, opt_cfg)
    want = dict(leaves_with_paths({"step": tree["step"], "opt": tree["opt"]}))
    have = dict(leaves_with_paths({"step": state["step"], "opt": state["opt"]}))
    if set(want) != set(have):
        raise KeyError(f"train states differ: missing {sorted(set(have) - set(want))}, "
                       f"extra {sorted(set(want) - set(have))}")
    with torch.no_grad():
        for path, t in have.items():
            a = np.asarray(want[path])
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{'/'.join(path)}: shape {a.shape} != {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(a)))
    return state


def _to_dict(tree):
    return {k: _to_dict(v) for k, v in tree.items()} if isinstance(tree, Mapping) else tree


def shards_from_numpy(cfg: ModelConfig, tree: Mapping, mesh, *, device,
                      fsdp=("pod", "data"), tp="model") -> dict:
    """This rank's slices of the reference's parameter tree ``tree`` (nested
    dicts of numpy arrays) on ``mesh`` under ``param_specs``, as tensors in
    ``param_dtype`` on ``device`` requiring grad, the tree a sharded train
    state holds.  Raises on a missing or extra leaf."""
    layout = layout_of(mesh)
    specs = param_specs(cfg, mesh, fsdp=fsdp, tp=tp)
    tree = _to_dict(tree)
    want = {path for path, _ in leaves_with_paths(specs)}
    have = {path for path, _ in leaves_with_paths(tree)}
    if want != have:
        raise KeyError(f"trees differ: missing {sorted(want - have)}, extra {sorted(have - want)}")

    def cut(a, spec):
        a = np.asarray(a)
        part = np.array(a[layout.slices(a.shape, spec)], dtype=np.float32)
        return torch.from_numpy(part).to(device=device, dtype=dtype_of(cfg.param_dtype)
                                         ).requires_grad_(True)

    return tree_map(cut, tree, specs)
