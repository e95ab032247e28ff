"""Atomic, async-capable checkpointing, the port of
``repro.distributed.checkpoint``, with the reference's on-disk layout::

    <dir>/step_00000123/
        MANIFEST.json       # step, and each leaf's name, file, shape, dtype
        leaf_00000.npy ...  # one .npy per leaf

A leaf's name is its ``/``-joined path in the state (``step``,
``params/blocks/attn/wq``, ``opt/mu/...``), as the reference names the
leaves of its pytree, so each package restores the other's checkpoints.

* **Atomic commit**: a save writes ``step_X.tmp/`` and renames it into
  place; only directories holding a MANIFEST count.
* **Async save**: ``save_async`` copies the state to host memory at once
  and writes it in a background thread; ``wait()`` joins it and raises
  what the write raised.
* **Restore into a state**: ``restore(state_like)`` copies each leaf into
  the matching tensor of ``state_like`` (so a model's own parameters take
  the values) and returns it with the step.

Restoring onto a mesh (``shardings``) waits for multi-GPU (ROADMAP Queue 1
item 11).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.tree import leaves_with_paths


def named_leaves(tree) -> List[Tuple[str, object]]:
    """``[(name, leaf), ...]``: names the reference's ``/``-joined paths."""
    return [("/".join(path), leaf) for path, leaf in leaves_with_paths(tree)]


def _to_host(tree) -> List[Tuple[str, np.ndarray]]:
    return [(name, leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf))
            for name, leaf in named_leaves(tree)]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, state) -> str:
        return self._write(step, _to_host(state))

    def save_async(self, step: int, state) -> None:
        """Snapshot to host now, write in the background."""
        self.wait()
        host = _to_host(state)

        def write():
            try:
                self._write(step, host)
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _write(self, step: int, host: List[Tuple[str, np.ndarray]]) -> str:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest: Dict = {"step": step, "leaves": []}
        for i, (name, leaf) in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), leaf)
            manifest["leaves"].append({"name": name, "file": fname, "shape": list(leaf.shape),
                                       "dtype": str(leaf.dtype)})
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.directory, d, "MANIFEST.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, state_like, step: Optional[int] = None):
        """Copy checkpoint ``step`` (the latest when None) into the tensors of
        ``state_like``, leaf by leaf by name (values cast to each tensor's
        type); raises on a missing leaf or a shape mismatch.  Returns
        ``(state_like, step)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            files = {e["name"]: e for e in json.load(f)["leaves"]}
        for name, leaf in named_leaves(state_like):
            if name not in files:
                raise KeyError(f"checkpoint step {step} has no leaf {name!r}")
            arr = np.load(os.path.join(d, files[name]["file"]))
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {name}: {arr.shape} vs {tuple(leaf.shape)}")
            leaf.copy_(torch.from_numpy(np.array(arr)))
        return state_like, step
