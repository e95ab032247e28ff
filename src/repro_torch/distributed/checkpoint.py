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
* **Sharded (elastic)**: with ``shardings`` (a tree of
  ``distributed.sharding.NamedSharding`` matching the state, whose tensors
  are this rank's slices) a save still writes whole leaves in the same
  layout: rank 0 creates each ``.npy`` at its whole shape, and every rank
  that holds the first replica of a slice writes it through a memmap; a
  restore memmaps each leaf and reads only this rank's slice, so the
  saving and the restoring meshes may differ in shape and size, and each
  package restores the other's checkpoints.  Every rank of the mesh calls
  the sharded ``save`` / ``save_async`` / ``wait`` / ``restore`` together;
  the directory must be one that every rank sees.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.train.tree import leaves_with_paths

# How long rank 0 waits for the other ranks' slices of a sharded save.
SHARDED_SAVE_TIMEOUT = 600.0


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
        self._sharded_pending = False

    # ------------------------------------------------------------------
    def save(self, step: int, state, shardings=None) -> str:
        if shardings is None:
            return self._write(step, _to_host(state))
        path = self._write_slices(self._begin_sharded(step, state, shardings))
        dist.barrier()        # every rank sees the commit
        return path

    def save_async(self, step: int, state, shardings=None) -> None:
        """Snapshot to host now, write in the background (a sharded save
        creates its files first, with every rank, then writes its slices in
        the background; :meth:`wait` joins them all)."""
        self.wait()
        if shardings is None:
            host = _to_host(state)
            target, args = self._write, (step, host)
        else:
            target, args = self._write_slices, (self._begin_sharded(step, state, shardings),)
            self._sharded_pending = True

        def write():
            try:
                target(*args)
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded_pending:   # rank 0 commits after every rank's slices
            self._sharded_pending = False
            dist.barrier()
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _begin_sharded(self, step: int, state, shardings) -> dict:
        """The synchronous part of a sharded save: this rank's slices copied
        to the host, rank 0's empty ``.npy`` files at the leaves' whole
        shapes, and a barrier so that every file exists before any slice is
        written."""
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        shards = dict(named_leaves(shardings))
        leaves, manifest = [], {"step": step, "leaves": []}
        for i, (name, leaf) in enumerate(named_leaves(state)):
            sh = shards[name]
            shape = sh.global_shape(tuple(leaf.shape))
            fname = f"leaf_{i:05d}.npy"
            dtype = torch.empty(0, dtype=leaf.dtype).numpy().dtype
            manifest["leaves"].append({"name": name, "file": fname, "shape": list(shape),
                                       "dtype": str(dtype)})
            if sh.writes():   # the first replica of each slice copies it to the host
                leaves.append((fname, sh.slices(shape), leaf.detach().cpu().numpy()))
        if dist.get_rank() == 0:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for entry in manifest["leaves"]:
                np.lib.format.open_memmap(os.path.join(tmp, entry["file"]), mode="w+",
                                          dtype=np.dtype(entry["dtype"]),
                                          shape=tuple(entry["shape"])).flush()
        dist.barrier()
        return {"tmp": tmp, "final": final, "leaves": leaves, "manifest": manifest,
                "rank": dist.get_rank(), "world": dist.get_world_size()}

    def _write_slices(self, job: dict) -> str:
        """Write this rank's slices into the files, mark it done; rank 0 waits
        for every rank's mark, then writes the MANIFEST and commits."""
        tmp = job["tmp"]
        for fname, slices, host in job["leaves"]:
            mm = np.load(os.path.join(tmp, fname), mmap_mode="r+")
            mm[slices] = host
            mm.flush()
            del mm
        open(os.path.join(tmp, f"done_{job['rank']:05d}"), "w").close()
        if job["rank"] != 0:
            return job["final"]
        deadline = time.monotonic() + SHARDED_SAVE_TIMEOUT
        while not all(os.path.exists(os.path.join(tmp, f"done_{r:05d}"))
                      for r in range(job["world"])):
            if time.monotonic() > deadline:
                raise TimeoutError(f"sharded save {tmp}: not every rank wrote its slices in "
                                   f"{SHARDED_SAVE_TIMEOUT} s")
            time.sleep(0.01)
        for r in range(job["world"]):
            os.remove(os.path.join(tmp, f"done_{r:05d}"))
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(job["manifest"], f)
        if os.path.exists(job["final"]):
            shutil.rmtree(job["final"])
        os.rename(tmp, job["final"])
        self._gc()
        return job["final"]

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
    def restore(self, state_like, shardings=None, step: Optional[int] = None):
        """Copy checkpoint ``step`` (the latest when None) into the tensors of
        ``state_like``, leaf by leaf by name (values cast to each tensor's
        type); raises on a missing leaf or a shape mismatch.  With
        ``shardings`` (a matching tree of ``NamedSharding``, on any mesh) the
        tensors are this rank's slices: each leaf is memmapped and only the
        slice is read.  Returns ``(state_like, step)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            files = {e["name"]: e for e in json.load(f)["leaves"]}
        shards = dict(named_leaves(shardings)) if shardings is not None else {}
        for name, leaf in named_leaves(state_like):
            if name not in files:
                raise KeyError(f"checkpoint step {step} has no leaf {name!r}")
            arr = np.load(os.path.join(d, files[name]["file"]), mmap_mode="r")
            sh = shards.get(name)
            want = tuple(sh.local_shape(arr.shape)) if sh is not None else tuple(arr.shape)
            if want != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {name}: {arr.shape} "
                                 f"({'this rank: ' + str(want) if sh is not None else 'whole'})"
                                 f" vs {tuple(leaf.shape)}")
            part = arr[sh.slices(arr.shape)] if sh is not None else arr
            leaf.copy_(torch.from_numpy(np.array(part)))
        return state_like, step
