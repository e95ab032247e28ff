"""Fault tolerance and straggler monitoring, the port of
``repro.distributed.fault``.

:class:`FaultTolerantRunner` drives ``step_fn(state, batch) -> (state,
metrics)``.  A step that raises counts as a failure: the runner rebuilds the
state with ``make_state(None)``, restores the latest complete checkpoint into
it and resumes from that step, up to ``max_restarts`` times.  Each step's
wall time is held against the median of the last ``straggler_window``; one
slower than ``straggler_factor`` times that median is logged as a
straggler.  Recovery is restore + rerun: what must survive is the checkpoint
(and the loader's cursor).  With ``remesh`` (the reference's elastic path)
the state is rebuilt on the mesh ``remesh()`` returns, at start and after
every failure, and the checkpoint layer reshards on read.  A failed
collective (``torch.distributed.DistError``) is not a step failure: it is
raised at once, since the ranks can no longer agree on a restore.
"""

from __future__ import annotations

import dataclasses
import logging
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

import torch.distributed as dist

from repro_torch.distributed.checkpoint import CheckpointManager

log = logging.getLogger(__name__)


@dataclasses.dataclass
class FaultEvent:
    step: int
    kind: str           # "failure" | "straggler" | "restore"
    detail: str = ""


@dataclasses.dataclass
class RunnerConfig:
    checkpoint_every: int = 50
    async_checkpoint: bool = True
    max_restarts: int = 10
    straggler_factor: float = 3.0
    straggler_window: int = 16


class FaultTolerantRunner:
    """Drives ``step_fn(state, batch) -> (state, metrics)`` with recovery.

    ``make_state(mesh) -> (state, shardings)`` builds the state: ``mesh`` is
    ``remesh()``'s (None without ``remesh``), ``shardings`` None for a whole
    state or a tree of ``NamedSharding`` for one rank's slices (checkpoints
    are then saved and restored sharded).  It is called at start and after
    every failure, and the latest checkpoint is restored into it.  In a
    multi-rank run every rank drives its runner in step, and a failure is
    one that every rank sees."""

    def __init__(self, step_fn: Callable, make_state: Callable, batch_iter,
                 ckpt: CheckpointManager, cfg: RunnerConfig = RunnerConfig(),
                 remesh: Optional[Callable[[], Any]] = None):
        self.step_fn = step_fn
        self.make_state = make_state
        self.batch_iter = batch_iter
        self.ckpt = ckpt
        self.cfg = cfg
        self.remesh = remesh
        self.shardings = None
        self.events: List[FaultEvent] = []
        self.step_times: List[float] = []

    def _check_straggler(self, step: int, dt: float) -> None:
        w = self.step_times[-self.cfg.straggler_window:]
        if len(w) >= 4:
            med = statistics.median(w)
            if dt > self.cfg.straggler_factor * med:
                self.events.append(FaultEvent(step, "straggler",
                                              f"{dt:.3f}s vs median {med:.3f}s"))
                log.warning("straggler at step %d: %.3fs (median %.3fs)", step, dt, med)
        self.step_times.append(dt)

    def run(self, num_steps: int) -> Dict[str, Any]:
        restarts = 0
        state, self.shardings = self.make_state(self.remesh() if self.remesh else None)
        # Resume from the latest checkpoint if one exists.
        if self.ckpt.latest_step() is not None:
            state, at = self.ckpt.restore(state, self.shardings)
            self.events.append(FaultEvent(at, "restore", "startup resume"))

        step = int(state["step"])
        while step < num_steps:
            batch = next(self.batch_iter)
            t0 = time.monotonic()
            try:
                state, metrics = self.step_fn(state, batch)
            except Exception as e:  # noqa: BLE001 — any device loss surfaces here
                if isinstance(e, dist.DistError):
                    raise
                restarts += 1
                self.events.append(FaultEvent(step, "failure", repr(e)))
                if restarts > self.cfg.max_restarts:
                    raise
                log.warning("step %d failed (%s); restoring", step, e)
                self.ckpt.wait()
                state, self.shardings = self.make_state(self.remesh() if self.remesh else None)
                state, at = self.ckpt.restore(state, self.shardings)
                self.events.append(FaultEvent(at, "restore", f"after failure at {step}"))
                step = at
                continue
            self._check_straggler(step, time.monotonic() - t0)
            step += 1
            if step % self.cfg.checkpoint_every == 0:
                if self.cfg.async_checkpoint:
                    self.ckpt.save_async(step, state, self.shardings)
                else:
                    self.ckpt.save(step, state, self.shardings)
        self.ckpt.wait()
        self.ckpt.save(step, state, self.shardings)
        return {"state": state, "events": self.events, "restarts": restarts}
