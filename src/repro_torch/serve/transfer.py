"""Pooled host-to-device transfers for the serving layer (the port of
``repro.serve.transfer``).

A long-lived session uploads the same padded bucket shapes thousands of
times.  :class:`TransferPool` keeps a ring of ``depth`` staging slots per
bucket key instead of allocating per batch:

* ``upload(key, arrays)`` copies the batch's numpy arrays into the next
  slot's host tensors and copies those to the device.  On a CUDA device the
  slots are pinned and the copies are issued with ``non_blocking=True``, so
  the upload of batch N+1 can overlap the step of batch N;
* a pinned slot must not be overwritten while its copy is still in flight,
  or a later batch would silently read the next batch's rows: each slot
  records a CUDA event after its copies, and the next ``upload`` into that
  slot waits on it first;
* counters (``slot_builds`` / ``uploads`` / ``staged_bytes``) make reuse
  assertable: once a bucket is warm ``slot_builds`` stops moving while
  ``uploads`` keeps counting.

On the CPU the "device" tensors are copies of the slot, so a later upload
never aliases an earlier batch.
"""

from __future__ import annotations

import threading
from typing import Dict, Hashable, List, Sequence

import numpy as np
import torch

from repro_torch.core.engine import resolve_device


class _Slot:
    __slots__ = ("host", "signature", "event")

    def __init__(self, arrays: Sequence[np.ndarray], pin: bool):
        self.host = [torch.empty(a.shape, dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype,
                                 pin_memory=pin) for a in arrays]
        self.signature = tuple((a.shape, a.dtype.str) for a in arrays)
        self.event = None   # recorded after the slot's last device copy


class TransferPool:
    """A ring of reusable host staging tensors per bucket key, copied to
    ``device`` (a ``torch.device`` or its name; ``None`` is the card, and
    raises without one) on every upload."""

    def __init__(self, depth: int = 3, device=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self.device = resolve_device(device)
        self._pin = self.device.type == "cuda"
        self._lock = threading.Lock()
        self._slots: Dict[Hashable, List[_Slot]] = {}
        self._next: Dict[Hashable, int] = {}
        self.slot_builds = 0
        self.uploads = 0
        self.staged_bytes = 0

    def _acquire(self, key: Hashable, arrays: Sequence[np.ndarray]) -> _Slot:
        signature = tuple((a.shape, a.dtype.str) for a in arrays)
        with self._lock:
            ring = self._slots.setdefault(key, [])
            # A key whose shapes changed drops its stale ring: the signature
            # is the bucket.
            if ring and ring[0].signature != signature:
                ring.clear()
                self._next[key] = 0
            if len(ring) < self.depth:
                slot = _Slot(arrays, self._pin)
                ring.append(slot)
                self.slot_builds += 1
                return slot
            i = self._next.get(key, 0)
            self._next[key] = (i + 1) % self.depth
            return ring[i]

    def upload(self, key: Hashable, arrays: Sequence[np.ndarray]) -> List[torch.Tensor]:
        """Stage ``arrays`` into a pooled slot and copy them to the device.

        Returns one device tensor per array.  On a CUDA device the copies
        run asynchronously on the current stream; callers pipeline by
        uploading batch N+1 before they block on batch N's outputs.
        """
        slot = self._acquire(key, arrays)
        if slot.event is not None:
            slot.event.synchronize()   # the slot's previous copy has finished
        for buf, a in zip(slot.host, arrays):
            buf.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        if self._pin:
            dev = [b.to(self.device, non_blocking=True) for b in slot.host]
            slot.event = torch.cuda.Event()
            slot.event.record()
        else:
            dev = [b.to(self.device, copy=True) for b in slot.host]
        with self._lock:
            self.uploads += 1
            self.staged_bytes += sum(b.numel() * b.element_size() for b in slot.host)
        return dev

    def stats(self) -> dict:
        with self._lock:
            return {"depth": self.depth,
                    "buckets": len(self._slots),
                    "slot_builds": self.slot_builds,
                    "uploads": self.uploads,
                    "staged_bytes": self.staged_bytes}
