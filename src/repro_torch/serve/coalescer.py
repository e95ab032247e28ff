"""The request coalescer: a FIFO queue that merges incoming probe requests
into batches under a max-batch / max-wait policy (the port of
``repro.serve.coalescer``).

Requests are :class:`~repro_torch.core.collection.Collection` batches of
any size (often single sets).  ``submit`` enqueues and returns a
:class:`ProbeTicket`; ``drain`` groups the queue FIFO into merged batches of
at most ``max_batch`` rows.  The session runs each group as one padded
device batch and scatters per-request pairs and ``JoinStats`` back onto the
tickets, identical to probing each request alone through
``JoinEngine.probe``.

* ``max_batch`` — a group never exceeds this many probe rows (the session
  clamps it to the plan's chunk size, so a solo probe of any coalescable
  request is one chunk, which is what makes per-request stats
  recoverable).  A request larger than ``max_batch`` becomes its own group
  and is routed to the sequential path.
* ``max_wait`` — ``due(now)`` turns true once the oldest queued ticket has
  waited this long, or a full batch is queued; ``JoinSession.poll``
  flushes on it.  ``max_wait=0`` flushes on every submit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.core.collection import Collection


@dataclasses.dataclass
class ProbeTicket:
    """One submitted probe request and, after its flush, the result."""

    request: Collection
    seq: int
    submitted_at: float
    pairs: Optional[np.ndarray] = None   # int64[K, 2] (corpus, request-local)
    stats: Optional[object] = None       # JoinStats, equal to a solo probe's
    done: bool = False
    completed_at: Optional[float] = None
    route: str = ""                      # "coalesced" | "sequential"

    @property
    def rows(self) -> int:
        return self.request.num_sets

    @property
    def latency_s(self) -> Optional[float]:
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at

    def result(self):
        if not self.done:
            raise RuntimeError("probe not flushed yet; call session.flush()")
        return self.pairs, self.stats


class RequestCoalescer:
    """FIFO queue and grouping policy (no device work happens here)."""

    def __init__(self, max_batch: int = 512, max_wait: float = 0.002):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {max_wait}")
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait)
        self._queue: List[ProbeTicket] = []
        self._seq = 0
        self.submitted = 0
        self.drained_groups = 0

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def pending_rows(self) -> int:
        return sum(t.rows for t in self._queue)

    def submit(self, request: Collection, *,
               now: Optional[float] = None) -> ProbeTicket:
        ticket = ProbeTicket(request=request, seq=self._seq,
                             submitted_at=time.perf_counter()
                             if now is None else now)
        self._seq += 1
        self.submitted += 1
        self._queue.append(ticket)
        return ticket

    def due(self, now: Optional[float] = None) -> bool:
        """Whether the queue should flush: a full batch is waiting, or the
        oldest ticket has waited ``max_wait``."""
        if not self._queue:
            return False
        if self.pending_rows >= self.max_batch:
            return True
        now = time.perf_counter() if now is None else now
        return (now - self._queue[0].submitted_at) >= self.max_wait

    def drain(self) -> List[List[ProbeTicket]]:
        """Group the whole queue FIFO into merged batches.

        Greedy first fit in arrival order: a group closes when the next
        request would push it past ``max_batch`` rows.  Oversized requests
        form groups of their own.  Order is kept: request k never completes
        after request k+1's group within one flush.
        """
        groups: List[List[ProbeTicket]] = []
        current: List[ProbeTicket] = []
        rows = 0
        for t in self._queue:
            if current and rows + t.rows > self.max_batch:
                groups.append(current)
                current, rows = [], 0
            current.append(t)
            rows += t.rows
            if rows >= self.max_batch:
                groups.append(current)
                current, rows = [], 0
        if current:
            groups.append(current)
        self._queue = []
        self.drained_groups += len(groups)
        return groups
