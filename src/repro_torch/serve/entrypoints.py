"""The bucketed entrypoint cache: one step callable per (entrypoint,
bucket) key, with build counters that make "nothing is rebuilt in steady
state" a property a test can assert (the port of
``repro.serve.entrypoints``).

PyTorch runs eagerly, so an entrypoint here is the step callable the
session builds once per bucket key (the reference's jitted function, whose
traces it counts); :meth:`EntrypointCache.note_trace` counts each build.
The contract reads the same as the reference's: after warm-up, and across
``append()``, ``stats()["traces"]`` stops moving.  Capturing each step in a
CUDA graph is later work.

:func:`pow2_bucket` is the padding policy that makes keys recur: probe
batches are padded to power-of-two row counts, token widths, prefix
widths and candidate capacities.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, Hashable


def pow2_bucket(n: int, floor: int = 1) -> int:
    """Round ``n`` up to a power of two ``>= floor``."""
    return max(int(floor), 1 << max(int(n) - 1, 0).bit_length())


class EntrypointCache:
    """Bounded key -> entrypoint cache with hit, miss and build counters.

    ``get(key, builder)`` returns the cached entrypoint, calling ``builder``
    (no arguments) at most once per key; eviction is LRU.  A builder records
    each build with :meth:`note_trace`, so ``stats()["traces"]`` counts the
    entrypoints built (``== entries`` when nothing was evicted).
    """

    def __init__(self, maxsize: int = 256):
        self.maxsize = int(maxsize)
        self._lock = threading.RLock()
        self._data: "collections.OrderedDict" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.traces = 0
        self.trace_counts: Dict[Hashable, int] = {}

    def get(self, key: Hashable, builder: Callable[[], Callable]):
        with self._lock:
            if key in self._data:
                self.hits += 1
                self._data.move_to_end(key)
                return self._data[key]
            # Build under the (reentrant) lock: a builder only constructs
            # the step callable and records the build, so this is cheap and
            # deduplicates concurrent misses.
            self.misses += 1
            fn = builder()
            self._data[key] = fn
            while len(self._data) > self.maxsize:
                evicted, _ = self._data.popitem(last=False)
                self.trace_counts.pop(evicted, None)
            return fn

    def note_trace(self, key: Hashable) -> None:
        """Record one build of ``key``'s entrypoint."""
        with self._lock:
            self.traces += 1
            self.trace_counts[key] = self.trace_counts.get(key, 0) + 1

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._data), "hits": self.hits,
                    "misses": self.misses, "traces": self.traces,
                    "max_traces_per_key": max(self.trace_counts.values(),
                                              default=0)}

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self.trace_counts.clear()
            self.hits = self.misses = self.traces = 0
