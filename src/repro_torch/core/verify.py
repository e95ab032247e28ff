"""Exact verification of candidate pairs.

Device path: batched, branch-free intersection over the padded sorted token
layout — one batched ``torch.searchsorted`` over ``(K, L)`` rows, a clip and
a gather.  Host path: numpy verification with the early-termination bound
of [13] (the CPU algorithms' verifier).
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from repro_torch.core import bounds
from repro_torch.core.constants import PAD_TOKEN


# ---------------------------------------------------------------------------
# Device (torch) path
# ---------------------------------------------------------------------------

def pairwise_overlap(tok_r: torch.Tensor, tok_s: torch.Tensor) -> torch.Tensor:
    """int32[K]: overlap of each sorted, PAD-padded row pair
    ``tok_r[k]`` (int32[K, Lr]) and ``tok_s[k]`` (int32[K, Ls])."""
    idx = torch.searchsorted(tok_s.contiguous(), tok_r.contiguous())
    idx = idx.clamp_(0, tok_s.shape[1] - 1)
    hit = (torch.gather(tok_s, 1, idx) == tok_r) & (tok_r != PAD_TOKEN)
    return hit.sum(1, dtype=torch.int32)


def overlap_many(tokens: torch.Tensor, idx_r: torch.Tensor, idx_s: torch.Tensor) -> torch.Tensor:
    """Exact overlaps for candidate pairs (idx_r[i], idx_s[i]) of one collection."""
    return pairwise_overlap(tokens[idx_r], tokens[idx_s])


class _DeviceTableCache:
    """Bounded LRU of device-resident int32 threshold tables, keyed by
    ``(kind, sim, tau, lmax_r, lmax_s, device)`` and safe under concurrent
    callers (a table is built outside the lock; a concurrent miss on the
    same key costs one duplicate upload at worst).  Hits and misses are
    counted per kind; the serving session reports the min-overlap ones."""

    _BUILDERS = {"min_overlap": bounds.min_overlap_table,
                 "prune": bounds.prune_table}

    def __init__(self, maxsize: int = 64):
        self.maxsize = maxsize
        self._lock = threading.Lock()
        self._data: "collections.OrderedDict" = collections.OrderedDict()
        self.hits: collections.Counter = collections.Counter()
        self.misses: collections.Counter = collections.Counter()

    def get(self, kind: str, sim: str, tau: float, lmax_r: int, lmax_s: int,
            device) -> torch.Tensor:
        device = torch.device(device)
        key = (kind, sim, float(tau), int(lmax_r), int(lmax_s), str(device))
        with self._lock:
            if key in self._data:
                self.hits[kind] += 1
                self._data.move_to_end(key)
                return self._data[key]
            self.misses[kind] += 1
        host = self._BUILDERS[kind](sim, float(tau), int(lmax_r), int(lmax_s))
        table = torch.from_numpy(host).to(device)
        with self._lock:
            if key not in self._data:
                self._data[key] = table
                while len(self._data) > self.maxsize:
                    self._data.popitem(last=False)
            return self._data[key]

    def stats(self, kind: str) -> dict:
        with self._lock:
            return {"hits": self.hits[kind], "misses": self.misses[kind],
                    "entries": sum(k[0] == kind for k in self._data),
                    "maxsize": self.maxsize}

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self.hits.clear()
            self.misses.clear()


_TABLE_CACHE = _DeviceTableCache(maxsize=64)


def min_overlap_table_dev(sim: str, tau: float, lmax_r: int, lmax_s: int,
                          device) -> torch.Tensor:
    """``bounds.min_overlap_table`` on ``device``, cached (bounded LRU), so
    repeated verification calls do not re-upload the same table."""
    return _TABLE_CACHE.get("min_overlap", sim, tau, lmax_r, lmax_s, device)


def min_overlap_cache_stats() -> dict:
    """Hit, miss and entry counters of the min-overlap tables in the device
    table cache (reported by ``repro_torch.serve.JoinSession.stats_summary``)."""
    return _TABLE_CACHE.stats("min_overlap")


def prune_table_dev(sim: str, tau: float, lmax_r: int, lmax_s: int,
                    device) -> torch.Tensor:
    """``bounds.prune_table`` on ``device``, cached like
    :func:`min_overlap_table_dev` (the verdict kernels' threshold table)."""
    return _TABLE_CACHE.get("prune", sim, tau, lmax_r, lmax_s, device)


def verify_pairs(tokens: torch.Tensor, lengths: torch.Tensor, idx_r: torch.Tensor,
                 idx_s: torch.Tensor, sim: str, tau: float) -> torch.Tensor:
    """bool[K] — whether each candidate pair of one collection is truly
    similar.  Acceptance compares the exact integer overlap against the
    integer :func:`bounds.min_overlap_table`, so it agrees with the float64
    oracle bit for bit."""
    lmax = int(tokens.shape[1])
    tab = min_overlap_table_dev(sim, tau, lmax, lmax, tokens.device)
    o = overlap_many(tokens, idx_r, idx_s)
    return o >= bounds.min_overlap_gather(sim, tab, lengths[idx_r], lengths[idx_s])


def verify_pairs_rs(tokens_r: torch.Tensor, lengths_r: torch.Tensor,
                    tokens_s: torch.Tensor, lengths_s: torch.Tensor,
                    idx_r: torch.Tensor, idx_s: torch.Tensor,
                    sim: str, tau: float) -> torch.Tensor:
    """R×S variant of :func:`verify_pairs` (same integer-exact acceptance)."""
    tab = min_overlap_table_dev(sim, tau, int(tokens_r.shape[1]),
                                int(tokens_s.shape[1]), tokens_r.device)
    o = pairwise_overlap(tokens_r[idx_r], tokens_s[idx_s])
    return o >= bounds.min_overlap_gather(sim, tab, lengths_r[idx_r], lengths_s[idx_s])


# ---------------------------------------------------------------------------
# Host (numpy) path — early-termination merge of [13]
# ---------------------------------------------------------------------------

def overlap_early_terminate(r: np.ndarray, s: np.ndarray, required: float) -> int:
    """Sorted-merge overlap with the early-termination condition of [13].

    Stops as soon as the remaining elements cannot reach ``required`` overlap.
    Returns the exact overlap if it is >= required, otherwise a value < required
    (possibly a partial count — callers only compare against ``required``).
    """
    i = j = o = 0
    lr, ls = len(r), len(s)
    while i < lr and j < ls:
        if o + min(lr - i, ls - j) < required:
            return o
        ri, sj = r[i], s[j]
        if ri == sj:
            o += 1
            i += 1
            j += 1
        elif ri < sj:
            i += 1
        else:
            j += 1
    return o


def overlap_numpy(r: np.ndarray, s: np.ndarray) -> int:
    """Vectorised exact overlap (no early termination)."""
    idx = np.searchsorted(s, r)
    idx = np.clip(idx, 0, len(s) - 1)
    return int(np.sum(s[idx] == r)) if len(s) else 0
