"""Padded, device-friendly representation of a collection of token sets.

A collection ``R = {r_1, ..., r_N}`` of sets of integer tokens is stored as a
dense, padded ``tokens`` matrix plus a ``lengths`` vector.  Tokens inside each
row are sorted ascending; padding uses ``PAD_TOKEN`` (int32 max) so that sorted
rows keep padding at the end, which makes merge/searchsorted-based exact
verification branch-free.

The paper's preprocessing (Section 5) is reproduced by :func:`preprocess`:
tokens are re-labelled by ascending global frequency (which maximises prefix
filter selectivity) and sets are ordered by size, ties broken lexicographically.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence

import numpy as np

from repro_torch.core.constants import PAD_TOKEN


@dataclasses.dataclass
class Collection:
    """A padded collection of token sets.

    Attributes:
      tokens: int32[N, L] — row-sorted tokens, padded with ``PAD_TOKEN``.
      lengths: int32[N] — true set sizes.
    """

    tokens: np.ndarray
    lengths: np.ndarray

    @property
    def num_sets(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def max_len(self) -> int:
        return int(self.tokens.shape[1])

    def __len__(self) -> int:
        return self.num_sets

    def row(self, i: int) -> np.ndarray:
        """Return the (unpadded) sorted token array of set ``i``."""
        return self.tokens[i, : self.lengths[i]]

    def as_lists(self) -> List[List[int]]:
        return [list(self.row(i)) for i in range(self.num_sets)]


def from_lists(sets: Sequence[Iterable[int]], pad_to: int | None = None) -> Collection:
    """Build a :class:`Collection` from an iterable of token iterables.

    Duplicate tokens within one set are removed (sets, not bags).
    """
    uniq = [np.unique(np.asarray(list(s), dtype=np.int64)).astype(np.int64) for s in sets]
    lengths = np.array([len(u) for u in uniq], dtype=np.int32)
    max_len = int(lengths.max()) if len(lengths) else 0
    if pad_to is not None:
        if pad_to < max_len:
            raise ValueError(f"pad_to={pad_to} < max set length {max_len}")
        max_len = pad_to
    tokens = np.full((len(uniq), max(max_len, 1)), PAD_TOKEN, dtype=np.int32)
    for i, u in enumerate(uniq):
        if np.any(u >= PAD_TOKEN) or np.any(u < 0):
            raise ValueError("tokens must be in [0, PAD_TOKEN)")
        tokens[i, : len(u)] = u.astype(np.int32)
    return Collection(tokens=tokens, lengths=lengths)


def split_join_args(col_s, sim, tau):
    """Support both ``(col, sim, tau)`` and ``(col_r, col_s, sim, tau)``.

    Every join driver historically took ``sim`` as its second positional
    argument; when the second argument is a similarity name instead of a
    :class:`Collection`, the remaining positionals shift right and the call
    is a self-join.
    """
    if isinstance(col_s, str):
        if not isinstance(tau, (int, float)) or isinstance(tau, bool):
            # A displaced object (e.g. a BitmapFilter passed positionally
            # after (col, sim, tau)) would otherwise be dropped silently.
            raise TypeError(
                "extra positional argument after (col, sim, tau); pass "
                "bitmap=/stats= by keyword")
        if isinstance(sim, (int, float)) and not isinstance(sim, bool):
            tau = float(sim)
        sim = col_s
        col_s = None
    return col_s, sim, tau


def _frequency_lut(flat: np.ndarray) -> dict:
    """token -> rank by (frequency, token); deterministic relabelling."""
    uniq, counts = np.unique(flat, return_counts=True)
    order = np.lexsort((uniq, counts))
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[order] = np.arange(len(uniq))
    return dict(zip(uniq.tolist(), rank.tolist()))


def _relabel_and_sort(col: Collection, lut: dict) -> Collection:
    relabeled: List[List[int]] = []
    for i in range(col.num_sets):
        relabeled.append(sorted(lut[int(t)] for t in col.row(i)))
    # Sort sets by (size, lexicographic token ids).
    relabeled.sort(key=lambda r: (len(r), tuple(r)))
    return from_lists(relabeled)


def preprocess(col: Collection) -> Collection:
    """Paper Section 5 preprocessing.

    1. Re-label tokens by ascending global frequency (rarest token gets the
       smallest id). This is the canonical ordering that makes prefix filters
       most selective, and what the reference implementation of [13] does.
    2. Sort sets by size; ties broken lexicographically by token ids.
    """
    return _relabel_and_sort(col, _frequency_lut(col.tokens[col.tokens != PAD_TOKEN]))


def preprocess_rs(col_r: Collection, col_s: Collection) -> tuple[Collection, Collection]:
    """Section 5 preprocessing for a two-collection R×S join.

    Token frequencies are counted over the union of *both* collections so the
    relabelled ids form one shared total order — prefix-filter correctness
    and selectivity depend on R and S agreeing on it (relabelling each side
    independently would map the same token to different ids).  Each collection
    is then sorted by size as in :func:`preprocess`.
    """
    flat = np.concatenate([col_r.tokens[col_r.tokens != PAD_TOKEN],
                           col_s.tokens[col_s.tokens != PAD_TOKEN]])
    lut = _frequency_lut(flat)
    return _relabel_and_sort(col_r, lut), _relabel_and_sort(col_s, lut)


def pad_collection(col: Collection, num_sets: int, max_len: int | None = None) -> Collection:
    """Pad a collection with empty sets up to ``num_sets`` (for block tiling)."""
    max_len = max_len or col.max_len
    if num_sets < col.num_sets:
        raise ValueError("cannot shrink collection")
    tokens = np.full((num_sets, max_len), PAD_TOKEN, dtype=np.int32)
    tokens[: col.num_sets, : col.max_len] = col.tokens
    lengths = np.zeros((num_sets,), dtype=np.int32)
    lengths[: col.num_sets] = col.lengths
    return Collection(tokens=tokens, lengths=lengths)
