"""Compile a prepared collection's ℓ-prefix inverted index into flat CSR
arrays (the port of ``repro.index.postings``).

* tokens are remapped to **dense frequency-ordered ids** (id 0 = rarest,
  ties broken by token value);
* postings are laid out **CSR**: ``starts[tid] : starts[tid + 1]`` spans
  token ``tid``'s entries in the flat ``post_set`` / ``post_pos`` arrays;
* within a token's list, entries are sorted by set id, which is sorted by
  length (the prepared collection is length-sorted), so the composite
  ``post_key = tid * (L + 1) + length`` is globally non-decreasing and one
  ``searchsorted`` narrows every probe's lookup to its admissible length
  window before expansion;
* ``post_len`` caches ``lengths[post_set]``;
* probe-side lookup is a value-ordered ``vocab`` + ``searchsorted``.

The index is built on the host in numpy (fields keep the reference's names
and dtypes, so an index built by the JAX package carries across field by
field, :meth:`PostingsIndex.carry`); :meth:`PostingsIndex.device_arrays`
uploads the six arrays the driver reads, once per device.  Instances are
cached on :class:`~repro_torch.core.engine.PreparedCollection` per
``(sim, tau, ell)`` with a ``builds["postings"]`` counter.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import bounds


@dataclasses.dataclass
class PostingsIndex:
    """Flat CSR ℓ-prefix inverted index over one prepared collection.

    All ids are in the prepared (length-sorted) index space; callers remap
    result pairs through ``prepared.order`` like every other driver.
    """

    sim: str
    tau: float
    ell: int
    max_len: int            # padded row width L; post_key scale is L + 1
    vocab: np.ndarray       # int32[V] distinct prefix tokens, ascending value
    vocab_tid: np.ndarray   # int32[V] dense frequency-ordered id of vocab[k]
    starts: np.ndarray      # int32[V + 1] CSR row starts over dense ids
    post_set: np.ndarray    # int32[P] set id (sorted space), ascending per row
    post_pos: np.ndarray    # int32[P] token position inside the set row
    post_len: np.ndarray    # int32[P] == lengths[post_set]
    post_key: np.ndarray    # int32[P] tid * (L + 1) + post_len, non-decreasing
    prefix_len: np.ndarray  # int32[N] ℓ-prefix length per sorted row
    _device: Dict[str, Tuple[torch.Tensor, ...]] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @classmethod
    def carry(cls, other) -> "PostingsIndex":
        """A copy of ``other`` (any object with these field names, such as
        the JAX package's index), field by field, as numpy arrays."""
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name.startswith("_"):
                continue
            v = getattr(other, f.name)
            kw[f.name] = np.array(v) if isinstance(v, np.ndarray) else v
        return cls(**kw)

    @property
    def num_tokens(self) -> int:
        return int(self.vocab.shape[0])

    @property
    def num_postings(self) -> int:
        return int(self.post_set.shape[0])

    def device_arrays(self, device) -> Tuple[torch.Tensor, ...]:
        """(vocab, vocab_tid, post_set, post_pos, post_len, post_key) as
        int32 tensors on ``device``, cached per device."""
        key = str(torch.device(device))
        if key not in self._device:
            self._device[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
                for a in (self.vocab, self.vocab_tid, self.post_set,
                          self.post_pos, self.post_len, self.post_key))
        return self._device[key]

    def as_dict(self) -> dict:
        """token -> [(set_id, position), ...] — the CPU index shape."""
        out = {}
        for k in range(self.num_tokens):
            tid = int(self.vocab_tid[k])
            sl = slice(int(self.starts[tid]), int(self.starts[tid + 1]))
            out[int(self.vocab[k])] = list(
                zip(self.post_set[sl].tolist(), self.post_pos[sl].tolist()))
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"PostingsIndex(sim={self.sim}, tau={self.tau}, "
                f"ell={self.ell}, tokens={self.num_tokens}, "
                f"postings={self.num_postings})")


def build_postings(prep, sim: str, tau: float, ell: int = 1) -> PostingsIndex:
    """Compile the ℓ-prefix inverted index of a prepared collection.

    Vectorized: prefix lengths from :func:`bounds.prefix_length_ell`, the
    flat ``(set, pos)`` expansion from a cumsum/searchsorted, the CSR layout
    from one stable argsort by dense token id (stability keeps the
    ascending set-id order inside each postings list).
    """
    lengths = np.asarray(prep.lengths, dtype=np.int64)
    max_len = int(prep.max_len)
    n = int(lengths.shape[0])
    p = np.zeros(n, dtype=np.int64)
    nz = lengths > 0
    if nz.any():
        p[nz] = bounds.prefix_length_ell(sim, tau, lengths[nz], ell)
    total = int(p.sum())
    if total == 0:
        empty32 = np.zeros(0, dtype=np.int32)
        return PostingsIndex(
            sim=sim, tau=float(tau), ell=int(ell), max_len=max_len,
            vocab=empty32, vocab_tid=empty32,
            starts=np.zeros(1, dtype=np.int32),
            post_set=empty32, post_pos=empty32, post_len=empty32,
            post_key=empty32, prefix_len=p.astype(np.int32))

    ends = np.cumsum(p)
    flat = np.arange(total, dtype=np.int64)
    set_id = np.searchsorted(ends, flat, side="right")
    pos = flat - (ends[set_id] - p[set_id])
    toks = np.asarray(prep.tokens)[set_id, pos].astype(np.int64)

    vocab, inverse, counts = np.unique(toks, return_inverse=True,
                                       return_counts=True)
    # Dense frequency-ordered ids: rarest first, ties by ascending value.
    order = np.lexsort((vocab, counts))
    rank = np.empty(len(vocab), dtype=np.int64)
    rank[order] = np.arange(len(vocab))
    tid = rank[inverse]

    perm = np.argsort(tid, kind="stable")  # keeps per-token set-id order
    starts = np.zeros(len(vocab) + 1, dtype=np.int64)
    starts[1:] = np.cumsum(np.bincount(tid, minlength=len(vocab)))
    post_set = set_id[perm].astype(np.int32)
    post_len = lengths[post_set].astype(np.int64)
    if len(vocab) * (max_len + 1) > np.iinfo(np.int32).max:
        raise ValueError(
            f"postings key space {len(vocab)} tokens x (max_len={max_len} + 1)"
            f" overflows int32; shrink the vocabulary or pad width")
    post_key = tid[perm] * (max_len + 1) + post_len
    return PostingsIndex(
        sim=sim, tau=float(tau), ell=int(ell), max_len=max_len,
        vocab=vocab.astype(np.int32),
        vocab_tid=rank.astype(np.int32),
        starts=starts.astype(np.int32),
        post_set=post_set,
        post_pos=pos[perm].astype(np.int32),
        post_len=post_len.astype(np.int32),
        post_key=post_key.astype(np.int32),
        prefix_len=p.astype(np.int32))


def lookup_counts_host(post: PostingsIndex, tokens_np, ps_np, lo_np, hi_np,
                       lp: int):
    """Host (int64-exact) twin of the device windowed lookup.

    Returns ``(cnt, tid, valid)``, each ``[C, lp]``: the window-surviving
    postings count, the dense token id, and the lookup-validity mask per
    ``(probe, prefix position)``.  The count prepass sums it to size each
    chunk's capacity and to catch a pathological expansion before any
    device buffer is allocated.
    """
    c = int(np.asarray(tokens_np).shape[0])
    if post.num_tokens == 0 or lp == 0:
        z = np.zeros((c, max(lp, 1)), dtype=np.int64)
        return z, z.copy(), np.zeros_like(z, dtype=bool)
    scale = post.max_len + 1
    ptoks = np.asarray(tokens_np)[:, :lp].astype(np.int64)
    j = np.clip(np.searchsorted(post.vocab, ptoks), 0, post.num_tokens - 1)
    found = post.vocab[j].astype(np.int64) == ptoks
    tid = np.where(found, post.vocab_tid[j], 0).astype(np.int64)
    valid = found & (np.arange(lp)[None, :] < np.asarray(ps_np)[:, None])
    base = tid * scale
    lo_c = np.clip(np.asarray(lo_np).astype(np.int64), 0, scale - 1)[:, None]
    hi_c = np.clip(np.asarray(hi_np).astype(np.int64), 0, scale - 1)[:, None]
    a = np.searchsorted(post.post_key, base + lo_c, side="left")
    b = np.searchsorted(post.post_key, base + hi_c, side="right")
    cnt = np.where(valid, np.maximum(b - a, 0), 0).astype(np.int64)
    return cnt, tid, valid
