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

:func:`partition_postings` cuts an index into the ``"sharded-indexed"``
driver's token slabs (:class:`ShardedPostings`, cached per shard count
with a ``builds["sharded_postings"]`` counter), and
:func:`shard_expansion_counts` is its per-slab count prepass.
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


# ---------------------------------------------------------------------------
# Token-slab partitioning (the "sharded-indexed" driver's build artifact)
# ---------------------------------------------------------------------------

# Padding sentinel for the slabs' post_key tails.  build_postings guarantees
# every real key is at most num_tokens * (max_len + 1) - 1 < INT32_MAX, and
# the windowed lookup's upper probe is num_tokens * scale - 1 at most, so a
# sentinel slot never falls inside a searchsorted range.
_KEY_SENTINEL = np.int32(np.iinfo(np.int32).max)


@dataclasses.dataclass
class ShardedPostings:
    """A :class:`PostingsIndex` re-cut into contiguous token-id slabs.

    ``post_*[k]`` hold shard ``k``'s postings, padded to a common width with
    ``_KEY_SENTINEL`` keys, so the same windowed ``searchsorted`` lookup
    works unchanged on a slab; ``slab_tid[k] : slab_tid[k + 1]`` is the dense
    token-id range shard ``k`` owns, chosen so that postings volume, not
    token count, balances across shards.  ``vocab`` / ``vocab_tid`` stay the
    base index's: the probe-side lookup is the same on every rank.
    """

    base: PostingsIndex
    n_shards: int
    slab_tid: np.ndarray    # int64[n_shards + 1] dense-token-id boundaries
    counts: np.ndarray      # int64[n_shards] real postings per slab
    post_set: np.ndarray    # int32[n_shards, pmax]
    post_pos: np.ndarray    # int32[n_shards, pmax]
    post_len: np.ndarray    # int32[n_shards, pmax]
    post_key: np.ndarray    # int32[n_shards, pmax]; sentinel-padded tails
    _device: Dict[Tuple[str, int], Tuple[torch.Tensor, ...]] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def slab_width(self) -> int:
        return int(self.post_set.shape[1])

    def device_arrays(self, device, shard: int) -> Tuple[torch.Tensor, ...]:
        """Slab ``shard``'s (post_set, post_pos, post_len, post_key) as int32
        tensors on ``device``, cached: a rank uploads its own slab only."""
        key = (str(torch.device(device)), int(shard))
        if key not in self._device:
            self._device[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a[shard])).to(device)
                for a in (self.post_set, self.post_pos, self.post_len, self.post_key))
        return self._device[key]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"ShardedPostings(n_shards={self.n_shards}, "
                f"width={self.slab_width}, counts={self.counts.tolist()})")


def partition_postings(post: PostingsIndex, n_shards: int) -> ShardedPostings:
    """Cut a postings index into ``n_shards`` contiguous token slabs.

    Slab ``k`` starts at the first token whose cumulative postings count
    reaches ``k / n_shards`` of the total (from the CSR row offsets), so
    slabs balance by postings volume; a token is never split, so a hot token
    lands wholly in one slab (the per-shard count prepass and the escalation
    absorb that skew).
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    cum = post.starts.astype(np.int64)
    total = int(post.num_postings)
    targets = (total * np.arange(n_shards + 1, dtype=np.int64)) // n_shards
    slab_tid = np.searchsorted(cum, targets, side="left").astype(np.int64)
    slab_tid[0] = 0
    slab_tid[-1] = post.num_tokens
    slab_tid = np.maximum.accumulate(slab_tid)
    slab_post = cum[slab_tid]
    counts = np.diff(slab_post)
    pmax = max(int(counts.max(initial=0)), 1)

    post_set = np.zeros((n_shards, pmax), dtype=np.int32)
    post_pos = np.zeros((n_shards, pmax), dtype=np.int32)
    post_len = np.zeros((n_shards, pmax), dtype=np.int32)
    post_key = np.full((n_shards, pmax), _KEY_SENTINEL, dtype=np.int32)
    for k in range(n_shards):
        sl = slice(int(slab_post[k]), int(slab_post[k + 1]))
        w = int(counts[k])
        post_set[k, :w] = post.post_set[sl]
        post_pos[k, :w] = post.post_pos[sl]
        post_len[k, :w] = post.post_len[sl]
        post_key[k, :w] = post.post_key[sl]
    return ShardedPostings(
        base=post, n_shards=int(n_shards), slab_tid=slab_tid, counts=counts,
        post_set=post_set, post_pos=post_pos, post_len=post_len, post_key=post_key)


def lookup_counts_host(post: PostingsIndex, tokens_np, ps_np, lo_np, hi_np,
                       lp: int):
    """Host (int64-exact) twin of the device windowed lookup.

    Returns ``(cnt, tid, valid)``, each ``[C, lp]``: the window-surviving
    postings count, the dense token id, and the lookup-validity mask per
    ``(probe, prefix position)``.  The count prepasses (the total one and
    :func:`shard_expansion_counts`) sum it to size each chunk's capacity
    and to catch a pathological expansion before any device buffer is
    allocated.
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


def shard_expansion_counts(sharded: ShardedPostings, tokens_np, ps_np,
                           lo_np, hi_np, lp: int) -> np.ndarray:
    """Per-shard count prepass: the window-surviving postings entries this
    probe chunk expands to on each token slab (``int64[n_shards]``).  The
    slabs are disjoint, so these partition the single-device count: their
    sum is the unsharded prepass's total."""
    cnt, tid, valid = lookup_counts_host(
        sharded.base, tokens_np, ps_np, lo_np, hi_np, lp)
    owner = np.clip(np.searchsorted(sharded.slab_tid, tid, side="right") - 1,
                    0, sharded.n_shards - 1)
    out = np.zeros(sharded.n_shards, dtype=np.int64)
    np.add.at(out, owner[valid], cnt[valid])
    return out
