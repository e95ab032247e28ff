"""The appendable corpus store: delta segments and LSM-style compaction
(the port of ``repro.store.store``).

Every cached artifact of a
:class:`~repro_torch.core.engine.PreparedCollection` (length sort, packed
bitmap words, CSR postings) derives from its source collection, so a
prepared corpus is frozen.  The store keeps one **sealed base segment** and
an ordered list of small **delta segments**, each its own prepared
collection on the store's device:

* :meth:`CorpusStore.append` prepares only the new delta; the base's
  ``builds`` counters never move on append.
* Every probe and self-join runs the **base join ∪ per-delta joins** under
  the store's one pinned :class:`~repro_torch.core.plan.JoinPlan`: a probe
  batch joins every segment; a self-join is each segment's self-join plus
  every earlier × later segment R×S join.  Pairs come back in
  **store-global ids** (append order: the base's rows first, then each
  delta's) and the funnel :class:`~repro_torch.core.join.JoinStats` are
  summed over the segment joins.
* A :class:`CompactionPolicy` (delta count or size ratio, plus an explicit
  :meth:`CorpusStore.compact`) folds the deltas into a new sealed base, so
  artifacts are rebuilt once per merge instead of once per append.
  Global ids are append-ordered, so compaction preserves them.

Exactness: at every state the store's pairs equal a join of a from-scratch
rebuild of :meth:`CorpusStore.collection` under the same plan, and the
per-pair funnel counters (:data:`FUNNEL_SUM_FIELDS`, plus
``postings_expanded`` for probes) sum to the rebuild's.  ``blocks_total``,
``blocks_skipped`` and ``overflow_blocks`` describe the decomposition and
are summed but not bound; a self-join's ``postings_expanded`` depends on the
direction of each segment join and is not bound either.

With ``mesh=`` / ``axis=`` every segment engine runs on that mesh, so a
``ring`` or ``sharded-indexed`` plan executes across its ranks; every rank
builds the same store and calls the same appends and joins.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.collection import Collection
from repro_torch.core.constants import JACCARD, PAD_TOKEN
from repro_torch.core.engine import JoinEngine, PreparedCollection, prepare, resolve_device
from repro_torch.core.join import JoinStats
from repro_torch.core.plan import JoinPlan, JoinPlanner, backend_of

#: JoinStats fields that count per-pair predicates: invariant under the
#: segment decomposition, so their sums equal a from-scratch rebuild's.
#: ``postings_expanded`` joins them for probes (the probe side is the same
#: on both sides of the comparison) but not for self-joins.
FUNNEL_SUM_FIELDS = ("total_pairs", "candidates", "verified_true",
                     "candidates_generated")
PROBE_SUM_FIELDS = FUNNEL_SUM_FIELDS + ("postings_expanded",)


def sum_stats(stats_list: Sequence[JoinStats]) -> JoinStats:
    """Field-wise sum of :class:`~repro_torch.core.join.JoinStats` counters."""
    out = JoinStats()
    for s in stats_list:
        for f in dataclasses.fields(JoinStats):
            setattr(out, f.name, getattr(out, f.name) + getattr(s, f.name))
    return out


def merge_pairs(chunks: Sequence[np.ndarray]) -> np.ndarray:
    """Concatenate per-segment pair buffers and lexsort them into the
    canonical (column 0 major) order every driver emits."""
    chunks = [c for c in chunks if len(c)]
    if not chunks:
        return np.zeros((0, 2), dtype=np.int64)
    p = np.concatenate(chunks, axis=0).astype(np.int64)
    return p[np.lexsort((p[:, 1], p[:, 0]))]


def empty_collection(max_len: int = 1) -> Collection:
    """A zero-row collection (the base of a store born empty)."""
    return Collection(tokens=np.full((0, max(max_len, 1)), PAD_TOKEN,
                                     dtype=np.int32),
                      lengths=np.zeros((0,), dtype=np.int32))


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """When to fold the delta list into a new sealed base.

    ``max_deltas`` triggers on the delta count (each delta adds one segment
    join per probe); ``size_ratio`` triggers when the delta rows exceed that
    fraction of the base (the LSM size-ratio rule).
    """

    max_deltas: int = 4
    size_ratio: float = 0.5

    def __post_init__(self):
        if self.max_deltas < 1:
            raise ValueError(f"max_deltas must be >= 1, got {self.max_deltas}")
        if self.size_ratio <= 0:
            raise ValueError(f"size_ratio must be > 0, got {self.size_ratio}")

    def should_compact(self, base_rows: int,
                       delta_rows: Sequence[int]) -> bool:
        if not delta_rows:
            return False
        if len(delta_rows) >= self.max_deltas:
            return True
        return sum(delta_rows) > self.size_ratio * max(base_rows, 1)

    @classmethod
    def never(cls) -> "CompactionPolicy":
        """Auto-compaction disabled; only an explicit ``compact()`` merges."""
        return cls(max_deltas=1 << 30, size_ratio=float("inf"))


@dataclasses.dataclass
class StoreStats:
    """The store's observability rollup."""

    segments: int            # 1 (base) + live delta count
    base_rows: int
    delta_rows: int
    delta_count: int
    delta_fraction: float    # delta_rows / max(total rows, 1)
    appends: int
    compactions: int
    probes: int
    builds: Dict[str, int]           # the live base segment's build counters
    delta_builds: Dict[str, int]     # summed over live delta segments
    lifetime_builds: Dict[str, int]  # base + deltas + retired segments

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Segment:
    """One sealed store segment: a prepared collection at a global-id
    offset.  :meth:`engine` is its lazily built
    :class:`~repro_torch.core.engine.JoinEngine` under the store's plan,
    cached so repeated probes reuse every segment-side artifact."""

    __slots__ = ("prepared", "offset", "kind", "_engine")

    def __init__(self, prepared: PreparedCollection, offset: int, kind: str):
        self.prepared = prepared
        self.offset = int(offset)
        self.kind = kind
        self._engine: Optional[JoinEngine] = None

    @property
    def rows(self) -> int:
        return self.prepared.num_sets

    def engine(self, store: "CorpusStore") -> JoinEngine:
        if self._engine is None:
            self._engine = JoinEngine(self.prepared, store.sim, store.tau,
                                      plan=store.plan, device=store.device,
                                      mesh=store.mesh, axis=store.axis)
        return self._engine

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Segment({self.kind}, offset={self.offset}, rows={self.rows})"


class CorpusStore:
    """An appendable corpus over the prepared-collection engine.

    ``CorpusStore(base, sim, tau)`` seals ``base`` as the first segment on
    ``device`` (the card when ``None``, or the device a prepared base lives
    on) and resolves one :class:`~repro_torch.core.plan.JoinPlan` for that
    device's backend, shared by every segment join for the store's lifetime
    (pass ``plan=`` to pin it), on ``mesh`` / ``axis`` when given (an auto
    plan then counts the mesh's ranks as devices).  ``append`` adds a delta
    segment (preparing only the delta), ``probe``/``self_join`` run the
    segment-union join, and ``compact`` seals everything into a fresh base.

    Documents are addressed by store-global ids: the base's original
    indices first, then each delta's, in append order; compaction
    materialises segments in that order, so ids survive any number of merges.
    """

    def __init__(self, base: Collection | PreparedCollection | None = None,
                 sim: str = JACCARD, tau: float = 0.8, *,
                 plan: Optional[JoinPlan] = None,
                 planner: Optional[JoinPlanner] = None,
                 policy: Optional[CompactionPolicy] = None,
                 mesh=None, axis=None,
                 device=None):
        if base is None:
            base = empty_collection()
        if device is None and isinstance(base, PreparedCollection):
            device = base.device
        self.device = resolve_device(device)
        prepared = prepare(base, self.device)
        self.sim = sim
        self.tau = float(tau)
        if plan is None:
            planner = planner or JoinPlanner()
            # A mesh or the card: the planner counts the ranks (or cards).
            n_dev = None if (self.device.type == "cuda" or mesh is not None) else 1
            plan = planner.plan(sim, self.tau, n_r=max(prepared.num_sets, 1),
                                backend=backend_of(self.device), n_devices=n_dev)
        if plan.sim != sim or plan.tau != self.tau:
            raise ValueError(
                f"plan is for (sim={plan.sim}, tau={plan.tau}); the store "
                f"was asked for (sim={sim}, tau={self.tau})")
        self.plan = plan
        self.policy = policy or CompactionPolicy()
        self.mesh = mesh
        self.axis = axis
        self.base = Segment(prepared, 0, "base")
        self.deltas: List[Segment] = []
        self.appends = 0
        self.compactions = 0
        self.probes = 0
        #: bumped on every mutation (append or compact)
        self.version = 0
        #: bumped only when the base segment is replaced (compaction): a
        #: resident consumer (``serve.JoinSession``) rebinds its device
        #: artifacts iff this moved.
        self.base_version = 0
        self._retired_builds: collections.Counter = collections.Counter()

    # -- shape ---------------------------------------------------------------

    def segments(self) -> List[Segment]:
        return [self.base] + list(self.deltas)

    @property
    def num_sets(self) -> int:
        return self.base.rows + sum(d.rows for d in self.deltas)

    def __len__(self) -> int:
        return self.num_sets

    @property
    def max_len(self) -> int:
        return max((s.prepared.source.tokens.shape[1]
                    for s in self.segments()), default=1)

    # -- mutation ------------------------------------------------------------

    def append(self, col: Collection | PreparedCollection, *,
               compact: bool | str = "auto") -> Segment:
        """Seal ``col`` as a new delta segment; only the delta is prepared.

        ``compact="auto"`` lets :attr:`policy` decide whether to fold
        afterwards; ``True`` forces a merge, ``False`` suppresses it.
        Returns the new segment (its ``offset`` is the first global id the
        appended documents received, valid across later compactions).
        """
        seg = Segment(prepare(col, self.device), self.num_sets, "delta")
        self.deltas.append(seg)
        self.appends += 1
        self.version += 1
        if compact is True or (
                compact == "auto" and self.policy.should_compact(
                    self.base.rows, [d.rows for d in self.deltas])):
            self.compact()
        return seg

    def compact(self) -> bool:
        """Fold every delta into a new sealed base (one artifact rebuild per
        merge instead of one per append).  No-op without deltas.  Returns
        whether a merge happened."""
        if not self.deltas:
            return False
        for seg in self.segments():
            self._retired_builds.update(seg.prepared.builds)
        merged = self.collection()
        self.base = Segment(prepare(merged, self.device), 0, "base")
        self.deltas = []
        self.compactions += 1
        self.version += 1
        self.base_version += 1
        return True

    def collection(self) -> Collection:
        """The materialised union in global-id order (the compaction input,
        and the from-scratch rebuild's input in the exactness tests)."""
        width = self.max_len
        n = self.num_sets
        tokens = np.full((n, width), PAD_TOKEN, dtype=np.int32)
        lengths = np.zeros((n,), dtype=np.int32)
        for seg in self.segments():
            src = seg.prepared.source
            o, k = seg.offset, seg.rows
            if k:
                tokens[o:o + k, :src.tokens.shape[1]] = src.tokens
                lengths[o:o + k] = src.lengths
        return Collection(tokens=tokens, lengths=lengths)

    # -- joins ---------------------------------------------------------------

    def _probe_segments(self, segments: Sequence[Segment], batch
                        ) -> Tuple[List[np.ndarray], List[JoinStats]]:
        prep_b = prepare(batch, self.device)
        chunks: List[np.ndarray] = []
        stats: List[JoinStats] = []
        for seg in segments:
            if seg.rows == 0:
                continue
            p, st = seg.engine(self).probe(prep_b)
            if len(p):
                chunks.append(p + np.array([seg.offset, 0], dtype=np.int64))
            stats.append(st)
        return chunks, stats

    def probe(self, batch: Collection | PreparedCollection, *,
              return_stats: bool = True):
        """Join one batch against every segment; pairs come back as
        ``(store_global_id, batch_index)`` in the canonical lexsorted order,
        with the funnel counters summed over the segment joins."""
        self.probes += 1
        if batch.num_sets == 0:
            out = merge_pairs([]), JoinStats()
            return out if return_stats else out[0]
        chunks, stats = self._probe_segments(self.segments(), batch)
        pairs, total = merge_pairs(chunks), sum_stats(stats)
        return (pairs, total) if return_stats else pairs

    def probe_deltas(self, batch: Collection | PreparedCollection
                     ) -> Tuple[np.ndarray, List[JoinStats]]:
        """The delta part of :meth:`probe` alone: the serving layer runs the
        base join in its own device step and adds this on top (the same
        per-delta engine probes the sequential path runs)."""
        if batch.num_sets == 0 or not self.deltas:
            return merge_pairs([]), []
        chunks, stats = self._probe_segments(self.deltas, batch)
        return merge_pairs(chunks), stats

    def self_join(self, *, return_stats: bool = False):
        """The whole store joined against itself: each segment's self-join
        plus every earlier × later segment R×S join, in global ids, with
        summed stats."""
        segs = [s for s in self.segments() if s.rows > 0]
        chunks: List[np.ndarray] = []
        stats: List[JoinStats] = []
        for i, seg in enumerate(segs):
            p, st = seg.engine(self).self_join(return_stats=True)
            if len(p):
                chunks.append(p + seg.offset)
            stats.append(st)
            for later in segs[i + 1:]:
                p, st = seg.engine(self).probe(later.prepared)
                if len(p):
                    chunks.append(p + np.array([seg.offset, later.offset],
                                               dtype=np.int64))
                stats.append(st)
        pairs, total = merge_pairs(chunks), sum_stats(stats)
        return (pairs, total) if return_stats else pairs

    # -- observability -------------------------------------------------------

    def builds(self) -> Dict[str, int]:
        """The live base segment's build counters: ``sort`` and ``bitmap``
        staying put across appends show that ``append`` never rebuilds the
        base."""
        return dict(self.base.prepared.builds)

    def stats(self) -> StoreStats:
        delta_rows = sum(d.rows for d in self.deltas)
        total = self.base.rows + delta_rows
        delta_builds: collections.Counter = collections.Counter()
        for d in self.deltas:
            delta_builds.update(d.prepared.builds)
        lifetime = collections.Counter(self._retired_builds)
        lifetime.update(self.base.prepared.builds)
        lifetime.update(delta_builds)
        return StoreStats(
            segments=1 + len(self.deltas),
            base_rows=self.base.rows,
            delta_rows=delta_rows,
            delta_count=len(self.deltas),
            delta_fraction=delta_rows / max(total, 1),
            appends=self.appends,
            compactions=self.compactions,
            probes=self.probes,
            builds=self.builds(),
            delta_builds=dict(delta_builds),
            lifetime_builds=dict(lifetime),
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"CorpusStore(n={self.num_sets}, base={self.base.rows}, "
                f"deltas={[d.rows for d in self.deltas]}, "
                f"plan={self.plan.driver!r}, compactions={self.compactions}, "
                f"device={self.device})")
