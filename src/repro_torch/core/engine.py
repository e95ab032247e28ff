"""The prepared-collection engine: build-once join artifacts + batched probes.

The port of ``repro.core.engine``:

* :class:`PreparedCollection` — a length-sorted view of a
  :class:`~repro_torch.core.collection.Collection` with the inverse
  permutation, the sorted token/length tensors on one device, packed bitmap
  words cached per ``(b, method, mix)`` (and their numpy ``uint32`` copy
  for the CPU algorithms), integer length windows cached per ``(sim,
  tau)``, the CPU algorithms' ℓ-prefix index and the CSR postings index
  cached per ``(sim, tau, ell)``, and its token-slab partition per ``(sim,
  tau, ell, n_shards)``.  ``builds`` counts each build so reuse is
  assertable.
* :class:`JoinEngine` — prepare R once, stream batches of S through
  :meth:`JoinEngine.probe`, each returning pairs plus a per-batch
  :class:`~repro_torch.core.join.JoinStats`, under an explicit
  :class:`~repro_torch.core.plan.JoinPlan`.  It executes the ``naive``,
  ``blocked`` and ``indexed`` drivers, the four CPU algorithms
  (:mod:`repro_torch.core.cpu_algos`, with :func:`prepared_bitmap_filter`),
  and on a device mesh the ``ring`` and ``sharded-indexed`` drivers (without
  one, the reference's recorded fallbacks), over a prepared corpus or an
  appendable :class:`~repro_torch.store.CorpusStore`.

Entry points run on the card: ``prepare(col)`` without a ``device`` resolves
to ``cuda`` and raises when no card is present; tests pass ``device="cpu"``.

:func:`prepared_from_numpy` carries state across from the JAX package: it
takes a collection's numpy ``tokens``/``lengths``, packed ``uint32`` words
and postings indexes built there, and returns a prepared collection whose
caches already hold them; :func:`store_from_numpy` does the same for a
whole corpus store, segment by segment.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import bounds
from repro_torch.core.collection import Collection
from repro_torch.core.constants import BITMAP_COMBINED, JACCARD
from repro_torch.core.filters import BitmapFilter
from repro_torch.core.plan import CPU_DRIVERS, JoinPlan, JoinPlanner, backend_of


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card, and raises
    when there is none (the caller must ask for the CPU explicitly)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


class PreparedCollection:
    """Build-once join artifacts for one collection on one device.

    Construction performs the only eager step — the stable length sort.
    Everything else (device tensors, packed words per ``(b, method, mix)``,
    integer length windows per ``(sim, tau)``, CPU prefix indexes and
    postings indexes per ``(sim, tau, ell)``) is built on first use and
    cached; ``builds`` counts each build.
    """

    def __init__(self, source: Collection, device=None):
        self.device = resolve_device(device)
        order = np.argsort(source.lengths, kind="stable")
        inverse = np.empty_like(order)
        inverse[order] = np.arange(len(order))
        self.source = source
        self.order = order          # sorted index -> original index
        self.inverse = inverse      # original index -> sorted index
        self.tokens = source.tokens[order]    # length-sorted view (numpy)
        self.lengths = source.lengths[order]
        # Cached artifacts derive from these arrays: an in-place edit after
        # prepare() would silently serve stale sorts and bitmaps.
        for arr in (source.tokens, source.lengths, self.tokens, self.lengths):
            arr.flags.writeable = False
        self.builds: Dict[str, int] = {"sort": 1, "bitmap": 0, "window": 0,
                                       "prefix_index": 0, "postings": 0,
                                       "sharded_postings": 0}
        self._device_arrays: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._words: Dict[Tuple[int, str, bool], torch.Tensor] = {}
        self._words_np: Dict[Tuple[int, str, bool], np.ndarray] = {}
        self._windows: Dict[Tuple[str, float], Tuple] = {}
        self._prefix: Dict[Tuple[str, float, int], dict] = {}
        self._postings: Dict[Tuple[str, float, int], object] = {}
        self._sharded_postings: Dict[Tuple[str, float, int, int], object] = {}
        self._sorted_collection: Optional[Collection] = None

    # -- Collection duck-typing (over the length-sorted view) ---------------

    @property
    def num_sets(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def max_len(self) -> int:
        return int(self.tokens.shape[1])

    def __len__(self) -> int:
        return self.num_sets

    def row(self, i: int) -> np.ndarray:
        return self.tokens[i, : self.lengths[i]]

    @property
    def sorted_collection(self) -> Collection:
        """The length-sorted view as a plain :class:`Collection`."""
        if self._sorted_collection is None:
            self._sorted_collection = Collection(tokens=self.tokens,
                                                 lengths=self.lengths)
        return self._sorted_collection

    # -- cached artifacts ----------------------------------------------------

    def device_arrays(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(tokens int32[N, L], lengths int32[N]) on :attr:`device`, cached."""
        if self._device_arrays is None:
            self._device_arrays = (torch.from_numpy(self.tokens.copy()).to(self.device),
                                   torch.from_numpy(self.lengths.copy()).to(self.device))
        return self._device_arrays

    def bitmap_words(self, b: int, method: str, *, mix: bool = False,
                     tau: Optional[float] = None) -> torch.Tensor:
        """Packed int32[N, b//32] words over the sorted view, cached per
        ``(b, resolved method, mix)``; ``method='combined'`` needs ``tau``."""
        if method == BITMAP_COMBINED:
            if tau is None:
                raise ValueError("combined method needs tau to resolve")
            method = bm.choose_method(float(tau), b)
        key = (int(b), method, bool(mix))
        if key not in self._words:
            tokens, lengths = self.device_arrays()
            self._words[key] = bm.generate_bitmaps(tokens, lengths, b,
                                                   method=method, mix=mix)
            self.builds["bitmap"] += 1
        return self._words[key]

    def bitmap_words_np(self, b: int, method: str, *, mix: bool = False,
                        tau: Optional[float] = None) -> np.ndarray:
        """:meth:`bitmap_words` on the host as numpy ``uint32`` (the int32
        bit patterns viewed), for the CPU ``BitmapFilter``; cached per key."""
        if method == BITMAP_COMBINED:
            if tau is None:
                raise ValueError("combined method needs tau to resolve")
            method = bm.choose_method(float(tau), b)
        key = (int(b), method, bool(mix))
        if key not in self._words_np:
            words = self.bitmap_words(b, method, mix=mix)
            self._words_np[key] = words.cpu().numpy().view(np.uint32)
        return self._words_np[key]

    def length_window_int(self, sim: str, tau: float):
        """Integer-exact Table 2 windows for every sorted row, cached per
        ``(sim, tau)``.  Returns ``(lo_np, hi_np, lo_dev, hi_dev)``."""
        key = (sim, float(tau))
        if key not in self._windows:
            lo, hi = bounds.length_window_int(sim, tau, self.lengths)
            self._windows[key] = (lo, hi, torch.from_numpy(lo).to(self.device),
                                  torch.from_numpy(hi).to(self.device))
            self.builds["window"] += 1
        return self._windows[key]

    def prefix_index(self, sim: str, tau: float, ell: int = 1) -> dict:
        """Cached ℓ-prefix inverted index over the sorted view (the CPU
        algorithms' build artifact), built at most once per
        ``(sim, tau, ell)``."""
        key = (sim, float(tau), int(ell))
        if key not in self._prefix:
            # Imported here: cpu_algos imports this module.
            from repro_torch.core import cpu_algos
            self._prefix[key] = cpu_algos._build_prefix_index(
                self.sorted_collection, sim, tau, ell=ell)
            self.builds["prefix_index"] += 1
        return self._prefix[key]

    def postings(self, sim: str, tau: float, ell: int = 1):
        """The CSR ℓ-prefix postings index over the sorted view (the
        ``"indexed"`` driver's build artifact,
        :class:`repro_torch.index.postings.PostingsIndex`), built at most
        once per ``(sim, tau, ell)``."""
        key = (sim, float(tau), int(ell))
        if key not in self._postings:
            # Imported here: repro_torch.index layers over this module.
            from repro_torch.index.postings import build_postings
            self._postings[key] = build_postings(self, sim, tau, ell=ell)
            self.builds["postings"] += 1
        return self._postings[key]

    def sharded_postings(self, sim: str, tau: float, ell: int = 1,
                         n_shards: int = 1):
        """The token-slab partition of :meth:`postings` (the
        ``"sharded-indexed"`` driver's build artifact,
        :class:`repro_torch.index.postings.ShardedPostings`), built at most
        once per ``(sim, tau, ell, n_shards)``; the CSR index under it is the
        single-device driver's, cached once."""
        key = (sim, float(tau), int(ell), int(n_shards))
        if key not in self._sharded_postings:
            from repro_torch.index.postings import partition_postings
            self._sharded_postings[key] = partition_postings(
                self.postings(sim, tau, ell), n_shards)
            self.builds["sharded_postings"] += 1
        return self._sharded_postings[key]

    def build_counts(self) -> Dict[str, int]:
        """A copy of the build counters
        (sort/bitmap/window/prefix_index/postings/sharded_postings)."""
        return dict(self.builds)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"PreparedCollection(n={self.num_sets}, max_len={self.max_len}, "
                f"device={self.device}, builds={self.builds})")


def prepare(col: Collection | PreparedCollection, device=None) -> PreparedCollection:
    """Build the reusable join artifact for ``col`` on ``device`` (the card
    when ``None``).  A prepared collection is returned as is; asking for
    another device than the one it lives on raises."""
    if isinstance(col, PreparedCollection):
        if device is not None and torch.device(device) != col.device:
            raise ValueError(f"collection is prepared on {col.device}, "
                             f"not on {torch.device(device)}")
        return col
    return PreparedCollection(col, device)


def as_prepared(col: Collection | PreparedCollection, device=None) -> PreparedCollection:
    """Alias of :func:`prepare`; reads better at driver entry points."""
    return prepare(col, device)


def prepared_from_numpy(
    tokens: np.ndarray,
    lengths: np.ndarray,
    *,
    words: Optional[Mapping[Tuple[int, str, bool], np.ndarray]] = None,
    postings: Iterable = (),
    device,
) -> PreparedCollection:
    """A :class:`PreparedCollection` over numpy arrays built elsewhere.

    ``tokens``/``lengths`` are a collection's padded int32 arrays in
    original row order.  ``words`` maps ``(b, method, mix)`` to packed
    ``uint32[N, b//32]`` words over the *length-sorted* view (the stable
    sort here is the one ``repro.core.engine.PreparedCollection`` applies);
    they enter the word cache as is, so ``builds["bitmap"]`` stays 0 until
    another key is asked for.  ``postings`` are postings indexes over the
    same sorted view (any objects with the fields of
    :class:`repro_torch.index.postings.PostingsIndex`),
    carried into the cache under their ``(sim, tau, ell)``, so
    ``builds["postings"]`` stays 0 for them.
    """
    prep = PreparedCollection(
        Collection(tokens=np.ascontiguousarray(tokens, dtype=np.int32),
                   lengths=np.ascontiguousarray(lengths, dtype=np.int32)),
        device)
    for (b, method, mix), w in (words or {}).items():
        w = np.asarray(w)
        if w.dtype != np.uint32 or w.shape != (prep.num_sets, int(b) // 32):
            raise ValueError(
                f"words for {(b, method, mix)} must be uint32"
                f"[{prep.num_sets}, {int(b) // 32}], got {w.dtype}{list(w.shape)}")
        bits = torch.from_numpy(np.ascontiguousarray(w).view(np.int32).copy())
        prep._words[(int(b), method, bool(mix))] = bits.to(prep.device)
    from repro_torch.index.postings import PostingsIndex

    for post in postings:
        post = PostingsIndex.carry(post)
        if post.prefix_len.shape != (prep.num_sets,) or post.max_len != prep.max_len:
            raise ValueError("a carried postings index must cover this collection's "
                             f"{prep.num_sets} rows of width {prep.max_len}")
        prep._postings[(post.sim, float(post.tau), int(post.ell))] = post
    return prep


def store_from_numpy(segments: Sequence[Mapping], sim: str, tau: float, *,
                     plan: JoinPlan, policy=None, device):
    """A :class:`~repro_torch.store.CorpusStore` over segments built
    elsewhere (such as the JAX package's store), with their caches filled.

    ``segments`` lists the base first, then each delta, as mappings with the
    keys of :func:`prepared_from_numpy` (``tokens``, ``lengths`` and
    optionally ``words`` and ``postings``) plus ``offset``, the segment's
    first store-global id.  The segments are carried as they are: the
    deltas enter the store as live deltas (not counted as ``appends``), and
    no cached artifact they bring is rebuilt.
    """
    from repro_torch.store.store import CorpusStore, Segment

    segments = list(segments)
    if not segments:
        raise ValueError("a store needs at least its base segment")
    preps, offset = [], 0
    for seg in segments:
        if int(seg["offset"]) != offset:
            raise ValueError(f"segment offsets must be contiguous from 0: expected "
                             f"{offset}, got {seg['offset']}")
        preps.append(prepared_from_numpy(
            seg["tokens"], seg["lengths"], words=seg.get("words"),
            postings=seg.get("postings", ()), device=device))
        offset += preps[-1].num_sets
    store = CorpusStore(preps[0], sim, tau, plan=plan, policy=policy, device=device)
    for prep, seg in zip(preps[1:], segments[1:]):
        store.deltas.append(Segment(prep, int(seg["offset"]), "delta"))
    return store


def prepared_bitmap_filter(
    prep_r: PreparedCollection,
    prep_s: Optional[PreparedCollection] = None,
    *,
    sim: str,
    tau: float,
    b: int = 64,
    method: str = BITMAP_COMBINED,
    mix: bool = False,
    use_cutoff: bool = True,
) -> BitmapFilter:
    """A :class:`~repro_torch.core.filters.BitmapFilter` over prepared
    collections.

    Reuses the prepared words (built on the prepared collections' device,
    no regeneration); index side R, probe side S (self-join when ``prep_s``
    is omitted).  Indices fed to ``prune_mask`` are in the prepared
    (length-sorted) space, as the CPU algorithms use with prepared inputs.
    """
    from repro_torch.core import expected

    chosen = bm.choose_method(float(tau), b) if method == BITMAP_COMBINED else method
    words_r = prep_r.bitmap_words_np(b, chosen, mix=mix)
    cutoff = (expected.cutoff_point(chosen, b, float(tau)) if use_cutoff
              else np.iinfo(np.int32).max)
    kw = {}
    if prep_s is not None and prep_s is not prep_r:
        kw = dict(probe_words=prep_s.bitmap_words_np(b, chosen, mix=mix),
                  probe_lengths=prep_s.lengths)
    return BitmapFilter(words=words_r, lengths=prep_r.lengths, sim=sim,
                        tau=tau, b=b, cutoff=int(cutoff), method=chosen, **kw)


# ---------------------------------------------------------------------------
# JoinEngine: prepare R once, stream probe batches against it
# ---------------------------------------------------------------------------

def _as_store(corpus):
    """``corpus`` if it is a :class:`repro_torch.store.CorpusStore`, else
    None.  Imported lazily: :mod:`repro_torch.store` layers over this module."""
    if type(corpus).__name__ != "CorpusStore":
        return None
    from repro_torch.store.store import CorpusStore
    return corpus if isinstance(corpus, CorpusStore) else None


@dataclasses.dataclass
class ProbeResult:
    pairs: np.ndarray       # int64[K, 2] (corpus_index, batch_index)
    stats: "object"         # JoinStats for this batch


class JoinEngine:
    """The serving shape: one prepared corpus, many probe batches.

    ``JoinEngine(corpus, sim, tau)`` prepares R once on ``device`` (the card
    when ``None``) and resolves a :class:`~repro_torch.core.plan.JoinPlan`
    for that device's backend (``cuda`` plans as ``"gpu"``).  Each
    :meth:`probe` joins one batch of S, prepared on the same device, against
    the corpus and returns ``(pairs, JoinStats)`` with pairs as
    ``(corpus_index, batch_index)`` in original indices; the corpus-side
    artifacts (words, windows, postings) are built once and reused.

    Pass ``mesh=`` / ``axis=`` (:func:`repro_torch.launch.mesh.make_mesh`)
    to execute a ``ring`` or ``sharded-indexed`` plan across the mesh's
    ranks: every rank builds the same engine over the same corpus and calls
    the same probes, and every rank gets the same pairs and ``JoinStats``.
    Without a mesh a ring plan runs ``blocked`` and a sharded-indexed plan
    ``indexed``, each recorded in ``fallbacks``, as the reference does.  An
    auto plan with a mesh counts its ranks as the devices.  A CPU-algorithm
    plan runs its algorithm over the prepared sorted views on the host, with
    the bitmap words built on the engine's device
    (:func:`prepared_bitmap_filter`).

    The corpus may also be a :class:`repro_torch.store.CorpusStore`: the
    engine then adopts the store's plan, sim, τ, device and mesh, and every
    probe and self-join runs the store's segment-union join (base ∪ deltas);
    :attr:`prepared` reads through to the store's live base segment across
    compactions.
    """

    #: Default bound on the per-probe ``JoinStats`` history.
    HISTORY_LIMIT = 1024

    def __init__(self, corpus: Collection | PreparedCollection,
                 sim: str = JACCARD, tau: float = 0.8, *,
                 plan: Optional[JoinPlan] = None,
                 planner: Optional[JoinPlanner] = None,
                 expected_batch: Optional[int] = None,
                 mesh=None, axis=None,
                 history_limit: Optional[int] = None,
                 device=None):
        self.store = _as_store(corpus)
        self._planner = planner or JoinPlanner()
        if self.store is not None:
            store = self.store
            if (sim, float(tau)) not in ((store.sim, store.tau), (JACCARD, 0.8)):
                raise ValueError(
                    f"engine asked for (sim={sim}, tau={tau}) but the store "
                    f"is (sim={store.sim}, tau={store.tau})")
            if plan is not None and plan != store.plan:
                raise ValueError(
                    "engine plan conflicts with the store's plan; the store "
                    "pins one plan for every segment join")
            if device is not None and torch.device(device) != store.device:
                raise ValueError(f"the store lives on {store.device}, not on "
                                 f"{torch.device(device)}")
            self.device = store.device
            self._prepared = store.base.prepared
            self.sim = store.sim
            self.tau = store.tau
            self.plan = store.plan
            self._auto_planned = False
            self.mesh = store.mesh
            self.axis = store.axis
        else:
            if device is None and isinstance(corpus, PreparedCollection):
                device = corpus.device
            self.device = resolve_device(device)
            self._prepared = prepare(corpus, self.device)
            self.sim = sim
            self.tau = float(tau)
            self._auto_planned = plan is None
            if plan is None:
                # A mesh or the card: the planner counts the ranks (or cards).
                n_dev = None if (self.device.type == "cuda" or mesh is not None) else 1
                plan = self._planner.plan(
                    sim, tau, n_r=self._prepared.num_sets, n_s=expected_batch,
                    backend=backend_of(self.device), n_devices=n_dev)
            self.plan = plan
            self.mesh = mesh
            self.axis = axis
        self.probes = 0
        if history_limit is None:
            history_limit = self.HISTORY_LIMIT
        # Bounded: keeps the newest `history_limit` JoinStats; the rollup in
        # stats_summary() accumulates over every probe regardless.
        self.history: Deque[object] = collections.deque(maxlen=history_limit)
        self.fallbacks: list = []
        self._totals: Dict[str, int] = collections.defaultdict(int)

    @property
    def prepared(self) -> PreparedCollection:
        """The corpus-side artifact: the store's live base segment in store
        mode (compaction swaps it), else the prepared corpus the engine was
        built on."""
        if self.store is not None:
            return self.store.base.prepared
        return self._prepared

    def attach_store(self, store) -> None:
        """Upgrade a frozen-corpus engine in place to serve ``store``, whose
        base must be this engine's prepared corpus under the same plan.
        History, fallbacks and the lifetime rollup carry over: this is how a
        resident session absorbs its first ``append()``."""
        if store.base.prepared is not self._prepared:
            raise ValueError(
                "store's base segment is not this engine's prepared corpus")
        if (store.sim, store.tau) != (self.sim, self.tau):
            raise ValueError(
                f"store is (sim={store.sim}, tau={store.tau}) but the engine "
                f"serves (sim={self.sim}, tau={self.tau})")
        if store.plan != self.plan:
            raise ValueError("store plan differs from the engine's plan")
        self.store = store
        self._auto_planned = False

    # -- public API ----------------------------------------------------------

    def probe(self, batch: Collection | PreparedCollection, *,
              return_stats: bool = True):
        """Join one batch of S against the prepared corpus.

        Returns ``(pairs, stats)`` (or just pairs with
        ``return_stats=False``); pairs are ``(corpus_index, batch_index)``
        int64 in the original index spaces of both collections.  Pass an
        already-prepared batch (on the engine's device) to reuse its caches
        across repeated probes.
        """
        pairs, stats = self._execute(batch)
        self.record_probe(stats)
        return (pairs, stats) if return_stats else pairs

    def record_probe(self, stats) -> None:
        """Account one probe's ``JoinStats``: bump the probe counter, append
        to the bounded history and fold the counters into the rollup."""
        self.probes += 1
        self.history.append(stats)
        for field in ("total_pairs", "blocks_total", "blocks_skipped",
                      "candidates", "verified_true", "overflow_blocks",
                      "candidates_generated", "postings_expanded"):
            self._totals[field] += getattr(stats, field, 0)

    def stats_summary(self) -> Dict[str, object]:
        """Lifetime rollup over every probe (not just the bounded history):
        summed funnel counters plus the derived ratios."""
        t = dict(self._totals)
        total = t.get("total_pairs", 0)
        cand = t.get("candidates", 0)
        return {
            "probes": self.probes,
            "history_len": len(self.history),
            "history_limit": self.history.maxlen,
            "fallbacks": len(self.fallbacks),
            **t,
            "filter_ratio": (1.0 - cand / total) if total else 0.0,
            "precision": (t.get("verified_true", 0) / cand) if cand else 1.0,
        }

    def self_join(self, *, return_stats: bool = False):
        """The corpus joined against itself under this engine's plan."""
        pairs, stats = self._execute(None)
        return (pairs, stats) if return_stats else pairs

    # -- execution -----------------------------------------------------------

    def _execute(self, batch):
        # Imported here: the drivers import this module.
        from repro_torch.core import join as join_mod

        if self.store is not None:
            # Segment-union join: the store runs base ∪ per-delta joins
            # through its own per-segment engines and sums the counters.
            if batch is None:
                return self.store.self_join(return_stats=True)
            return self.store.probe(batch, return_stats=True)

        plan = self.plan
        driver = plan.driver
        if driver == "ring" and self.mesh is None:
            self.fallbacks.append("ring plan without a mesh -> blocked")
            driver = "blocked"
        if driver == "sharded-indexed" and self.mesh is None:
            self.fallbacks.append(
                "sharded-indexed plan without a mesh -> indexed")
            driver = "indexed"
        if driver == "naive" and self._auto_planned and batch is not None:
            # Planned from the corpus size alone; a large batch would make
            # the dense oracle quadratic.
            cells = self.prepared.num_sets * batch.num_sets
            if cells > self._planner.naive_cells:
                self.fallbacks.append(
                    f"naive plan but this batch gives {cells} cells -> blocked")
                driver = "blocked"

        if driver == "naive":
            pairs = join_mod.naive_join(self.prepared, batch, self.sim, self.tau,
                                        device=self.device)
            n = len(pairs)
            stats = join_mod.JoinStats(total_pairs=n, candidates=n,
                                       verified_true=n, candidates_generated=n)
            return pairs, stats

        if driver == "blocked":
            return join_mod.blocked_bitmap_join(
                self.prepared, batch, self.sim, self.tau,
                b=plan.b, method=plan.method, mix=plan.mix, block=plan.block,
                impl=plan.impl, use_cutoff=plan.use_cutoff,
                compaction=plan.compaction, capacity=plan.capacity,
                return_stats=True)

        prep_s = None if batch is None else prepare(batch, self.device)
        if driver == "indexed":
            from repro_torch.index.candidates import indexed_join_prepared

            return indexed_join_prepared(
                self.prepared, prep_s, sim=self.sim, tau=self.tau,
                b=plan.b, method=plan.method, mix=plan.mix, ell=plan.ell,
                probe_block=plan.block, impl=plan.impl,
                use_cutoff=plan.use_cutoff, capacity=plan.capacity,
                return_stats=True)

        if driver == "sharded-indexed":
            from repro_torch.distributed.sharded_index import sharded_indexed_join_prepared

            # The per-rank funnel counters come back summed, so a probe
            # reports the same funnel as "indexed".
            return sharded_indexed_join_prepared(
                self.prepared, prep_s, mesh=self.mesh, axis=self.axis,
                sim=self.sim, tau=self.tau, b=plan.b, method=plan.method,
                mix=plan.mix, ell=plan.ell, probe_block=plan.block,
                impl=plan.impl, use_cutoff=plan.use_cutoff,
                capacity=plan.capacity, return_stats=True)

        if driver == "ring":
            pairs, counters, _overflow = join_mod.ring_join_prepared(
                self.prepared, prep_s, mesh=self.mesh, axis=self.axis,
                sim=self.sim, tau=self.tau, b=plan.b, method=plan.method,
                mix=plan.mix, use_cutoff=plan.use_cutoff, impl=plan.impl,
                capacity_per_step=plan.capacity, return_stats=True)
            # The ring applies no length window: every pair of non-empty
            # sets is bitmap-evaluated once (i < j for a self-join), so
            # total_pairs is that grid and filter_ratio the bitmap's pruning.
            nnz_r = int((self.prepared.lengths > 0).sum())
            if prep_s is None:
                total = nnz_r * (nnz_r - 1) // 2
            else:
                total = nnz_r * int((prep_s.lengths > 0).sum())
            stats = join_mod.JoinStats(
                total_pairs=total, candidates=int(counters[:, 0].sum()),
                verified_true=len(pairs), candidates_generated=total)
            return pairs, stats

        if driver in CPU_DRIVERS:
            from repro_torch.core import cpu_algos

            bf = prepared_bitmap_filter(
                self.prepared, prep_s, sim=self.sim, tau=self.tau, b=plan.b,
                method=plan.method, mix=plan.mix, use_cutoff=plan.use_cutoff)
            astats = cpu_algos.AlgoStats()
            algo = cpu_algos.ALGORITHMS[driver]
            pairs = algo(self.prepared, prep_s, self.sim, self.tau,
                         bitmap=bf, stats=astats)
            stats = join_mod.JoinStats(
                total_pairs=astats.candidates,
                candidates=astats.candidates - astats.bitmap_pruned,
                verified_true=astats.results,
                candidates_generated=astats.candidates)
            return pairs, stats

        raise ValueError(f"unknown driver {driver!r}")  # pragma: no cover
