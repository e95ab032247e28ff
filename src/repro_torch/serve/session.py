"""The resident join session: one prepared corpus held on the device for the
session's lifetime, probed by coalesced, padded, pipelined request batches
(the port of ``repro.serve.session``).

``JoinEngine.probe`` amortises the build (prepare R once); the session
amortises the serve, hoisting every per-probe cost that is constant work out
of the request path:

* **Resident corpus** — the corpus-side artifacts (tokens and lengths,
  packed words, the postings CSR) go on the device when the session binds,
  so no probe rebuilds or re-uploads them; the build counters prove it.
* **Bucketed entrypoints** — merged batches are padded to power-of-two
  buckets (rows, token width, prefix width, candidate capacity), and each
  bucket's step callable is built once
  (:class:`repro_torch.serve.entrypoints.EntrypointCache`;
  ``stats_summary()["entrypoints"]["traces"]`` counts the builds).
* **Request coalescing** — the
  :class:`~repro_torch.serve.coalescer.RequestCoalescer` merges queued
  requests into one padded device batch per group; per-request pairs and
  ``JoinStats`` are scattered back out **identical to probing each request
  alone** (the per-probe-row funnel counters are summed per row on the
  device, so even the stats match a solo run).
* **Pooled transfers** — each batch is staged through the
  :class:`~repro_torch.serve.transfer.TransferPool` and its step dispatched
  before the previous batch's outputs are read, so the upload of batch N+1
  overlaps batch N's step (``pipeline_depth``).
* **Live corpus** — ``append()`` seals new documents as
  :mod:`repro_torch.store` delta segments between batches: the built
  entrypoints keep serving the untouched base (no new builds on append),
  delta results are merged in, and only compaction, which swaps the base,
  rebinds the resident tensors.

Routing: the coalesced path serves a request iff its solo probe would run
it as a single, non-overflowing indexed chunk; the session computes the
driver's own host count prepass per request and routes everything else
(oversized requests, forced-capacity overflows, pathological expansions,
non-indexed plans) through ``JoinEngine.probe`` itself.  The coalesced path
is a faster way to the same answer, never a second semantics.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import bounds, expected, verify
from repro_torch.core.collection import Collection
from repro_torch.core.constants import BITMAP_COMBINED, JACCARD, PAD_TOKEN
from repro_torch.core.engine import (JoinEngine, PreparedCollection, _as_store,
                                     prepare, resolve_device)
from repro_torch.core.join import JoinStats
from repro_torch.core.plan import JoinPlan, JoinPlanner, backend_of
from repro_torch.serve.coalescer import ProbeTicket, RequestCoalescer
from repro_torch.serve.entrypoints import EntrypointCache, pow2_bucket
from repro_torch.serve.transfer import TransferPool


def _probe_step_impl(tokens_r, lengths_r, words_r,
                     vocab, vocab_tid, post_set, post_pos, post_len, post_key,
                     probe_tokens, probe_lengths, probe_prefix, lo_r, hi_r,
                     need_tab, prune_tab,
                     *, sim: str, tau: float, b: int, method: str, mix: bool,
                     cap: int, lp: int, scale: int, cutoff: int, impl: str):
    """One serving step over a coalesced probe batch, on the device.

    The three stages of the indexed driver's chunk step
    (:func:`repro_torch.index.candidates._indexed_chunk_step`), with two
    serving additions: the probe bitmap words are generated inside the step,
    and the generated, bitmap-surviving and verified candidates are summed
    per probe row (``index_add_``), so per-request funnel counters can be
    recovered from the merged batch exactly.  ``prune_tab`` is the int32
    prune table covering the corpus's and the batch's lengths.

    Returns ``(pairs, n_verified, gen_rows, bm_rows, ok_rows)``.
    """
    from repro_torch.index.candidates import (dedup_pairs, expand_and_filter,
                                              verdict_and_verify)

    probe_words = bm.generate_bitmaps(probe_tokens, probe_lengths, b,
                                      method=method, mix=mix)
    rr, ss, _n_exp = expand_and_filter(
        post_set, post_pos, post_len, post_key, vocab, vocab_tid,
        probe_tokens, probe_lengths, probe_prefix, lo_r, hi_r, 0,
        sim=sim, tau=tau, cap=cap, lp=lp, scale=scale, self_join=False,
        impl=impl, table=prune_tab)
    cand_r, cand_s, n_gen = dedup_pairs(rr, ss, cap)
    del rr, ss
    slot_ok = torch.arange(cap, device=cand_r.device) < n_gen
    pairs, _n_bm, n_ok, bm_mask, ok_mask = verdict_and_verify(
        tokens_r, lengths_r, words_r, probe_tokens, probe_lengths,
        probe_words, cand_r, cand_s, slot_ok, need_tab, 0,
        sim=sim, tau=tau, cutoff=cutoff, impl=impl, return_masks=True,
        table=prune_tab)
    cb = probe_tokens.shape[0]
    safe_s = torch.where(slot_ok, cand_s, 0).to(torch.int64)

    def per_row(mask):
        return torch.zeros(cb, dtype=torch.int32, device=mask.device).index_add_(
            0, safe_s, mask.to(torch.int32))

    return pairs, n_ok, per_row(slot_ok), per_row(bm_mask), per_row(ok_mask)


class _FastRequest:
    """A coalesced-path request inside one merged batch."""

    __slots__ = ("ticket", "offset", "rows", "n_exp", "lp")

    def __init__(self, ticket, offset, rows, n_exp, lp):
        self.ticket = ticket
        self.offset = offset
        self.rows = rows
        self.n_exp = n_exp
        self.lp = lp


class JoinSession:
    """A long-lived serving session over one corpus, on one device.

    ``probe(batch)`` is the single-request path (submit + flush); an online
    service calls ``submit`` per arrival plus ``poll``/``flush``, letting
    the coalescer fill padded buckets under its max-batch / max-wait policy.
    The corpus is a collection, a prepared collection or a
    :class:`~repro_torch.store.CorpusStore`; the session runs on the store's
    or the prepared corpus's device, else on ``device`` (the card when
    ``None``).  ``stats_summary()`` reports the engine's lifetime funnel
    rollup plus the entrypoint-cache, transfer-pool, min-overlap-cache and
    coalescing counters.
    """

    def __init__(self, corpus, sim: str = JACCARD, tau: float = 0.8, *,
                 plan: Optional[JoinPlan] = None,
                 planner: Optional[JoinPlanner] = None,
                 max_batch: int = 512,
                 max_wait: float = 0.002,
                 pipeline_depth: int = 2,
                 history_limit: Optional[int] = None,
                 policy=None,
                 device=None):
        planner = planner or JoinPlanner()
        self.store = _as_store(corpus)
        if self.store is not None:
            # The store pinned one plan for every segment join; the session
            # serves under the same plan, or session = store = rebuild breaks.
            if plan is not None and plan != self.store.plan:
                raise ValueError("session plan conflicts with the store's")
            if device is not None and torch.device(device) != self.store.device:
                raise ValueError(f"the store lives on {self.store.device}, not on "
                                 f"{torch.device(device)}")
            plan = self.store.plan
            sim, tau = self.store.sim, self.store.tau
            self.device = self.store.device
            self._prepared = self.store.base.prepared
            self.engine = JoinEngine(self.store, history_limit=history_limit)
        else:
            if device is None and isinstance(corpus, PreparedCollection):
                device = corpus.device
            self.device = resolve_device(device)
            self._prepared = prepare(corpus, self.device)
            if plan is None:
                plan = planner.serving_plan(
                    sim, tau, n_r=max(self._prepared.num_sets, 1),
                    backend=backend_of(self.device))
            self.engine = JoinEngine(self._prepared, sim, tau, plan=plan,
                                     planner=planner,
                                     history_limit=history_limit,
                                     device=self.device)
        self.plan = plan
        self.sim = sim
        self.tau = float(tau)
        self._policy = policy
        # Solo-probe parity needs every coalescable request to be a single
        # driver chunk, so the merge ceiling never exceeds the chunk size.
        self.coalescer = RequestCoalescer(
            max_batch=min(int(max_batch), int(plan.block)),
            max_wait=max_wait)
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got "
                             f"{pipeline_depth}")
        self.pipeline_depth = int(pipeline_depth)
        self.entrypoints = EntrypointCache()
        # depth + 1 staging slots: the slot staged for batch N +
        # pipeline_depth is never one an in-flight batch is still reading.
        self.transfer = TransferPool(depth=self.pipeline_depth + 1,
                                     device=self.device)
        self._cap_hints: Dict[Tuple[int, int, int], int] = {}
        self.requests = 0
        self.coalesced_requests = 0
        self.sequential_requests = 0
        self.coalesced_batches = 0
        self.flushes = 0
        self.padded_rows = 0
        self.real_rows = 0
        self._bind_corpus()

    @property
    def prepared(self) -> PreparedCollection:
        """The resident corpus-side artifact: the store's live base segment
        in store mode (never stale across compactions), else the prepared
        corpus the session was built on."""
        if self.store is not None:
            return self.store.base.prepared
        return self._prepared

    def _bind_corpus(self) -> None:
        """(Re)build the resident fast path from the current base segment:
        everything corpus-side goes on the device now.  Called at
        construction and again only when compaction swaps the base;
        appends never come here."""
        plan, prepared = self.plan, self.prepared
        self._chosen = (bm.choose_method(self.tau, plan.b)
                        if plan.method == BITMAP_COMBINED else plan.method)
        self._cutoff = (expected.cutoff_point(self._chosen, plan.b, self.tau)
                        if plan.use_cutoff else 1 << 30)
        self._fast = plan.driver == "indexed" and prepared.num_sets > 0
        if self._fast:
            self._post = prepared.postings(self.sim, self.tau, plan.ell)
            if self._post.num_postings == 0:
                self._fast = False
        if self._fast:
            self._csr = self._post.device_arrays(self.device)
            self._scale = self._post.max_len + 1
            self._tokens_r, self._lengths_r = prepared.device_arrays()
            self._words_r = prepared.bitmap_words(plan.b, self._chosen,
                                                  mix=plan.mix)
            self._max_auto = self._default_max_auto()

    @staticmethod
    def _default_max_auto() -> int:
        from repro_torch.index.candidates import _MAX_AUTO_CAPACITY
        return _MAX_AUTO_CAPACITY

    # -- live corpus ---------------------------------------------------------

    def _ensure_store(self):
        """Turn a frozen-corpus session into an appendable one in place: the
        prepared corpus becomes the store's sealed base (nothing rebuilt,
        re-uploaded or re-built as an entrypoint) and the engine keeps its
        history through ``attach_store``."""
        if self.store is None:
            from repro_torch.store import CorpusStore
            store = CorpusStore(self._prepared, self.sim, self.tau,
                                plan=self.plan, policy=self._policy,
                                device=self.device)
            self.engine.attach_store(store)
            self.store = store
        return self.store

    def append(self, col: Collection, *, compact: bool | str = "auto"):
        """Absorb new documents between batches as a store delta (only the
        delta is prepared).  Later probes serve base ∪ deltas; the built
        entrypoints keep serving the untouched base.  If the compaction
        policy fires (or ``compact=True``), the deltas fold into a new base
        and the resident fast path rebinds to it.  Returns the new segment."""
        store = self._ensure_store()
        version = store.base_version
        seg = store.append(col, compact=compact)
        if store.base_version != version:
            self._bind_corpus()
        return seg

    def compact(self) -> bool:
        """Fold the session's deltas into a new sealed base and rebind the
        resident fast path to it.  Returns whether a merge happened (False
        on a frozen or delta-free session)."""
        if self.store is None or not self.store.compact():
            return False
        self._bind_corpus()
        return True

    # -- public API ----------------------------------------------------------

    def submit(self, request: Collection, *,
               now: Optional[float] = None) -> ProbeTicket:
        """Queue one probe request; returns its ticket (resolved by the next
        flush)."""
        self.requests += 1
        return self.coalescer.submit(request, now=now)

    def poll(self, now: Optional[float] = None) -> List[ProbeTicket]:
        """Flush iff the coalescer's max-batch / max-wait policy says so."""
        if self.coalescer.due(now):
            return self.flush()
        return []

    def probe(self, batch: Collection, *, return_stats: bool = True):
        """Single-request convenience with ``JoinEngine.probe`` semantics
        (and identical results)."""
        ticket = self.submit(batch)
        self.flush()
        pairs, stats = ticket.result()
        return (pairs, stats) if return_stats else pairs

    def flush(self) -> List[ProbeTicket]:
        """Drain the queue: coalesce, dispatch pipelined device batches,
        scatter per-request results onto the tickets."""
        groups = self.coalescer.drain()
        if not groups:
            return []
        self.flushes += 1
        done: List[ProbeTicket] = []
        inflight: collections.deque = collections.deque()
        for group in groups:
            fast, sequential = self._route(group)
            for ticket in sequential:
                self._probe_sequential(ticket)
                done.append(ticket)
            if fast:
                # Upload and dispatch now; block on the oldest in-flight
                # batch only once the pipeline is full.
                inflight.append(self._dispatch(fast))
                self.coalesced_batches += 1
                if len(inflight) > self.pipeline_depth:
                    done.extend(self._complete(inflight.popleft()))
        while inflight:
            done.extend(self._complete(inflight.popleft()))
        return done

    def warm_buckets(self, sample: Sequence[Collection]) -> int:
        """Build the coalesced entrypoint ladder before taking traffic.

        Given representative ``sample`` requests, flushes one synthetic
        group per power-of-two row bucket up to ``max_batch``; each rung
        calibrates its capacity hint and builds its entrypoint, so
        steady-state groups land on entrypoints that exist.  Results are
        discarded; engine and session counters do advance (warm-up is real
        traffic).  Returns the number of entrypoints built.  Steady-state
        traffic builds again only past the calibration: wider sets, longer
        prefixes, or group expansions beyond the calibrated capacity.
        """
        if not self._fast or not sample:
            return 0
        before = self.entrypoints.stats()["traces"]
        mb = self.coalescer.max_batch

        def flush_rows(target: int) -> None:
            rows = 0
            i = 0
            while rows < target:
                req = sample[i % len(sample)]
                if req.num_sets == 0 or rows + req.num_sets > target:
                    i += 1
                    if i > 4 * len(sample):  # the samples cannot tile the target
                        break
                    continue
                self.submit(req)
                rows += req.num_sets
                i += 1
            self.flush()

        # Calibrate the capacity hint on a full batch first, so the ladder
        # below builds every row bucket at the final (largest) capacity.
        flush_rows(mb)
        rung = 16  # the dispatch row-bucket floor
        while rung <= pow2_bucket(mb, floor=16):
            flush_rows(min(rung, mb))
            rung *= 2
        return self.entrypoints.stats()["traces"] - before

    def stats_summary(self) -> Dict[str, object]:
        """The session's observability rollup (engine funnel totals plus
        serving-layer counters)."""
        real = max(self.real_rows, 1)
        return {
            "engine": self.engine.stats_summary(),
            "entrypoints": self.entrypoints.stats(),
            "transfer": self.transfer.stats(),
            "min_overlap_cache": verify.min_overlap_cache_stats(),
            "requests": self.requests,
            "coalesced_requests": self.coalesced_requests,
            "sequential_requests": self.sequential_requests,
            "coalesced_batches": self.coalesced_batches,
            "flushes": self.flushes,
            "pad_overhead": self.padded_rows / real,
            "builds": self.prepared.build_counts(),
            "store": (self.store.stats().to_dict()
                      if self.store is not None else None),
        }

    # -- routing -------------------------------------------------------------

    def _route(self, group: Sequence[ProbeTicket]
               ) -> Tuple[List[_FastRequest], List[ProbeTicket]]:
        """Split one coalescer group into coalesced requests (with their
        solo-identical prepass counts) and sequential ones."""
        if not self._fast:
            return [], list(group)
        fast: List[_FastRequest] = []
        sequential: List[ProbeTicket] = []
        offset = 0
        forced = self.plan.capacity
        for ticket in group:
            rows = ticket.rows
            if rows == 0 or rows > self.coalescer.max_batch:
                sequential.append(ticket)
                continue
            n_exp, lp = self._prepass(ticket.request)
            if n_exp > self._max_auto or (forced is not None
                                          and n_exp > int(forced)):
                # A solo probe would escalate this chunk (forced-capacity
                # overflow or a pathological expansion): run it through the
                # engine, so the dense-fallback stats stay identical.
                sequential.append(ticket)
                continue
            fast.append(_FastRequest(ticket, offset, rows, n_exp, lp))
            offset += rows
        return fast, sequential

    def _prepass(self, request: Collection) -> Tuple[int, int]:
        """The driver's own host count prepass, per request: the exact
        postings expansion and this request's longest prefix."""
        from repro_torch.index.postings import lookup_counts_host

        lengths = request.lengths
        ps = np.zeros(request.num_sets, dtype=np.int32)
        nz = lengths > 0
        if nz.any():
            ps[nz] = bounds.prefix_length(
                self.sim, self.tau, lengths[nz].astype(np.int64)
            ).astype(np.int32)
        lp = int(ps.max(initial=0))
        if lp == 0:
            return 0, 0
        lo, hi = bounds.length_window_int(self.sim, self.tau, lengths)
        cnt, _tid, valid = lookup_counts_host(
            self._post, request.tokens, ps, lo, hi, lp)
        return int(cnt[valid].sum()), lp

    # -- the coalesced path --------------------------------------------------

    def _dispatch(self, fast: List[_FastRequest]) -> dict:
        rows_total = sum(f.rows for f in fast)
        cb = pow2_bucket(rows_total, floor=16)
        width = pow2_bucket(max(f.ticket.request.max_len for f in fast),
                            floor=8)
        lp = pow2_bucket(max(f.lp for f in fast), floor=1)
        width = max(width, lp)
        n_exp_total = sum(f.n_exp for f in fast)
        cap = pow2_bucket(max(n_exp_total, 1), floor=128)
        # A monotone capacity hint per shape bucket: reusing the largest
        # capacity seen for this bucket keeps one steady-state entrypoint
        # per bucket instead of minting new ones near capacity boundaries;
        # ``warm_buckets`` calibrates it before traffic.
        hint_key = (cb, width, lp)
        cap = max(cap, self._cap_hints.get(hint_key, 0))
        self._cap_hints[hint_key] = cap

        tokens = np.full((cb, width), PAD_TOKEN, dtype=np.int32)
        lengths = np.zeros((cb,), dtype=np.int32)
        prefix = np.zeros((cb,), dtype=np.int32)
        lo = np.zeros((cb,), dtype=np.int32)
        hi = np.zeros((cb,), dtype=np.int32)
        for f in fast:
            req = f.ticket.request
            o, n = f.offset, f.rows
            tokens[o:o + n, :req.max_len] = req.tokens
            lengths[o:o + n] = req.lengths
            nz = req.lengths > 0
            if nz.any():
                prefix[o:o + n][nz] = bounds.prefix_length(
                    self.sim, self.tau, req.lengths[nz].astype(np.int64)
                ).astype(np.int32)
            rlo, rhi = bounds.length_window_int(self.sim, self.tau,
                                                req.lengths)
            lo[o:o + n] = rlo
            hi[o:o + n] = rhi
        self.real_rows += rows_total
        self.padded_rows += cb - rows_total

        dev = self.transfer.upload((cb, width), [tokens, lengths, prefix,
                                                 lo, hi])
        lmax_r = self.prepared.max_len
        need_tab = verify.min_overlap_table_dev(self.sim, self.tau, lmax_r,
                                                int(width), self.device)
        prune_tab = verify.prune_table_dev(self.sim, self.tau, lmax_r,
                                           int(width), self.device)
        step = self._entrypoint(cb, width, lp, cap)
        outputs = step(self._tokens_r, self._lengths_r, self._words_r,
                       *self._csr, *dev, need_tab, prune_tab)
        return {"fast": fast, "outputs": outputs}

    def _entrypoint(self, cb: int, width: int, lp: int, cap: int):
        key = ("serve_probe", self.plan.driver, self.sim, self.tau,
               cb, width, lp, cap)
        statics = dict(sim=self.sim, tau=self.tau, b=self.plan.b,
                       method=self._chosen, mix=self.plan.mix, cap=cap,
                       lp=lp, scale=self._scale, cutoff=int(self._cutoff),
                       impl=self.plan.impl)
        cache = self.entrypoints

        def build():
            cache.note_trace(key)

            def step(*args):
                return _probe_step_impl(*args, **statics)
            return step

        return cache.get(key, build)

    def _complete(self, ctx: dict) -> List[ProbeTicket]:
        pairs_d, n_ok, gen_rows, bm_rows, ok_rows = ctx["outputs"]
        k = int(n_ok)                       # blocks on the step's results
        pairs = pairs_d[:k].cpu().numpy().astype(np.int64)
        gen_rows, bm_rows, ok_rows = torch.stack(
            [gen_rows, bm_rows, ok_rows]).cpu().numpy()
        gi = (self.prepared.order[pairs[:, 0]] if k
              else np.zeros((0,), dtype=np.int64))
        s = pairs[:, 1] if k else np.zeros((0,), dtype=np.int64)
        now = time.perf_counter()
        done = []
        live = self.store is not None and bool(self.store.deltas)
        for f in ctx["fast"]:
            o, n = f.offset, f.rows
            m = (s >= o) & (s < o + n)
            sub = np.stack([gi[m], s[m] - o], axis=1).astype(np.int64)
            sub = sub[np.lexsort((sub[:, 1], sub[:, 0]))]
            if f.lp == 0:
                # A solo probe returns before its chunk loop when no row
                # has a prefix: all-zero stats, not a skipped block.
                stats = JoinStats()
            else:
                g = int(gen_rows[o:o + n].sum())
                stats = JoinStats(
                    total_pairs=g,
                    blocks_total=1,
                    blocks_skipped=int(f.n_exp == 0),
                    candidates=int(bm_rows[o:o + n].sum()),
                    verified_true=int(ok_rows[o:o + n].sum()),
                    candidates_generated=g,
                    postings_expanded=f.n_exp)
            if live:
                # The device step served the sealed base; the delta part is
                # the same per-delta engine probes the sequential path runs,
                # so merged pairs and summed stats equal ``store.probe``'s
                # (base pairs are store-global already: the base is at 0).
                from repro_torch.store.store import merge_pairs, sum_stats
                dpairs, dstats = self.store.probe_deltas(f.ticket.request)
                if len(dpairs):
                    sub = merge_pairs([sub, dpairs])
                if dstats:
                    stats = sum_stats([stats] + dstats)
            t = f.ticket
            t.pairs, t.stats = sub, stats
            t.done, t.completed_at, t.route = True, now, "coalesced"
            self.engine.record_probe(stats)
            self.coalesced_requests += 1
            done.append(t)
        return done

    # -- the sequential path -------------------------------------------------

    def _probe_sequential(self, ticket: ProbeTicket) -> None:
        pairs, stats = self.engine.probe(ticket.request)
        ticket.pairs, ticket.stats = pairs, stats
        ticket.done = True
        ticket.completed_at = time.perf_counter()
        ticket.route = "sequential"
        self.sequential_requests += 1
