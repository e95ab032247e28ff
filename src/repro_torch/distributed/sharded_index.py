"""The ``"sharded-indexed"`` join driver: the indexed driver's candidate
generation sharded over a device mesh (the port of
``repro.distributed.sharded_index``), one rank per device over
``torch.distributed``.

The ring driver shards the dense grid; this driver shards the index:

* **Build** — the corpus-side CSR postings index is cut into contiguous
  token slabs, one a rank, balanced by postings volume
  (:func:`repro_torch.index.postings.partition_postings`, cached on the
  :class:`~repro_torch.core.engine.PreparedCollection` with a
  ``builds["sharded_postings"]`` counter).  A rank uploads its own slab;
  every rank holds the whole R (tokens, lengths, words): verification is
  row-local, only candidate generation is sharded.
* **Probe** — every rank walks the same probe chunks and runs the indexed
  driver's stages 1 + 2 (:func:`~repro_torch.index.candidates.
  expand_and_filter`, :func:`~repro_torch.index.candidates.dedup_pairs`)
  against its slab: the sentinel-padded slab makes tokens of other slabs
  expand to nothing, so the slabs' expansions partition the chunk's.
* **Reduce** — an all-gather of the fixed-size ``cap`` candidate buffers, a
  global ``dedup_pairs`` (a pair reached through two slabs counts once),
  and each rank takes an equal ``cap``-slot slice of the unique list for
  stage 3 (:func:`~repro_torch.index.candidates.verdict_and_verify`), which
  rebalances verification when one slab is hot and makes the per-rank
  funnel counters sum to the single-device driver's.
* **Escalate** — a chunk whose exact host-prepass expansion exceeds a
  forced ``capacity`` or the auto ceiling runs the dense grid fallback on
  every rank (``JoinStats.overflow_blocks``).  The trigger is the total
  expansion, the single-device driver's own, so the funnel stays identical
  to it under any capacity.

The per-rank counters ``(expanded, slice, bitmap, verified)`` and the
verified pairs are all-gathered: every rank returns the same pairs and
summed ``JoinStats``.  On the card under ``impl="auto"`` stages 1 + 2 and 3
run the stage kernels ``expand_filter`` and ``verdict_verify``.  The
reference caches a traced shard_map step per static configuration
(``_sharded_chunk_fn``); eager ranks have nothing to trace or cache.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import expected
from repro_torch.core.collection import Collection, split_join_args
from repro_torch.core.constants import BITMAP_COMBINED, JACCARD, PAD_TOKEN
from repro_torch.core.engine import PreparedCollection, as_prepared
from repro_torch.core.join import JoinStats, _bucket_capacity
from repro_torch.distributed.sharding import all_gather_stacked, join_axes
from repro_torch.index.candidates import (
    _MAX_AUTO_CAPACITY,
    _chunk_inputs,
    _dense_chunk_fallback,
    _pad_chunk,
    dedup_pairs,
    expand_and_filter,
    finish_pairs,
    probe_prefix_lengths,
    verdict_and_verify,
)
from repro_torch.index.postings import shard_expansion_counts


def _sharded_chunk_step(slab, vocab, vocab_tid, tokens_r, lengths_r, words_r,
                        probe_tokens, probe_lengths, probe_words, probe_prefix,
                        lo_r, hi_r, need_tab, s0, *, group, n_dev: int, my: int,
                        sim: str, tau: float, cap: int, lp: int, scale: int,
                        self_join: bool, cutoff: int, impl: str, table):
    """One probe chunk on one rank: stages 1 + 2 on its slab, the
    all-gather-compact reduce, stage 3 on its slice.  Returns device tensors
    ``(pairs int32[cap, 2], counters int32[4])``, the counters being
    ``(expanded on the slab, slice candidates, bitmap survivors, verified)``."""
    post_set, post_pos, post_len, post_key = slab
    rr, ss, n_exp = expand_and_filter(
        post_set, post_pos, post_len, post_key, vocab, vocab_tid,
        probe_tokens, probe_lengths, probe_prefix, lo_r, hi_r, s0,
        sim=sim, tau=tau, cap=cap, lp=lp, scale=scale, self_join=self_join,
        impl=impl, table=table)
    cand_r, cand_s, _ = dedup_pairs(rr, ss, cap)
    del rr, ss
    every = all_gather_stacked(torch.stack([cand_r, cand_s]), group, n_dev)
    u_r, u_s, n_gen = dedup_pairs(every[:, 0].reshape(-1), every[:, 1].reshape(-1),
                                  n_dev * cap)
    start = my * cap
    sl_r, sl_s = u_r[start:start + cap], u_s[start:start + cap]
    slot_ok = (start + torch.arange(cap, device=sl_r.device)) < n_gen
    pairs, n_bm, n_ok = verdict_and_verify(
        tokens_r, lengths_r, words_r, probe_tokens, probe_lengths, probe_words,
        sl_r, sl_s, slot_ok, need_tab, s0, sim=sim, tau=tau, cutoff=cutoff,
        impl=impl, table=table)
    counters = torch.stack([n_exp, slot_ok.sum(dtype=torch.int32), n_bm, n_ok])
    return pairs, counters.to(torch.int32)


def sharded_indexed_join_prepared(
    prep_r: PreparedCollection,
    prep_s: PreparedCollection | None = None,
    *,
    mesh,
    axis=None,
    sim: str = JACCARD,
    tau: float = 0.8,
    b: int = 128,
    method: str = BITMAP_COMBINED,
    mix: bool = False,
    ell: int = 1,
    probe_block: int = 4096,
    impl: str = "auto",
    use_cutoff: bool = True,
    capacity: int | None = None,
    return_stats: bool = False,
):
    """Index-driven exact join sharded over a device mesh: the mesh twin of
    :func:`repro_torch.index.candidates.indexed_join_prepared`, with its
    knobs plus ``mesh`` / ``axis`` (``None``: all of the mesh's axes), its
    self-join contract (self-join only when ``prep_s`` is omitted) and its
    return shape.  Every rank of the mesh calls it with the same inputs and
    gets the same pairs and summed ``JoinStats``, identical to the
    single-device driver's for any shard count, probe block and capacity.

    ``capacity`` bounds each rank's buffers; a chunk whose exact total
    expansion exceeds it escalates to the dense grid path, as in the
    single-device driver.
    """
    _axes, group, n_dev, my = join_axes(mesh, axis)
    self_join = prep_s is None
    prep_s_eff = prep_r if self_join else prep_s
    chosen = bm.choose_method(tau, b) if method == BITMAP_COMBINED else method
    cutoff = (expected.cutoff_point(chosen, b, float(tau)) if use_cutoff
              else 1 << 30)
    nr, ns = prep_r.num_sets, prep_s_eff.num_sets
    stats = JoinStats()

    def _finish(pairs_list):
        pairs = finish_pairs(prep_r, prep_s_eff, self_join, pairs_list)
        return (pairs, stats) if return_stats else pairs

    sharded = prep_r.sharded_postings(sim, tau, ell, n_dev)
    post = sharded.base
    ps_np, lp = probe_prefix_lengths(prep_s_eff, sim, tau)
    if nr == 0 or ns == 0 or post.num_postings == 0 or lp == 0:
        return _finish([])

    d = _chunk_inputs(prep_r, prep_s, sim, tau, b, chosen, mix)
    tokens_r, lengths_r, words_r = d["tokens_r"], d["lengths_r"], d["words_r"]
    tokens_s, lengths_s, words_s = d["tokens_s"], d["lengths_s"], d["words_s"]
    lo_np, hi_np, lo_d, hi_d = prep_s_eff.length_window_int(sim, tau)
    ps_d = torch.from_numpy(ps_np).to(d["dev"])
    slab = sharded.device_arrays(d["dev"], my)
    vocab_d, tid_d = post.device_arrays(d["dev"])[:2]
    scale = post.max_len + 1

    cb = int(probe_block)
    pairs_out: list[np.ndarray] = []
    for c0 in range(0, ns, cb):
        c1 = min(c0 + cb, ns)
        stats.blocks_total += 1
        per_shard = shard_expansion_counts(
            sharded, prep_s_eff.tokens[c0:c1], ps_np[c0:c1],
            lo_np[c0:c1], hi_np[c0:c1], lp)
        n_exp = int(per_shard.sum())
        stats.postings_expanded += n_exp
        if n_exp == 0:
            stats.blocks_skipped += 1
            continue
        if capacity is None:
            cap = min(_bucket_capacity(int(per_shard.max())), nr * (c1 - c0) * lp)
        else:
            cap = int(capacity)
        if (capacity is not None and n_exp > cap) or n_exp > _MAX_AUTO_CAPACITY:
            # The single-device driver's trigger (the total expansion), so
            # the funnel stays identical under overflow, and no slab's
            # buffer can truncate on the fast path (a slab's count is at
            # most the total).  Every rank runs the same fallback.
            stats.overflow_blocks += 1
            n_win, n_bm, vpairs = _dense_chunk_fallback(
                tokens_r, lengths_r, words_r,
                tokens_s[c0:c1], lengths_s[c0:c1], words_s[c0:c1],
                lo_np[c0:c1], hi_np[c0:c1], c0,
                sim=sim, tau=tau, cutoff=cutoff, impl=impl,
                self_join=self_join, table=d["table"])
            stats.total_pairs += n_win
            stats.candidates_generated += n_win
            stats.candidates += n_bm
            stats.verified_true += len(vpairs)
            if len(vpairs):
                pairs_out.append(vpairs)
            continue
        pairs_d, counters_d = _sharded_chunk_step(
            slab, vocab_d, tid_d, tokens_r, lengths_r, words_r,
            _pad_chunk(tokens_s[c0:c1], cb, PAD_TOKEN),
            _pad_chunk(lengths_s[c0:c1], cb, 0),
            _pad_chunk(words_s[c0:c1], cb, 0),
            _pad_chunk(ps_d[c0:c1], cb, 0),
            _pad_chunk(lo_d[c0:c1], cb, 0), _pad_chunk(hi_d[c0:c1], cb, 0),
            d["need_tab"], c0, group=group, n_dev=n_dev, my=my,
            sim=sim, tau=float(tau), cap=cap, lp=lp, scale=scale,
            self_join=self_join, cutoff=int(cutoff), impl=impl, table=d["table"])
        counters = all_gather_stacked(counters_d, group, n_dev, "cpu").numpy()
        # The slices partition the globally deduped list, so their sums are
        # the single-device chunk's counters.
        n_gen = int(counters[:, 1].sum())
        stats.total_pairs += n_gen
        stats.candidates_generated += n_gen
        stats.candidates += int(counters[:, 2].sum())
        stats.verified_true += int(counters[:, 3].sum())
        k_max = int(counters[:, 3].max())
        if k_max:
            every = all_gather_stacked(pairs_d[:k_max], group, n_dev, "cpu").numpy()
            for r in range(n_dev):
                k = int(counters[r, 3])
                if k:
                    pairs_out.append(every[r, :k].astype(np.int64))

    return _finish(pairs_out)


def sharded_indexed_bitmap_join(
    col_r: Collection | PreparedCollection,
    col_s: Collection | PreparedCollection | str | None = None,
    sim: str = JACCARD,
    tau: float = 0.8,
    *,
    mesh,
    axis=None,
    device=None,
    **kwargs,
):
    """Collection-level wrapper of :func:`sharded_indexed_join_prepared` (the
    ``blocked_bitmap_join`` calling convention).  Plain collections are
    prepared on ``device`` (the card when ``None``); prepared ones reuse
    their caches, the token slabs included."""
    col_s, sim, tau = split_join_args(col_s, sim, tau)
    prep_r = as_prepared(col_r, device)
    prep_s = None if col_s is None else as_prepared(col_s, prep_r.device)
    return sharded_indexed_join_prepared(prep_r, prep_s, mesh=mesh, axis=axis,
                                         sim=sim, tau=tau, **kwargs)
