"""The ``"indexed"`` join driver: candidate generation from a CSR prefix
index, feeding the bitmap filter and exact verification (the port of
``repro.index.candidates``).

Per probe chunk of S:

1. **Expand** — look up the probe prefix tokens in the postings index
   (:mod:`repro_torch.index.postings`) and expand the matching, length-window
   narrowed lists into a flat entry stream, sized by a host count prepass.
2. **Filter** — admit entries through the length window, the positional
   bound and the self-join triangle.
3. **Deduplicate** — sort the surviving ``(probe, set)`` keys and keep the
   unique ones, compacted into a fixed ``cap``-slot candidate buffer.
4. **Verify** — the pairwise bitmap verdict, exact integer verification,
   and compaction down to the verified pairs.

The stages are the three functions :func:`expand_and_filter`,
:func:`dedup_pairs` and :func:`verdict_and_verify`, with the reference's
signatures; :func:`_indexed_chunk_step` composes them.  On the card under
``impl="auto"``, steps 1–2 after the window lookups are one kernel
(:func:`repro_torch.kernels.ops.expand_filter`), and so is step 4 before its
compaction (:func:`repro_torch.kernels.ops.verdict_verify`), which reads the
candidates' words where they lie and verifies only the bitmap's survivors;
an explicit kernel impl runs the PyTorch compositions around the
``entry_filter`` and ``pair_verdict`` kernels instead, and CPU tensors the
plain versions.  Buffers keep the
reference's fixed ``cap`` shapes, so every counter matches it, and the host
reads back once per chunk: the four counts, then the verified pairs.  Every
gather index is clipped or masked as in the reference: on the card an index
out of range is a device-side fault, not a clamp.

A chunk whose expansion exceeds a forced ``capacity``, or the
``_MAX_AUTO_CAPACITY`` ceiling, escalates to a dense grid fallback
(``JoinStats.overflow_blocks``), so the result is exact for any capacity.

``JoinStats`` reports the candidate funnel: ``postings_expanded``
(pre-dedup entries) → ``candidates_generated`` (== ``total_pairs``: deduped
pairs the bitmap is evaluated on) → ``candidates`` (after the bitmap) →
``verified_true``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import bounds, expected, verify
from repro_torch.core.collection import Collection, split_join_args
from repro_torch.core.constants import BITMAP_COMBINED, JACCARD, PAD_TOKEN
from repro_torch.core.engine import PreparedCollection, as_prepared
from repro_torch.core.join import JoinStats, _bucket_capacity, _nonzero_capped
from repro_torch.index.postings import lookup_counts_host
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import prune_table_for

_INT32_MAX = int(np.iinfo(np.int32).max)
# Auto-sized chunk buffers are capped here; a chunk whose (exact, host
# int64) expansion count exceeds it escalates to the dense fallback instead
# of allocating multi-GiB device buffers (or wrapping int32 on device).
_MAX_AUTO_CAPACITY = 1 << 26


def _windowed_ranges(vocab, vocab_tid, post_key, probe_tokens, probe_prefix,
                     lo_r, hi_r, lp: int, scale: int):
    """Vocab lookup + window-narrowed CSR ranges per (probe, prefix pos).

    One ``searchsorted`` against the composite non-decreasing ``post_key``
    = ``tid * scale + length`` bounds each lookup to postings whose set
    length lies inside the probe's admissible window.

    Returns ``(range_start, count)``, both int32[C, lp] (count 0 where the
    prefix position is invalid or the token is unknown).
    """
    dev = probe_tokens.device
    ptoks = probe_tokens[:, :lp].contiguous()
    j = torch.searchsorted(vocab, ptoks).clamp_(0, vocab.shape[0] - 1)
    found = vocab[j] == ptoks
    tid = torch.where(found, vocab_tid[j], 0)
    evalid = found & (torch.arange(lp, device=dev)[None, :] < probe_prefix[:, None])
    base = tid * scale
    lo_c = lo_r.clamp(0, scale - 1)[:, None]
    hi_c = hi_r.clamp(0, scale - 1)[:, None]
    a = torch.searchsorted(post_key, (base + lo_c).contiguous())
    b = torch.searchsorted(post_key, (base + hi_c).contiguous(), right=True)
    cnt = torch.where(evalid, (b - a).clamp_(min=0), 0)
    return a.to(torch.int32), cnt.to(torch.int32)


def expansion_segments(vocab, vocab_tid, post_key, probe_tokens, probe_prefix,
                       lo_r, hi_r, lp: int, scale: int):
    """Stage 1's segments, one per (probe, prefix position) ``k = s_loc *
    lp + pos``: ``(rng_flat, cnt, seg_end)``, int32[C * lp] each, the
    window-narrowed CSR start and count and the counts' inclusive prefix
    sum (``seg_end[-1]`` is the chunk's expansion)."""
    rng_start, cnt2d = _windowed_ranges(vocab, vocab_tid, post_key, probe_tokens,
                                        probe_prefix, lo_r, hi_r, lp, scale)
    cnt = cnt2d.reshape(-1)
    return rng_start.reshape(-1), cnt, torch.cumsum(cnt, 0, dtype=torch.int32)


def expand_filter_operands(args, statics) -> tuple:
    """The positional operands of :func:`repro_torch.kernels.ops.expand_filter`
    (and of its kernel and plain version) from a chunk step's ``args`` and
    ``statics`` (:func:`chunk_step_spec`)."""
    (_, _, _, vocab, vocab_tid, post_set, post_pos, post_len, post_key, ptok, plen, _,
     ppre, lo, hi, _, s0) = args
    return (*expansion_segments(vocab, vocab_tid, post_key, ptok, ppre, lo, hi,
                                statics["lp"], statics["scale"]),
            post_set, post_pos, post_len, plen, lo, hi, s0)


def _expansion_count_host(post, tokens_np, ps_np, lo_np, hi_np,
                          lp: int, scale: int) -> int:
    """Count prepass on host numpy (int64-exact): the window-surviving
    postings entries this probe chunk expands to.  It sizes the chunk's
    capacity and guards it: an expansion that would wrap int32 or exhaust
    device memory is caught before anything is allocated.  (``scale`` is
    implied by ``post``; kept for call-site symmetry with the device step.)
    """
    cnt, _tid, valid = lookup_counts_host(post, tokens_np, ps_np, lo_np, hi_np, lp)
    return int(cnt[valid].sum())


def expand_and_filter(
    post_set, post_pos, post_len, post_key, vocab, vocab_tid,
    probe_tokens, probe_lengths, probe_prefix, lo_r, hi_r, s0,
    *, sim: str, tau: float, cap: int, lp: int, scale: int, self_join: bool,
    impl: str, table: torch.Tensor | None = None,
):
    """Stage 1: CSR expansion + per-entry admission filters over one
    postings view.  ``table`` is the int32 prune table covering both
    collections' lengths (built from the lengths when omitted).

    Returns ``(rr, ss, n_expanded)``: int32[cap] sentinel-keyed entry
    streams (pruned slots hold ``INT32_MAX``) ready for :func:`dedup_pairs`,
    plus the exact expansion count (an int32 device scalar).
    """
    # -- expand: window-narrowed CSR lookups per (probe, prefix position) --
    rng_flat, cnt, seg_end = expansion_segments(
        vocab, vocab_tid, post_key, probe_tokens, probe_prefix, lo_r, hi_r, lp, scale)
    n_expanded = seg_end[-1]

    rr, ss = kops.expand_filter(
        rng_flat, cnt, seg_end, post_set, post_pos, post_len, probe_lengths, lo_r, hi_r,
        s0, sim=sim, tau=tau, cap=cap, lp=lp, self_join=self_join, impl=impl, table=table)
    return rr, ss, n_expanded


def dedup_pairs(rr, ss, cap: int):
    """Stage 2: sort sentinel-keyed ``(probe, set)`` entries, keep uniques,
    compact into a ``cap``-slot buffer.

    One sort of the int64 key ``(ss << 32) | rr`` gives the reference's
    ``lexsort((rr, ss))`` order (s major, r minor, ``INT32_MAX`` sentinels
    last); equal keys are equal entries, so stability does not matter.
    Returns ``(cand_r, cand_s, n_generated)`` with slots ``>= n_generated``
    holding ``INT32_MAX``.
    """
    dev = rr.device
    key = (ss.to(torch.int64) << 32) | rr.to(torch.int64)
    key = torch.sort(key).values
    sr = (key & 0xFFFFFFFF).to(torch.int32)
    s2 = (key >> 32).to(torch.int32)
    first = torch.ones(1, dtype=torch.bool, device=dev)
    uniq = (s2 != _INT32_MAX) & torch.cat([first, key[1:] != key[:-1]])
    n_generated = uniq.sum(dtype=torch.int32)
    ui = _nonzero_capped(uniq, cap)[:, 0]
    slot_ok = torch.arange(cap, device=dev) < n_generated
    cand_r = torch.where(slot_ok, sr[ui], _INT32_MAX)
    cand_s = torch.where(slot_ok, s2[ui], _INT32_MAX)
    return cand_r, cand_s, n_generated


def verdict_and_verify(
    tokens_r, lengths_r, words_r, probe_tokens, probe_lengths, probe_words,
    cand_r, cand_s, slot_ok, need_tab, s0,
    *, sim: str, tau: float, cutoff: int, impl: str,
    return_masks: bool = False, table: torch.Tensor | None = None,
):
    """Stage 3: pairwise bitmap verdict → exact overlap verification →
    verified-only compaction, over a compacted candidate buffer.

    Returns ``(pairs, n_bitmap, n_verified)``; pair slots ``>= n_verified``
    are garbage.  ``return_masks=True`` also returns the per-slot
    bitmap-survivor and verified masks (``bool[cap]`` each).
    """
    cap = cand_r.shape[0]
    cand_mask, ok = kops.verdict_verify(
        tokens_r, lengths_r, words_r, probe_tokens, probe_lengths, probe_words,
        cand_r, cand_s, slot_ok, need_tab, sim=sim, tau=tau, cutoff=cutoff, impl=impl,
        table=table)
    n_bitmap = cand_mask.sum(dtype=torch.int32)
    n_verified = ok.sum(dtype=torch.int32)
    vi = _nonzero_capped(ok, cap)[:, 0]
    pairs = torch.stack([torch.where(slot_ok[vi], cand_r[vi], 0),
                         torch.where(slot_ok[vi], cand_s[vi], 0) + s0], dim=1)
    if return_masks:
        return pairs, n_bitmap, n_verified, cand_mask, ok
    return pairs, n_bitmap, n_verified


def _indexed_chunk_step(
    tokens_r, lengths_r, words_r,
    vocab, vocab_tid, post_set, post_pos, post_len, post_key,
    probe_tokens, probe_lengths, probe_words, probe_prefix, lo_r, hi_r,
    need_tab, s0,
    *, sim: str, tau: float, cap: int, lp: int, scale: int, self_join: bool,
    cutoff: int, impl: str, table: torch.Tensor | None = None,
):
    """One candidate-generation + verification step for a probe chunk: the
    three stages composed.  Everything stays on the device.

    Returns ``(pairs, n_expanded, n_generated, n_bitmap, n_verified)`` as
    device tensors: pairs are ``(r_sorted, s_sorted)`` ids (slots ``>=
    n_verified`` are garbage); ``n_expanded > cap`` means the entry stream
    was truncated (the driver pre-checks with the count prepass, so this
    happens only under a forced capacity it escalates anyway).
    """
    if table is None:
        table = prune_table_for(sim, tau, lengths_r, probe_lengths)
    rr, ss, n_expanded = expand_and_filter(
        post_set, post_pos, post_len, post_key, vocab, vocab_tid,
        probe_tokens, probe_lengths, probe_prefix, lo_r, hi_r, s0,
        sim=sim, tau=tau, cap=cap, lp=lp, scale=scale, self_join=self_join,
        impl=impl, table=table)
    cand_r, cand_s, n_generated = dedup_pairs(rr, ss, cap)
    del rr, ss
    slot_ok = torch.arange(cap, device=cand_r.device) < n_generated
    pairs, n_bitmap, n_verified = verdict_and_verify(
        tokens_r, lengths_r, words_r, probe_tokens, probe_lengths,
        probe_words, cand_r, cand_s, slot_ok, need_tab, s0,
        sim=sim, tau=tau, cutoff=cutoff, impl=impl, table=table)
    return pairs, n_expanded, n_generated, n_bitmap, n_verified


def _pad_chunk(a: torch.Tensor, rows: int, fill) -> torch.Tensor:
    pad = rows - a.shape[0]
    if pad == 0:
        return a
    tail = torch.full((pad, *a.shape[1:]), fill, dtype=a.dtype, device=a.device)
    return torch.cat([a, tail])


def probe_prefix_lengths(prep_s, sim: str, tau: float):
    """1-prefix schema lengths per probe row -> ``(ps_np int32[N], lp)``.

    Probe prefixes use the 1-prefix schema whatever the index's ℓ (an
    ℓ-prefix index is a superset of the 1-prefix one, so matches are only
    ever added, never lost).
    """
    ns = prep_s.num_sets
    ps_np = np.zeros(ns, dtype=np.int32)
    nz = prep_s.lengths > 0
    if nz.any():
        ps_np[nz] = bounds.prefix_length(
            sim, tau, prep_s.lengths[nz].astype(np.int64)).astype(np.int32)
    return ps_np, int(ps_np.max(initial=0))


def finish_pairs(prep_r, prep_s, self_join: bool, pairs_list) -> np.ndarray:
    """Concatenate sorted-space chunk pair buffers, remap through the
    prepared orders to original indices, canonicalize (i < j for a
    self-join) and lexsort."""
    if pairs_list:
        pairs = np.concatenate(pairs_list, axis=0)
        gi = prep_r.order[pairs[:, 0]]
        gj = prep_s.order[pairs[:, 1]]
        if self_join:
            pairs = np.stack([np.minimum(gi, gj), np.maximum(gi, gj)], axis=1)
        else:
            pairs = np.stack([gi, gj], axis=1)
        pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
        return pairs.astype(np.int64)
    return np.zeros((0, 2), dtype=np.int64)


def _dense_chunk_fallback(tokens_r, lengths_r, words_r, tokens_c, lengths_c,
                          words_c, lo_c, hi_c, s0, *, sim, tau, cutoff, impl,
                          self_join, table=None):
    """Dense escalation for a probe chunk whose expansion overflowed: grid
    verdict over R × chunk (``candidate_matrix``), window mask and
    compaction on the host, batched exact verification on the device.

    Returns ``(n_window_cells, n_bitmap, verified sorted-space pairs)``.
    """
    cand = kops.candidate_matrix(
        words_r, words_c, lengths_r, lengths_c, sim=sim, tau=float(tau),
        self_join=False, cutoff=int(cutoff), impl=impl, table=table).cpu().numpy()
    np_lr = lengths_r.cpu().numpy()
    np_ls = lengths_c.cpu().numpy()
    win = ((np_lr[:, None] >= np.asarray(lo_c)[None, :])
           & (np_lr[:, None] <= np.asarray(hi_c)[None, :])
           & (np_lr[:, None] > 0) & (np_ls[None, :] > 0))
    if self_join:
        win &= (np.arange(len(np_lr))[:, None]
                < (s0 + np.arange(len(np_ls)))[None, :])
    cand = cand & win
    n_win = int(win.sum())
    ii, jj = np.nonzero(cand)
    if len(ii) == 0:
        return n_win, 0, np.zeros((0, 2), dtype=np.int64)
    dev = tokens_r.device
    ok = verify.verify_pairs_rs(
        tokens_r, lengths_r, tokens_c, lengths_c,
        torch.from_numpy(ii).to(dev), torch.from_numpy(jj).to(dev),
        sim, float(tau)).cpu().numpy()
    pairs = np.stack([ii[ok], jj[ok] + s0], axis=1).astype(np.int64)
    return n_win, len(ii), pairs


def _chunk_inputs(prep_r, prep_s, sim, tau, b, chosen, mix):
    """Everything the chunk loop reads, built (or taken from the prepared
    caches) once per join."""
    self_join = prep_s is None
    if self_join:
        prep_s = prep_r
    if prep_s.device != prep_r.device:
        raise ValueError(f"R is prepared on {prep_r.device}, S on {prep_s.device}")
    dev = prep_r.device
    tokens_r, lengths_r = prep_r.device_arrays()
    words_r = prep_r.bitmap_words(b, chosen, mix=mix)
    if self_join:
        tokens_s, lengths_s, words_s = tokens_r, lengths_r, words_r
    else:
        tokens_s, lengths_s = prep_s.device_arrays()
        words_s = prep_s.bitmap_words(b, chosen, mix=mix)
    return dict(
        dev=dev, tokens_r=tokens_r, lengths_r=lengths_r, words_r=words_r,
        tokens_s=tokens_s, lengths_s=lengths_s, words_s=words_s,
        need_tab=verify.min_overlap_table_dev(sim, float(tau), prep_r.max_len,
                                              prep_s.max_len, dev),
        table=verify.prune_table_dev(sim, float(tau), prep_r.max_len,
                                     prep_s.max_len, dev))


def chunk_step_spec(
    prep_r: PreparedCollection,
    prep_s: PreparedCollection | None = None,
    *,
    sim: str = JACCARD,
    tau: float = 0.8,
    b: int = 128,
    method: str = BITMAP_COMBINED,
    mix: bool = False,
    ell: int = 1,
    probe_block: int = 4096,
    impl: str = "auto",
    use_cutoff: bool = True,
):
    """Concrete ``(args, statics)`` for one chunk step over the first probe
    chunk — exactly what :func:`indexed_join_prepared` dispatches, reified so
    callers can time ``_indexed_chunk_step(*args, **statics)`` in isolation
    or capture its kernels' operands at the driver's shapes.

    Raises ``ValueError`` for a degenerate spec (empty index or zero prefix
    lengths) where the driver would never dispatch the step at all.
    """
    self_join = prep_s is None
    chosen = bm.choose_method(tau, b) if method == BITMAP_COMBINED else method
    cutoff = (expected.cutoff_point(chosen, b, float(tau)) if use_cutoff
              else 1 << 30)
    post = prep_r.postings(sim, tau, ell)
    ps_np, lp = probe_prefix_lengths(prep_r if self_join else prep_s, sim, tau)
    if post.num_postings == 0 or lp == 0:
        raise ValueError("degenerate chunk spec: empty index or prefixes")
    d = _chunk_inputs(prep_r, prep_s, sim, tau, b, chosen, mix)
    if self_join:
        prep_s = prep_r
    lo_np, hi_np, lo_d, hi_d = prep_s.length_window_int(sim, tau)
    scale = post.max_len + 1
    cb = min(int(probe_block), prep_s.num_sets)
    n_exp = _expansion_count_host(
        post, prep_s.tokens[:cb], ps_np[:cb], lo_np[:cb], hi_np[:cb], lp, scale)
    cap = min(_bucket_capacity(max(n_exp, 1)), prep_r.num_sets * cb * lp)
    ps_d = torch.from_numpy(ps_np).to(d["dev"])
    args = (
        d["tokens_r"], d["lengths_r"], d["words_r"], *post.device_arrays(d["dev"]),
        _pad_chunk(d["tokens_s"][:cb], cb, PAD_TOKEN),
        _pad_chunk(d["lengths_s"][:cb], cb, 0),
        _pad_chunk(d["words_s"][:cb], cb, 0),
        _pad_chunk(ps_d[:cb], cb, 0),
        _pad_chunk(lo_d[:cb], cb, 0), _pad_chunk(hi_d[:cb], cb, 0),
        d["need_tab"], 0,
    )
    statics = dict(sim=sim, tau=float(tau), cap=cap, lp=lp, scale=scale,
                   self_join=self_join, cutoff=int(cutoff), impl=impl,
                   table=d["table"])
    return args, statics


def indexed_join_prepared(
    prep_r: PreparedCollection,
    prep_s: PreparedCollection | None = None,
    *,
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
    """Index-driven exact join over prepared inputs, on their device.

    The ℓ-prefix CSR postings index is built over R (cached on ``prep_r``
    per ``(sim, tau, ell)``); S streams through in ``probe_block``-sized
    chunks.  Self-join only when ``prep_s`` is omitted (the same object as
    both operands is a full R×S cross product, diagonal included).

    ``capacity=None`` sizes each chunk's buffer from the count prepass, so
    nothing overflows; an explicit capacity bounds device memory and
    escalates overflowing chunks to the dense fallback
    (``JoinStats.overflow_blocks``), preserving exactness.

    Returns lexicographically sorted int64[K, 2] pairs in original indices
    (``i < j`` for a self-join), with ``return_stats=True`` also the
    candidate-funnel ``JoinStats``.
    """
    self_join = prep_s is None
    chosen = bm.choose_method(tau, b) if method == BITMAP_COMBINED else method
    cutoff = (expected.cutoff_point(chosen, b, float(tau)) if use_cutoff
              else 1 << 30)
    stats = JoinStats()
    prep_s_eff = prep_r if self_join else prep_s
    nr, ns = prep_r.num_sets, prep_s_eff.num_sets

    def _finish(pairs_list):
        pairs = finish_pairs(prep_r, prep_s_eff, self_join, pairs_list)
        return (pairs, stats) if return_stats else pairs

    post = prep_r.postings(sim, tau, ell)
    ps_np, lp = probe_prefix_lengths(prep_s_eff, sim, tau)
    if nr == 0 or ns == 0 or post.num_postings == 0 or lp == 0:
        return _finish([])

    d = _chunk_inputs(prep_r, prep_s, sim, tau, b, chosen, mix)
    tokens_r, lengths_r, words_r = d["tokens_r"], d["lengths_r"], d["words_r"]
    tokens_s, lengths_s, words_s = d["tokens_s"], d["lengths_s"], d["words_s"]
    # Admissible |r| window per probe row (cached per (sim, tau) on S).
    lo_np, hi_np, lo_d, hi_d = prep_s_eff.length_window_int(sim, tau)
    ps_d = torch.from_numpy(ps_np).to(d["dev"])
    csr = post.device_arrays(d["dev"])
    scale = post.max_len + 1

    cb = int(probe_block)
    pairs_out: list[np.ndarray] = []
    for c0 in range(0, ns, cb):
        c1 = min(c0 + cb, ns)
        stats.blocks_total += 1
        n_exp = _expansion_count_host(
            post, prep_s_eff.tokens[c0:c1], ps_np[c0:c1],
            lo_np[c0:c1], hi_np[c0:c1], lp, scale)
        stats.postings_expanded += n_exp
        if n_exp == 0:
            stats.blocks_skipped += 1
            continue
        if capacity is None:
            cap = min(_bucket_capacity(n_exp), nr * (c1 - c0) * lp)
        else:
            cap = int(capacity)
        if n_exp > cap or n_exp > _MAX_AUTO_CAPACITY:
            # The entry stream would truncate (forced capacity) or the
            # auto-sized buffer would be unreasonably large (a hot-token
            # chunk): escalate the whole chunk to the dense grid.
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
        pairs_d, n_exp_d, n_gen, n_bm, n_ok = _indexed_chunk_step(
            tokens_r, lengths_r, words_r, *csr,
            _pad_chunk(tokens_s[c0:c1], cb, PAD_TOKEN),
            _pad_chunk(lengths_s[c0:c1], cb, 0),
            _pad_chunk(words_s[c0:c1], cb, 0),
            _pad_chunk(ps_d[c0:c1], cb, 0),
            _pad_chunk(lo_d[c0:c1], cb, 0), _pad_chunk(hi_d[c0:c1], cb, 0),
            d["need_tab"], c0,
            sim=sim, tau=float(tau), cap=cap, lp=lp, scale=scale,
            self_join=self_join, cutoff=int(cutoff), impl=impl, table=d["table"])
        # One read-back of the four counts, then the verified pairs only.
        _, n_gen, n_bm, k = torch.stack([n_exp_d, n_gen, n_bm, n_ok]).tolist()
        stats.total_pairs += n_gen
        stats.candidates_generated += n_gen
        stats.candidates += n_bm
        stats.verified_true += k
        if k:
            pairs_out.append(pairs_d[:k].cpu().numpy().astype(np.int64))

    return _finish(pairs_out)


def indexed_bitmap_join(
    col_r: Collection | PreparedCollection,
    col_s: Collection | PreparedCollection | str | None = None,
    sim: str = JACCARD,
    tau: float = 0.8,
    *,
    device=None,
    **kwargs,
):
    """Collection-level wrapper of :func:`indexed_join_prepared` (the
    ``blocked_bitmap_join`` calling convention: ``(col, sim, tau)`` for a
    self-join, ``(col_r, col_s, sim, tau)`` for R×S).  Plain collections are
    prepared on ``device`` (the card when ``None``); prepared ones reuse
    their caches."""
    col_s, sim, tau = split_join_args(col_s, sim, tau)
    prep_r = as_prepared(col_r, device)
    prep_s = None if col_s is None else as_prepared(col_s, prep_r.device)
    return indexed_join_prepared(prep_r, prep_s, sim=sim, tau=tau, **kwargs)
