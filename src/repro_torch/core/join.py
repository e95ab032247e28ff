"""Exact set-similarity join drivers (the port of ``repro.core.join``).

* :func:`naive_join` — Algorithm 1, the O(|R|·|S|) oracle.
* :func:`blocked_bitmap_join` — the paper's GPU Algorithm 8: a
  length-sorted collection, block-level length-filter early-outs, the fused
  bitmap verdict (a CUDA kernel), candidate compaction (on the host, or
  device-resident with ``compaction="device"``) and batched exact
  verification on the device.  The host drives the block loop.

Self-join is selected by omitting the second collection:
``naive_join(col, sim, tau)``; R×S by passing it:
``naive_join(col_r, col_s, sim, tau)``.  Self-joins return pairs ``(i, j)``
with ``i < j``; R×S joins return ``(r_index, s_index)``.  Both return
int64[K, 2] numpy arrays in original indices, sorted, and both drivers
agree with ``repro.core.join`` on the pairs and on every ``JoinStats``
counter.

Every entry point runs on the card unless the caller passes ``device``
(``"cpu"`` for the plain versions); see :func:`repro_torch.core.engine.prepare`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import bounds, expected, verify
from repro_torch.core.collection import Collection, split_join_args
from repro_torch.core.constants import BITMAP_COMBINED, JACCARD
from repro_torch.core.engine import PreparedCollection, as_prepared, resolve_device
from repro_torch.kernels import ops as kops


# ---------------------------------------------------------------------------
# Oracle
# ---------------------------------------------------------------------------

_NAIVE_CHUNK_ELEMS = 1 << 24   # (rows, NS, L) elements per overlap chunk


def naive_join(col_r: Collection, col_s: Collection | str | None = None,
               sim: str = JACCARD, tau: float = 0.8, *, device=None) -> np.ndarray:
    """Algorithm 1: all verified pairs as int64[K, 2].

    Self-join (``col_s`` omitted) returns pairs with i < j; R×S returns
    (r_index, s_index) over the full cross product.  The overlap matrix is
    computed on ``device`` in chunks of rows; the acceptance test is the
    float64 Table 1 need on the host.
    """
    col_s, sim, tau = split_join_args(col_s, sim, tau)
    if isinstance(col_r, PreparedCollection):
        col_r = col_r.source
    if isinstance(col_s, PreparedCollection):
        col_s = col_s.source
    self_join = col_s is None
    if self_join:
        col_s = col_r
    o = _overlap_matrix(col_r.tokens, col_s.tokens, resolve_device(device))
    len_r = np.asarray(col_r.lengths)
    len_s = np.asarray(col_s.lengths)
    need = bounds.equivalent_overlap(sim, tau, len_r[:, None], len_s[None, :])
    simmat = o >= need
    # Empty sets are never similar to anything (the vacuous 0 >= 0 case).
    simmat &= (len_r > 0)[:, None] & (len_s > 0)[None, :]
    if self_join:
        iu = np.triu_indices(col_r.num_sets, k=1)
        mask = simmat[iu]
        return np.stack([iu[0][mask], iu[1][mask]], axis=1).astype(np.int64)
    ii, jj = np.nonzero(simmat)
    return np.stack([ii, jj], axis=1).astype(np.int64)


def _overlap_matrix(tokens_r: np.ndarray, tokens_s: np.ndarray, device) -> np.ndarray:
    """int32[NR, NS] exact overlaps; (rows, NS, L) at a time on ``device``."""
    nr, lr = tokens_r.shape
    ns = tokens_s.shape[0]
    tr = torch.tensor(tokens_r, device=device)
    ts = torch.tensor(tokens_s, device=device)
    out = np.zeros((nr, ns), dtype=np.int32)
    rows = max(1, _NAIVE_CHUNK_ELEMS // max(ns * max(lr, tokens_s.shape[1]), 1))
    for r0 in range(0, nr, rows):
        r1 = min(r0 + rows, nr)
        a = tr[r0:r1, None, :].expand(r1 - r0, ns, lr).reshape(-1, lr)
        b = ts[None, :, :].expand(r1 - r0, ns, ts.shape[1]).reshape(-1, ts.shape[1])
        out[r0:r1] = verify.pairwise_overlap(a, b).reshape(r1 - r0, ns).cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# Blocked device join (Algorithm 8)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JoinStats:
    """Observability counters (paper Tables 9-10 are derived from these).

    ``total_pairs`` is the number of cells the bitmap filter's verdict was
    consumed on (window-surviving grid cells for the grid drivers).  The
    candidate funnel is ``candidates_generated`` (== ``total_pairs``) →
    ``candidates`` (after the bitmap) → ``verified_true``;
    ``postings_expanded`` is the indexed driver's pre-dedup volume (0 here).
    """

    total_pairs: int = 0          # pairs the bitmap verdict is consumed on
    blocks_total: int = 0         # block pairs walked
    blocks_skipped: int = 0       # pruned by the length filter
    candidates: int = 0           # pairs surviving the bitmap filter
    verified_true: int = 0        # final result size
    overflow_blocks: int = 0      # tiles escalated to the dense path
    candidates_generated: int = 0  # pre-bitmap candidate pairs (the funnel top)
    postings_expanded: int = 0    # indexed driver: pre-dedup postings entries

    @property
    def filter_ratio(self) -> float:
        """Fraction of length-surviving pairs pruned by the bitmap filter."""
        if self.total_pairs == 0:
            return 0.0
        return 1.0 - self.candidates / self.total_pairs

    @property
    def precision(self) -> float:
        """true positives / unfiltered (Section 5.1.3)."""
        if self.candidates == 0:
            return 1.0
        return self.verified_true / self.candidates

    def to_dict(self) -> dict:
        """Counters + derived ratios as plain JSON-able types."""
        d = dataclasses.asdict(self)
        d["filter_ratio"] = self.filter_ratio
        d["precision"] = self.precision
        return d


def _bucket_capacity(n: int, floor: int = 128) -> int:
    """Round a measured candidate count up to a power of two (>= floor)."""
    return max(floor, 1 << max(int(n) - 1, 0).bit_length())


def _nonzero_capped(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """int64[cap, mask.dim()]: the first ``cap`` nonzero indices in row-major
    order, zero-filled past the count (``jnp.nonzero(size=cap, fill_value=0)``)."""
    return torch.nonzero_static(mask, size=cap, fill_value=0)


def _resident_block_step(
    tokens_r, lengths_r, words_r, tokens_s, lengths_s, words_s,
    lo_s, hi_s, need_tab, prune_tab, r0, s0,
    *, sim: str, tau: float, cap: int, diag: bool, cutoff: int, impl: str,
    use_bitmap: bool = True,
):
    """One device-resident block-pair step (Algorithm 8's local candidate
    list): bitmap verdict -> integer length-window mask -> fixed-capacity
    compaction -> exact searchsorted verification -> compaction down to the
    verified pairs.  Only the compacted pairs and three counts reach the
    host; the dense verdict tile stays on the device.

    Returns ``(pairs, n_win, n_cand, n_ok)``: global sorted-index pairs
    int64[n_ok, 2] on the host when ``n_cand <= cap`` (else ``None``, and
    the caller escalates this block pair to the dense host path).
    """
    win = ((lengths_s[None, :] >= lo_s[:, None])
           & (lengths_s[None, :] <= hi_s[:, None])
           & (lengths_r[:, None] > 0) & (lengths_s[None, :] > 0))
    if diag:
        dev = win.device
        win &= (torch.arange(win.shape[0], device=dev)[:, None]
                < torch.arange(win.shape[1], device=dev)[None, :])
    if use_bitmap:
        cand = kops.candidate_matrix(
            words_r, words_s, lengths_r, lengths_s, sim=sim, tau=tau,
            self_join=False, cutoff=cutoff, impl=impl, table=prune_tab) & win
    else:
        cand = win
    n_win = win.sum(dtype=torch.int64)
    n_cand = cand.sum(dtype=torch.int64)
    idx = _nonzero_capped(cand, cap)
    ii, jj = idx[:, 0], idx[:, 1]
    slot_ok = torch.arange(cap, device=cand.device) < n_cand
    o = verify.pairwise_overlap(tokens_r[ii], tokens_s[jj])
    # Integer-exact acceptance: float thresholds only ever prune.
    need = bounds.min_overlap_gather(sim, need_tab, lengths_r[ii], lengths_s[jj])
    ok = slot_ok & (o >= need)
    n_ok = ok.sum(dtype=torch.int64)
    vi = _nonzero_capped(ok, cap)[:, 0]
    pairs = torch.stack([ii[vi] + r0, jj[vi] + s0], dim=1)
    n_win, n_cand, n_ok = torch.stack([n_win, n_cand, n_ok]).tolist()
    if n_cand > cap:
        return None, n_win, n_cand, n_ok
    return pairs[:n_ok].cpu().numpy(), n_win, n_cand, n_ok


def _dense_block_verify(
    tokens_r, lengths_r, words_r, tokens_s, lengths_s, words_s,
    np_len_r, np_len_s, r0, r1, s0, s1, prune_tab,
    *, sim, tau, cutoff, impl, diag, self_join, use_bitmap=True,
):
    """Host-compaction path for one block pair: dense mask -> ``np.nonzero``
    on the host -> batched exact verification on the device.  The classic
    route, and the escalation target when a resident tile overflows.

    Returns ``(n_win, n_cand, verified sorted-index pairs int64[K, 2])``.
    """
    win = _window_pair_mask(np_len_r[r0:r1], np_len_s[s0:s1], sim, tau)
    if diag:
        win = np.triu(win, k=1)
    if use_bitmap:
        cand = kops.candidate_matrix(
            words_r[r0:r1], words_s[s0:s1], lengths_r[r0:r1], lengths_s[s0:s1],
            sim=sim, tau=float(tau), self_join=False, cutoff=int(cutoff),
            impl=impl, table=prune_tab)
        # The verdict does not apply the length filter; intersect it so that
        # `candidates` never exceeds `total_pairs`.
        cand = cand.cpu().numpy() & win
    else:
        cand = win
    n_win = int(win.sum())
    ii, jj = np.nonzero(cand)
    if len(ii) == 0:
        return n_win, 0, np.zeros((0, 2), dtype=np.int64)
    dev = tokens_r.device
    gi = torch.from_numpy(ii + r0).to(dev)
    gj = torch.from_numpy(jj + s0).to(dev)
    if self_join:
        ok = verify.verify_pairs(tokens_r, lengths_r, gi, gj, sim, float(tau))
    else:
        ok = verify.verify_pairs_rs(tokens_r, lengths_r, tokens_s, lengths_s,
                                    gi, gj, sim, float(tau))
    ok = ok.cpu().numpy()
    pairs = np.stack([ii[ok] + r0, jj[ok] + s0], axis=1)
    return n_win, len(ii), pairs.astype(np.int64)


def blocked_bitmap_join(
    col_r: Collection | PreparedCollection,
    col_s: Collection | PreparedCollection | str | None = None,
    sim: str = JACCARD,
    tau: float = 0.8,
    *,
    b: int = 128,
    method: str = BITMAP_COMBINED,
    mix: bool = False,
    block: int = 4096,
    impl: str = "auto",
    use_cutoff: bool = True,
    use_bitmap: bool = True,
    compaction: str = "host",
    capacity: int | None = None,
    return_stats: bool = False,
    device=None,
):
    """Exact join; returns int64[K, 2] pairs in original indices.

    Plain ``Collection`` inputs are prepared on ``device`` (the card when
    ``None``); ``PreparedCollection`` inputs reuse their cached length sort,
    bitmap words and length windows.  The driver walks block pairs of the
    length-sorted collections — the full R×S grid, or the upper triangle of
    a self-join — and the Table 2 length window prunes whole block pairs.

    Surviving block pairs run one of two compaction modes:

    * ``compaction="host"`` — the dense verdict tile goes to the host,
      ``np.nonzero`` compacts it there, and the candidates go back for
      verification.
    * ``compaction="device"`` — the resident path: the tile-count prepass
      (``kops.count_candidates``) measures the candidate count, a
      power-of-two capacity is sized from it, and the step fuses verdict ->
      window mask -> fixed-capacity compaction -> exact verification, so only
      compacted pairs and counts reach the host.  An explicit ``capacity``
      skips the prepass; a block pair whose candidates exceed it is
      escalated to the dense host path (``JoinStats.overflow_blocks``).

    Both modes return identical pairs and ``JoinStats``.
    """
    col_s, sim, tau = split_join_args(col_s, sim, tau)
    prep_r = as_prepared(col_r, device)
    prep_s = None if col_s is None else as_prepared(col_s, prep_r.device)
    return blocked_bitmap_join_prepared(
        prep_r, prep_s, sim=sim, tau=tau, b=b, method=method, mix=mix,
        block=block, impl=impl, use_cutoff=use_cutoff, use_bitmap=use_bitmap,
        compaction=compaction, capacity=capacity, return_stats=return_stats)


def blocked_bitmap_join_prepared(
    prep_r: PreparedCollection,
    prep_s: PreparedCollection | None = None,
    *,
    sim: str = JACCARD,
    tau: float = 0.8,
    b: int = 128,
    method: str = BITMAP_COMBINED,
    mix: bool = False,
    block: int = 4096,
    impl: str = "auto",
    use_cutoff: bool = True,
    use_bitmap: bool = True,
    compaction: str = "host",
    capacity: int | None = None,
    return_stats: bool = False,
):
    """The blocked join over prepared inputs (see :func:`blocked_bitmap_join`),
    on the device the inputs are prepared on."""
    if compaction not in ("host", "device"):
        raise ValueError(f"compaction must be 'host' or 'device', got {compaction!r}")
    # Self-join ONLY when S is omitted: the same prepared object twice is an
    # R×S join over the full cross product.
    self_join = prep_s is None
    if self_join:
        prep_s = prep_r
    if prep_s.device != prep_r.device:
        raise ValueError(f"R is prepared on {prep_r.device}, S on {prep_s.device}")
    order_r, order_s = prep_r.order, prep_s.order
    nr, ns = prep_r.num_sets, prep_s.num_sets
    tokens_r, lengths_r = prep_r.device_arrays()
    tokens_s, lengths_s = prep_s.device_arrays()

    chosen = bm.choose_method(tau, b) if method == BITMAP_COMBINED else method
    cutoff = expected.cutoff_point(chosen, b, float(tau)) if use_cutoff else 1 << 30
    words_r = prep_r.bitmap_words(b, chosen, mix=mix)
    words_s = words_r if self_join else prep_s.bitmap_words(b, chosen, mix=mix)
    prune_tab = verify.prune_table_dev(sim, float(tau), prep_r.max_len,
                                       prep_s.max_len, prep_r.device)

    np_len_r = prep_r.lengths
    np_len_s = prep_s.lengths
    stats = JoinStats()
    pairs_out: list[np.ndarray] = []
    nb_r = math.ceil(nr / block)
    nb_s = math.ceil(ns / block)
    if compaction == "device":
        # Integer windows for every sorted row (block rows slice them).
        _, _, full_lo, full_hi = prep_r.length_window_int(sim, tau)
        need_tab = verify.min_overlap_table_dev(
            sim, float(tau), prep_r.max_len, prep_s.max_len, prep_r.device)

    for bi in range(nb_r):
        r0, r1 = bi * block, min((bi + 1) * block, nr)
        min_lr = int(np_len_r[r0])
        max_lr = int(np_len_r[r1 - 1])
        # Block-wide admissible |s| window [lo(min |r|), hi(max |r|)] (the
        # bounds are nondecreasing in |r|), integer-exact.
        blk_lo, blk_hi = bounds.length_window_int(
            sim, tau, np.array([max(min_lr, 1), max(max_lr, 1)]))
        lo_r0, hi_r1 = int(blk_lo[0]), int(blk_hi[1])
        for bj in range(bi if self_join else 0, nb_s):
            s0, s1 = bj * block, min((bj + 1) * block, ns)
            stats.blocks_total += 1
            min_ls = int(np_len_s[s0])
            max_ls = int(np_len_s[s1 - 1])
            # Length-sorted blocks: past the window, every later bj fails too ...
            if min_ls > hi_r1:
                stats.blocks_total += nb_s - bj - 1
                stats.blocks_skipped += nb_s - bj
                break
            # ... below it, only this bj fails.
            if max_ls < lo_r0:
                stats.blocks_skipped += 1
                continue
            diag = self_join and bi == bj
            dense_args = (tokens_r, lengths_r, words_r, tokens_s, lengths_s, words_s,
                          np_len_r, np_len_s, r0, r1, s0, s1, prune_tab)
            dense_kw = dict(sim=sim, tau=tau, cutoff=cutoff, impl=impl, diag=diag,
                            self_join=self_join, use_bitmap=use_bitmap)

            if compaction == "host":
                n_win, n_cand, vpairs = _dense_block_verify(*dense_args, **dense_kw)
                stats.total_pairs += n_win
                stats.candidates += n_cand
                stats.verified_true += len(vpairs)
                if len(vpairs):
                    pairs_out.append(np.stack(
                        [order_r[vpairs[:, 0]], order_s[vpairs[:, 1]]], axis=1))
                continue

            # --- device-resident compaction ---
            win_lo, win_hi = full_lo[r0:r1], full_hi[r0:r1]
            if capacity is None:
                # Tile-count prepass: size the capacity from the real counts.
                nwin_t, ncand_t = kops.count_candidates(
                    words_r[r0:r1], words_s[s0:s1],
                    lengths_r[r0:r1], lengths_s[s0:s1], win_lo, win_hi,
                    sim=sim, tau=float(tau), self_join=diag,
                    cutoff=int(cutoff), impl=impl, table=prune_tab)
                n_win, n_cand_pre = torch.stack(
                    [nwin_t.sum(dtype=torch.int64),
                     ncand_t.sum(dtype=torch.int64)]).tolist()
                stats.total_pairs += n_win
                if not use_bitmap:
                    n_cand_pre = n_win
                if n_cand_pre == 0:
                    continue
                cap = min(_bucket_capacity(n_cand_pre), (r1 - r0) * (s1 - s0))
            else:
                cap = int(capacity)
            vp, n_win_d, n_cand_d, n_ok_d = _resident_block_step(
                tokens_r[r0:r1], lengths_r[r0:r1], words_r[r0:r1],
                tokens_s[s0:s1], lengths_s[s0:s1], words_s[s0:s1],
                win_lo, win_hi, need_tab, prune_tab, r0, s0,
                sim=sim, tau=float(tau), cap=cap, diag=diag,
                cutoff=int(cutoff), impl=impl, use_bitmap=use_bitmap)
            if capacity is not None:
                stats.total_pairs += n_win_d
            stats.candidates += n_cand_d
            if vp is None:
                # The fixed-capacity list truncated this tile: re-run it
                # densely for exactness (the counts above are exact).
                stats.overflow_blocks += 1
                _, _, vp = _dense_block_verify(*dense_args, **dense_kw)
            stats.verified_true += len(vp)
            if len(vp):
                pairs_out.append(np.stack([order_r[vp[:, 0]], order_s[vp[:, 1]]], axis=1))

    if pairs_out:
        pairs = np.concatenate(pairs_out, axis=0)
        if self_join:
            lo = np.minimum(pairs[:, 0], pairs[:, 1])
            hi_ = np.maximum(pairs[:, 0], pairs[:, 1])
            pairs = np.stack([lo, hi_], axis=1)
        pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    else:
        pairs = np.zeros((0, 2), dtype=np.int64)
    # Grid driver: the funnel top is the windowed grid, on both paths.
    stats.candidates_generated = stats.total_pairs
    if return_stats:
        return pairs, stats
    return pairs


def _window_pair_mask(len_r: np.ndarray, len_s: np.ndarray, sim: str, tau: float) -> np.ndarray:
    """Integer-exact Table 2 window per pair: the same int test as the
    device-resident step, so both paths agree on ``total_pairs``."""
    lo_i, hi_i = bounds.length_window_int(sim, tau, len_r)
    ls = len_s[None, :]
    return ((ls >= lo_i[:, None]) & (ls <= hi_i[:, None])
            & (len_r[:, None] > 0) & (len_s[None, :] > 0))


# ---------------------------------------------------------------------------
# Distributed ring join (one process per device over torch.distributed)
# ---------------------------------------------------------------------------

# Candidate masks are counted and compacted a row band of at most this many
# elements at a time (the first ``cap`` survivors of each band, then of
# their union): a bool sum casts its band to int64 first, and no single
# compaction indexes past int32.
_NONZERO_BAND = 1 << 28
# Candidates of an overflowed ring tile are verified this many at a time.
_VERIFY_BATCH = 1 << 20


def _count_and_first_nonzero(mask: torch.Tensor, cap: int):
    """``(idx, n)`` for a 2-D mask of any size: :func:`_nonzero_capped`'s
    first ``cap`` nonzero ``(row, col)`` indices in row-major order,
    zero-filled, and the int64 count of nonzeros, both on the device."""
    rows = max(1, _NONZERO_BAND // max(mask.shape[1], 1))
    slots = torch.arange(cap, device=mask.device)
    idx, ok, counts = [], [], []
    for r0 in range(0, mask.shape[0], rows):
        band = mask[r0:r0 + rows]
        counts.append(band.sum(dtype=torch.int64))
        sub = _nonzero_capped(band, cap)
        sub[:, 0] += r0
        idx.append(sub)
        ok.append(slots < counts[-1])
    n = torch.stack(counts).sum()
    if len(idx) == 1:
        return idx[0], n
    idx, ok = torch.cat(idx), torch.cat(ok)
    first = _nonzero_capped(ok, cap)[:, 0]
    return torch.where((slots < n)[:, None], idx[first], 0), n


def _nonzero_banded(mask: torch.Tensor) -> torch.Tensor:
    """int64[K, 2]: every nonzero ``(row, col)`` of a 2-D mask of any size,
    in row-major order, on its device (one ``nonzero`` per row band)."""
    rows = max(1, _NONZERO_BAND // max(mask.shape[1], 1))
    parts = []
    for r0 in range(0, mask.shape[0], rows):
        nz = torch.nonzero(mask[r0:r0 + rows])
        nz[:, 0] += r0
        parts.append(nz)
    if not parts:
        return torch.zeros((0, 2), dtype=torch.int64, device=mask.device)
    return torch.cat(parts)


def _ring_step(tok, length, word, s_tok, s_len, s_word, gi0: int, gj0: int,
               need_tab, prune_tab, *, sim: str, tau: float, cutoff: int, impl: str,
               cap: int, rs_join: bool):
    """One ring step on one rank: the verdict of the local R shard (global
    rows from ``gi0``) against the S shard held (from ``gj0``), the triangle
    ``gi < gj`` on a self-join, compaction of the first ``cap`` candidates in
    row-major order, exact verification.  Returns device tensors ``(pairs
    int32[cap, 2], ok bool[cap], n_cand, n_ok, overflowed)``."""
    cand = kops.candidate_matrix(word, s_word, length, s_len, sim=sim, tau=tau,
                                 self_join=False, cutoff=cutoff, impl=impl,
                                 table=prune_tab)
    if not rs_join:
        cand.triu_(gi0 - gj0 + 1)   # gi < gj  <=>  j - i >= gi0 - gj0 + 1
    idx, n_cand = _count_and_first_nonzero(cand, cap)
    del cand
    ii, jj = idx[:, 0], idx[:, 1]
    slot_ok = torch.arange(cap, device=idx.device) < n_cand
    o = verify.pairwise_overlap(tok[ii], s_tok[jj])
    need = bounds.min_overlap_gather(sim, need_tab, length[ii], s_len[jj])
    ok = slot_ok & (o >= need)
    pairs = torch.stack([ii + gi0, jj + gj0], dim=1).to(torch.int32)
    return pairs, ok, n_cand, ok.sum(dtype=torch.int64), n_cand > cap


def ring_sweep(tok, length, word, s_tok, s_len, s_word, *, group, index: int, n_dev: int,
               sim: str, tau: float, need_tab, prune_tab, cutoff: int, impl: str, cap: int,
               rs_join: bool) -> list:
    """One rank's ring sweep: its R shard (``tok``, ``length``, ``word``;
    global rows from ``index * len(tok)``) against each S shard in turn,
    starting with its own (``s_*``), which moves one hop round the ring
    (:class:`~repro_torch.distributed.sharding.RingShift` over ``group``)
    while a step computes.  Returns the ``n_dev`` steps' :func:`_ring_step`
    results, on the device."""
    from repro_torch.distributed.sharding import RingShift

    shard_r, shard_s, ls = tok.shape[0], s_tok.shape[0], s_tok.shape[1]
    # The S shard travels as one int32 buffer: tokens | length | words.
    held = torch.cat([s_tok, s_len[:, None].to(s_tok.dtype), s_word.to(s_tok.dtype)], dim=1)
    shift = RingShift(group, index, n_dev, tok.device) if n_dev > 1 else None
    outbound = shift.outbound(held) if shift else None
    steps = []
    for t in range(n_dev):
        s_dev = (index - t) % n_dev
        hop = shift.start(outbound) if shift and t < n_dev - 1 else None
        steps.append(_ring_step(
            tok, length, word, held[:, :ls], held[:, ls].contiguous(),
            held[:, ls + 1:].contiguous(), index * shard_r, s_dev * shard_s, need_tab,
            prune_tab, sim=sim, tau=float(tau), cutoff=int(cutoff), impl=impl, cap=cap,
            rs_join=rs_join))
        if hop is not None:
            outbound, held = shift.finish(hop)
    return steps


def ring_join_sharded(
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    words: torch.Tensor,
    *,
    mesh,
    axis,
    sim: str,
    tau: float,
    tokens_s: torch.Tensor | None = None,
    lengths_s: torch.Tensor | None = None,
    words_s: torch.Tensor | None = None,
    cutoff: int = 1 << 30,
    impl: str = "auto",
    capacity_per_step: int | None = None,
):
    """Distributed exact join via a ring sweep, one rank per device.

    Every rank passes the same global tensors (on its own device).  R is
    sharded over ``axis``: rank ``i`` keeps rows ``i * |R| / n`` onwards, and
    at each of the ``n`` steps runs the bitmap verdict and exact
    verification of its R shard against the S shard it holds, while that
    shard (tokens, lengths and words in one buffer) moves one hop round the
    ring (``batch_isend_irecv`` to the next rank and from the previous one,
    posted before the step's compute and waited after it; on the card under
    NCCL, through host copies under gloo).  After ``n`` steps every pair has
    been examined once: the upper triangle (``i < j``) for a self-join (S
    omitted), the full R×S grid otherwise.

    Each step compacts its candidates into ``capacity_per_step`` slots, the
    first survivors in row-major order, and flags the step when there were
    more: :func:`ring_join` re-runs the flagged ``(device, step)`` tiles
    densely.  ``impl="auto"`` runs ``candidate_matrix_mxu`` on the card and
    the plain version on the CPU (the reference's default is ``"ref"``).
    The reference runs the sweep as a jitted ``shard_map`` memoized per
    static configuration (``_ring_entrypoint_cache``, ``_ring_sweep_fn``);
    eager ranks have nothing to trace, so nothing here caches.

    Returns numpy arrays, the same on every rank and equal to the
    reference's: ``pairs`` int32[n * n * cap, 2] global ``(i, j)`` ids
    (garbage where ``valid`` is False), ``valid`` bool[n * n * cap],
    ``counters`` int64[n, 3] per device (candidates, verified, overflowed
    steps) and ``overflow_steps`` bool[n, n] per ``[device, step]``.
    """
    from repro_torch.distributed.sharding import all_gather_stacked, join_axes

    rs_join = tokens_s is not None
    if rs_join and (lengths_s is None or words_s is None):
        raise ValueError("R×S ring join needs tokens_s, lengths_s and words_s")
    if not rs_join:
        tokens_s, lengths_s, words_s = tokens, lengths, words
    _axes, group, n_dev, my = join_axes(mesh, axis)
    n_r, n_s = tokens.shape[0], tokens_s.shape[0]
    if n_r % n_dev or n_s % n_dev:
        raise ValueError(
            f"collection sizes {n_r}x{n_s} must divide over {n_dev} devices (pad first)")
    shard_r, shard_s = n_r // n_dev, n_s // n_dev
    cap = int(capacity_per_step or max(8 * max(shard_r, shard_s), 128))
    dev = tokens.device
    lr, ls = int(tokens.shape[1]), int(tokens_s.shape[1])
    need_tab = verify.min_overlap_table_dev(sim, float(tau), lr, ls, dev)
    prune_tab = verify.prune_table_dev(sim, float(tau), lr, ls, dev)

    r_sl = slice(my * shard_r, (my + 1) * shard_r)
    s_sl = slice(my * shard_s, (my + 1) * shard_s)
    steps = ring_sweep(tokens[r_sl], lengths[r_sl], words[r_sl], tokens_s[s_sl],
                       lengths_s[s_sl], words_s[s_sl], group=group, index=my, n_dev=n_dev,
                       sim=sim, tau=tau, need_tab=need_tab, prune_tab=prune_tab,
                       cutoff=cutoff, impl=impl, cap=cap, rs_join=rs_join)

    pairs, ok, n_cand, n_ok, ovf = (list(x) for x in zip(*steps))
    counters = torch.stack([torch.stack(n_cand).sum(), torch.stack(n_ok).sum(),
                            torch.stack(ovf).sum()])
    # One gather of everything this rank found, as int64.
    mine = torch.cat([torch.cat(pairs).to(torch.int64).reshape(-1),
                      torch.cat(ok).to(torch.int64), torch.stack(ovf).to(torch.int64),
                      counters])
    every = all_gather_stacked(mine, group, n_dev, "cpu").numpy()
    n_p = n_dev * cap
    pairs = every[:, :2 * n_p].reshape(n_dev * n_p, 2).astype(np.int32)
    valid = every[:, 2 * n_p:3 * n_p].reshape(-1).astype(bool)
    overflow = every[:, 3 * n_p:3 * n_p + n_dev].astype(bool)
    return pairs, valid, every[:, 3 * n_p + n_dev:], overflow


def ring_join(
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    words: torch.Tensor,
    *,
    mesh,
    axis,
    sim: str,
    tau: float,
    tokens_s: torch.Tensor | None = None,
    lengths_s: torch.Tensor | None = None,
    words_s: torch.Tensor | None = None,
    cutoff: int = 1 << 30,
    impl: str = "auto",
    capacity_per_step: int | None = None,
    return_stats: bool = False,
):
    """Exact distributed join: the ring sweep plus a dense re-run of the
    tiles whose compaction overflowed.

    Every rank sees the same overflow flags (they come back gathered from
    :func:`ring_join_sharded`) and re-runs the same flagged ``(device,
    step)`` tiles, one R shard against the S shard it held at that step:
    the bitmap verdict, the triangle on a self-join, banded compaction of
    every candidate and exact verification in batches, all on the device;
    only the verified pairs reach the host.  Their complete pair sets
    replace the truncated ones; other tiles keep the ring's output.

    Returns lexsorted int64[K, 2] global indices, the same on every rank:
    ``(i, j)`` with ``i < j`` for a self-join, ``(r_index, s_index)``
    otherwise.  ``return_stats=True`` adds ``(counters, overflow_steps)``
    (see :func:`ring_join_sharded`), the verified counters reconciled with
    the re-runs, so ``counters[:, 1].sum() == len(pairs)``.
    """
    from repro_torch.distributed.sharding import join_axes

    rs_join = tokens_s is not None
    if not rs_join:
        tokens_s, lengths_s, words_s = tokens, lengths, words
    _axes, _group, n_dev, _my = join_axes(mesh, axis)
    shard_r = tokens.shape[0] // n_dev
    shard_s = tokens_s.shape[0] // n_dev

    pairs, valid, counters, overflow = ring_join_sharded(
        tokens, lengths, words, mesh=mesh, axis=axis, sim=sim, tau=tau,
        tokens_s=tokens_s if rs_join else None,
        lengths_s=lengths_s if rs_join else None,
        words_s=words_s if rs_join else None,
        cutoff=cutoff, impl=impl, capacity_per_step=capacity_per_step)
    cap = pairs.shape[0] // (n_dev * n_dev)
    p4 = pairs.reshape(n_dev, n_dev, cap, 2)
    v3 = valid.reshape(n_dev, n_dev, cap)
    out = [p4[v3 & ~overflow[:, :, None]].reshape(-1, 2)]
    if overflow.any():
        dev = tokens.device
        prune_tab = verify.prune_table_dev(sim, float(tau), int(tokens.shape[1]),
                                           int(tokens_s.shape[1]), dev)
    for d, t in zip(*np.nonzero(overflow)):
        d, t = int(d), int(t)
        s_dev = (d - t) % n_dev
        r_sl = slice(d * shard_r, (d + 1) * shard_r)
        s_sl = slice(s_dev * shard_s, (s_dev + 1) * shard_s)
        cand = kops.candidate_matrix(
            words[r_sl], words_s[s_sl], lengths[r_sl], lengths_s[s_sl], sim=sim,
            tau=float(tau), self_join=False, cutoff=int(cutoff), impl=impl,
            table=prune_tab)
        if not rs_join:
            cand.triu_(d * shard_r - s_dev * shard_s + 1)   # gi < gj, as in a step
        idx = _nonzero_banded(cand)
        del cand
        n_ok = 0
        for k0 in range(0, idx.shape[0], _VERIFY_BATCH):
            gi = idx[k0:k0 + _VERIFY_BATCH, 0] + d * shard_r
            gj = idx[k0:k0 + _VERIFY_BATCH, 1] + s_dev * shard_s
            ok = verify.verify_pairs_rs(tokens, lengths, tokens_s, lengths_s, gi, gj,
                                        sim, float(tau))
            found = torch.stack([gi[ok], gj[ok]], dim=1).cpu().numpy()
            n_ok += len(found)
            if len(found):
                out.append(found)
        # The ring step saw only the first cap candidates of this tile.
        counters[d, 1] += n_ok - int(v3[d, t].sum())
    merged = np.concatenate(out, axis=0).astype(np.int64)
    merged = merged[np.lexsort((merged[:, 1], merged[:, 0]))]
    if return_stats:
        return merged, counters, overflow
    return merged


def ring_join_prepared(
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
    use_cutoff: bool = True,
    impl: str = "auto",
    capacity_per_step: int | None = None,
    return_stats: bool = False,
):
    """:func:`ring_join` over prepared inputs, in original indices.

    Bitmap words come from the prepared caches (built once per ``(b,
    method, mix)``); both sides are padded on their device with empty sets
    up to a multiple of the device count (an empty set is similar to
    nothing, so padding never changes the result); pairs are mapped from
    the padded sorted space back to original indices: ``(i, j)`` with
    ``i < j`` for a self-join (S omitted), ``(r_index, s_index)``
    otherwise, lexsorted, exactly :func:`naive_join`'s pairs.  The default
    ``impl`` is ``"auto"`` (the reference's is ``"ref"``).

    With ``return_stats=True`` returns ``(pairs, counters, overflow_steps)``.
    """
    from repro_torch.core.constants import PAD_TOKEN
    from repro_torch.distributed.sharding import join_axes
    from repro_torch.index.candidates import _pad_chunk

    # Self-join ONLY when S is omitted: an explicit S, even the same object,
    # is the full R×S cross product.
    self_join = prep_s is None
    if self_join:
        prep_s = prep_r
    if prep_s.device != prep_r.device:
        raise ValueError(f"R is prepared on {prep_r.device}, S on {prep_s.device}")
    chosen = bm.choose_method(tau, b) if method == BITMAP_COMBINED else method
    cutoff = expected.cutoff_point(chosen, b, float(tau)) if use_cutoff else 1 << 30
    _axes, _group, n_dev, _my = join_axes(mesh, axis)
    nr, ns = prep_r.num_sets, prep_s.num_sets
    nr_pad = math.ceil(nr / n_dev) * n_dev
    ns_pad = math.ceil(ns / n_dev) * n_dev

    def padded(prep, n_pad):
        tokens, lengths = prep.device_arrays()
        # Empty sets hash to all-zero bitmaps: zero rows are their words.
        return (_pad_chunk(tokens, n_pad, PAD_TOKEN), _pad_chunk(lengths, n_pad, 0),
                _pad_chunk(prep.bitmap_words(b, chosen, mix=mix), n_pad, 0))

    tokens, lengths, words = padded(prep_r, nr_pad)
    rs_kw = {}
    if not self_join:
        rs_kw = dict(zip(("tokens_s", "lengths_s", "words_s"), padded(prep_s, ns_pad)))
    sorted_pairs, counters, overflow = ring_join(
        tokens, lengths, words, mesh=mesh, axis=axis, sim=sim, tau=float(tau),
        cutoff=int(cutoff), impl=impl, capacity_per_step=capacity_per_step,
        return_stats=True, **rs_kw)
    # Padded rows have length 0 and never pair; keep the guard anyway.
    keep = (sorted_pairs[:, 0] < nr) & (sorted_pairs[:, 1] < ns)
    sorted_pairs = sorted_pairs[keep]
    gi = prep_r.order[sorted_pairs[:, 0]]
    gj = prep_s.order[sorted_pairs[:, 1]]
    if self_join:
        pairs = np.stack([np.minimum(gi, gj), np.maximum(gi, gj)], axis=1)
    else:
        pairs = np.stack([gi, gj], axis=1)
    pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))].astype(np.int64)
    if return_stats:
        return pairs, counters, overflow
    return pairs
