"""The plain versions of the indexed driver's two stage kernels, on the CPU.

``ref.expand_filter_ref`` (the CSR expansion and entry admission that
``expand_filter`` fuses) and ``ref.verdict_verify_ref`` (the pairwise
verdict and exact verification that ``verdict_verify`` fuses) must equal,
exactly, both

* the unfused compositions (the PyTorch ops around the ``entry_filter``
  and ``pair_verdict`` kernels, which explicit impls run), written out
  below as a fixed yardstick (``_unfused_expand``, ``_unfused_verdict``), and
* the JAX package's stages, ``repro.index.candidates.expand_and_filter`` and
  ``verdict_and_verify`` (its plain path on the CPU), through the port's
  stages of the same names,

on a probe chunk of seeded collections: 4 similarities × τ ∈ {0.5,
0.6, 0.8, 0.95} (overlap: an absolute count, τ · 8) × self-join and R×S, the
verdict at W ∈ {1, 4, 32}; and at the edges: no expansion, a stream that
fills its capacity exactly, a segment longer than a kernel block, PAD probe
rows, empty sets, a cutoff below the lengths and a later chunk's offset.  The kernels themselves are
held against these plain versions on the card (``tests/test_torch_cuda.py``).

Exact verification binary-searches each probe row, as
``verify.pairwise_overlap`` does, so token rows must be sorted with their
PAD tail from ``length`` on: the last test asserts that of every collection
the join path takes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.index import candidates as jcand
from repro_torch.core import bounds, engine as tengine, verify
from repro_torch.core.collection import from_lists as tfrom_lists
from repro_torch.core.constants import PAD_TOKEN
from repro_torch.data import collections as tdata
from repro_torch.index import candidates as tcand
from repro_torch.kernels import ops, ref
from repro_torch.store import CorpusStore
from test_torch_join import _both, _sets

SIMS = ("jaccard", "cosine", "dice", "overlap")
TAUS = (0.5, 0.6, 0.8, 0.95)
WIDTHS = (1, 4, 32)
_INT32_MAX = 2**31 - 1
# One chunk holds every probe row: the driver sorts rows by length, so a
# small first chunk would hold only the shortest sets.
_BLOCK = 128


def _threshold(sim: str, tau: float) -> float:
    return float(max(1, round(tau * 8))) if sim == "overlap" else tau


# -- the unfused compositions, written out -----------------------------------

def _unfused_expand(rng_flat, cnt, seg_end, post_set, post_pos, post_len, probe_lengths,
                   lo_r, hi_r, s0, *, sim, tau, cap, lp, self_join, table):
    c = probe_lengths.shape[0]
    dev = rng_flat.device
    n_expanded = seg_end[-1]
    g = torch.arange(cap, dtype=torch.int32, device=dev)
    k = torch.searchsorted(seg_end, g, right=True).clamp_(0, c * lp - 1)
    in_range = g < n_expanded
    within = g - (seg_end[k] - cnt[k])
    pidx = (rng_flat[k] + within).clamp_(0, post_set.shape[0] - 1)
    r_idx = post_set[pidx]
    s_loc = torch.div(k, lp, rounding_mode="floor").to(torch.int32)
    keep = ops.entry_filter(
        post_len[pidx], post_pos[pidx],
        probe_lengths[s_loc], (k % lp).to(torch.int32),
        lo_r[s_loc], hi_r[s_loc],
        r_idx, s0 + s_loc, in_range,
        sim=sim, tau=tau, self_join=self_join, impl="ref", table=table)
    rr = torch.where(keep, r_idx, _INT32_MAX)
    ss = torch.where(keep, s_loc, _INT32_MAX)
    return rr, ss


def _unfused_verdict(tokens_r, lengths_r, words_r, probe_tokens, probe_lengths, probe_words,
                    cand_r, cand_s, slot_ok, need_tab, *, sim, tau, cutoff, table):
    safe_r = torch.where(slot_ok, cand_r, 0)
    safe_s = torch.where(slot_ok, cand_s, 0)
    bm_pass = ops.pair_verdict(
        words_r[safe_r], probe_words[safe_s],
        lengths_r[safe_r], probe_lengths[safe_s],
        sim=sim, tau=tau, cutoff=cutoff, impl="ref", table=table)
    cand_mask = slot_ok & bm_pass
    o = verify.pairwise_overlap(tokens_r[safe_r], probe_tokens[safe_s])
    need = bounds.min_overlap_gather(sim, need_tab, lengths_r[safe_r],
                                     probe_lengths[safe_s])
    return cand_mask, cand_mask & (o >= need)


# -- inputs --------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _collections(rs: bool):
    """``((jax R, jax S), (torch R, torch S))`` prepared; S is None for a
    self-join.  Each side holds an empty set."""
    sets_r = _sets("dup_heavy", seed=21, n=64) + [[]]
    sides = [sets_r]
    if rs:
        rng = np.random.default_rng(22)
        sets_s = _sets("skewed", seed=22, n=40) + [[]]
        for k in range(8):  # cross-collection near-duplicates
            src = sets_r[5 * k]
            sets_s[k] = src[: max(1, len(src) - int(rng.integers(2)))]
        sides.append(sets_s)
    pairs = [_both(s) for s in sides]
    jax_side = tuple(jengine.prepare(j) for j, _ in pairs) + (None,) * (not rs)
    torch_side = tuple(tengine.prepare(t, device="cpu") for _, t in pairs) + (None,) * (not rs)
    return jax_side, torch_side


def _specs(jprep, tprep, sim, tau, w):
    kw = dict(sim=sim, tau=tau, b=32 * w, probe_block=_BLOCK)
    return jcand.chunk_step_spec(*jprep, **kw), tcand.chunk_step_spec(*tprep, **kw)


def _stage1_args(args):
    """The arguments of ``expand_and_filter`` in a chunk step's ``args``."""
    return (*args[5:9], *args[3:5], args[9], args[10], *args[12:15], args[16])


def _jax_stages(jargs, words, st):
    """The reference's three stages, jitted once: stage 1, dedup, and stage 3
    (masks included) for each ``(words_r, probe_words)`` of ``words``."""
    def run(args, words):
        rr, ss, n_exp = jcand.expand_and_filter(
            *_stage1_args(args), sim=st["sim"], tau=st["tau"], cap=st["cap"],
            lp=st["lp"], scale=st["scale"], self_join=st["self_join"], impl=st["impl"])
        cr, cs, n_gen = jcand.dedup_pairs(rr, ss, st["cap"])
        slot_ok = jnp.arange(st["cap"]) < n_gen
        outs = [jcand.verdict_and_verify(
            args[0], args[1], wr, args[9], args[10], ws, cr, cs, slot_ok, args[15],
            args[16], sim=st["sim"], tau=st["tau"], cutoff=st["cutoff"], impl=st["impl"],
            return_masks=True) for wr, ws in words]
        return rr, ss, n_exp, cr, cs, n_gen, outs

    return jax.device_get(jax.jit(run)(jargs, words))


def _torch_stages(targs, words, st):
    """The port's stages on the CPU, each plain version checked against the
    unfused composition on the way; the same outputs as :func:`_jax_stages`."""
    tokens_r, lengths_r, ptok, plen, need_tab, s0 = (targs[i] for i in (0, 1, 9, 10, 15, 16))
    sim, tau, cap, lp, table = st["sim"], st["tau"], st["cap"], st["lp"], st["table"]
    ekw = dict(sim=sim, tau=tau, cap=cap, lp=lp, self_join=st["self_join"], table=table)
    eargs = tcand.expand_filter_operands(targs, st)
    plain = ref.expand_filter_ref(*eargs, **ekw)
    unfused = _unfused_expand(*eargs, **ekw)
    rr, ss, n_exp = tcand.expand_and_filter(
        *_stage1_args(targs), sim=sim, tau=tau, cap=cap, lp=lp, scale=st["scale"],
        self_join=st["self_join"], impl=st["impl"], table=table)
    for a, b in ((plain, unfused), ((rr, ss), plain)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    cr, cs, n_gen = tcand.dedup_pairs(rr, ss, cap)
    slot_ok = torch.arange(cap) < n_gen
    outs = []
    vkw = dict(sim=sim, tau=tau, cutoff=st["cutoff"], table=table)
    for wr, ws in words:
        vargs = (tokens_r, lengths_r, wr, ptok, plen, ws, cr, cs, slot_ok, need_tab)
        plain = ref.verdict_verify_ref(*vargs, **vkw)
        for other in (_unfused_verdict(*vargs, **vkw),
                      ops.verdict_verify(*vargs, **vkw, impl="ref_mxu")):
            assert all(torch.equal(x, y) for x, y in zip(plain, other))
        out = tcand.verdict_and_verify(*vargs, s0, impl=st["impl"], return_masks=True,
                                       **vkw)
        assert torch.equal(out[3], plain[0]) and torch.equal(out[4], plain[1])
        outs.append(out)
    return rr, ss, n_exp, cr, cs, n_gen, outs


def _assert_same_stages(want, got):
    """Entry streams, candidates, masks, counts and the verified pairs."""
    for w, g in zip(want[:6], got[:6]):
        assert np.array_equal(np.asarray(w), g.numpy())
    for w, g in zip(want[6], got[6]):
        pairs, n_bm, n_ok, cand_mask, ok = g
        assert int(w[1]) == int(n_bm) and int(w[2]) == int(n_ok)
        assert np.array_equal(np.asarray(w[3]), cand_mask.numpy())
        assert np.array_equal(np.asarray(w[4]), ok.numpy())
        k = int(n_ok)
        assert np.array_equal(np.asarray(w[0])[:k], pairs[:k].numpy())


def _run_both(jprep, tprep, sim, tau, edit=lambda args, st: (args, st)):
    """The first chunk's stages in both packages at every W, after ``edit``
    (applied alike to both packages' arguments and statics)."""
    specs = [_specs(jprep, tprep, sim, tau, w) for w in WIDTHS]
    (jargs, jst), (targs, tst) = specs[0]
    jargs, jst = edit(list(jargs), dict(jst))
    targs, tst = edit(list(targs), dict(tst))
    jwords = [(a[2], a[11]) for (a, _), _ in specs]
    twords = [(a[2], a[11]) for _, (a, _) in specs]
    if len(targs[9]) != len(twords[0][1]):  # PAD probe rows were appended
        pad = len(targs[9]) - len(twords[0][1])
        jwords = [(wr, jnp.concatenate([ws, jnp.zeros((pad, ws.shape[1]), ws.dtype)]))
                  for wr, ws in jwords]
        twords = [(wr, torch.cat([ws, ws.new_zeros(pad, ws.shape[1])])) for wr, ws in twords]
    got = _torch_stages(targs, twords, tst)
    _assert_same_stages(_jax_stages(jargs, jwords, jst), got)
    return got


@pytest.mark.parametrize("rs", [False, True], ids=["self", "rs"])
@pytest.mark.parametrize("tau", TAUS)
@pytest.mark.parametrize("sim", SIMS)
def test_stage_plain_versions_match_unfused_and_reference(sim, tau, rs):
    jprep, tprep = _collections(rs)
    got = _run_both(jprep, tprep, sim, _threshold(sim, tau))
    assert int(got[2]) > 0


def _append_pad_probe_rows(args, st, rows=5):
    """``rows`` PAD probe rows (length 0, no prefix) after the chunk's."""
    args = list(args)
    for i, fill in ((9, PAD_TOKEN), (10, 0), (12, 0), (13, 0), (14, 0)):
        a = args[i]
        tail = (jnp.full((rows, *a.shape[1:]), fill, a.dtype) if isinstance(a, jax.Array)
                else torch.full((rows, *a.shape[1:]), fill, dtype=a.dtype))
        args[i] = (jnp.concatenate([a, tail]) if isinstance(a, jax.Array)
                   else torch.cat([a, tail]))
    return args, st


def _cap_at_expansion(args, st):
    """The capacity cut to the chunk's exact expansion: the stream fills it."""
    return args, dict(st, cap=_expansion(args, st))


def _expansion(args, st):
    """The chunk's expansion count, from either package's arguments."""
    used = (3, 4, 5, 6, 7, 8, 9, 10, 12, 13, 14)
    targs = [torch.as_tensor(np.array(a)) if i in used else None
             for i, a in enumerate(args[:16])] + [args[16]]
    return int(tcand.expand_filter_operands(targs, st)[2][-1])


@functools.lru_cache(maxsize=None)
def _edge_collections(kind: str):
    if kind == "long_segment":
        j, t = _both(tdata.shared_token_lists(1500, 31))
        return (jengine.prepare(j), None), (tengine.prepare(t, device="cpu"), None)
    assert kind == "disjoint"  # R and S share no token: nothing expands
    (jr, tr), (js, ts) = _both(_sets("uniform", seed=7)), _both(
        [[t + 1000 for t in s] for s in _sets("uniform", seed=8, n=20)])
    return ((jengine.prepare(jr), jengine.prepare(js)),
            (tengine.prepare(tr, device="cpu"), tengine.prepare(ts, device="cpu")))


@pytest.mark.parametrize("edge", ["no_expansion", "fills_cap", "long_segment",
                                  "pad_probe_rows", "cutoff_below_lengths", "probe_offset"])
def test_stage_plain_versions_at_the_edges(edge):
    sim, tau = "jaccard", 0.5
    if edge == "no_expansion":
        jprep, tprep = _edge_collections("disjoint")
        got = _run_both(jprep, tprep, sim, tau)
        assert int(got[2]) == 0 and int(got[5]) == 0
        return
    if edge == "long_segment":
        jprep, tprep = _edge_collections("long_segment")
        got = _run_both(jprep, tprep, sim, tau)
        assert int(got[2]) > 2 * 1024
        return
    jprep, tprep = _collections(edge != "probe_offset")
    edit = {"fills_cap": _cap_at_expansion,
            "pad_probe_rows": _append_pad_probe_rows,
            "cutoff_below_lengths": lambda a, st: (a, dict(st, cutoff=2)),
            # a later chunk's offset: the self-join triangle moves with it
            "probe_offset": lambda a, st: (a[:16] + [7], st)}[edge]
    got = _run_both(jprep, tprep, sim, tau, edit)
    if edge == "fills_cap":
        assert int(got[2]) == len(got[0]) and (got[0] != _INT32_MAX).any()
    if edge == "cutoff_below_lengths":
        assert int(got[6][0][1]) > int(got[6][0][2])  # the cutoff passes, verification prunes


def test_expand_filter_ref_at_synthetic_edges():
    """Segments built by hand: empty ones between full ones, one longer than
    three kernel blocks, streams shorter than, equal to and longer than the
    capacity, against the unfused composition and a per-entry loop."""
    rng = np.random.default_rng(5)
    c, lp, npost = 6, 3, 5000
    cnt = np.zeros(c * lp, np.int32)
    cnt[[0, 6, 7, 11, 17]] = [7, 3300, 1, 40, 12]
    start = np.array([rng.integers(0, npost - n) if n else 0 for n in cnt], np.int32)
    post_set = rng.integers(0, 900, npost).astype(np.int32)
    post_pos = rng.integers(0, 3, npost).astype(np.int32)
    post_len = rng.integers(2, 25, npost).astype(np.int32)
    post_len[::9] = 0
    plen = np.array([9, 0, 14, 20, 5, 11], np.int32)
    lo = np.array([3, 0, 7, 10, 2, 6], np.int32)
    hi = np.array([15, 0, 20, 24, 8, 18], np.int32)
    t = torch.from_numpy
    seg_end = np.cumsum(cnt, dtype=np.int32)
    n = int(seg_end[-1])
    for sim, tau in (("jaccard", 0.5), ("cosine", 0.6)):
        table = t(bounds.prune_table(sim, tau, 25, 25))
        for cap in (n - 100, n, n + 1000):
            kept = 0
            for sj in (False, True):
                kw = dict(sim=sim, tau=tau, cap=cap, lp=lp, self_join=sj, table=table)
                args = (t(start), t(cnt), t(seg_end), t(post_set), t(post_pos),
                        t(post_len), t(plen), t(lo), t(hi), 300)
                got = ref.expand_filter_ref(*args, **kw)
                want = _unfused_expand(*args, **kw)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
                loop = _expand_loop(start, cnt, post_set, post_pos, post_len, plen, lo, hi,
                                    table.numpy(), cap, lp, 300, sim == "cosine", sj)
                assert np.array_equal(got[0].numpy(), loop[0])
                assert np.array_equal(got[1].numpy(), loop[1])
                kept += int((got[0] != _INT32_MAX).sum())
            assert 0 < kept < 2 * cap


def _expand_loop(start, cnt, post_set, post_pos, post_len, plen, lo, hi, table, cap, lp,
                 s0, key_prod, self_join):
    rr = np.full(cap, _INT32_MAX, np.int64)
    ss = np.full(cap, _INT32_MAX, np.int64)
    g = 0
    for k, n in enumerate(cnt):
        for j in range(n):
            if g >= cap:
                break
            p = start[k] + j
            s, pos = divmod(k, lp)
            lr, ls = post_len[p], plen[s]
            ok = lr > 0 and ls > 0 and lo[s] <= lr <= hi[s]
            ok = ok and 1 + min(lr - post_pos[p] - 1, ls - pos - 1) >= table[
                lr * ls if key_prod else lr + ls]
            ok = ok and (not self_join or post_set[p] < s0 + s)
            if ok:
                rr[g], ss[g] = post_set[p], s
            g += 1
    return rr, ss


def _assert_sorted_rows(tokens, lengths, what):
    tokens, lengths = np.asarray(tokens), np.asarray(lengths)
    width = tokens.shape[1]
    inside = np.arange(width)[None, :] < lengths[:, None]
    assert ((tokens >= 0) & (tokens < PAD_TOKEN) == inside).all(), what
    steps = np.diff(tokens.astype(np.int64), axis=1) > 0
    assert (steps | ~inside[:, 1:]).all(), what


def test_token_rows_are_sorted_with_a_pad_tail():
    """The row layout exact verification searches: strictly increasing
    tokens on [0, length), PAD after, in every collection the join path
    takes (the generators, ``from_lists``, the prepared sorted view, a
    store's collection after an append)."""
    cols = {
        "skewed": tdata.with_duplicates(tdata.skewed_collection(n_sets=3000, seed=1),
                                        n_clusters=40, seed=2),
        "uniform": tdata.uniform_collection(n_sets=2000, seed=3),
        "zipf": tdata.zipf_collection(n_sets=500, seed=4),
        "lists": tfrom_lists(_sets("dup_heavy", seed=5) + [[]] + _sets("skewed", seed=6),
                             pad_to=16),
    }
    for name, col in cols.items():
        _assert_sorted_rows(col.tokens, col.lengths, name)
        tok, lens = tengine.prepare(col, device="cpu").device_arrays()
        _assert_sorted_rows(tok.numpy(), lens.numpy(), f"{name} prepared")
    store = CorpusStore(cols["skewed"], "jaccard", 0.8, device="cpu")
    store.append(cols["lists"])
    merged = store.collection()
    _assert_sorted_rows(merged.tokens, merged.lengths, "store")
