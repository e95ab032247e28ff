"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one.  The file imports neither JAX nor ``repro``, so it also runs on a GPU
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports the JAX package.)

The join kernels' outputs are integers or bools: those comparisons are
exact.  The flash-attention kernel is held against its plain version on
the same card tensors at rtol = atol = 2e-5 in float32 (TF32 off in
PyTorch; both float32 instances, the 3xTF32 one's prepass bit-identical to
its plain version) and 1e-2 in bf16 (both round p to bf16 against their own
running maxima, and round the output to bf16).  The backward kernel's dq,
dk and dv: float32 at 2e-5, bf16 within 5% relative RMS (``BWD_GRAD_REL``).
The bitmap build's words are compared bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import bitmap, bounds, engine, join
from repro_torch.core.collection import Collection
from repro_torch.core.constants import COSINE, PAD_TOKEN
from repro_torch.core.plan import JoinPlan
from repro_torch.data.collections import (near_duplicate_lists, shared_token_lists,
                                         skewed_collection, with_duplicates)
from repro_torch.index import candidates, indexed_bitmap_join
from repro_torch import configs
from repro_torch.kernels import bitmap_build, bitmap_filter, bitplane, compaction, ops
from repro_torch.kernels import postings, ref
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.models import DecodeEngine, Model
from repro_torch.models.generate import greedy_generate
from repro_torch.models.model import attention_applications
from repro_torch.serve import JoinSession
from repro_torch.store import CorpusStore

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(nr, ns, w, seed, dev, universe=150, max_len=60):
    """Xor bitmaps and sizes of random sets from a small universe (many
    overlapping pairs, so the verdict keeps some); every fourth set empty."""
    rng = np.random.default_rng(seed)

    def side(n):
        lens = rng.integers(1, max_len, n).astype(np.int32)
        lens[::4] = 0
        toks = np.full((n, max_len), PAD_TOKEN, np.int32)
        for i, l in enumerate(lens):
            toks[i, :l] = np.sort(rng.choice(universe, size=l, replace=False))
        t, l = torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev)
        return bitmap.generate_bitmaps(t, l, 32 * w, method="xor"), l

    (wr, lr), (ws, ls) = side(nr), side(ns)
    return wr, ws, lr, ls


CASES = [  # nr, ns, W, sim, tau, self_join, cutoff, tile
    (33, 70, 1, "jaccard", 0.6, False, 1 << 30, 32),
    (64, 64, 4, "cosine", 0.4, True, 1 << 30, 256),
    (300, 200, 128, "dice", 0.3, False, 40, 64),
    (257, 65, 128, "overlap", 3.0, True, 1 << 30, 256),
    (1000, 999, 4, "jaccard", 0.3, False, 20, 256),
]


@pytest.mark.parametrize("nr,ns,w,sim,tau,self_join,cutoff,tile", CASES)
def test_kernels_match_plain_versions(dev, nr, ns, w, sim, tau, self_join, cutoff, tile):
    wr, ws, lr, ls = _operands(nr, ns, w, nr + ns + w, dev)
    if self_join:
        ws, ls = wr, lr
    table = ref.prune_table_for(sim, tau, lr, ls)
    lo, hi = (torch.from_numpy(a).to(dev)
              for a in bounds.length_window_int(sim, tau, lr.cpu().numpy()))
    kw = dict(key_prod=sim == COSINE, self_join=self_join, cutoff=cutoff)
    got = bitmap_filter.candidate_matrix_cuda(wr, ws, lr, ls, table, **kw)
    want = ref.candidate_matrix_ref(wr, ws, lr, ls, sim=sim, tau=tau,
                                    self_join=self_join, cutoff=cutoff, table=table)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < want.numel() or cutoff < 1 << 30
    for window in (False, True):
        got_n = compaction.count_candidates_cuda(
            wr, ws, lr, ls, lo if window else None, hi if window else None, table,
            tile_r=tile, tile_s=tile, **kw)
        want_n = ref.count_candidates_ref(
            wr, ws, lr, ls, lo, hi, sim=sim, tau=tau, self_join=self_join,
            cutoff=cutoff, window=window, tile_r=tile, tile_s=tile, table=table)
        assert all(torch.equal(g, r) for g, r in zip(got_n, want_n))


def test_launch_counters_count_launches(dev):
    """``auto`` launches the tensor-core verdict kernels at b = 128 too (the
    form the card measured faster); ``swar`` the packed-word ones."""
    wr, ws, lr, ls = _operands(70, 50, 4, 1, dev)
    counters = (bitmap_filter.candidate_matrix_mxu_cuda, compaction.count_candidates_mxu_cuda,
                bitmap_filter.candidate_matrix_cuda, compaction.count_candidates_cuda)
    before = [f.launches for f in counters]
    ops.candidate_matrix(wr, ws, lr, ls, "jaccard", 0.8, False)
    ops.count_candidates(wr, ws, lr, ls, lr, lr, "jaccard", 0.8)
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 0, 0]
    ops.candidate_matrix(wr, ws, lr, ls, "jaccard", 0.8, False, impl="swar")
    ops.count_candidates(wr, ws, lr, ls, lr, lr, "jaccard", 0.8, impl="swar")
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1, 1]


# -- the tensor-core verdict kernels (candidate_matrix_mxu, count_candidates_mxu) --

# The sweep of W (1, 4, 8, 12, 32, 128) and the kernels' 128 x 256 work-tile
# edges (NR, NS in {127, 128, 129, 255, 256, 257}); NS % 16 != 0 in most.
MXU_SHAPES = [(33, 70, 1), (300, 200, 4), (129, 257, 8), (255, 127, 12), (256, 256, 32),
              (257, 129, 128), (127, 255, 4), (128, 128, 1), (1000, 999, 4)]
# sim, tau, self_join, cutoff: every key kind, the cutoff hit and not.
MXU_VERDICTS = [("jaccard", 0.6, False, 1 << 30), ("cosine", 0.75, True, 1 << 30),
                ("dice", 0.5, False, 12), ("overlap", 3.0, True, 12)]
# Count tiles: the sweeps' 32 and 64, ops' 256, and 20 (not a multiple of 8:
# the kernel's per-pair path).
MXU_TILES = (32, 64, 256, 20)


def _verdict_operands(nr, ns, w, kind, dev):
    if kind == "sets":
        return _operands(nr, ns, w, nr + ns + w, dev)
    (wr, lr), (ws, ls) = _random_words(nr, w, nr, dev), _random_words(ns, w, ns + 1, dev)
    if kind == "all_pass":     # identical zero bitmaps, equal sizes: ub == |r|
        wr.zero_(), ws.zero_(), lr.fill_(20), ls.fill_(20)
    elif kind == "all_prune":  # random words, tiny sets: ub < 0
        lr.fill_(2), ls.fill_(2)
    return wr, ws, lr, ls


@pytest.mark.parametrize("nr,ns,w", MXU_SHAPES)
@pytest.mark.parametrize("kind", ["sets", "random", "all_pass", "all_prune"])
def test_mxu_verdict_kernels_match_plain_versions(dev, nr, ns, w, kind):
    wr, ws, lr, ls = _verdict_operands(nr, ns, w, kind, dev)
    for sim, tau, self_join, cutoff in MXU_VERDICTS:
        r_words, r_len = (wr, lr)
        s_words, s_len = (wr, lr) if self_join else (ws, ls)
        table = ref.prune_table_for(sim, tau, r_len, s_len)
        kw = dict(key_prod=sim == COSINE, self_join=self_join, cutoff=cutoff)
        got = bitmap_filter.candidate_matrix_mxu_cuda(r_words, s_words, r_len, s_len, table,
                                                      **kw)
        want = ref.candidate_matrix_ref(r_words, s_words, r_len, s_len, sim=sim, tau=tau,
                                        self_join=self_join, cutoff=cutoff, table=table)
        assert torch.equal(got, want), (sim, self_join, cutoff)
        lo, hi = (torch.from_numpy(a).to(dev)
                  for a in bounds.length_window_int(sim, tau, r_len.cpu().numpy()))
        for tile in MXU_TILES:
            for window in (False, True):
                got_n = compaction.count_candidates_mxu_cuda(
                    r_words, s_words, r_len, s_len, lo if window else None,
                    hi if window else None, table, tile_r=tile, tile_s=tile, **kw)
                want_n = ref.count_candidates_ref(
                    r_words, s_words, r_len, s_len, lo, hi, sim=sim, tau=tau,
                    self_join=self_join, cutoff=cutoff, window=window, tile_r=tile,
                    tile_s=tile, table=table)
                assert all(torch.equal(g, r) for g, r in zip(got_n, want_n)), \
                    (sim, self_join, cutoff, tile, window)


@pytest.mark.parametrize("b", [128, 1024])
def test_mxu_and_swar_verdict_kernels_agree(dev, b):
    """The two forms of each dense verdict give equal results through ops,
    at the blocked join's two widths."""
    wr, ws, lr, ls = _operands(700, 650, b // 32, b, dev)
    kept = 0
    for sim, tau, self_join, cutoff in MXU_VERDICTS:
        s_words, s_len = (wr, lr) if self_join else (ws, ls)
        args = (wr, s_words, lr, s_len)
        lo, hi = (torch.from_numpy(a).to(dev)
                  for a in bounds.length_window_int(sim, tau, lr.cpu().numpy()))
        mxu = ops.candidate_matrix(*args, sim, tau, self_join, cutoff, impl="mxu")
        assert torch.equal(mxu, ops.candidate_matrix(*args, sim, tau, self_join, cutoff,
                                                     impl="swar"))
        kept += int(mxu.sum())
        for tile in (64, 256):
            kw = dict(self_join=self_join, cutoff=cutoff, tile=tile)
            got = ops.count_candidates(*args, lo, hi, sim, tau, impl="mxu", **kw)
            want = ops.count_candidates(*args, lo, hi, sim, tau, impl="swar", **kw)
            assert all(torch.equal(g, r) for g, r in zip(got, want))
    assert kept > 0


def test_mxu_verdict_wrappers_reject_bad_operands(dev):
    wr, ws, lr, ls = _operands(8, 8, 4, 2, dev)
    table = ref.prune_table_for("jaccard", 0.8, lr, ls)
    kw = dict(key_prod=False, self_join=False, cutoff=1 << 30)
    nkw = dict(kw, tile_r=32, tile_s=32)
    for bad in ((wr.cpu(), ws, lr, ls), (wr, ws[:, :2], lr, ls), (wr, ws, lr.long(), ls),
                (wr[:, :0], ws[:, :0], lr, ls)):
        with pytest.raises(ValueError):
            bitmap_filter.candidate_matrix_mxu_cuda(*bad, table, **kw)
        with pytest.raises(ValueError):
            compaction.count_candidates_mxu_cuda(*bad, None, None, table, **nkw)
    with pytest.raises(ValueError):
        compaction.count_candidates_mxu_cuda(wr, ws, lr, ls, lr, None, table, **nkw)
    with pytest.raises(ValueError):
        compaction.count_candidates_mxu_cuda(wr, ws, lr, ls, None, None, table,
                                             **dict(nkw, tile_r=0))
    empty = bitmap_filter.candidate_matrix_mxu_cuda(wr[:0], ws, lr[:0], ls, table, **kw)
    assert empty.shape == (0, 8)
    win, cand = compaction.count_candidates_mxu_cuda(wr, ws[:0], lr, ls[:0], None, None,
                                                     table, **nkw)
    assert win.shape == cand.shape == (1, 0)


def test_wrappers_reject_bad_operands(dev):
    wr, ws, lr, ls = _operands(8, 8, 4, 2, dev)
    table = ref.prune_table_for("jaccard", 0.8, lr, ls)
    kw = dict(key_prod=False, self_join=False, cutoff=1 << 30)
    with pytest.raises(ValueError):
        bitmap_filter.candidate_matrix_cuda(wr.cpu(), ws, lr, ls, table, **kw)
    with pytest.raises(ValueError):
        bitmap_filter.candidate_matrix_cuda(wr, ws[:, :2], lr, ls, table, **kw)
    with pytest.raises(ValueError):
        bitmap_filter.candidate_matrix_cuda(wr, ws, lr.long(), ls, table, **kw)
    with pytest.raises(ValueError):
        ops.candidate_matrix(wr, ws, lr, ls, "jaccard", 0.8, False, impl="ref")


@pytest.mark.parametrize("compaction_mode,capacity", [("host", None), ("device", None),
                                                      ("device", 2)])
def test_card_join_matches_cpu_join(dev, compaction_mode, capacity):
    col = with_duplicates(skewed_collection(n_sets=600, seed=4), n_clusters=30, seed=5)
    kw = dict(b=128, block=128, compaction=compaction_mode, capacity=capacity,
              return_stats=True)
    gpu = join.blocked_bitmap_join(col, "jaccard", 0.7, device=dev, **kw)
    cpu = join.blocked_bitmap_join(col, "jaccard", 0.7, device="cpu", **kw)
    assert np.array_equal(gpu[0], cpu[0])
    assert gpu[1].to_dict() == cpu[1].to_dict()
    assert np.array_equal(gpu[0], join.naive_join(col, "jaccard", 0.7, device=dev))


def test_card_filter_and_dedup_match_cpu(dev):
    """The Bitmap Filter's words built on the card equal the CPU's, bit for
    bit, for every method; dedup on the card equals dedup on the CPU (plain,
    against a corpus, and streamed through a store)."""
    from repro_torch.core import cpu_algos
    from repro_torch.core.filters import BitmapFilter
    from repro_torch.data import dedup

    col = with_duplicates(skewed_collection(n_sets=500, seed=6), n_clusters=25, seed=7)
    for b in (64, 128):
        for method in ("set", "xor", "next", "combined"):
            args = (col.tokens, col.lengths, "jaccard", 0.6)
            card = BitmapFilter.build(*args, b=b, method=method, device=dev)
            cpu = BitmapFilter.build(*args, b=b, method=method, device="cpu")
            assert card.words.dtype == np.uint32
            assert np.array_equal(card.words, cpu.words) and card.cutoff == cpu.cutoff
    prep = engine.prepare(col, dev)
    bf = engine.prepared_bitmap_filter(prep, sim="jaccard", tau=0.6, b=64)
    stats = cpu_algos.AlgoStats()
    pairs = cpu_algos.ppjoin(prep, None, "jaccard", 0.6, bitmap=bf, stats=stats)
    assert np.array_equal(pairs, join.naive_join(col, "jaccard", 0.6, device=dev))
    assert stats.bitmap_pruned > 0
    kw = dict(b=128, block=128)
    for mode in ("host", "device"):
        got = dedup.dedup_collection(col, 0.8, compaction=mode, device=dev, **kw)
        want = dedup.dedup_collection(col, 0.8, compaction=mode, device="cpu", **kw)
        assert np.array_equal(got.keep, want.keep) and np.array_equal(got.pairs, want.pairs)
        assert got.stats.to_dict() == want.stats.to_dict() and len(got.drop) > 0
    corpus = Collection(tokens=col.tokens[:300], lengths=col.lengths[:300])
    shards = [Collection(tokens=col.tokens[a:a + 50], lengths=col.lengths[a:a + 50])
              for a in range(300, col.num_sets, 50)]
    got = dedup.dedup_shards(corpus, shards, 0.8, device=dev, **kw)
    want = dedup.dedup_shards(corpus, shards, 0.8, device="cpu", **kw)
    for g, w in zip(got, want):
        assert np.array_equal(g.keep, w.keep) and np.array_equal(g.pairs_rs, w.pairs_rs)
        assert g.stats_rs.to_dict() == w.stats_rs.to_dict()


def _entries(g, seed, dev):
    """Random entry-filter operands (lengths below 30, so a prune table for
    30 x 30 covers every key); every fifth set empty, a fifth invalid."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(1, 30, g), rng.integers(0, 10, g), rng.integers(1, 30, g),
            rng.integers(0, 10, g), rng.integers(0, 15, g), rng.integers(8, 40, g),
            rng.integers(0, 60, g), rng.integers(0, 60, g)]
    cols[0][::5] = 0
    cols[2][1::5] = 0
    ts = [torch.from_numpy(c.astype(np.int32)).to(dev) for c in cols]
    return ts, torch.from_numpy(rng.random(g) > 0.2).to(dev)


@pytest.mark.parametrize("g", [5, 100, 1024, 2500, 3000])
@pytest.mark.parametrize("sim,tau", [("jaccard", 0.8), ("cosine", 0.6), ("overlap", 3.0)])
def test_entry_filter_kernel_matches_plain_version(dev, g, sim, tau):
    ents, valid = _entries(g, g, dev)
    table = bounds.prune_table(sim, tau, 30, 30)
    table = torch.from_numpy(table).to(dev)
    kept = 0
    for self_join in (False, True):
        got = postings.entry_filter_cuda(*ents, valid, table, key_prod=sim == COSINE,
                                         self_join=self_join)
        want = ref.entry_filter_ref(*ents, valid, sim=sim, tau=tau, self_join=self_join,
                                    table=table)
        assert torch.equal(got, want), self_join
        kept += int(want.sum())
    assert kept < 2 * g and (kept > 0 or g < 1024)


def _gathered(g, w, seed, dev):
    rng = np.random.default_rng(seed)
    wr = rng.integers(0, 2**32, (g, w), dtype=np.uint32)
    ws = rng.integers(0, 2**32, (g, w), dtype=np.uint32)
    ws[::3] = wr[::3]  # identical rows pass
    lr = rng.integers(0, 40, g).astype(np.int32)
    ls = rng.integers(0, 40, g).astype(np.int32)
    lr[::7] = 0
    as_t = lambda a: torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)  # noqa: E731
    return [as_t(a) for a in (wr, ws, lr, ls)]


@pytest.mark.parametrize("g", [5, 100, 1024, 2500, 3000])
@pytest.mark.parametrize("w", [1, 4, 8, 12, 20, 128])
def test_pair_verdict_kernels_match_plain_version(dev, g, w):
    wr, ws, lr, ls = _gathered(g, w, g * w, dev)
    for sim, tau in (("jaccard", 0.7), ("cosine", 0.6), ("dice", 0.75)):
        table = ref.prune_table_for(sim, tau, lr, ls)
        for cutoff in (1 << 30, 12):
            want = ref.pair_verdict_ref(wr, ws, lr, ls, sim=sim, tau=tau, cutoff=cutoff,
                                        table=table)
            kw = dict(key_prod=sim == COSINE, cutoff=cutoff)
            assert torch.equal(postings.pair_verdict_cuda(wr, ws, lr, ls, table, **kw), want)
            assert torch.equal(postings.pair_verdict_tiled_cuda(wr, ws, lr, ls, table, **kw),
                               want)


@pytest.mark.parametrize("nr,ns,w", [(33, 70, 1), (64, 64, 4), (300, 200, 128), (1000, 999, 4)])
def test_hamming_matrix_kernel_matches_plain_version(dev, nr, ns, w):
    wr, ws, _, _ = _operands(nr, ns, w, nr + w, dev)
    got = bitmap_filter.hamming_matrix_cuda(wr, ws)
    assert got.dtype == torch.int32 and torch.equal(got, ref.hamming_matrix_ref(wr, ws))
    assert torch.equal(ops.hamming_matrix(wr, ws), got)


def test_postings_launch_counters_and_dispatch(dev):
    wr, ws, lr, ls = _gathered(300, 4, 5, dev)
    ents, valid = _entries(300, 5, dev)
    counters = (postings.entry_filter_cuda, postings.pair_verdict_cuda,
                postings.pair_verdict_tiled_cuda, bitmap_filter.hamming_matrix_cuda)
    before = [f.launches for f in counters]
    ops.entry_filter(*ents, valid, "jaccard", 0.8)
    ops.pair_verdict(wr, ws, lr, ls, "jaccard", 0.8, impl="swar")
    ops.pair_verdict(wr, ws, lr, ls, "jaccard", 0.8)          # auto: swar_tiled
    ops.hamming_matrix(wr, ws)
    assert [f.launches for f in counters] == [b + 1 for b in before]
    with pytest.raises(ValueError):
        ops.pair_verdict(wr, ws, lr, ls, "jaccard", 0.8, impl="ref")
    with pytest.raises(ValueError):
        postings.pair_verdict_cuda(wr, ws[:10], lr, ls, lr, key_prod=False, cutoff=1)
    with pytest.raises(ValueError):
        postings.entry_filter_cuda(*ents[:7], ents[7].long(), valid, lr,
                                   key_prod=False, self_join=False)


@pytest.mark.parametrize("impl,capacity", [("auto", None), ("swar", None), ("auto", 64)])
def test_card_indexed_join_matches_cpu_join(dev, impl, capacity):
    col = with_duplicates(skewed_collection(n_sets=600, seed=4), n_clusters=30, seed=5)
    kw = dict(b=128, probe_block=128, impl=impl, capacity=capacity, return_stats=True)
    gpu = indexed_bitmap_join(col, "jaccard", 0.7, device=dev, **kw)
    cpu = indexed_bitmap_join(col, "jaccard", 0.7, device="cpu",
                              **dict(kw, impl="auto"))
    assert np.array_equal(gpu[0], cpu[0])
    assert gpu[1].to_dict() == cpu[1].to_dict()
    assert np.array_equal(gpu[0], join.naive_join(col, "jaccard", 0.7, device=dev))
    assert (gpu[1].overflow_blocks > 0) == (capacity is not None)
    eng = engine.JoinEngine(col, "jaccard", 0.7, device=dev)
    assert eng.plan.compaction == "device"


# -- the indexed driver's stage kernels (expand_filter, verdict_verify) -------

STAGE_SIMS = ("jaccard", "cosine", "dice", "overlap")
STAGE_TAUS = (0.5, 0.6, 0.8, 0.95)


def _stage_threshold(sim, tau):
    return float(max(1, round(tau * 8))) if sim == "overlap" else tau


def _stage_preps(rs, dev):
    from repro_torch.core.collection import from_lists

    sets_r = near_duplicate_lists(64, 21)
    prep_r = engine.prepare(from_lists(sets_r, pad_to=16), dev)
    if not rs:
        return prep_r, None
    sets_s = near_duplicate_lists(40, 22)
    sets_s[:8] = [s[:-1] or s for s in sets_r[:40:5]]
    return prep_r, engine.prepare(from_lists(sets_s, pad_to=16), dev)


def _check_stage_kernels(args, st, words):
    """Both kernels against their plain versions on the same card tensors,
    bit for bit, the verdict at each ``(words_r, probe_words)``; returns the
    expansion, generated, bitmap and verified counts."""
    sim, tau, cap, table = st["sim"], st["tau"], st["cap"], st["table"]
    ops_e = candidates.expand_filter_operands(args, st)
    key_prod = sim == COSINE
    got = postings.expand_filter_cuda(*ops_e, table, cap=cap, lp=st["lp"],
                                      key_prod=key_prod, self_join=st["self_join"])
    want = ref.expand_filter_ref(*ops_e, sim=sim, tau=tau, cap=cap, lp=st["lp"],
                                 self_join=st["self_join"], table=table)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    cr, cs, n_gen = candidates.dedup_pairs(*got, cap)
    slot_ok = torch.arange(cap, device=cr.device) < n_gen
    counts = [int(ops_e[2][-1]), int(n_gen), 0, 0]
    for wr, ws in words:
        vargs = (args[0], args[1], wr, args[9], args[10], ws, cr, cs, slot_ok, args[15])
        got = postings.verdict_verify_cuda(*vargs[:9], table, args[15], key_prod=key_prod,
                                           cutoff=st["cutoff"])
        want = ref.verdict_verify_ref(*vargs, sim=sim, tau=tau, cutoff=st["cutoff"],
                                      table=table)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        counts[2:] = [int(want[0].sum()), int(want[1].sum())]
    return counts


def _stage_specs(preps, sim, tau, widths=(1, 4, 32)):
    specs = [candidates.chunk_step_spec(*preps, sim=sim, tau=tau, b=32 * w,
                                        probe_block=128) for w in widths]
    (args, st), words = specs[0], [(a[2], a[11]) for a, _ in specs]
    return list(args), dict(st), words


@pytest.mark.parametrize("rs", [False, True], ids=["self", "rs"])
@pytest.mark.parametrize("tau", STAGE_TAUS)
@pytest.mark.parametrize("sim", STAGE_SIMS)
def test_stage_kernels_match_plain_versions(dev, sim, tau, rs):
    args, st, words = _stage_specs(_stage_preps(rs, dev), sim, _stage_threshold(sim, tau))
    counts = _check_stage_kernels(args, st, words)
    assert counts[0] > 0 and counts[1] >= counts[2] >= counts[3]


@pytest.mark.parametrize("edge", ["no_expansion", "fills_cap", "long_segment",
                                  "pad_probe_rows", "cutoff_below_lengths", "probe_offset"])
def test_stage_kernels_at_the_edges(dev, edge):
    from repro_torch.core.collection import from_lists

    preps = _stage_preps(edge != "probe_offset", dev)  # the offset moves the triangle
    if edge == "no_expansion":
        preps = (preps[0], engine.prepare(from_lists(
            [[t + 1000 for t in s] for s in near_duplicate_lists(20, 8)], pad_to=16), dev))
    elif edge == "long_segment":  # one (probe, position) expands into ~1,500 postings
        preps = (engine.prepare(from_lists(shared_token_lists(1500, 31), pad_to=16), dev),
                 None)
    args, st, words = _stage_specs(preps, "jaccard", 0.5)
    if edge == "fills_cap":
        st["cap"] = int(candidates.expand_filter_operands(args, st)[2][-1])
    elif edge == "pad_probe_rows":
        for i, fill in ((9, PAD_TOKEN), (10, 0), (12, 0), (13, 0), (14, 0)):
            a = args[i]
            args[i] = torch.cat([a, torch.full((5, *a.shape[1:]), fill, dtype=a.dtype,
                                               device=dev)])
        words = [(wr, torch.cat([ws, ws.new_zeros(5, ws.shape[1])])) for wr, ws in words]
    elif edge == "cutoff_below_lengths":
        st["cutoff"] = 2
    elif edge == "probe_offset":
        args[16] = 7
    counts = _check_stage_kernels(args, st, words)
    if edge == "no_expansion":
        assert counts[:2] == [0, 0]
    elif edge == "fills_cap":
        assert counts[0] == st["cap"]
    elif edge == "long_segment":
        assert counts[0] > 2 * 1024
    elif edge == "cutoff_below_lengths":
        assert counts[2] > counts[3]


def test_stage_kernels_dispatch_and_counters(dev):
    """``auto`` on CUDA tensors launches the stage kernels; an explicit
    kernel impl runs the composition around the unfused path's kernels; the
    plain versions' names raise on the card; the wrappers check operands."""
    args, st, words = _stage_specs(_stage_preps(False, dev), "jaccard", 0.6, (4, 32))
    eargs = candidates.expand_filter_operands(args, st)
    ekw = dict(sim="jaccard", tau=0.6, cap=st["cap"], lp=st["lp"], self_join=True,
               table=st["table"])
    counters = (postings.expand_filter_cuda, postings.verdict_verify_cuda,
                postings.entry_filter_cuda, postings.pair_verdict_tiled_cuda,
                postings.pair_verdict_bitplane_cuda)
    before = [f.launches for f in counters]
    rr, ss = ops.expand_filter(*eargs, **ekw)
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 0, 0, 0, 0]
    composed = ops.expand_filter(*eargs, **ekw, impl="swar_tiled")
    assert torch.equal(rr, composed[0]) and torch.equal(ss, composed[1])
    cr, cs, n_gen = candidates.dedup_pairs(rr, ss, st["cap"])
    slot_ok = torch.arange(st["cap"], device=dev) < n_gen
    vkw = dict(sim="jaccard", tau=0.6, cutoff=st["cutoff"], table=st["table"])
    for (wr, ws), impl, old in ((words[0], "swar_tiled", 3), (words[1], "mxu", 4)):
        vargs = (args[0], args[1], wr, args[9], args[10], ws, cr, cs, slot_ok, args[15])
        mid = [f.launches for f in counters]
        fused = ops.verdict_verify(*vargs, **vkw)
        composed = ops.verdict_verify(*vargs, **vkw, impl=impl)
        ran = [f.launches - b for f, b in zip(counters, mid)]
        assert ran[1] == 1 and ran[old] == 1 and sum(ran) == 2, (impl, ran)
        assert torch.equal(fused[0], composed[0]) and torch.equal(fused[1], composed[1])
        with pytest.raises(ValueError):
            ops.verdict_verify(*vargs, **vkw, impl="ref")
    with pytest.raises(ValueError):
        ops.expand_filter(*eargs, **ekw, impl="ref_mxu")
    with pytest.raises(ValueError):
        postings.expand_filter_cuda(*eargs, st["table"], cap=st["cap"], lp=st["lp"] + 1,
                                    key_prod=False, self_join=True)
    with pytest.raises(ValueError):
        postings.verdict_verify_cuda(args[0], args[1], words[0][0], args[9], args[10],
                                     words[1][1], cr, cs, slot_ok, st["table"], args[15],
                                     key_prod=False, cutoff=1)


@pytest.mark.parametrize("b", [128, 1024])
def test_card_indexed_join_runs_the_stage_kernels(dev, b):
    """The indexed join under ``auto`` launches both stage kernels and none
    of the per-op postings kernels; under ``swar_tiled`` / ``mxu`` those and
    not the stage kernels; both equal the CPU join, pairs and every counter."""
    col = with_duplicates(skewed_collection(n_sets=600, seed=4), n_clusters=30, seed=5)
    kw = dict(b=b, probe_block=128, return_stats=True)
    counters = (postings.expand_filter_cuda, postings.verdict_verify_cuda,
                postings.entry_filter_cuda,
                postings.pair_verdict_tiled_cuda if b < 512
                else postings.pair_verdict_bitplane_cuda)
    cpu = indexed_bitmap_join(col, "jaccard", 0.7, device="cpu", **kw)
    for impl in ("auto", "swar_tiled" if b < 512 else "mxu"):
        before = [f.launches for f in counters]
        gpu = indexed_bitmap_join(col, "jaccard", 0.7, device=dev, impl=impl, **kw)
        ran = [f.launches - x for f, x in zip(counters, before)]
        if impl == "auto":
            assert min(ran[:2]) > 0 and ran[2:] == [0, 0], ran
        else:
            assert ran[:2] == [0, 0] and min(ran[2:]) > 0, ran
        assert np.array_equal(gpu[0], cpu[0]) and gpu[1].to_dict() == cpu[1].to_dict()


# -- the bit-plane kernels (bitplane_hamming, pair_verdict_bitplane) ----------

def _random_words(n, w, seed, dev):
    """Uniformly random words (half the bits set) and lengths below 40,
    every fifth row empty."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (n, w), dtype=np.uint32).view(np.int32)
    lens = rng.integers(0, 40, n).astype(np.int32)
    lens[::5] = 0
    return torch.from_numpy(words).to(dev), torch.from_numpy(lens).to(dev)


# The last seven sit on the kernel's 128 x 256 tile edges and its 128-byte
# stages (b = 32, 64 and 96 below one stage), with NS % 4 != 0 in five.
BITPLANE_SHAPES = [(33, 70, 1), (64, 64, 4), (96, 64, 16), (257, 65, 32), (300, 200, 128),
                   (1000, 999, 32), (127, 129, 1), (128, 257, 2), (129, 255, 3),
                   (255, 127, 32), (257, 4096, 128), (4096, 129, 32), (4096, 4096, 32)]


@pytest.mark.parametrize("nr,ns,w", BITPLANE_SHAPES)
@pytest.mark.parametrize("kind", ["sets", "random"])
def test_bitplane_hamming_kernel_matches_plain_version(dev, nr, ns, w, kind):
    if kind == "sets":
        wr, ws, lr, ls = _operands(nr, ns, w, nr + ns + w, dev)
    else:
        (wr, lr), (ws, ls) = _random_words(nr, w, nr, dev), _random_words(ns, w, ns + 1, dev)
    (pr, pc_r), (ps, pc_s) = ops._planes(wr), ops._planes(ws)
    got = bitplane.bitplane_hamming_cuda(pr, ps, pc_r, pc_s)
    assert got.dtype == torch.int32
    assert torch.equal(got, ref.bitplane_hamming_ref(pr, ps, pc_r, pc_s))
    assert torch.equal(got, bitmap_filter.hamming_matrix_cuda(wr, ws))  # the SWAR kernel
    assert torch.equal(ops.hamming_matrix(wr, ws, impl="mxu"), got)
    for sim, tau, self_join, cutoff in (("jaccard", 0.6, False, 1 << 30),
                                        ("cosine", 0.5, True, 1 << 30),
                                        ("dice", 0.3, False, 20)):
        table = ref.prune_table_for(sim, tau, lr, ls)
        args = (wr, ws, lr, ls, sim, tau, self_join, cutoff)
        assert torch.equal(ops.candidate_matrix(*args, impl="mxu", table=table),
                           ops.candidate_matrix(*args, impl="swar", table=table))


@pytest.mark.parametrize("lengths", ["all_pass", "all_prune", "empty_rows"])
def test_bitplane_candidate_matrix_edge_rows(dev, lengths):
    wr, lr = _random_words(130, 32, 1, dev)
    ws, ls = _random_words(70, 32, 2, dev)
    if lengths == "all_pass":     # identical zero bitmaps, equal sizes: ub == |r|
        wr, ws = torch.zeros_like(wr), torch.zeros_like(ws)
        lr, ls = torch.full_like(lr, 20), torch.full_like(ls, 20)
    elif lengths == "all_prune":  # random words, tiny sets: ub < 0
        lr, ls = torch.full_like(lr, 2), torch.full_like(ls, 2)
    else:
        lr[::3] = 0
        ls[1::4] = 0
    got = ops.candidate_matrix(wr, ws, lr, ls, "jaccard", 0.8, False, impl="mxu")
    assert torch.equal(got, ops.candidate_matrix(wr, ws, lr, ls, "jaccard", 0.8, False,
                                                 impl="swar"))
    n = int(got.sum())
    assert {"all_pass": n == got.numel(), "all_prune": n == 0}.get(lengths, True)


@pytest.mark.parametrize("g", [5, 100, 1024, 2500, 3000])
@pytest.mark.parametrize("w", [1, 4, 16, 32, 128])
def test_pair_verdict_bitplane_kernel_matches_plain_version(dev, g, w):
    wr, ws, lr, ls = _gathered(g, w, g * w + 1, dev)
    (pr, pc_r), (ps, pc_s) = ops._planes(wr), ops._planes(ws)
    ham = ref.bitplane_pair_hamming_ref(pr, ps, pc_r, pc_s)
    for sim, tau in (("jaccard", 0.7), ("cosine", 0.6), ("dice", 0.75)):
        table = ref.prune_table_for(sim, tau, lr, ls)
        for cutoff in (1 << 30, 12):
            want = bounds.verdict_from_hamming(ham, lr, ls, table, sim=sim, cutoff=cutoff)
            kw = dict(key_prod=sim == COSINE, cutoff=cutoff)
            got = postings.pair_verdict_bitplane_cuda(pr, ps, pc_r, pc_s, lr, ls, table, **kw)
            assert torch.equal(got, want), (sim, cutoff)
            assert torch.equal(got, postings.pair_verdict_tiled_cuda(wr, ws, lr, ls, table,
                                                                     **kw))


def test_pair_verdict_mxu_slices(dev, monkeypatch):
    wr, ws, lr, ls = _gathered(2500, 32, 7, dev)
    want = ops.pair_verdict(wr, ws, lr, ls, "jaccard", 0.6, impl="swar_tiled")
    monkeypatch.setattr(ops, "_MXU_SLICE", 1024)
    before = postings.pair_verdict_bitplane_cuda.launches
    assert torch.equal(ops.pair_verdict(wr, ws, lr, ls, "jaccard", 0.6, impl="mxu"), want)
    assert postings.pair_verdict_bitplane_cuda.launches == before + 3


def test_bitplane_wrappers_reject_bad_operands(dev):
    wr, ws, lr, ls = _gathered(64, 4, 3, dev)
    (pr, pc_r), (ps, pc_s) = ops._planes(wr), ops._planes(ws)
    table = ref.prune_table_for("jaccard", 0.8, lr, ls)
    kw = dict(key_prod=False, cutoff=1 << 30)
    with pytest.raises(ValueError):
        bitplane.bitplane_hamming_cuda(pr.cpu(), ps, pc_r, pc_s)
    with pytest.raises(ValueError):
        bitplane.bitplane_hamming_cuda(pr.to(torch.int32), ps, pc_r, pc_s)
    with pytest.raises(ValueError):
        bitplane.bitplane_hamming_cuda(pr[:, :48].contiguous(), ps[:, :48].contiguous(),
                                       pc_r, pc_s)
    with pytest.raises(ValueError):
        bitplane.bitplane_hamming_cuda(pr, ps, pc_r.long(), pc_s)
    misaligned = torch.zeros(pr.numel() + 1, dtype=torch.int8, device=dev)[1:].view(pr.shape)
    with pytest.raises(ValueError):
        bitplane.bitplane_hamming_cuda(misaligned, ps, pc_r, pc_s)
    with pytest.raises(ValueError):
        postings.pair_verdict_bitplane_cuda(pr, ps[:10], pc_r, pc_s, lr, ls, table, **kw)
    with pytest.raises(ValueError):
        postings.pair_verdict_bitplane_cuda(pr, ps, pc_r, pc_s, lr[:10], ls, table, **kw)
    with pytest.raises(ValueError):
        ops.pair_verdict(wr, ws, lr, ls, "jaccard", 0.8, impl="ref_mxu")


def test_bitplane_launch_counters_and_auto_dispatch(dev):
    """``auto`` on CUDA tensors: the bit-plane kernels from b = 512 (the
    reference's accelerator rule), the SWAR kernels below; the dense
    verdict and count are the tensor-core verdict kernels."""
    wr, ws, lr, ls = _operands(70, 50, 32, 1, dev)       # b = 1024
    gr, gs, glr, gls = _gathered(300, 16, 5, dev)         # b = 512
    ents, valid = _entries(300, 5, dev)
    counters = (bitplane.bitplane_hamming_cuda, postings.pair_verdict_bitplane_cuda,
                bitmap_filter.candidate_matrix_cuda, bitmap_filter.hamming_matrix_cuda,
                postings.pair_verdict_tiled_cuda, compaction.count_candidates_cuda,
                postings.entry_filter_cuda, bitmap_filter.candidate_matrix_mxu_cuda,
                compaction.count_candidates_mxu_cuda)
    before = [f.launches for f in counters]
    ops.hamming_matrix(wr, ws)
    ops.candidate_matrix(wr, ws, lr, ls, "jaccard", 0.8, False)    # the tensor-core verdict
    ops.pair_verdict(gr, gs, glr, gls, "jaccard", 0.8)
    ops.count_candidates(wr, ws, lr, ls, lr, lr, "jaccard", 0.8)   # the tensor-core count
    ops.entry_filter(*ents, valid, "jaccard", 0.8, impl="mxu")     # mxu: swar
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 0, 0, 0, 0, 1, 1, 1]
    ops.pair_verdict(gr[:, :8], gs[:, :8], glr, gls, "jaccard", 0.8)  # b = 256: swar_tiled
    assert postings.pair_verdict_tiled_cuda.launches == before[4] + 1


@pytest.mark.parametrize("driver", ["blocked", "indexed"])
def test_card_join_at_b1024_matches_cpu_join(dev, driver):
    col = with_duplicates(skewed_collection(n_sets=600, seed=4), n_clusters=30, seed=5)
    if driver == "blocked":
        run = lambda d: join.blocked_bitmap_join(col, "jaccard", 0.7, b=1024, block=128,  # noqa: E731
                                                 compaction="device", return_stats=True,
                                                 device=d)
        counter = compaction.count_candidates_mxu_cuda
    else:
        run = lambda d: indexed_bitmap_join(col, "jaccard", 0.7, b=1024, probe_block=128,  # noqa: E731
                                            return_stats=True, device=d)
        counter = postings.verdict_verify_cuda
    before = counter.launches
    gpu = run(dev)
    assert counter.launches > before
    cpu = run("cpu")
    assert np.array_equal(gpu[0], cpu[0]) and gpu[1].to_dict() == cpu[1].to_dict()
    assert np.array_equal(gpu[0], join.naive_join(col, "jaccard", 0.7, device=dev))


def test_card_session_at_b1024_matches_cpu_session(dev):
    """A store-backed session at b = 1024 serves the same tickets on the
    card as on the CPU, through appends and a compaction, and its probe
    step runs the fused verdict and verification (neither the bit-plane nor
    the packed-word pairwise verdict)."""
    col = with_duplicates(skewed_collection(n_sets=800, seed=6), n_clusters=40, seed=7)
    rows = lambda idx: Collection(tokens=col.tokens[idx], lengths=col.lengths[idx])  # noqa: E731
    rng = np.random.default_rng(8)
    requests = [rows(rng.integers(0, col.num_sets, rng.integers(1, 4))) for _ in range(60)]
    base, delta = rows(np.arange(600)), rows(np.arange(600, col.num_sets))
    plan = JoinPlan(driver="indexed", sim="jaccard", tau=0.7, b=1024, block=4096)

    def serve(d):
        sess = JoinSession(CorpusStore(base, "jaccard", 0.7, plan=plan, device=d),
                           max_batch=32, max_wait=0.0)
        tickets = [sess.submit(r) for r in requests[:30]]
        sess.flush()
        sess.append(delta, compact=False)
        tickets += [sess.submit(r) for r in requests[30:45]]
        sess.flush()
        sess.compact()
        tickets += [sess.submit(r) for r in requests[45:]]
        sess.flush()
        return [t.result() for t in tickets], [t.route for t in tickets]

    counters = (postings.verdict_verify_cuda, postings.expand_filter_cuda,
                postings.pair_verdict_bitplane_cuda, postings.pair_verdict_tiled_cuda)
    before = [f.launches for f in counters]
    gpu, routes = serve(dev)
    ran = [f.launches - b for f, b in zip(counters, before)]
    assert min(ran[:2]) > 0 and ran[2:] == [0, 0], ran
    assert "coalesced" in routes
    cpu, cpu_routes = serve("cpu")
    assert routes == cpu_routes
    for (gp, gs), (cp, cs) in zip(gpu, cpu):
        assert np.array_equal(gp, cp) and gs == cs


FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def exact_f32(dev):
    """float32 products in full float32 (no TF32) for the flash comparisons."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield dev
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


FLASH_SHAPES = [  # sq, sk, causal, group (H / KV), KV
    (1, 1, True, 1, 2), (63, 63, True, 3, 2), (100, 100, True, 4, 2), (64, 200, True, 8, 1),
    (200, 64, True, 3, 1), (100, 37, False, 8, 2), (1, 300, False, 1, 3),
    # the wgmma instance's 128-row q tiles and 128-key K/V tiles: each side of
    # one and two tiles, Sq != Sk both ways, groups 1, 3, 4 and 8
    (127, 127, True, 1, 2), (128, 128, False, 3, 1), (129, 129, True, 4, 2),
    (255, 257, True, 8, 1), (257, 255, False, 1, 2), (128, 257, True, 3, 1),
    (257, 128, True, 4, 1), (129, 255, False, 8, 1),
    # the 192-row q tiles of the head dims 16 and 32 instance
    (191, 193, True, 3, 1), (193, 191, False, 4, 2), (385, 384, True, 8, 1),
    # the 3xTF32 instance's 32- and 64-key tiles (32 at D = 128), Sk % 8 != 0
    (31, 33, True, 3, 2), (33, 31, False, 1, 1), (65, 63, True, 8, 1), (64, 97, False, 4, 2),
    (96, 95, True, 1, 2),
    # arctic's GQA group of 7; the vision model's non-causal cross-attention
    # over 1,600 image tokens (12.5 key tiles: a partial last one) from 1,024
    # and 2,048 queries; musicgen's 24 MHA heads
    (100, 130, True, 7, 1), (129, 257, False, 7, 2), (1024, 1600, False, 4, 2),
    (2048, 1600, False, 4, 1), (150, 150, True, 1, 24)]


def _flash_operands(dev, dtype, d, sq, sk, group, kv):
    gen = torch.Generator(device=dev).manual_seed(sq + sk + d)
    return tuple(torch.randn((2, n, heads, d), generator=gen, device=dev).to(dtype)
                 for n, heads in ((sq, group * kv), (sk, kv), (sk, kv)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 112, 128])
@pytest.mark.parametrize("sq,sk,causal,group,kv", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain_version(exact_f32, dtype, d, sq, sk, causal,
                                                      group, kv):
    q, k, v = _flash_operands(exact_f32, dtype, d, sq, sk, group, kv)
    got = flash_kernel.flash_attention_cuda(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [16, 32, 64, 112, 128])
@pytest.mark.parametrize("sq,sk,causal,group,kv", FLASH_SHAPES)
def test_flash_attention_simt_f32_instance_matches_plain_version(exact_f32, d, sq, sk, causal,
                                                                 group, kv):
    """The CUDA-core float32 instance, the rule until the 3xTF32 instance
    measured faster, stays held to the plain version."""
    q, k, v = _flash_operands(exact_f32, torch.float32, d, sq, sk, group, kv)
    counts = flash_kernel.flash_attention_cuda.instance_launches
    before = counts["simt_f32"]
    got = flash_kernel.flash_attention_cuda(q, k, v, causal=causal, instance="simt_f32")
    assert counts["simt_f32"] == before + 1
    tol = FLASH_TOL[torch.float32]
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, causal=causal), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("d", [16, 32, 64, 112, 128])
@pytest.mark.parametrize("sk,group,kv", [(1, 1, 1), (13, 3, 2), (64, 4, 1), (100, 8, 2),
                                         (4096, 4, 2)])
def test_flash_split_kv_kernel_matches_plain_version(exact_f32, d, sk, group, kv):
    """The 3xTF32 instance's prepass: bit-identical to its plain version."""
    _, k, v = _flash_operands(exact_f32, torch.float32, d, 1, sk, group, kv)
    before = flash_kernel.split_kv_cuda.launches
    got = flash_kernel.split_kv_cuda(k, v)
    assert flash_kernel.split_kv_cuda.launches == before + 1
    for part, want in zip(got, ref.split_kv_ref(k, v)):
        assert part.shape == want.shape
        assert torch.equal(part.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("d,sk,causal", [(128, 128, False), (128, 128, True), (128, 100, True),
                                         (64, 64, False), (64, 61, True), (16, 16, False),
                                         (112, 112, False), (112, 100, True)])
def test_flash_attention_tf32x3_sees_each_key_in_its_slot(exact_f32, d, sk, causal):
    """V = one-hot key indices (v[j] = e_j), so the output's column j is the
    attention weight of key j: a key that entered P V through another key's
    V^T slot shows as a wrong column."""
    gen = torch.Generator(device=exact_f32).manual_seed(d + sk)
    q = torch.randn((2, 64, 4, d), generator=gen, device=exact_f32)
    k = torch.randn((2, sk, 2, d), generator=gen, device=exact_f32)
    v = torch.zeros((2, sk, 2, d), device=exact_f32)
    v[:, torch.arange(sk), :, torch.arange(sk) % d] = 1.0
    got = flash_kernel.flash_attention_cuda(q, k, v, causal=causal, instance="wgmma_tf32x3")
    tol = FLASH_TOL[torch.float32]
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, causal=causal), rtol=tol,
                               atol=tol)


def test_flash_attention_wrapper_rejects_bad_operands(dev):
    q = torch.randn((1, 8, 4, 16), device=dev)
    k = torch.randn((1, 8, 2, 16), device=dev)
    with pytest.raises(ValueError):
        flash_kernel.flash_attention_cuda(q.cpu(), k, k)
    with pytest.raises(ValueError):
        flash_kernel.flash_attention_cuda(q, torch.randn((1, 8, 3, 16), device=dev), k)
    with pytest.raises(ValueError):
        flash_kernel.flash_attention_cuda(q[..., :8].contiguous(), k[..., :8].contiguous(),
                                          k[..., :8].contiguous())
    with pytest.raises(ValueError):
        flash_kernel.flash_attention_cuda(q.half(), k.half(), k.half())
    with pytest.raises(ValueError):
        flash_kernel.flash_attention_cuda(q.transpose(1, 2), k, k)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k, impl="ref")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel_at_a_qwen3_layer(exact_f32, dtype):
    """One (batch) of qwen3-8b's prefill attention: S = 4,096, 32 query
    heads on 8 KV heads of 128, causal, in bf16 and in float32."""
    gen = torch.Generator(device=exact_f32).manual_seed(7)
    q, k, v = (torch.randn((1, 4096, heads, 128), generator=gen, device=exact_f32)
               .to(dtype) for heads in (32, 8, 8))
    got = flash_kernel.flash_attention_cuda(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True, triangle=True)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,b,s", [(torch.bfloat16, 4, 1024), (torch.bfloat16, 2, 2048),
                                       (torch.float32, 1, 1024)])
def test_flash_attention_kernel_at_a_zamba2_layer(exact_f32, dtype, b, s):
    """zamba2-7b's shared attention: 32 heads of 112 (MHA), causal, at the
    serving shape (4 x 1,024) and the training shape (2 x 2,048) in bf16,
    and one sequence in float32."""
    gen = torch.Generator(device=exact_f32).manual_seed(9)
    q, k, v = (torch.randn((b, s, 32, 112), generator=gen, device=exact_f32).to(dtype)
               for _ in range(3))
    got = flash_kernel.flash_attention_cuda(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True, triangle=True)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


FAMILY_FWD_SHAPES = {  # b, sq, sk, heads, kv heads, d, causal
    "vision cross-attention": (4, 1024, 1600, 32, 8, 128, False),
    "musicgen layer": (4, 1500, 1500, 24, 24, 64, True),
    "arctic layer": (4, 1024, 1024, 56, 8, 128, True)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", list(FAMILY_FWD_SHAPES))
def test_flash_attention_kernel_at_the_family_shapes(exact_f32, dtype, shape):
    """The moe, vlm and audio families' serving shapes: llama-3.2-vision's
    cross-attention (non-causal, 1,600 image keys), musicgen's 24 MHA heads
    of 64, arctic's 56 heads on 8 KV heads."""
    b, sq, sk, h, kv, d, causal = FAMILY_FWD_SHAPES[shape]
    gen = torch.Generator(device=exact_f32).manual_seed(13)
    q = torch.randn((b, sq, h, d), generator=gen, device=exact_f32).to(dtype)
    k, v = (torch.randn((b, sk, kv, d), generator=gen, device=exact_f32).to(dtype)
            for _ in range(2))
    got = flash_kernel.flash_attention_cuda(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal, triangle=causal)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,instance", [(torch.bfloat16, "wgmma"),
                                            (torch.float32, "wgmma_tf32x3")])
def test_flash_attention_kernel_at_a_qwen3_layer_with_head_dim_32(exact_f32, dtype, instance):
    """The same layer shape with head dim 32 (no served config has it)."""
    gen = torch.Generator(device=exact_f32).manual_seed(8)
    q, k, v = (torch.randn((1, 4096, heads, 32), generator=gen, device=exact_f32)
               .to(dtype) for heads in (32, 8, 8))
    got = flash_kernel.flash_attention_cuda(q, k, v, causal=True, instance=instance)
    want = ref.flash_attention_ref(q, k, v, causal=True, triangle=True)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_flash_attention_instance_keyword_on_the_card(dev):
    """An instance with no kernel raises before launching, the prepass too."""
    q = torch.randn((1, 8, 4, 64), device=dev).to(torch.bfloat16)
    k = torch.randn((1, 8, 2, 64), device=dev).to(torch.bfloat16)
    before = flash_kernel.flash_attention_cuda.launches, flash_kernel.split_kv_cuda.launches
    with pytest.raises(ValueError, match="no kernel"):
        flash_kernel.flash_attention_cuda(q, k, k, instance="wgmma_tf32x3")
    with pytest.raises(ValueError, match="no kernel"):
        flash_kernel.flash_attention_cuda(q.float(), k.float(), k.float(), instance="wgmma")
    with pytest.raises(ValueError, match="unknown"):
        flash_kernel.flash_attention_cuda(q, k, k, instance="mma_sync")
    with pytest.raises(ValueError, match="float32"):
        flash_kernel.split_kv_cuda(k, k)
    assert (flash_kernel.flash_attention_cuda.launches,
            flash_kernel.split_kv_cuda.launches) == before


def test_flash_attention_launch_counter_and_dispatch(dev):
    q = torch.randn((1, 8, 4, 16), device=dev)
    k = torch.randn((1, 8, 2, 16), device=dev)
    before = flash_kernel.flash_attention_cuda.launches
    ops.flash_attention(q, k, k)
    ops.flash_attention(q, k, k, impl="cuda")
    assert flash_kernel.flash_attention_cuda.launches == before + 2


@pytest.mark.parametrize("dtype,d,instance", [
    (torch.bfloat16, 16, "wgmma"), (torch.bfloat16, 32, "wgmma"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 112, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 16, "wgmma_tf32x3"), (torch.float32, 64, "wgmma_tf32x3"),
    (torch.float32, 112, "wgmma_tf32x3"), (torch.float32, 128, "wgmma_tf32x3")])
def test_flash_attention_head_dim_dispatch_counts_its_instance(exact_f32, dtype, d, instance):
    q = torch.randn((1, 130, 4, d), device=exact_f32).to(dtype)
    k = torch.randn((1, 130, 2, d), device=exact_f32).to(dtype)
    counts = flash_kernel.flash_attention_cuda.instance_launches
    before = (flash_kernel.flash_attention_cuda.launches, dict(counts),
              flash_kernel.split_kv_cuda.launches)
    out = ops.flash_attention(q, k, k)
    torch.cuda.synchronize()
    assert flash_kernel.flash_attention_cuda.launches == before[0] + 1
    assert {n: counts[n] - before[1][n] for n in counts} == {
        n: int(n == instance) for n in flash_kernel.INSTANCES}
    assert flash_kernel.split_kv_cuda.launches == before[2] + (instance == "wgmma_tf32x3")
    torch.testing.assert_close(out, ref.flash_attention_ref(q, k, k), rtol=FLASH_TOL[dtype],
                               atol=FLASH_TOL[dtype])


@pytest.mark.parametrize("name", configs.ARCHS)
def test_card_serving_matches_cpu_serving(exact_f32, name):
    """The reduced configs (float32) on the card against the same weights
    on the CPU: prefill runs the kernel once an attention application (a
    layer; a group in the hybrid family; never in the ssm family), and the
    logits of forward, prefill and greedy decode agree at 1e-4."""
    cfg = configs.get_reduced(name)
    cpu = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    card = Model(cfg, device=exact_f32)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    before = flash_kernel.flash_attention_cuda.launches
    got = greedy_generate(DecodeEngine(card), tokens.to(exact_f32), 6)
    assert flash_kernel.flash_attention_cuda.launches == before + attention_applications(cfg)
    want = greedy_generate(DecodeEngine(cpu), tokens, 6)
    assert torch.equal(got.tokens.cpu(), want.tokens)
    for g, w in zip(got.logits, want.logits):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)
    with torch.inference_mode():
        torch.testing.assert_close(card({"tokens": tokens.to(exact_f32)})[0].cpu(),
                                   cpu({"tokens": tokens})[0], rtol=1e-4, atol=1e-4)


LSE_SHAPES = [(1, 1, True, 1, 2), (63, 63, True, 3, 2), (100, 37, False, 8, 2),
              (129, 129, True, 4, 2), (257, 255, False, 1, 2), (255, 257, True, 8, 1),
              (193, 191, False, 4, 2), (385, 384, True, 8, 1), (31, 33, True, 3, 2),
              (65, 63, True, 8, 1)]


@pytest.mark.parametrize("dtype,instance", [(torch.bfloat16, "wgmma"),
                                            (torch.float32, "wgmma_tf32x3"),
                                            (torch.float32, "simt_f32")])
@pytest.mark.parametrize("d", [16, 32, 64, 112, 128])
@pytest.mark.parametrize("sq,sk,causal,group,kv", LSE_SHAPES)
def test_flash_attention_kernel_lse_matches_plain_version(exact_f32, dtype, instance, d, sq, sk,
                                                          causal, group, kv):
    """Every instance's lse output (B, KV, G, Sq) against the plain
    version's within 1e-4 (1 + |lse|); the output equals the call without
    lse bit for bit, and only the call that asks for lse counts in
    ``lse_launches``."""
    q, k, v = _flash_operands(exact_f32, dtype, d, sq, sk, group, kv)
    before = flash_kernel.flash_attention_cuda.lse_launches
    plain = flash_kernel.flash_attention_cuda(q, k, v, causal=causal, instance=instance)
    out, lse = flash_kernel.flash_attention_cuda(q, k, v, causal=causal, instance=instance,
                                                 return_lse=True)
    assert flash_kernel.flash_attention_cuda.lse_launches == before + 1
    assert torch.equal(out, plain)
    _, want = ref.flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, kv, group, sq)
    assert bool(((lse - want).abs() <= 1e-4 * (1 + want.abs())).all())


def test_ops_flash_attention_returns_lse_on_the_card(exact_f32):
    q, k, v = _flash_operands(exact_f32, torch.bfloat16, 64, 300, 300, 3, 3)
    out, lse = ops.flash_attention(q, k, v, return_lse=True)
    want_out, want_lse = ref.flash_attention_ref(q, k, v, return_lse=True)
    torch.testing.assert_close(out, want_out, rtol=FLASH_TOL[torch.bfloat16],
                               atol=FLASH_TOL[torch.bfloat16])
    assert bool(((lse - want_lse).abs() <= 1e-4 * (1 + want_lse.abs())).all())


@pytest.mark.parametrize("name", ["smollm-135m", "qwen3-8b", "mamba2-2.7b", "zamba2-7b"])
def test_card_gradients_match_cpu_gradients(exact_f32, name):
    """The reduced config (float32) on the card, its forward through the
    kernel with lse, against the same weights on the CPU: the loss within
    1e-5 relative and each gradient leaf within 1e-4 relative RMS; serving
    under inference_mode asks for no lse."""
    from repro_torch.train.tree import leaves_with_paths

    cfg = configs.get_reduced(name)
    cpu = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    card = Model(cfg, device=exact_f32)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 65)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = []
    counts = flash_kernel.flash_attention_cuda
    for model in (card, cpu):
        for p in model.parameters():
            p.requires_grad_(True)
        before = counts.launches, counts.lse_launches
        loss, _ = model.loss({k: t.to(model.device) for k, t in batch.items()})
        grads = torch.autograd.grad(loss, [p for _, p in leaves_with_paths(model.param_tree())])
        out.append((float(loss.detach()), [g.cpu() for g in grads]))
        if model is card:
            assert (counts.launches - before[0], counts.lse_launches - before[1]) == (
                attention_applications(cfg),) * 2
    assert abs(out[0][0] - out[1][0]) <= 1e-5 * abs(out[1][0])
    for g, w in zip(out[0][1], out[1][1]):
        assert float((g - w).norm() / w.norm()) <= 1e-4
    before = counts.lse_launches
    with torch.inference_mode():
        card({"tokens": batch["tokens"].to(exact_f32)})
    assert counts.lse_launches == before


# The backward kernel against its plain version on the card.  float32 (the
# CUDA-core instance, TF32 off): elementwise at the forward's 2e-5 (the same
# float32 arithmetic, summed in another order).  bf16: relative RMS within
# chip_smoke's gradient gate (5%); both round p and ds to bf16 before their
# products, but the plain version also rounds the scores and each block's
# partial products to bf16, which the kernel does not.  Where each query
# row sees one key (Sk = 1, or Sq = 1 causal) dq and dk are zero but for
# rounding and have no relative error: dv alone is held there.
BWD_GRAD_REL = 0.05
BWD_SHAPES = [  # sq, sk, causal, group (H / KV), KV
    (1, 1, True, 1, 2), (63, 63, True, 3, 1), (63, 63, False, 4, 1), (128, 128, True, 1, 2),
    (128, 128, False, 3, 1), (200, 200, True, 4, 1), (200, 200, False, 1, 3),
    (257, 257, True, 3, 1), (257, 257, False, 4, 2),
    # Sq != Sk both ways; causal with Sk > Sq leaves key blocks no q row sees
    (128, 257, True, 3, 1), (257, 128, True, 4, 1), (63, 200, False, 1, 2),
    (200, 63, False, 3, 1), (1, 300, True, 4, 1), (129, 255, True, 1, 2),
    # a GQA group of 7, non-causal Sk = 1,600 against 1,024 and 2,048 queries,
    # 24 MHA heads (phases 17-19's shapes, cut in batch)
    (100, 130, True, 7, 1), (129, 257, False, 7, 2), (1024, 1600, False, 4, 2),
    (2048, 1600, False, 4, 1), (150, 150, True, 1, 24)]


def _bwd_operands(dev, dtype, d, sq, sk, group, kv, causal):
    """q, k, v, out, lse from the forward kernel, and a seeded do."""
    q, k, v = _flash_operands(dev, dtype, d, sq, sk, group, kv)
    gen = torch.Generator(device=dev).manual_seed(sq + 2 * sk + d)
    do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
    out, lse = flash_kernel.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    return q, k, v, out, lse, do


def _bwd_within(got, want, dtype, one_key=False) -> bool:
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if dtype == torch.float32:
            if not torch.allclose(g, w, rtol=FLASH_TOL[dtype], atol=FLASH_TOL[dtype]):
                return False
        elif not (one_key and i < 2):
            err = float((g.double() - w.double()).norm())
            if not err <= BWD_GRAD_REL * float(w.double().norm()):
                return False
    return True


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 32, 64, 112, 128])
@pytest.mark.parametrize("sq,sk,causal,group,kv", BWD_SHAPES)
def test_flash_attention_bwd_kernel_matches_plain_version(exact_f32, dtype, d, sq, sk, causal,
                                                          group, kv):
    ops_ = _bwd_operands(exact_f32, dtype, d, sq, sk, group, kv, causal)
    counts = flash_kernel.flash_attention_bwd_cuda.instance_launches
    before = flash_kernel.flash_attention_bwd_cuda.launches, dict(counts)
    got = flash_kernel.flash_attention_bwd_cuda(*ops_, causal=causal)
    torch.cuda.synchronize()
    name = flash_kernel.bwd_instance(dtype)
    assert flash_kernel.flash_attention_bwd_cuda.launches == before[0] + 1
    assert {n: counts[n] - before[1][n] for n in counts} == {
        n: int(n == name) for n in flash_kernel.BWD_INSTANCES}
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert _bwd_within(got, ref.flash_attention_bwd_ref(*ops_, causal=causal), dtype,
                       one_key=sk == 1 or (causal and sq == 1))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 64, 112, 128])
def test_flash_attention_bwd_kernel_fails_with_the_other_mask(exact_f32, dtype, d):
    """The negative control: the same comparison against the plain version
    with ``causal`` flipped must fail its tolerance."""
    ops_ = _bwd_operands(exact_f32, dtype, d, 200, 200, 3, 1, True)
    got = flash_kernel.flash_attention_bwd_cuda(*ops_, causal=True)
    assert _bwd_within(got, ref.flash_attention_bwd_ref(*ops_, causal=True), dtype)
    assert not _bwd_within(got, ref.flash_attention_bwd_ref(*ops_, causal=False), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 32, 64, 112, 128])
def test_flash_attention_bwd_kernel_is_deterministic(exact_f32, dtype, d):
    """No atomics: two calls give bit-identical dq, dk and dv."""
    ops_ = _bwd_operands(exact_f32, dtype, d, 257, 257, 3, 2, True)
    first = flash_kernel.flash_attention_bwd_cuda(*ops_)
    second = flash_kernel.flash_attention_bwd_cuda(*ops_)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_attention_bwd_kernel_at_a_smollm_layer(dev):
    """One batch of smollm-135m's training attention: S = 2,048, 9 query
    heads on 3 KV heads of 64, causal, bf16."""
    gen = torch.Generator(device=dev).manual_seed(11)
    q, do = (torch.randn((1, 2048, 9, 64), generator=gen, device=dev).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((1, 2048, 3, 64), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    out, lse = flash_kernel.flash_attention_cuda(q, k, v, return_lse=True)
    got = flash_kernel.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, triangle=True)
    assert _bwd_within(got, want, torch.bfloat16)


def test_flash_attention_bwd_kernel_at_a_zamba2_layer(dev):
    """zamba2-7b's training attention: 2 x 2,048 tokens, 32 heads of 112,
    causal, bf16."""
    gen = torch.Generator(device=dev).manual_seed(12)
    q, k, v, do = (torch.randn((2, 2048, 32, 112), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = flash_kernel.flash_attention_cuda(q, k, v, return_lse=True)
    got = flash_kernel.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, triangle=True)
    assert _bwd_within(got, want, torch.bfloat16)


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", [
    (2, 2048, 1600, 32, 8, 128, False),     # the vision model's cross layer in training
    (4, 1500, 1500, 24, 24, 64, True)])     # musicgen's layer in training
def test_flash_attention_bwd_kernel_at_the_family_shapes(dev, b, sq, sk, h, kv, d, causal):
    gen = torch.Generator(device=dev).manual_seed(14)
    q, do = (torch.randn((b, sq, h, d), generator=gen, device=dev).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn((b, sk, kv, d), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    out, lse = flash_kernel.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    got = flash_kernel.flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal, triangle=causal)
    assert _bwd_within(got, want, torch.bfloat16)


def test_flash_attention_bwd_wrapper_rejects_bad_operands(dev):
    q, k, v, out, lse, do = _bwd_operands(dev, torch.bfloat16, 64, 64, 64, 2, 2, True)
    before = flash_kernel.flash_attention_bwd_cuda.launches
    bad = [
        (q.cpu(), k, v, out, lse, do),                        # not on the card
        (q, k, v, out, lse.to(torch.bfloat16), do),           # lse not float32
        (q, k, v, out, lse[:, :1].contiguous(), do),          # lse of the wrong shape
        (q, k, v, out, lse, do.float()),                      # do of another type
        (q, k, v, out.transpose(1, 2).contiguous().transpose(1, 2), lse, do),   # strided out
        (q, k, v, out, lse, do[:, :32]),                      # do of the wrong shape
        (q[..., :8].contiguous(), k[..., :8].contiguous(), v[..., :8].contiguous(),
         out[..., :8].contiguous(), lse, do[..., :8].contiguous()),            # head dim 8
        (q.half(), k.half(), v.half(), out.half(), lse, do.half()),            # float16
    ]
    for args in bad:
        with pytest.raises(ValueError):
            flash_kernel.flash_attention_bwd_cuda(*args)
    with pytest.raises(ValueError, match="impl='ref'"):
        ops.flash_attention_bwd(q, k, v, out, lse, do, impl="ref")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.flash_attention_bwd(q, k, v, out, lse, do, impl="swar")
    assert flash_kernel.flash_attention_bwd_cuda.launches == before


# The query offset (a slice of the q sequence against the whole K and V):
# q's sq rows sit at positions offset .. offset + sq - 1.  The tile edges
# of FLASH_SHAPES: offsets that are not multiples of a tile, slices shorter than one
# tile, a causal slice whose last rows lie past Sk, key blocks no row of the
# slice sees (their dk and dv must be written as zeros), and a non-causal
# call, which ignores the offset.
OFFSET_SHAPES = [  # sq, sk, offset, causal, group, kv
    (64, 256, 192, True, 3, 1), (1, 129, 128, True, 1, 2), (100, 300, 37, True, 4, 2),
    (127, 255, 128, True, 8, 1), (129, 257, 1, True, 3, 1), (33, 200, 167, True, 1, 2),
    (50, 100, 80, True, 3, 1), (200, 64, 13, True, 4, 1), (3, 400, 5, True, 7, 1),
    (64, 192, 65, False, 3, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 112, 128])
@pytest.mark.parametrize("sq,sk,offset,causal,group,kv", OFFSET_SHAPES)
def test_flash_attention_kernels_with_an_offset_match_plain_versions(exact_f32, dtype, d, sq, sk,
                                                                     offset, causal, group, kv):
    q, k, v = _flash_operands(exact_f32, dtype, d, sq, sk, group, kv)
    gen = torch.Generator(device=exact_f32).manual_seed(sq + offset)
    do = torch.randn(q.shape, generator=gen, device=exact_f32).to(dtype)
    out, lse = flash_kernel.flash_attention_cuda(q, k, v, causal=causal, q_offset=offset,
                                                 return_lse=True)
    want, want_lse = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=offset,
                                             return_lse=True)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out, want, rtol=tol, atol=tol)
    assert bool(((lse - want_lse).abs() <= 1e-4 * (1 + want_lse.abs())).all())
    if dtype == torch.float32:   # the CUDA-core instance takes the offset too
        simt = flash_kernel.flash_attention_cuda(q, k, v, causal=causal, q_offset=offset,
                                                 instance="simt_f32")
        torch.testing.assert_close(simt, want, rtol=tol, atol=tol)
    got = flash_kernel.flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal,
                                                q_offset=offset)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert _bwd_within(got, ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                                        q_offset=offset), dtype)
    if causal and offset + sq < sk:   # keys past the last row's position: zero, written
        for g in got[1:]:
            assert not bool(g[:, offset + sq:].any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_offset_slices_recompose_the_whole(exact_f32, dtype, d):
    """Four q slices with their offsets, against one causal call on the
    whole q: outputs and dq are the whole's rows, dk and dv sum to the
    whole's; every slice given offset 0 (the control) does not."""
    q, k, v = _flash_operands(exact_f32, dtype, d, 300, 300, 3, 2)
    do = torch.randn(q.shape, device=exact_f32).to(dtype)
    out, lse = flash_kernel.flash_attention_cuda(q, k, v, return_lse=True)
    whole = flash_kernel.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    tol = FLASH_TOL[dtype]
    bounds = (0, 61, 150, 203, 300)

    def slices(offsets):
        outs, dqs, dk, dv = [], [], 0, 0
        for (r0, r1), off in zip(zip(bounds[:-1], bounds[1:]), offsets):
            qs, ds = q[:, r0:r1].contiguous(), do[:, r0:r1].contiguous()
            o, l = flash_kernel.flash_attention_cuda(qs, k, v, q_offset=off, return_lse=True)
            g = flash_kernel.flash_attention_bwd_cuda(qs, k, v, o, l, ds, q_offset=off)
            outs.append(o)
            dqs.append(g[0])
            dk, dv = dk + g[1].float(), dv + g[2].float()
        return torch.cat(outs, 1), (torch.cat(dqs, 1), dk.to(dtype), dv.to(dtype))

    got_out, got_grads = slices(bounds[:-1])
    torch.testing.assert_close(got_out, out, rtol=tol, atol=tol)
    assert _bwd_within(got_grads, whole, dtype)
    bad_out, _ = slices((0,) * 4)
    assert not torch.allclose(bad_out, out, rtol=tol, atol=tol)


def test_flash_attention_bwd_dispatch_on_the_card(exact_f32):
    """``auto`` and ``cuda`` launch the kernel on CUDA tensors, each once."""
    ops_ = _bwd_operands(exact_f32, torch.bfloat16, 32, 100, 100, 3, 1, True)
    before = flash_kernel.flash_attention_bwd_cuda.launches
    auto = ops.flash_attention_bwd(*ops_)
    cuda = ops.flash_attention_bwd(*ops_, impl="cuda")
    assert flash_kernel.flash_attention_bwd_cuda.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(auto, cuda))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layers_flash_attention_backward_runs_the_kernel(exact_f32, dtype, monkeypatch):
    """The autograd ``layers.flash_attention`` on CUDA tensors: one forward
    launch with lse, one backward launch of the static rule's instance, and
    the plain backward never; its gradients are the kernel's on the saved
    out and lse."""
    from repro_torch.models import layers

    q, k, v = (t.detach().requires_grad_() for t in
               _flash_operands(exact_f32, dtype, 64, 130, 130, 3, 1))
    w = torch.randn(q.shape, device=exact_f32).to(dtype)
    fwd, bwd = flash_kernel.flash_attention_cuda, flash_kernel.flash_attention_bwd_cuda
    before = fwd.lse_launches, bwd.launches, dict(bwd.instance_launches)

    def plain_backward(*args, **kw):
        raise AssertionError("the plain backward ran on the card")

    monkeypatch.setattr(ref, "flash_attention_bwd_ref", plain_backward)
    (layers.flash_attention(q, k, v) * w).sum().backward()
    torch.cuda.synchronize()
    monkeypatch.undo()
    name = flash_kernel.bwd_instance(dtype)
    assert (fwd.lse_launches - before[0], bwd.launches - before[1]) == (1, 1)
    assert bwd.instance_launches[name] == before[2][name] + 1
    out, lse = flash_kernel.flash_attention_cuda(q.detach(), k.detach(), v.detach(),
                                                 return_lse=True)
    want = flash_kernel.flash_attention_bwd_cuda(q.detach(), k.detach(), v.detach(), out, lse,
                                                 w.contiguous())
    assert all(torch.equal(g, x) for g, x in zip((q.grad, k.grad, v.grad), want))


# The mesh drivers on the card: ranks are processes of their own, sharing
# cuda:0 through a gloo group (a file store, loopback only).
_MESH_CHILD = r"""
import json, os
import numpy as np
import torch
import torch.distributed as dist
torch.cuda.set_device(0)
dist.init_process_group(os.environ["BACKEND"], init_method=os.environ["INIT"],
                        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
from repro_torch.launch.mesh import make_mesh
if os.environ["BACKEND"] == "nccl":
    try:
        make_mesh((2,), ("data",))
    except RuntimeError as e:
        assert "one GPU per rank" in str(e), e
        print("REFUSED", e)
    else:
        raise AssertionError("a 2-rank NCCL mesh on one GPU was accepted")
else:
    from repro_torch.core import engine, join
    from repro_torch.core.collection import Collection
    from repro_torch.distributed import sharded_indexed_join_prepared
    from repro_torch.kernels import bitmap_filter, postings
    d = np.load(os.environ["DATA"])
    prep = engine.prepare(Collection(tokens=d["tokens"], lengths=d["lengths"]), "cuda")
    mesh = make_mesh((2,), ("data",))
    ring, counters, _ = join.ring_join_prepared(prep, mesh=mesh, sim="jaccard", tau=0.8,
                                                return_stats=True)
    # Capacity 8: steps overflow, and their tiles are re-run on the card.
    forced, forced_counters, forced_ovf = join.ring_join_prepared(
        prep, mesh=mesh, sim="jaccard", tau=0.8, capacity_per_step=8, return_stats=True)
    si, stats = sharded_indexed_join_prepared(prep, mesh=mesh, sim="jaccard", tau=0.8,
                                              return_stats=True)
    np.savez(os.environ["OUT"], ring=ring, counters=counters, si=si, forced=forced,
             forced_counters=forced_counters, forced_ovf=forced_ovf)
    with open(os.environ["OUT"] + ".json", "w") as f:
        json.dump({"stats": stats.to_dict(),
                   "launches": [bitmap_filter.candidate_matrix_mxu_cuda.launches,
                                postings.expand_filter_cuda.launches,
                                postings.verdict_verify_cuda.launches]}, f)
dist.destroy_process_group()
"""


def _mesh_ranks(tmp_path, backend, data=None):
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=src, BACKEND=backend, RANK=str(r), WORLD_SIZE="2",
                   INIT=f"file://{tmp_path}/store_{backend}", OUT=str(tmp_path / f"r{r}.npz"),
                   DATA=str(data), GLOO_SOCKET_IFNAME="lo")
        procs.append(subprocess.Popen([sys.executable, "-c", _MESH_CHILD], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    if backend == "nccl":
        return outs
    return [(np.load(tmp_path / f"r{r}.npz"),
             json.loads((tmp_path / f"r{r}.npz.json").read_text())) for r in range(2)]


def test_mesh_drivers_on_two_gloo_ranks_match_the_single_device_joins(dev, tmp_path):
    """The ring and sharded-indexed drivers on 2 gloo ranks sharing the card
    return, on both ranks, the blocked join's pairs and the indexed join's
    pairs and ``JoinStats``, through ``candidate_matrix_mxu`` and the stage
    kernels; so does the ring with a capacity that overflows its steps."""
    col = with_duplicates(skewed_collection(n_sets=8000, seed=5), n_clusters=80,
                          cluster_size=3, jaccard=0.9, seed=5)
    np.savez(tmp_path / "data.npz", tokens=col.tokens, lengths=col.lengths)
    prep = engine.prepare(col, dev)
    blocked = join.blocked_bitmap_join_prepared(prep, sim="jaccard", tau=0.8)
    ipairs, istats = candidates.indexed_join_prepared(prep, sim="jaccard", tau=0.8,
                                                      return_stats=True)
    assert len(blocked) > 50 and np.array_equal(ipairs, blocked)
    for got, info in _mesh_ranks(tmp_path, "gloo", tmp_path / "data.npz"):
        assert np.array_equal(got["ring"], blocked)
        assert got["counters"][:, 1].sum() == len(blocked)
        assert got["forced_ovf"].any() and np.array_equal(got["forced"], blocked)
        assert got["forced_counters"][:, 1].sum() == len(blocked)
        assert np.array_equal(got["forced_counters"][:, 0], got["counters"][:, 0])
        assert np.array_equal(got["si"], ipairs) and info["stats"] == istats.to_dict()
        assert min(info["launches"]) > 0, info["launches"]


def test_nccl_mesh_refuses_two_ranks_on_one_gpu(dev, tmp_path):
    if torch.cuda.device_count() != 1:
        pytest.skip("needs a machine with exactly one GPU")
    outs = _mesh_ranks(tmp_path, "nccl")
    assert all("REFUSED" in o for o in outs), outs


_SERVE_CHILD = r"""
import json, os
import torch
import torch.distributed as dist
from repro_torch import configs
from repro_torch.distributed.sharding import activation_sharding
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import DecodeEngine, Model
from repro_torch.models.decode import sharded_decode_step, sharded_prefill
from repro_torch.models.model import param_specs

dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=0, world_size=1)
mesh = make_mesh((1, 1), ("data", "model"))
cfg = configs.get_reduced("qwen3-8b", dtype="bfloat16")
model = Model(cfg, device="cuda")
tok = torch.randint(0, cfg.vocab_size, (2, 40), device="cuda", dtype=torch.int32)
with torch.inference_mode():
    want, cache = DecodeEngine(model).prefill(model, {"tokens": tok[:, :32]}, max_len=40)
    step_want, _ = DecodeEngine(model).decode_step(model, cache, {"tokens": tok[:, 32:33]})
    fa.reset_launches()
    with activation_sharding(mesh):
        got, cache = sharded_prefill(cfg, model.param_tree(), param_specs(cfg, mesh),
                                     {"tokens": tok[:, :32]}, max_len=40)
        launches = fa.flash_attention_cuda.launches
        step_got, _ = sharded_decode_step(cfg, model.param_tree(), param_specs(cfg, mesh), cache,
                                          {"tokens": tok[:, 32:33]})
err = [float((g.float() - w.float()).norm() / w.float().norm())
       for g, w in ((got, want), (step_got, step_want))]
print("RESULT " + json.dumps({"launches": launches, "layers": cfg.num_layers, "err": err}))
dist.destroy_process_group()
"""


def test_sharded_serving_on_the_card_launches_the_flash_kernel(dev, tmp_path):
    """``sharded_prefill`` on a (1, 1) mesh of one gloo rank over the card
    launches the flash kernel once a layer, and its logits and the next
    decode step's equal the single-device engine's (bf16: within 1e-3
    relative RMS; the same kernels on the same operands)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"),
               INIT=f"file://{tmp_path}/store", GLOO_SOCKET_IFNAME="lo")
    out = subprocess.run([sys.executable, "-c", _SERVE_CHILD], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads([x for x in out.stdout.splitlines() if x.startswith("RESULT ")][-1][7:])
    assert res["launches"] == res["layers"]
    assert max(res["err"]) < 1e-3, res


def test_dryrun_join_cell_runs_row_1_on_the_card(dev, tmp_path):
    """The dry run's join cell runs one rank's 256 ring hops on the card
    under a fake group of 256 ranks: row 1 launched once a hop, 255 hops
    recorded, and every candidate verified or not (counts from real rows)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "bitmap-join", "--shape", "join_1m", "--out", str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    rec = json.loads((tmp_path / "bitmap-join__join_1m__single.json").read_text())
    assert rec["ok"] and rec["device"].startswith("cuda") and rec["hops"] == 256
    assert rec["row1_launches"] == 256
    (hop,) = [c for c in rec["hlo"]["collectives"] if c["opcode"] == "collective-permute"]
    assert hop["count"] == 255 and hop["group_size"] == 256
    assert 0 < rec["verified"] <= rec["candidates"]


def _build_rows(n: int, b: int, seed: int, l: int | None = None):
    """int32 tokens [n, l] (l = b + 8 by default) and lengths holding the
    bitmap build's edge cases that fit in l (probes that wrap past bit
    b - 1, rows of exactly b and of more than b tokens, an empty row, PAD
    inside a length, a length past the row), the other rows random of the
    sizes the joins see."""
    rng = np.random.default_rng(seed + b)
    l = b + 8 if l is None else l
    toks = np.full((n, l), PAD_TOKEN, np.int32)
    lens = rng.integers(0, min(60, l) + 1, n).astype(np.int32)
    for i, k in enumerate(lens):
        toks[i, :k] = rng.integers(0, 2**31 - 1, k)
    edges = [(b - 1) + b * np.arange(min(12, l)), rng.choice(100 * b, b, replace=False),
             rng.choice(100 * b, b + 8, replace=False), rng.integers(0, 3 * b, b + 8), []]
    edges = [row for row in edges if len(row) <= l]
    for i, row in enumerate(edges[:n]):
        toks[i] = PAD_TOKEN
        toks[i, :len(row)] = row
        lens[i] = len(row)
    if n > 6:
        toks[5, [0, l // 2]] = PAD_TOKEN
        lens[5] = l
        lens[6] = l + 5
    return toks, lens


# (n, b, l): widths that are and are not powers of two, N of 0 and 1, and
# a width whose words exceed one warp's 48 KB of shared memory, so its
# bits live in the output row (rows of 64 tokens: the plain Next loops
# over token positions).
BUILD_SHAPES = [(n, b, None) for n in (0, 1, 7, 1000) for b in (32, 96, 160, 1024, 4096)]
BUILD_SHAPES += [(n, 32 * 12289, 64) for n in (0, 1, 7, 40)]


@pytest.mark.parametrize("n,b,l", BUILD_SHAPES)
def test_bitmap_build_kernel_matches_plain_version(dev, n, b, l):
    toks, lens = _build_rows(n, b, seed=n, l=l)
    t, l = torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev)
    for method in ("set", "xor", "next"):
        for mix in (False, True):
            before = bitmap_build.WRAPPERS[method].launches
            got = bitmap_build.bitmap_build_cuda(t, l, b, method, mix)
            torch.cuda.synchronize()
            want = ref.bitmap_build_ref(t, l, b, method, mix)
            assert got.shape == (n, b // 32) and torch.equal(got, want), (method, mix)
            assert bitmap_build.WRAPPERS[method].launches == before + (n > 0)


def _form_rows(kind: str, n: int, b: int, l: int | None, seed: int):
    """Rows for the two forms: ``edges`` as :func:`_build_rows`;
    ``unsorted``, one warp of rows whose lengths run from 0 to b + 8 in a
    seeded order; ``saturate``, rows of distinct tokens longer than b, each
    a different length, so that lanes fill their bitmaps at different
    positions (PAD inside some); ``unaligned``, the rows after the first of
    an odd-width block (a base 4 bytes past a 16-byte boundary)."""
    rng = np.random.default_rng(seed + b)
    if kind in ("edges", "unaligned"):
        toks, lens = _build_rows(n + (kind == "unaligned"), b, seed, l)
        return (toks[1:], lens[1:]) if kind == "unaligned" else (toks, lens)
    l = b + 8 if l is None else l
    toks = np.full((n, l), PAD_TOKEN, np.int32)
    if kind == "unsorted":
        lens = rng.permutation(np.linspace(0, b + 8, n).astype(np.int32))
    else:
        lens = np.minimum(b + 1 + 3 * rng.permutation(n), l).astype(np.int32)
    for i, k in enumerate(lens):
        toks[i, :k] = rng.choice(100 * b, k, replace=False)
        if kind == "saturate":   # row i fills after i PADs at most
            toks[i, rng.choice(k, min(i, k // 2), replace=False)] = PAD_TOKEN
    return toks, lens


# (kind, n, b, l): N around one warp; one warp of unsorted lengths; every
# lane-form instance (words in registers at b = 32-256, in shared memory at
# 288, 512, 992 and 1,024); rows longer than many read-ahead chunks; lanes
# saturating at different positions; the lane form's widest b and one word
# above it (the warp form only); an unaligned base with an odd L.
FORM_CASES = [("edges", n, b, None) for n in (1, 31, 32, 33, 1000) for b in (32, 128, 1024)]
FORM_CASES += [("unsorted", 32, b, None) for b in (32, 96, 128, 256, 1024)]
FORM_CASES += [("edges", 100, b, None) for b in (64, 96, 160, 256, 288, 512, 992)]
FORM_CASES += [("edges", 100, 4096, 200), ("saturate", 64, 64, 300),
               ("saturate", 32, 32, 130), ("saturate", 33, 288, 400),
               ("edges", 40, 32 * bitmap_build.LANE_MAX_WORDS, 64),
               ("edges", 40, 32 * bitmap_build.LANE_MAX_WORDS + 32, 64),
               ("unaligned", 45, 128, 37), ("unaligned", 45, 1024, 101)]


@pytest.mark.parametrize("kind,n,b,l", FORM_CASES)
def test_bitmap_build_forms_match_plain_version(dev, kind, n, b, l):
    toks, lens = _form_rows(kind, n, b, l, seed=n)
    t, ln = torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev)
    if kind == "unaligned":
        base = torch.from_numpy(_form_rows("edges", n + 1, b, l, seed=n)[0]).to(dev)
        t = base[1:]
        assert t.is_contiguous() and t.data_ptr() % 16 and torch.equal(t.cpu(),
                                                                        torch.from_numpy(toks))
    lane_ok = b // 32 <= bitmap_build.LANE_MAX_WORDS
    for method in ("set", "xor", "next"):
        wrapper = bitmap_build.WRAPPERS[method]
        if not lane_ok:
            with pytest.raises(ValueError, match="lane form"):
                bitmap_build.bitmap_build_cuda(t, ln, b, method, form="lane")
        for mix in (False, True):
            want = ref.bitmap_build_ref(t, ln, b, method, mix)
            for form in ("lane", "warp") if lane_ok else ("warp",):
                before = dict(wrapper.form_launches)
                got = bitmap_build.bitmap_build_cuda(t, ln, b, method, mix, form=form)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (method, mix, form)
                assert wrapper.form_launches == before | {form: before[form] + 1}


def test_generate_bitmaps_on_the_card_runs_the_kernel(dev, monkeypatch):
    toks, lens = _build_rows(300, 128, seed=3)
    t, l = torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev)
    want = {m: ref.bitmap_build_ref(t, l, 128, m) for m in ("set", "xor", "next")}

    def plain(*args):
        raise AssertionError("a plain generator ran on CUDA tensors")

    monkeypatch.setattr(bitmap, "GENERATORS", dict.fromkeys(bitmap.GENERATORS, plain))
    for method, tau in (("set", None), ("xor", None), ("next", None), ("combined", 0.35)):
        resolved = bitmap.choose_method(tau, 128) if tau else method
        before = bitmap_build.WRAPPERS[resolved].launches
        got = bitmap.generate_bitmaps(t.long(), l.long(), 128, method=method, tau_jaccard=tau)
        assert torch.equal(got, want[resolved])
        bits = bitmap.generate_bitmaps(t, l, 128, method=method, tau_jaccard=tau, packed=False)
        assert torch.equal(bits, bitmap.unpack_bits(want[resolved]))
        assert bitmap_build.WRAPPERS[resolved].launches == before + 2


def test_bitmap_build_wrapper_rejects_bad_operands(dev):
    toks, lens = _build_rows(8, 64, seed=1)
    t, l = torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev)
    for bad in ((t.long(), l, 64), (t, l.long(), 64), (t, l, 48), (t, l, 0), (t, l, 64.0),
                (t.t(), l, 64), (t, l[:4], 64), (t.cpu(), l, 64), (t[0], l, 64)):
        with pytest.raises(ValueError):
            bitmap_build.bitmap_build_next_cuda(*bad)
    with pytest.raises(ValueError):
        ops.bitmap_build(t, l, 64, "combined")
