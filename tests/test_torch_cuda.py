"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one.  The file imports neither JAX nor ``repro``, so it also runs on a GPU
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports the JAX package.)

All outputs are integers or bools: the comparisons are exact.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import bitmap, bounds, join
from repro_torch.core.constants import COSINE, PAD_TOKEN
from repro_torch.data.collections import skewed_collection, with_duplicates
from repro_torch.kernels import bitmap_filter, compaction, ops, ref

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
    wr, ws, lr, ls = _operands(70, 50, 4, 1, dev)
    before = (bitmap_filter.candidate_matrix_cuda.launches,
              compaction.count_candidates_cuda.launches)
    ops.candidate_matrix(wr, ws, lr, ls, "jaccard", 0.8, False)
    ops.count_candidates(wr, ws, lr, ls, lr, lr, "jaccard", 0.8)
    assert bitmap_filter.candidate_matrix_cuda.launches == before[0] + 1
    assert compaction.count_candidates_cuda.launches == before[1] + 1


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
