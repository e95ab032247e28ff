"""The port's indexed driver against the JAX package's on R×S joins and
under forced capacities, on the CPU (the self-joins and the postings index
are in ``tests/test_torch_index.py``, whose grid this file shares).

Pairs and every ``JoinStats`` counter must be identical for the 4
similarities × {uniform, skewed, dup-heavy}, and under capacities of 1 and 4
that overflow chunks into the dense fallback (``overflow_blocks`` included).
"""

import numpy as np
import pytest

from repro.core import join as jjoin
from repro.index import indexed_bitmap_join as jindexed
from repro_torch.index import indexed_bitmap_join as tindexed
from test_torch_index import KINDS, SIM_TAUS, _KW
from test_torch_join import _assert_same, _both, _sets


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sim,tau", SIM_TAUS)
def test_indexed_rs_join_matches_reference(kind, sim, tau):
    rng = np.random.default_rng(len(kind) + int(tau * 10))
    sets_r = _sets(kind, seed=5)
    sets_s = _sets(kind, seed=6, n=37)
    for k in range(4):  # cross-collection near-duplicates -> non-trivial joins
        sets_s[k] = sets_r[3 * k][: max(1, len(sets_r[3 * k]) - int(rng.integers(2)))]
    (rj, rt), (sj, st) = _both(sets_r), _both(sets_s)
    ref = jindexed(rj, sj, sim, tau, **_KW)
    got = tindexed(rt, st, sim, tau, device="cpu", **_KW)
    _assert_same(ref, got, (kind, sim))
    assert np.array_equal(got[0], jjoin.naive_join(rj, sj, sim, tau))


@pytest.mark.parametrize("cap", [1, 4])
@pytest.mark.parametrize("rs", [False, True])
def test_forced_capacity_overflow_matches_reference(cap, rs):
    cj, ct = _both(_sets("dup_heavy", seed=cap))
    args_j, args_t = (cj,), (ct,)
    if rs:
        sj, st = _both(_sets("dup_heavy", seed=cap + 10, n=30))
        args_j, args_t = (cj, sj), (ct, st)
    ref = jindexed(*args_j, "jaccard", 0.6, capacity=cap, **_KW)
    got = tindexed(*args_t, "jaccard", 0.6, capacity=cap, device="cpu", **_KW)
    _assert_same(ref, got, cap)
    assert got[1].overflow_blocks > 0
    assert np.array_equal(got[0], jjoin.naive_join(*args_j, "jaccard", 0.6))
