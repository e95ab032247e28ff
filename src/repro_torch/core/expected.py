"""Expected overlap upper bounds and cutoff points (paper Sections 3.4-3.5).

Closed forms for the expected overlap upper bound E(b, n) between two *random*
(disjoint-by-chance) sets of ``n`` tokens hashed into ``b``-bit bitmaps:

* Eq. 4 (Bitmap-Set):   E = n + (b-1)^{2n}/b^{2n-1} - (b-1)^n/b^{n-1}
* Eq. 5 (Bitmap-Xor):   E = n - b/2 * P(odd #tokens hash to a bit over 2n draws)
                          = n - b/2 * (1 - (1 - 2/b)^{2n}) / 2 * 2
  (the parity closed form (1-(1-2/b)^{2n})/2, equal to the paper's
  binomial sum)
* Eq. 6 (Bitmap-Next):  E = min(n^2 / b, n)

From these the **cutoff point** omega(b, tau) — the largest set size at which
the filter still discriminates at Jaccard threshold tau — and the
**Bitmap-Combined** crossovers are derived numerically.

All computations are done in log space where needed so they stay stable for
the n ~ 10^4, b ~ 4096 regime plotted in Fig. 6 of the paper.

A numpy copy of ``repro.core.expected`` for the PyTorch port; only
:func:`monte_carlo_expected_bound` touches torch, to generate its bitmaps
on a device.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from repro_torch.core.constants import BITMAP_NEXT, BITMAP_SET, BITMAP_XOR


def expected_bound_set(b: int, n: np.ndarray | int) -> np.ndarray:
    """Eq. 4 — expected overlap upper bound for Bitmap-Set ("mark")."""
    n = np.asarray(n, dtype=np.float64)
    # (b-1)^{kn} / b^{kn-1} = b * ((b-1)/b)^{kn}; do it in log space.
    log_q = math.log((b - 1) / b)
    term1 = np.exp(math.log(b) + 2.0 * n * log_q)  # b * q^{2n}
    term2 = np.exp(math.log(b) + n * log_q)  # b * q^{n}
    return n + term1 - term2


def expected_bound_xor(b: int, n: np.ndarray | int) -> np.ndarray:
    """Eq. 5 — expected overlap upper bound for Bitmap-Xor.

    P(bit differs) = P(odd number of the 2n tokens hash to it)
                   = (1 - (1 - 2/b)^{2n}) / 2      (binomial parity identity)
    E[hamming] = b * P;  bound = n - E[hamming]/2.
    """
    n = np.asarray(n, dtype=np.float64)
    p_odd = 0.5 * (1.0 - np.power(1.0 - 2.0 / b, 2.0 * n))
    return n - 0.5 * b * p_odd


def expected_bound_xor_sum(b: int, n: int) -> float:
    """Eq. 5 exactly as printed (explicit odd-k binomial sum). O(n) terms.

    Used in tests to confirm the parity closed form above.
    """
    total = 0.0
    for k in range(1, 2 * n + 1, 2):
        total += math.comb(2 * n, k) * (1.0 / b) ** k * ((b - 1.0) / b) ** (2 * n - k)
    return n - 0.5 * b * total


def expected_bound_next(b: int, n: np.ndarray | int) -> np.ndarray:
    """Eq. 6 — expected overlap upper bound for Bitmap-Next."""
    n = np.asarray(n, dtype=np.float64)
    return np.minimum(n * n / b, n)


_EXPECTED = {
    BITMAP_SET: expected_bound_set,
    BITMAP_XOR: expected_bound_xor,
    BITMAP_NEXT: expected_bound_next,
}


def expected_bound(method: str, b: int, n: np.ndarray | int) -> np.ndarray:
    return _EXPECTED[method](b, n)


def jaccard_of_overlap(o: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Equivalent Jaccard of an overlap ``o`` between two size-``n`` sets."""
    o = np.asarray(o, dtype=np.float64)
    n = np.asarray(n, dtype=np.float64)
    denom = np.maximum(2.0 * n - o, 1e-300)
    return o / denom


@functools.lru_cache(maxsize=None)
def cutoff_point(method: str, b: int, tau_jaccard: float, n_max: int = 1 << 22) -> int:
    """omega(b, tau): max n such that the *expected* bound still prunes.

    Defined (Section 3.5) by E(b, n) == tau on the normalised scale; we return
    the largest ``n`` whose expected equivalent-Jaccard bound is <= tau.
    E-jaccard is monotonically increasing in n for all three methods, so a
    binary search suffices.
    """

    def ejac(n: int) -> float:
        return float(jaccard_of_overlap(expected_bound(method, b, n), n))

    if ejac(1) > tau_jaccard:
        return 0
    lo, hi = 1, 2
    while hi < n_max and ejac(hi) <= tau_jaccard:
        lo, hi = hi, hi * 2
    hi = min(hi, n_max)
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if ejac(mid) <= tau_jaccard:
            lo = mid
        else:
            hi = mid
    return lo


@functools.lru_cache(maxsize=None)
def combined_crossovers(b: int, grid: int = 400) -> tuple[float, float]:
    """Thresholds where the best generation method changes (Algorithm 6).

    Returns ``(lo, hi)``: Bitmap-Next wins for tau <= lo, Bitmap-Set for
    lo < tau < hi, Bitmap-Xor for tau >= hi.  The paper reports ~(0.56, 0.73)
    for b >= 64; we recompute from Eq. 4-6.
    """
    taus = np.linspace(0.05, 0.99, grid)
    best = []
    for t in taus:
        cuts = {m: cutoff_point(m, b, float(t)) for m in (BITMAP_SET, BITMAP_XOR, BITMAP_NEXT)}
        best.append(max(cuts, key=lambda m: cuts[m]))
    lo = 0.0
    hi = 1.0
    for t, m in zip(taus, best):
        if m == BITMAP_NEXT:
            lo = max(lo, float(t))
    for t, m in zip(taus, best):
        if m == BITMAP_XOR:
            hi = min(hi, float(t))
            break
    # Guard: degenerate grids (tiny b) — keep ordering sane.
    if hi < lo:
        lo = hi
    return lo, hi


def monte_carlo_expected_bound(
    method: str,
    b: int,
    n: int,
    trials: int = 2000,
    seed: int = 0,
    *,
    device=None,
) -> float:
    """Empirical E(b, n) via random disjoint pairs (paper's validation, §3.4).

    Tokens are drawn uniformly from a large universe; the expected *bound*
    (Eq. 2) is averaged over random pairs.  The bitmaps are generated on
    ``device`` (the card when ``None``); the popcount is numpy's on the
    host, as in the reference.
    """
    # Imported here: filters imports this module.
    from repro_torch.core.filters import words_numpy

    rng = np.random.default_rng(seed)
    universe = 1 << 30
    toks = rng.integers(0, universe, size=(2 * trials, n), dtype=np.int64)
    toks = np.sort(toks, axis=1).astype(np.int32)
    lengths = np.full((2 * trials,), n, dtype=np.int32)
    words = words_numpy(toks, lengths, b, method, False, device)
    wr, ws = words[:trials], words[trials:]
    x = wr ^ ws
    lut = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)
    ham = lut[x.view(np.uint8)].reshape(trials, -1).sum(axis=1)
    # Real-valued bound (no floor) to match the closed forms' expectation.
    bound = (2 * n - ham) / 2.0
    return float(bound.mean())


@functools.lru_cache(maxsize=None)
def combined_crossovers_normalized(b: int) -> tuple[float, float]:
    """The Algorithm 6 crossovers on the *normalised-overlap* scale.

    The paper states the Bitmap-Combined thresholds as (0.56, 0.73) on the
    normalised overlap scale E/n of Fig. 5's left axis, tau_norm = 2*tau_j /
    (1 + tau_j); :func:`combined_crossovers` returns the Jaccard-scale
    values (~0.39, ~0.57 for b >= 64), which map onto the paper's pair.
    """
    lo_j, hi_j = combined_crossovers(b)
    to_norm = lambda tj: 2.0 * tj / (1.0 + tj)
    return to_norm(lo_j), to_norm(hi_j)
