"""Threshold conversions, length bounds and the verdicts' threshold tables.

Implements Table 1 (similarities, equivalent overlap), Table 2 (length
bounds + prefix lengths), the Eq. 2 and positional upper bounds, plus the
integer tables that the Eq. 2 verdict and exact verification compare
against.  The host-side functions are numpy copies of
``repro.core.bounds``; the ``*_int``/``required_overlap*``/``*_gather``
twins take and return torch tensors.

The device prune test of every verdict is ``float32(ub) >=
required_overlap_safe(...)``.  The port never evaluates that float
expression on the device: :func:`prune_table` turns it, once on the host,
into the smallest integer ``ub`` that passes for each length key, so the CUDA
kernels and their plain versions compare integers only and cannot drift by
an ulp (nvcc contracts ``need * (1 - 1e-6) - 1e-6`` into an FMA by default).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.constants import COSINE, DICE, JACCARD, OVERLAP


# ---------------------------------------------------------------------------
# Similarity functions (Table 1)
# ---------------------------------------------------------------------------

def similarity(sim: str, overlap, len_r, len_s):
    """sim(r, s) given |r ∩ s| and the set sizes."""
    o = overlap
    if sim == OVERLAP:
        return o
    if sim == JACCARD:
        return o / (len_r + len_s - o)
    if sim == COSINE:
        return o / (len_r * 1.0 * len_s) ** 0.5
    if sim == DICE:
        return 2.0 * o / (len_r + len_s)
    raise ValueError(f"unknown similarity {sim!r}")


def equivalent_overlap(sim: str, tau: float, len_r, len_s):
    """Minimum overlap needed for sim(r,s) >= tau (Table 1, real-valued).

    Comparing an integer overlap ``o >= equivalent_overlap(...)`` is exactly
    equivalent to ``sim >= tau`` (monotone transformations; no rounding).
    """
    if sim == OVERLAP:
        return tau + 0.0 * (len_r + len_s)  # broadcast like inputs
    if sim == JACCARD:
        return tau / (1.0 + tau) * (len_r + len_s)
    if sim == COSINE:
        return tau * (len_r * 1.0 * len_s) ** 0.5
    if sim == DICE:
        return tau * (len_r + len_s) / 2.0
    raise ValueError(f"unknown similarity {sim!r}")


def min_overlap_int(sim: str, tau: float, len_r, len_s):
    """Smallest *integer* overlap the oracle accepts for (|r|, |s|): the
    ceiling of the float64 need :func:`naive_join` compares against."""
    need = equivalent_overlap(sim, tau, np.asarray(len_r, dtype=np.int64),
                              np.asarray(len_s, dtype=np.int64))
    return np.ceil(need).astype(np.int64)


def _table_keys(sim: str, lr_max: int, ls_max: int) -> np.ndarray:
    """Every key a threshold table is indexed by: ``|r|*|s|`` for cosine,
    ``|r|+|s|`` otherwise (overlap's need is constant; it keys like Jaccard)."""
    if sim not in (OVERLAP, JACCARD, COSINE, DICE):
        raise ValueError(f"unknown similarity {sim!r}")
    if sim == COSINE:
        # The table is O(lr_max·ls_max): fail loudly on absurd padded widths
        # (and keep the gather index inside int32).
        if lr_max * ls_max + 1 > (1 << 27):
            raise ValueError(
                f"cosine min-overlap table key space {lr_max}x{ls_max} "
                f"exceeds 2^27 entries; shard or narrow the collections")
        return np.arange(lr_max * ls_max + 1, dtype=np.int64)
    return np.arange(lr_max + ls_max + 1, dtype=np.int64)


@functools.lru_cache(maxsize=64)
def min_overlap_table(sim: str, tau: float, lr_max: int, ls_max: int):
    """Acceptance thresholds: int32 :func:`min_overlap_int` per length key.

    Indexed with :func:`min_overlap_gather`; comparing an exact integer
    overlap against it reproduces the float64 oracle's verdict with pure
    int32 arithmetic.  Cached per ``(sim, tau, lr_max, ls_max)``.
    """
    key = _table_keys(sim, lr_max, ls_max)
    if sim == COSINE:
        need = tau * (key * 1.0) ** 0.5
    elif sim == OVERLAP:
        need = tau + 0.0 * key
    elif sim == JACCARD:
        need = tau / (1.0 + tau) * key
    else:
        need = tau * key / 2.0
    tab = np.maximum(np.ceil(need), 0.0)
    return np.minimum(tab, np.iinfo(np.int32).max).astype(np.int32)


def _required_overlap_safe_f32(sim: str, tau: float, key: np.ndarray) -> np.ndarray:
    """``repro.core.bounds.required_overlap_safe`` per length key, evaluated
    in numpy float32 with the same operation order (no fused multiply-add).

    ``key`` is ``|r|+|s|`` (or ``|r|*|s|`` for cosine); ``f32(|r|)+f32(|s|)``
    and ``f32(|r|)*f32(|s|)`` round the same exact integer as ``f32(key)``.
    """
    k = key.astype(np.float32)
    if sim == OVERLAP:
        need = np.full_like(k, np.float32(tau))
    elif sim == JACCARD:
        need = np.float32(tau / (1.0 + tau)) * k
    elif sim == COSINE:
        need = np.float32(tau) * np.sqrt(k)
    elif sim == DICE:
        need = np.float32(tau / 2.0) * k
    else:
        raise ValueError(f"unknown similarity {sim!r}")
    return need * np.float32(1.0 - 1e-6) - np.float32(1e-6)


@functools.lru_cache(maxsize=64)
def prune_table(sim: str, tau: float, lr_max: int, ls_max: int) -> np.ndarray:
    """Prune thresholds: int32, indexed like :func:`min_overlap_table`.

    Entry ``k`` is the smallest integer ``u`` with ``float32(u) >=
    required_overlap_safe`` at key ``k``, so ``ub >= table[k]`` on the
    integer bound is exactly the reference's float32 prune test
    ``float32(ub) >= required_overlap_safe(...)`` (float32 rounding of an
    integer is monotone).  Entries are >= 0 because the safe need is
    >= -1e-6.
    """
    need = _required_overlap_safe_f32(sim, tau, _table_keys(sim, lr_max, ls_max))
    u = np.ceil(need.astype(np.float64)).astype(np.int64)
    # Above 2^24, float32(u - 1) can round up onto the need: step down until
    # the next integer below fails (never taken for integers below 2^24).
    while True:
        lower = (u - 1).astype(np.float32) >= need
        if not lower.any():
            break
        u = np.where(lower, u - 1, u)
    return np.minimum(u, np.iinfo(np.int32).max).astype(np.int32)


def min_overlap_gather(sim: str, table: torch.Tensor, len_r: torch.Tensor,
                       len_s: torch.Tensor) -> torch.Tensor:
    """Gather a threshold per pair from a :func:`min_overlap_table` or
    :func:`prune_table` tensor (key ``lr*ls`` for cosine, ``lr+ls`` else)."""
    len_r = len_r.to(torch.int64)
    len_s = len_s.to(torch.int64)
    idx = len_r * len_s if sim == COSINE else len_r + len_s
    return table[idx]


def verdict_from_hamming(ham: torch.Tensor, lr: torch.Tensor, ls: torch.Tensor,
                         table: torch.Tensor, *, sim: str, cutoff: int) -> torch.Tensor:
    """The bitmap filter's verdict from a Hamming distance, broadcast over
    int32 ``ham``/``lr``/``ls``: the Eq. 2 bound ``min((lr + ls - ham) // 2,
    min(lr, ls))`` against the :func:`prune_table` threshold, OR either
    length past the Alg. 7 cutoff; AND both lengths positive."""
    ub = torch.minimum((lr + ls - ham).div(2, rounding_mode="floor"),
                       torch.minimum(lr, ls))
    passed = ub >= min_overlap_gather(sim, table, lr, ls)
    cand = passed | (lr > cutoff) | (ls > cutoff)
    return cand & (lr > 0) & (ls > 0)


def required_overlap(sim: str, tau: float, lr, ls) -> torch.Tensor:
    """float32 torch twin of :func:`equivalent_overlap` (the reference's
    device threshold; the port's verdicts use :func:`prune_table`)."""
    lr = torch.as_tensor(lr).to(torch.float32)
    ls = torch.as_tensor(ls).to(torch.float32)
    if sim == OVERLAP:
        return torch.full_like(lr + ls, float(tau))
    if sim == JACCARD:
        return (tau / (1.0 + tau)) * (lr + ls)
    if sim == COSINE:
        # torch's float32 sqrt on the CPU is not always correctly rounded;
        # float64 sqrt rounded to float32 is, as the reference's is.
        return tau * torch.sqrt((lr * ls).to(torch.float64)).to(torch.float32)
    if sim == DICE:
        return (tau / 2.0) * (lr + ls)
    raise ValueError(f"unknown similarity {sim!r}")


def required_overlap_safe(sim: str, tau: float, lr, ls) -> torch.Tensor:
    """Prune-side lower bound on the float64 equivalent overlap: the float32
    need relaxed by a ≤1e-6 relative margin, so a float32 prune is a strict
    subset of the float64 one."""
    need = required_overlap(sim, tau, lr, ls)
    return need * (1.0 - 1e-6) - 1e-6


# ---------------------------------------------------------------------------
# Length filter bounds (Table 2)
# ---------------------------------------------------------------------------

def length_bounds(sim: str, tau: float, len_r):
    """(lower, upper) real-valued bounds on |s| for sim(r,s) >= tau."""
    if sim == OVERLAP:
        lower = tau + 0.0 * len_r
        upper = np.inf + 0.0 * len_r
    elif sim == JACCARD:
        lower = len_r * tau
        upper = len_r / tau
    elif sim == COSINE:
        lower = len_r * tau * tau
        upper = len_r / (tau * tau)
    elif sim == DICE:
        lower = len_r * tau / (2.0 - tau)
        upper = len_r * (2.0 - tau) / tau
    else:
        raise ValueError(f"unknown similarity {sim!r}")
    return lower, upper


def length_window_int(sim: str, tau: float, len_r):
    """Integer-exact admissible partner-size window per |r| (int32 lo, hi).

    The float Table 2 bounds are only the starting guess (``5 * 0.8 ==
    4.0000000000000002``); each side is corrected against the need test
    itself — a partner size ``m`` is admissible iff ``min(|r|, m)`` reaches
    :func:`equivalent_overlap` — which is the test verification applies.
    """
    n = np.asarray(len_r, dtype=np.int64)
    lo, hi = length_bounds(sim, tau, n.astype(np.float64))
    int32_max = np.int64(np.iinfo(np.int32).max)
    lo_i = np.maximum(np.ceil(lo), 0.0).astype(np.int64)
    lo_i = np.minimum(lo_i, int32_max)
    hi_i = np.where(np.isfinite(hi), np.floor(hi), float(int32_max))
    hi_i = np.minimum(hi_i, float(int32_max)).astype(np.int64)

    def admissible(m):
        ok = (m >= 1) & (n >= 1)
        need = equivalent_overlap(sim, tau, n, m)
        return ok & (np.minimum(n, m) >= need)

    # Widen (never shrink) each side by the at-most-one integer the float
    # guess can be off.
    lo_i = np.where(admissible(lo_i - 1), lo_i - 1, lo_i)
    hi_i = np.where(admissible(hi_i + 1), hi_i + 1, hi_i)
    return (np.minimum(lo_i, int32_max).astype(np.int32),
            np.minimum(hi_i, int32_max).astype(np.int32))


def prefix_length(sim: str, tau: float, n):
    """Prefix size for a set of size ``n`` (1-overlap prefix schema), derived
    from the oracle's own acceptance test: ``n - o_min + 1`` with ``o_min``
    the ceiling of the need at the smallest admissible partner size."""
    n_arr = np.asarray(n, dtype=np.int64)
    if sim not in (OVERLAP, JACCARD, COSINE, DICE):
        raise ValueError(f"unknown similarity {sim!r}")
    lo, _hi = length_window_int(sim, tau, np.maximum(n_arr, 1))
    o_min_f = equivalent_overlap(sim, tau, n_arr, np.maximum(lo.astype(np.int64), 1))
    o_min = np.maximum(np.ceil(o_min_f), 1.0)
    p = n_arr - o_min + 1
    return np.minimum(np.maximum(p, 0), n_arr).astype(np.int64)


def prefix_length_ell(sim: str, tau: float, n, ell: int):
    """ℓ-prefix schema (Section 2.3.5): the 1-prefix length plus ``ell - 1``,
    capped at the set size (the postings index's per-set prefix)."""
    n = np.asarray(n)
    base = prefix_length(sim, tau, n)
    return np.minimum(base + (ell - 1), n).astype(np.int64)


# ---------------------------------------------------------------------------
# Eq. 2 and the positional bound (Section 2.3.3), host and device
# ---------------------------------------------------------------------------

def overlap_upper_bound(len_r, len_s, hamming):
    """⌊(|r| + |s| - popcount(b_r ⊕ b_s)) / 2⌋ (Theorem 1), on numpy
    arrays or Python ints (the CPU algorithms' ``BitmapFilter``)."""
    return (len_r + len_s - hamming) // 2


def positional_upper_bound(len_r, len_s, pos_r, pos_s):
    """The positional filter's bound on numpy arrays or Python ints: given
    the 0-based positions of the first common prefix token in r and s, the
    overlap is at most 1 + min(remaining suffix lengths)."""
    return 1 + np.minimum(len_r - pos_r - 1, len_s - pos_s - 1)


def positional_upper_bound_int(len_r, len_s, pos_r, pos_s) -> torch.Tensor:
    """int32 torch twin of the Section 2.3.3 positional bound: at most
    ``1 + min(remaining suffix lengths)`` after the first common prefix
    token at 0-based positions ``pos_r``/``pos_s``."""
    len_r = torch.as_tensor(len_r).to(torch.int32)
    len_s = torch.as_tensor(len_s).to(torch.int32)
    pos_r = torch.as_tensor(pos_r).to(torch.int32)
    pos_s = torch.as_tensor(pos_s).to(torch.int32)
    return 1 + torch.minimum(len_r - pos_r - 1, len_s - pos_s - 1)
