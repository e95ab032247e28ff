"""Plain PyTorch versions of the port's kernels.

Twins of ``repro.kernels.ref``: the CPU path runs them, the tests hold them
against the JAX package, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  Nothing on the CUDA join path calls them.  All
outputs are integers or bools, so every comparison is exact.

The verdict's float32 prune test is replaced by the integer
:func:`repro_torch.core.bounds.prune_table` (``table``); when a caller
passes none, one is built that covers the lengths given.
"""

from __future__ import annotations

import torch

from repro_torch.core import bounds, verify
from repro_torch.core.bitmap import hamming_packed, popcount32
from repro_torch.core.bounds import positional_upper_bound_int


# All-pairs Hamming distance, int32[NR, W] x int32[NS, W] -> int32[NR, NS]
# (one word at a time, so the (NR, NS, W) cross product is never built).
hamming_matrix_ref = hamming_packed


def bitplane_hamming_ref(planes_r: torch.Tensor, planes_s: torch.Tensor,
                         pc_r: torch.Tensor, pc_s: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distance from {0, 1} int8 bit planes: int8[NR, b] x
    int8[NS, b] plus int32 row popcounts -> int32[NR, NS] =
    ``pc_r[:, None] + pc_s[None, :] - 2 * planes_r @ planes_s.T``.

    The inner products go through a float64 matrix product, which is exact
    here (every partial sum is an integer of at most b < 2^53) and runs on
    the CPU and the card alike (CUDA has no integer matmul)."""
    dot = (planes_r.to(torch.float64) @ planes_s.to(torch.float64).T).to(torch.int32)
    return pc_r.to(torch.int32)[:, None] + pc_s.to(torch.int32)[None, :] - 2 * dot


def bitplane_pair_hamming_ref(planes_r: torch.Tensor, planes_s: torch.Tensor,
                              pc_r: torch.Tensor, pc_s: torch.Tensor) -> torch.Tensor:
    """Pairwise bit-plane Hamming: int8[G, b] x 2 -> int32[G], the identity
    ``popcount(x ^ y) = pc(x) + pc(y) - 2 <bits(x), bits(y)>`` per candidate,
    in int32."""
    dot = (planes_r.to(torch.int32) * planes_s.to(torch.int32)).sum(-1, dtype=torch.int32)
    return pc_r.to(torch.int32) + pc_s.to(torch.int32) - 2 * dot


def prune_table_for(sim: str, tau: float, len_r: torch.Tensor,
                    len_s: torch.Tensor) -> torch.Tensor:
    """The device prune table covering every length in ``len_r``/``len_s``."""
    lmax_r = int(len_r.max()) if len_r.numel() else 0
    lmax_s = int(len_s.max()) if len_s.numel() else 0
    return verify.prune_table_dev(sim, tau, max(lmax_r, 0), max(lmax_s, 0),
                                  len_r.device)


def candidate_matrix_ref(
    words_r: torch.Tensor,
    words_s: torch.Tensor,
    len_r: torch.Tensor,
    len_s: torch.Tensor,
    *,
    sim: str,
    tau: float,
    self_join: bool,
    cutoff: int = 1 << 30,
    table: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused bitmap-filter verdicts -> bool[NR, NS] (self-join: global i<j)."""
    if table is None:
        table = prune_table_for(sim, tau, len_r, len_s)
    ham = hamming_matrix_ref(words_r, words_s)
    lr = len_r.to(torch.int32)[:, None]
    ls = len_s.to(torch.int32)[None, :]
    cand = bounds.verdict_from_hamming(ham, lr, ls, table, sim=sim, cutoff=cutoff)
    if self_join:
        cand &= _upper_triangle(words_r.shape[0], words_s.shape[0], words_r.device)
    return cand


def _upper_triangle(nr: int, ns: int, device) -> torch.Tensor:
    return (torch.arange(nr, device=device)[:, None]
            < torch.arange(ns, device=device)[None, :])


def count_candidates_ref(
    words_r: torch.Tensor,
    words_s: torch.Tensor,
    len_r: torch.Tensor,
    len_s: torch.Tensor,
    lo_s: torch.Tensor,
    hi_s: torch.Tensor,
    *,
    sim: str,
    tau: float,
    self_join: bool,
    cutoff: int = 1 << 30,
    window: bool = True,
    tile_r: int = 256,
    tile_s: int = 256,
    table: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile (window-pair count, candidate count) -> two int32[GR, GS].

    ``lo_s``/``hi_s`` are the integer admissible |s| windows per R row.  The
    last tiles count as if padded with empty (length-0) rows.
    """
    nr, ns = words_r.shape[0], words_s.shape[0]
    lr = len_r.to(torch.int32)[:, None]
    ls = len_s.to(torch.int32)[None, :]
    win = (lr > 0) & (ls > 0)
    if window:
        win &= (ls >= lo_s.to(torch.int32)[:, None]) & (ls <= hi_s.to(torch.int32)[:, None])
    if self_join:
        win &= _upper_triangle(nr, ns, words_r.device)
    cand = candidate_matrix_ref(words_r, words_s, len_r, len_s, sim=sim, tau=tau,
                                self_join=self_join, cutoff=cutoff, table=table) & win

    def tile_sums(m):
        gr, gs = -(-nr // tile_r), -(-ns // tile_s)
        p = torch.zeros((gr * tile_r, gs * tile_s), dtype=torch.int32, device=m.device)
        p[:nr, :ns] = m.to(torch.int32)
        return p.reshape(gr, tile_r, gs, tile_s).sum(dim=(1, 3), dtype=torch.int32)

    return tile_sums(win), tile_sums(cand)


def entry_filter_ref(
    len_r: torch.Tensor,
    pos_r: torch.Tensor,
    len_s: torch.Tensor,
    pos_s: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    idx_r: torch.Tensor,
    idx_s: torch.Tensor,
    valid: torch.Tensor,
    *,
    sim: str,
    tau: float,
    self_join: bool,
    table: torch.Tensor | None = None,
) -> torch.Tensor:
    """Postings-entry admission mask -> bool[G]: valid, both sets non-empty,
    ``lo <= |r| <= hi``, the Section 2.3.3 positional bound at this prefix
    position reaching the prune table's threshold, and (self-join) the
    strict ``idx_r < idx_s`` triangle in sorted ids."""
    if table is None:
        table = prune_table_for(sim, tau, len_r, len_s)
    lr = len_r.to(torch.int32)
    ls = len_s.to(torch.int32)
    ub = positional_upper_bound_int(lr, ls, pos_r, pos_s)
    ok = (valid & (lr > 0) & (ls > 0)
          & (lr >= lo.to(torch.int32)) & (lr <= hi.to(torch.int32))
          & (ub >= bounds.min_overlap_gather(sim, table, lr, ls)))
    if self_join:
        ok &= idx_r < idx_s
    return ok


def pair_verdict_ref(
    words_r: torch.Tensor,
    words_s: torch.Tensor,
    len_r: torch.Tensor,
    len_s: torch.Tensor,
    *,
    sim: str,
    tau: float,
    cutoff: int = 1 << 30,
    table: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pairwise bitmap-filter verdict over gathered candidate rows ->
    bool[G]: ``candidate_matrix_ref``'s test on ``words_r[g]`` against
    ``words_s[g]`` (the diagonal of the dense verdict)."""
    if table is None:
        table = prune_table_for(sim, tau, len_r, len_s)
    ham = popcount32(words_r ^ words_s).sum(-1, dtype=torch.int32)
    return bounds.verdict_from_hamming(ham, len_r.to(torch.int32), len_s.to(torch.int32),
                                       table, sim=sim, cutoff=cutoff)
