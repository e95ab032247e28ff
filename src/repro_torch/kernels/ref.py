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

from repro_torch.core import verify
from repro_torch.core.bitmap import hamming_packed
from repro_torch.core.constants import COSINE


# All-pairs Hamming distance, int32[NR, W] x int32[NS, W] -> int32[NR, NS]
# (one word at a time, so the (NR, NS, W) cross product is never built).
hamming_matrix_ref = hamming_packed


def prune_table_for(sim: str, tau: float, len_r: torch.Tensor,
                    len_s: torch.Tensor) -> torch.Tensor:
    """The device prune table covering every length in ``len_r``/``len_s``."""
    lmax_r = int(len_r.max()) if len_r.numel() else 0
    lmax_s = int(len_s.max()) if len_s.numel() else 0
    return verify.prune_table_dev(sim, tau, max(lmax_r, 0), max(lmax_s, 0),
                                  len_r.device)


def verdict_from_hamming(ham: torch.Tensor, lr: torch.Tensor, ls: torch.Tensor,
                         table: torch.Tensor, *, sim: str, cutoff: int) -> torch.Tensor:
    """Eq. 2 bound against the prune table, the Alg. 7 cutoff and the
    positivity test, broadcast over ``lr``/``ls`` (int32)."""
    ub = torch.minimum((lr + ls - ham).div(2, rounding_mode="floor"),
                       torch.minimum(lr, ls))
    key = (lr.to(torch.int64) * ls if sim == COSINE else lr.to(torch.int64) + ls)
    passed = ub >= table[key]
    cand = passed | (lr > cutoff) | (ls > cutoff)
    return cand & (lr > 0) & (ls > 0)


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
    cand = verdict_from_hamming(ham, lr, ls, table, sim=sim, cutoff=cutoff)
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
