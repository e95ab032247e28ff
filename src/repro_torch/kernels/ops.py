"""Public entry points of the port's kernels, with implementation dispatch.

The twins of ``repro.kernels.ops``: ``hamming_matrix``, ``candidate_matrix``
and ``count_candidates`` (dense), ``entry_filter`` and ``pair_verdict``
(1-D over the indexed driver's entry and candidate streams), with the same
argument lists plus an optional precomputed prune ``table`` (built from the
lengths when omitted).

``impl`` selects by the tensors' device and never falls back:

* ``"auto"`` — the CUDA kernel for CUDA tensors (``"swar"``; for
  ``pair_verdict`` the candidate-major ``"swar_tiled"``), the plain version
  (``"ref"``) for CPU tensors, at every b;
* ``"swar"`` — the CUDA kernel; raises on CPU tensors;
* ``"swar_tiled"`` — ``pair_verdict``'s candidate-major CUDA kernel
  (``entry_filter`` maps it to ``"swar"``, as the reference does);
* ``"ref"`` — the plain version; raises on CUDA tensors (compare against the
  plain version on the card by calling :mod:`repro_torch.kernels.ref`);
* ``"mxu"``/``"ref_mxu"`` — the reference's int8 bit-plane formulation,
  not ported yet (ROADMAP Queue 2); raises ``NotImplementedError``
  (``entry_filter``, which has no words, maps them to ``"swar"``/``"ref"``
  as the reference does).
"""

from __future__ import annotations

import torch

from repro_torch.core.constants import COSINE
from repro_torch.kernels import bitmap_filter, compaction, postings, ref

_TILE = 256
_TILE_1D = 1024


def resolve_impl(impl: str, device: torch.device, *, kernels=("swar",),
                 auto: str = "swar") -> str:
    """The CUDA kernel's name (one of ``kernels``; ``auto`` on CUDA tensors)
    or ``"ref"`` (the plain version, ``auto`` on CPU tensors)."""
    on_cuda = device.type == "cuda"
    if impl in ("mxu", "ref_mxu"):
        raise NotImplementedError(
            f"impl={impl!r}: the bit-plane kernels (bitplane_hamming_pallas, "
            f"pair_verdict_bitplane_pallas) are not ported yet; see ROADMAP.md "
            f"Queue 2")
    if impl == "auto":
        return auto if on_cuda else "ref"
    if impl in kernels and not on_cuda:
        raise ValueError(f"impl={impl!r} launches a CUDA kernel; CPU tensors take "
                         f"impl='ref'")
    if impl == "ref" and on_cuda:
        raise ValueError("impl='ref' is the CPU path; CUDA tensors launch the kernel")
    if impl not in (*kernels, "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl


def _resolve_pairwise_impl(impl: str, device: torch.device) -> str:
    """Pairwise (1-D candidate stream) dispatch: ``auto`` is the
    candidate-major ``"swar_tiled"`` kernel on CUDA tensors at every b."""
    return resolve_impl(impl, device, kernels=("swar", "swar_tiled"),
                        auto="swar_tiled")


def _resolve_entry_impl(impl: str, device: torch.device) -> str:
    """``entry_filter`` is pure integer filtering with no bitmap words, so
    the mxu impls map to their elementwise equivalents and ``swar_tiled`` to
    ``swar``, as the reference maps them."""
    impl = {"mxu": "swar", "ref_mxu": "ref", "swar_tiled": "swar"}.get(impl, impl)
    return resolve_impl(impl, device)


def _check_interpret(interpret) -> None:
    if interpret:
        raise ValueError("the CUDA kernels have no interpret mode")


def hamming_matrix(
    words_r: torch.Tensor,
    words_s: torch.Tensor,
    impl: str = "auto",
    interpret: bool | None = None,
    tile: int = _TILE,
) -> torch.Tensor:
    """All-pairs Hamming distance between packed bitmaps -> int32[NR, NS].

    ``tile`` is accepted for parity with the reference.
    """
    _check_interpret(interpret)
    if resolve_impl(impl, words_r.device) == "ref":
        return ref.hamming_matrix_ref(words_r, words_s)
    return bitmap_filter.hamming_matrix_cuda(words_r, words_s)


def candidate_matrix(
    words_r: torch.Tensor,
    words_s: torch.Tensor,
    len_r: torch.Tensor,
    len_s: torch.Tensor,
    sim: str,
    tau: float,
    self_join: bool,
    cutoff: int = 1 << 30,
    impl: str = "auto",
    interpret: bool | None = None,
    tile: int = _TILE,
    *,
    table: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused bitmap-filter verdicts -> bool[NR, NS] candidate mask.

    ``tile`` is accepted for parity with the reference; the verdict does not
    depend on tiling.
    """
    _check_interpret(interpret)
    impl = resolve_impl(impl, words_r.device)
    if table is None:
        table = ref.prune_table_for(sim, tau, len_r, len_s)
    if impl == "ref":
        return ref.candidate_matrix_ref(
            words_r, words_s, len_r, len_s, sim=sim, tau=tau,
            self_join=self_join, cutoff=cutoff, table=table)
    return bitmap_filter.candidate_matrix_cuda(
        words_r, words_s, len_r.to(torch.int32).contiguous(),
        len_s.to(torch.int32).contiguous(), table, key_prod=sim == COSINE,
        self_join=self_join, cutoff=cutoff)


def count_candidates(
    words_r: torch.Tensor,
    words_s: torch.Tensor,
    len_r: torch.Tensor,
    len_s: torch.Tensor,
    lo_s: torch.Tensor,
    hi_s: torch.Tensor,
    sim: str,
    tau: float,
    self_join: bool = False,
    cutoff: int = 1 << 30,
    window: bool = True,
    impl: str = "auto",
    interpret: bool | None = None,
    tile: int = _TILE,
    *,
    table: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tile-count prepass -> (window counts, candidate counts), two
    int32[ceil(NR/tile), ceil(NS/tile)].

    Counts exactly what :func:`candidate_matrix` intersected with the
    integer length window (``lo_s``/``hi_s`` per R row) would mark true,
    without materialising the dense mask.
    """
    _check_interpret(interpret)
    impl = resolve_impl(impl, words_r.device)
    if table is None:
        table = ref.prune_table_for(sim, tau, len_r, len_s)
    if impl == "ref":
        return ref.count_candidates_ref(
            words_r, words_s, len_r, len_s, lo_s, hi_s, sim=sim, tau=tau,
            self_join=self_join, cutoff=cutoff, window=window,
            tile_r=tile, tile_s=tile, table=table)
    i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
    return compaction.count_candidates_cuda(
        words_r, words_s, i32(len_r), i32(len_s),
        i32(lo_s) if window else None, i32(hi_s) if window else None, table,
        key_prod=sim == COSINE, self_join=self_join, cutoff=cutoff,
        tile_r=tile, tile_s=tile)


def entry_filter(
    len_r: torch.Tensor,
    pos_r: torch.Tensor,
    len_s: torch.Tensor,
    pos_s: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    idx_r: torch.Tensor,
    idx_s: torch.Tensor,
    valid: torch.Tensor,
    sim: str,
    tau: float,
    self_join: bool = False,
    impl: str = "auto",
    interpret: bool | None = None,
    tile: int = _TILE_1D,
    *,
    table: torch.Tensor | None = None,
) -> torch.Tensor:
    """Postings-entry admission mask -> bool[G]: the probe's integer length
    window on |r|, the positional bound at this matching prefix position,
    non-empty rows, and (self-join) the strict ``idx_r < idx_s`` triangle;
    ``valid`` masks padding and overrun slots."""
    _check_interpret(interpret)
    impl = _resolve_entry_impl(impl, len_r.device)
    if table is None:
        table = ref.prune_table_for(sim, tau, len_r, len_s)
    if impl == "ref":
        return ref.entry_filter_ref(len_r, pos_r, len_s, pos_s, lo, hi, idx_r,
                                    idx_s, valid, sim=sim, tau=tau,
                                    self_join=self_join, table=table)
    i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
    return postings.entry_filter_cuda(
        *(i32(t) for t in (len_r, pos_r, len_s, pos_s, lo, hi, idx_r, idx_s)),
        valid.contiguous(), table, key_prod=sim == COSINE, self_join=self_join)


def pair_verdict(
    words_r: torch.Tensor,
    words_s: torch.Tensor,
    len_r: torch.Tensor,
    len_s: torch.Tensor,
    sim: str,
    tau: float,
    cutoff: int = 1 << 30,
    impl: str = "auto",
    interpret: bool | None = None,
    tile: int = _TILE_1D,
    *,
    table: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pairwise fused bitmap-filter verdict -> bool[G] over gathered
    candidate rows (``words_r[g]`` vs ``words_s[g]``): the test of
    :func:`candidate_matrix` on a candidate list instead of the dense grid.
    ``swar`` is the word-loop kernel, ``swar_tiled`` (``auto``) the
    candidate-major one; both equal ``ref`` exactly."""
    _check_interpret(interpret)
    impl = _resolve_pairwise_impl(impl, words_r.device)
    if table is None:
        table = ref.prune_table_for(sim, tau, len_r, len_s)
    if impl == "ref":
        return ref.pair_verdict_ref(words_r, words_s, len_r, len_s, sim=sim,
                                    tau=tau, cutoff=cutoff, table=table)
    kernel = (postings.pair_verdict_tiled_cuda if impl == "swar_tiled"
              else postings.pair_verdict_cuda)
    return kernel(words_r.contiguous(), words_s.contiguous(),
                  len_r.to(torch.int32).contiguous(), len_s.to(torch.int32).contiguous(),
                  table, key_prod=sim == COSINE, cutoff=cutoff)
