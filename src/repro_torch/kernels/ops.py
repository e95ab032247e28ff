"""Public entry points of the port's kernels, with implementation dispatch.

The twins of ``repro.kernels.ops.candidate_matrix`` and
``count_candidates``, with the same argument lists plus an optional
precomputed prune ``table`` (built from the lengths when omitted).

``impl`` selects by the tensors' device and never falls back:

* ``"auto"`` — the CUDA kernel (``"swar"``) for CUDA tensors, the plain
  version (``"ref"``) for CPU tensors;
* ``"swar"`` — the CUDA kernel; raises on CPU tensors;
* ``"ref"`` — the plain version; raises on CUDA tensors (compare against the
  plain version on the card by calling :mod:`repro_torch.kernels.ref`);
* ``"mxu"``/``"ref_mxu"`` — the reference's int8 bit-plane formulation,
  not ported yet (ROADMAP Queue 2); raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from repro_torch.core.constants import COSINE
from repro_torch.kernels import bitmap_filter, compaction, ref

_TILE = 256


def resolve_impl(impl: str, device: torch.device) -> str:
    """``"swar"`` (the CUDA kernel) or ``"ref"`` (the plain version)."""
    on_cuda = device.type == "cuda"
    if impl in ("mxu", "ref_mxu"):
        raise NotImplementedError(
            f"impl={impl!r}: the bit-plane kernel (bitplane_hamming_pallas) is not "
            f"ported yet; see ROADMAP.md Queue 2")
    if impl == "auto":
        return "swar" if on_cuda else "ref"
    if impl == "swar" and not on_cuda:
        raise ValueError("impl='swar' launches the CUDA kernel; CPU tensors take impl='ref'")
    if impl == "ref" and on_cuda:
        raise ValueError("impl='ref' is the CPU path; CUDA tensors launch the kernel")
    if impl not in ("swar", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl


def _check_interpret(interpret) -> None:
    if interpret:
        raise ValueError("the CUDA kernels have no interpret mode")


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
