"""Public entry points of the port's kernels, with implementation dispatch.

The twins of ``repro.kernels.ops``: ``hamming_matrix``, ``candidate_matrix``
and ``count_candidates`` (dense), ``entry_filter`` and ``pair_verdict``
(1-D over the indexed driver's entry and candidate streams), with the same
argument lists plus an optional precomputed prune ``table`` (built from the
lengths when omitted).  Beside them, the indexed driver's two stages,
:func:`expand_filter` and :func:`verdict_verify`, which on the card under
``auto`` run one fused kernel each (below).

``impl`` selects by the tensors' device and never falls back:

* ``"auto"`` — on CPU tensors the plain version (``"ref"``); on CUDA
  tensors, for ``hamming_matrix`` and ``pair_verdict`` what the reference
  picks on its accelerator: the bit-plane kernels (``"mxu"``) for b >= 512,
  else the SWAR kernel (``"swar"``; for ``pair_verdict`` the
  candidate-major ``"swar_tiled"``); for ``candidate_matrix`` and
  ``count_candidates`` the tensor-core verdict kernels (``"mxu"``) at every
  b, the form the card measured faster at both main shapes (b = 128 and
  1024; PERF.md);
* ``"swar"`` — the packed-word CUDA kernel; raises on CPU tensors;
* ``"swar_tiled"`` — ``pair_verdict``'s candidate-major CUDA kernel
  (``entry_filter`` maps it to ``"swar"``, as the reference does);
* ``"mxu"`` — the tensor-core CUDA kernels.  ``candidate_matrix`` and
  ``count_candidates`` launch one kernel each that reads the packed words,
  expands them into bit planes in shared memory, runs the product on
  ``wgmma`` and fuses the verdict (and the count's window, triangle and
  per-tile sums) into its epilogue.  ``hamming_matrix`` and
  ``pair_verdict`` unpack the words into {0, 1} int8 planes and row
  popcounts here, outside the kernel, as the reference does
  (``bitplane_hamming``, ``pair_verdict_bitplane``).  ``entry_filter`` has
  no words and maps it to ``"swar"``.  Raises on CPU tensors;
* ``"ref"`` / ``"ref_mxu"`` — the plain versions (packed-word and
  bit-plane); raise on CUDA tensors (compare against the plain version on
  the card by calling :mod:`repro_torch.kernels.ref`).

The stages :func:`expand_filter` and :func:`verdict_verify` take the same
names: ``"auto"`` on CUDA tensors launches their own kernel
(``postings.expand_filter_cuda``, ``postings.verdict_verify_cuda``: the
gathers fused in, only bitmap survivors verified); an explicit kernel name
(``"swar"``, ``"swar_tiled"``, ``"mxu"``) runs the PyTorch composition
around :func:`entry_filter` and :func:`pair_verdict` under that name, the
unfused form of these stages; on CPU tensors ``"auto"`` and
``"ref"`` run the plain versions (``ref.expand_filter_ref``,
``ref.verdict_verify_ref``) and ``"ref_mxu"`` the latter with the bit-plane
plain verdict.

:func:`bitmap_build`, the bitmap build (Bitmap-Set, -Xor and -Next into
packed words), has no ``impl``: CUDA tensors launch its kernel
(``bitmap_build.bitmap_build_cuda``), other tensors run the plain
generators (``ref.bitmap_build_ref``).

:func:`flash_attention`, the LM scaffold's entry, and its backward
:func:`flash_attention_bwd` have their own two impls: ``"cuda"`` (the
kernel; ``auto`` on CUDA tensors) and ``"ref"`` (the plain version; ``auto``
on CPU tensors), each raising on the other device.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import bounds
from repro_torch.core.constants import COSINE
from repro_torch.kernels import bitmap_build as build_kernel
from repro_torch.kernels import bitmap_filter, bitplane, compaction, postings, ref
from repro_torch.kernels import flash_attention as flash_kernel

_TILE = 256
_TILE_1D = 1024
# Candidates unpacked into bit planes at once by pair_verdict(impl="mxu"):
# 1 GiB of planes a side at b = 1024.
_MXU_SLICE = 1 << 20


def resolve_impl(impl: str, device: torch.device, b: int, *,
                 kernels=("swar",), auto: str = "swar") -> str:
    """The implementation for tensors on ``device`` with ``b``-bit rows: a
    CUDA kernel's name (one of ``kernels`` or ``"mxu"``; ``auto`` on CUDA
    picks ``"mxu"`` at b >= 512, else ``auto``) or a plain version's
    (``"ref"``, which ``auto`` picks on the CPU, or ``"ref_mxu"``)."""
    on_cuda = torch.device(device).type == "cuda"
    if impl == "auto":
        if not on_cuda:
            return "ref"
        return "mxu" if b >= 512 else auto
    if impl not in (*kernels, "mxu", "ref", "ref_mxu"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl in ("ref", "ref_mxu"):
        if on_cuda:
            raise ValueError(f"impl={impl!r} is the CPU path; CUDA tensors launch "
                             f"the kernel")
    elif not on_cuda:
        raise ValueError(f"impl={impl!r} launches a CUDA kernel; CPU tensors take "
                         f"impl='ref' or 'ref_mxu'")
    return impl


def _resolve_pairwise_impl(impl: str, device: torch.device, b: int) -> str:
    """Pairwise (1-D candidate stream) dispatch: ``auto`` is the
    candidate-major ``"swar_tiled"`` kernel on CUDA tensors below b = 512
    and the bit-plane ``"mxu"`` kernel from there on."""
    return resolve_impl(impl, device, b, kernels=("swar", "swar_tiled"),
                        auto="swar_tiled")


def _resolve_dense_impl(impl: str, device: torch.device, b: int) -> str:
    """``candidate_matrix`` and ``count_candidates``: ``auto`` on CUDA
    tensors is the tensor-core verdict kernel (``"mxu"``) at every b, the
    form the card measured faster than the SWAR one at the blocked join's
    block pairs, b = 128 and 1024 (PERF.md)."""
    return resolve_impl(impl, device, b, auto="mxu")


def _resolve_entry_impl(impl: str, device: torch.device) -> str:
    """``entry_filter`` is pure integer filtering with no bitmap words, so
    the mxu impls map to their elementwise equivalents and ``swar_tiled`` to
    ``swar``, as the reference maps them."""
    impl = {"mxu": "swar", "ref_mxu": "ref", "swar_tiled": "swar"}.get(impl, impl)
    return resolve_impl(impl, device, 32)


def _planes(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8[N, b] {0, 1} bit planes, int32[N] row popcounts) of packed
    int32[N, b/32] words: the bit-plane operands."""
    return bm.unpack_planes(words), bm.popcount_rows(words)


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
    impl = resolve_impl(impl, words_r.device, 32 * words_r.shape[1])
    if impl == "ref":
        return ref.hamming_matrix_ref(words_r, words_s)
    if impl == "swar":
        return bitmap_filter.hamming_matrix_cuda(words_r, words_s)
    (pr, pc_r), (ps, pc_s) = _planes(words_r), _planes(words_s)
    if impl == "ref_mxu":
        return ref.bitplane_hamming_ref(pr, ps, pc_r, pc_s)
    return bitplane.bitplane_hamming_cuda(pr, ps, pc_r, pc_s)


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
    impl = _resolve_dense_impl(impl, words_r.device, 32 * words_r.shape[1])
    if table is None:
        table = ref.prune_table_for(sim, tau, len_r, len_s)
    if impl in ("ref", "ref_mxu"):
        return ref.candidate_matrix_ref(
            words_r, words_s, len_r, len_s, sim=sim, tau=tau,
            self_join=self_join, cutoff=cutoff, table=table,
            bitplane=impl == "ref_mxu")
    kernel = (bitmap_filter.candidate_matrix_mxu_cuda if impl == "mxu"
              else bitmap_filter.candidate_matrix_cuda)
    return kernel(words_r, words_s, len_r.to(torch.int32).contiguous(),
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
    without materialising the dense mask.  ``mxu`` (``auto`` on the card)
    is the tensor-core kernel with the window, the triangle, the verdict and
    the per-tile sums in its epilogue, ``swar`` the packed-word kernel;
    ``ref_mxu`` is the plain version with the Hamming distances taken from
    the bit planes, as the tensor-core kernel takes them (the reference
    runs its plain version for ``mxu``/``ref_mxu``: it has no bit-plane
    count kernel).  All give the same counts.
    """
    _check_interpret(interpret)
    impl = _resolve_dense_impl(impl, words_r.device, 32 * words_r.shape[1])
    if table is None:
        table = ref.prune_table_for(sim, tau, len_r, len_s)
    if impl in ("ref", "ref_mxu"):
        return ref.count_candidates_ref(
            words_r, words_s, len_r, len_s, lo_s, hi_s, sim=sim, tau=tau,
            self_join=self_join, cutoff=cutoff, window=window,
            tile_r=tile, tile_s=tile, table=table, bitplane=impl == "ref_mxu")
    i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
    kernel = (compaction.count_candidates_mxu_cuda if impl == "mxu"
              else compaction.count_candidates_cuda)
    return kernel(
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
    ``swar`` is the word-loop kernel, ``swar_tiled`` (``auto`` below b =
    512) the candidate-major one, ``mxu`` (``auto`` from b = 512) the
    bit-plane one, which unpacks and launches at most ``2^20`` candidates
    at a time; all equal ``ref`` exactly."""
    _check_interpret(interpret)
    impl = _resolve_pairwise_impl(impl, words_r.device, 32 * words_r.shape[1])
    if table is None:
        table = ref.prune_table_for(sim, tau, len_r, len_s)
    if impl == "ref":
        return ref.pair_verdict_ref(words_r, words_s, len_r, len_s, sim=sim,
                                    tau=tau, cutoff=cutoff, table=table)
    len_r, len_s = len_r.to(torch.int32).contiguous(), len_s.to(torch.int32).contiguous()
    if impl == "ref_mxu":
        (pr, pc_r), (ps, pc_s) = _planes(words_r), _planes(words_s)
        ham = ref.bitplane_pair_hamming_ref(pr, ps, pc_r, pc_s)
        return bounds.verdict_from_hamming(ham, len_r, len_s, table, sim=sim,
                                           cutoff=cutoff)
    if impl == "mxu":
        out = torch.empty(words_r.shape[0], dtype=torch.bool, device=words_r.device)
        for a in range(0, words_r.shape[0], _MXU_SLICE):
            z = min(a + _MXU_SLICE, words_r.shape[0])
            (pr, pc_r), (ps, pc_s) = _planes(words_r[a:z]), _planes(words_s[a:z])
            out[a:z] = postings.pair_verdict_bitplane_cuda(
                pr, ps, pc_r, pc_s, len_r[a:z], len_s[a:z], table,
                key_prod=sim == COSINE, cutoff=cutoff)
        return out
    kernel = (postings.pair_verdict_tiled_cuda if impl == "swar_tiled"
              else postings.pair_verdict_cuda)
    return kernel(words_r.contiguous(), words_s.contiguous(), len_r, len_s,
                  table, key_prod=sim == COSINE, cutoff=cutoff)


def _stage_impl(impl: str, device: torch.device) -> str:
    """The stages' dispatch: ``"fused"`` (their own kernel; ``auto`` on
    CUDA tensors), ``"ref"`` (``auto`` on CPU tensors), or the name of the
    impl their composition passes on; raises where :func:`resolve_impl`
    would."""
    if impl == "auto":
        return "fused" if torch.device(device).type == "cuda" else "ref"
    return resolve_impl(impl, device, 32, kernels=("swar", "swar_tiled"))


def expand_filter(
    rng_flat: torch.Tensor,
    cnt: torch.Tensor,
    seg_end: torch.Tensor,
    post_set: torch.Tensor,
    post_pos: torch.Tensor,
    post_len: torch.Tensor,
    probe_lengths: torch.Tensor,
    lo_r: torch.Tensor,
    hi_r: torch.Tensor,
    s0: int,
    *,
    sim: str,
    tau: float,
    cap: int,
    lp: int,
    self_join: bool,
    impl: str = "auto",
    table: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A probe chunk's expanded, admitted postings entries -> ``(rr, ss)``,
    int32[cap] each with ``INT32_MAX`` in every other slot (the contract of
    :func:`repro_torch.kernels.ref.expand_filter_ref`)."""
    impl = _stage_impl(impl, rng_flat.device)
    if table is None:
        table = ref.prune_table_for(sim, tau, post_len, probe_lengths)
    kw = dict(sim=sim, tau=tau, cap=cap, lp=lp, self_join=self_join, table=table)
    if impl == "fused":
        i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
        return postings.expand_filter_cuda(
            *(i32(t) for t in (rng_flat, cnt, seg_end, post_set, post_pos, post_len,
                               probe_lengths, lo_r, hi_r)),
            s0, table, cap=cap, lp=lp, key_prod=sim == COSINE, self_join=self_join)
    args = (rng_flat, cnt, seg_end, post_set, post_pos, post_len, probe_lengths, lo_r,
            hi_r, s0)
    if impl == "ref":
        return ref.expand_filter_ref(*args, **kw)
    return ref.expand_filter_ref(*args, **kw,
                                 entry_filter=functools.partial(entry_filter, impl=impl))


def verdict_verify(
    tokens_r: torch.Tensor,
    lengths_r: torch.Tensor,
    words_r: torch.Tensor,
    probe_tokens: torch.Tensor,
    probe_lengths: torch.Tensor,
    probe_words: torch.Tensor,
    cand_r: torch.Tensor,
    cand_s: torch.Tensor,
    slot_ok: torch.Tensor,
    need_tab: torch.Tensor,
    *,
    sim: str,
    tau: float,
    cutoff: int = 1 << 30,
    impl: str = "auto",
    table: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The bitmap verdict and exact verification of a candidate buffer ->
    ``(cand_mask, ok)``, bool[cap] each (the contract of
    :func:`repro_torch.kernels.ref.verdict_verify_ref`)."""
    impl = _stage_impl(impl, cand_r.device)
    if table is None:
        table = ref.prune_table_for(sim, tau, lengths_r, probe_lengths)
    if impl == "fused":
        i32 = lambda t: t.to(torch.int32).contiguous()  # noqa: E731
        return postings.verdict_verify_cuda(
            *(i32(t) for t in (tokens_r, lengths_r, words_r, probe_tokens, probe_lengths,
                               probe_words, cand_r, cand_s)),
            slot_ok.contiguous(), table, i32(need_tab), key_prod=sim == COSINE,
            cutoff=cutoff)
    args = (tokens_r, lengths_r, words_r, probe_tokens, probe_lengths, probe_words, cand_r,
            cand_s, slot_ok, need_tab)
    kw = dict(sim=sim, tau=tau, cutoff=cutoff, table=table)
    if impl == "ref":
        return ref.verdict_verify_ref(*args, **kw)
    return ref.verdict_verify_ref(*args, **kw,
                                  pair_verdict=functools.partial(pair_verdict, impl=impl))


def bitmap_build(tokens: torch.Tensor, lengths: torch.Tensor, b: int, method: str,
                 mix: bool = False) -> torch.Tensor:
    """Packed int32[N, b // 32] bitmap words of int32[N, L] padded tokens
    and their int32[N] lengths, by ``method`` ('set', 'xor' or 'next'), in
    :func:`repro_torch.core.bitmap.pack_bits`' bit order.  CUDA tensors
    launch the kernel (which raises on a bad operand or a failed launch);
    other tensors run the plain version."""
    if tokens.device.type == "cuda":
        return build_kernel.bitmap_build_cuda(tokens, lengths, b, method, mix)
    return ref.bitmap_build_ref(tokens, lengths, b, method, mix)


def _flash_impl(impl: str, device: torch.device) -> str:
    """The flash entry points' implementation on ``device``: ``"cuda"`` (the
    kernel) or ``"ref"`` (the plain version); ``"auto"`` picks by device,
    and each of the two raises on the other device."""
    on_cuda = device.type == "cuda"
    if impl == "auto":
        return "cuda" if on_cuda else "ref"
    if impl == "cuda" and not on_cuda:
        raise ValueError("impl='cuda' launches the CUDA kernel; CPU tensors take impl='ref'")
    if impl == "ref" and on_cuda:
        raise ValueError("impl='ref' is the CPU path; CUDA tensors launch the kernel")
    if impl not in ("cuda", "ref"):
        raise ValueError(f"unknown impl {impl!r}")
    return impl


# The dry run (``repro_torch.launch.cost``) runs a rank's program on ``meta``
# tensors, which hold shapes and no data.  There the flash entry points
# return shape-only results (no kernel and no plain version runs: the plain
# version's blocks would cost the count hundreds of thousands of ops) and
# record the attention's work inside ``counting_meta_attention``: the plain
# version's products over every (q, k) pair, and the kernel's traffic, each
# operand and result moved once.
_META = threading.local()


@contextlib.contextmanager
def counting_meta_attention():
    """Record each flash call on meta tensors inside as ``(name, flops,
    bytes)`` in the yielded list."""
    prev = getattr(_META, "work", None)
    _META.work = out = []
    try:
        yield out
    finally:
        _META.work = prev


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _flash_meta(q, k, v, return_lse: bool):
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, k.shape[2], h // k.shape[2], sq), dtype=torch.float32,
                      device=q.device)
    work = getattr(_META, "work", None)
    if work is not None:   # two products (q k^T, p v) over every (q, k) pair
        work.append(("flash_attention", 4.0 * b * h * sq * k.shape[1] * d,
                     _nbytes(q, k, v, out, *((lse,) if return_lse else ()))))
    return (out, lse) if return_lse else out


def _flash_bwd_meta(q, k, v, out, lse, do):
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    work = getattr(_META, "work", None)
    if work is not None:   # five products (s, dv, dp, dq, dk) over every pair
        b, sq, h, d = q.shape
        work.append(("flash_attention_bwd", 10.0 * b * h * sq * k.shape[1] * d,
                     _nbytes(q, k, v, out, lse, do, dq, dk, dv)))
    return dq, dk, dv


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    impl: str = "auto",
    q_chunk: int = 512,
    kv_chunk: int = 512,
    triangle: bool = False,
    return_lse: bool = False,
    q_offset: int = 0,
):
    """GQA attention forward -> (B, Sq, H, D) in q's type, for q (B, Sq, H,
    D) and k, v (B, Sk, KV, D); with ``return_lse``, ``(out, lse)``, lse the
    float32 log-sum-exp of each query row, (B, KV, G, Sq).

    ``impl="auto"`` launches the CUDA kernel on CUDA tensors and runs the
    plain version on CPU tensors; ``"cuda"`` raises on CPU tensors and
    ``"ref"`` on CUDA tensors.  ``q_chunk``, ``kv_chunk`` and ``triangle``
    shape only the plain version's blocks (the kernel has its own tiles);
    the result does not depend on them beyond float rounding.  ``q_offset``
    places query row i at position ``q_offset + i`` (keys from 0) for the
    causal mask.  On ``meta`` tensors (the dry run) the result has the
    shapes only (above).
    """
    if q.device.type == "meta":
        return _flash_meta(q, k, v, return_lse)
    if _flash_impl(impl, q.device) == "cuda":
        return flash_kernel.flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset,
                                                 return_lse=return_lse)
    return ref.flash_attention_ref(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                                   triangle=triangle, return_lse=return_lse, q_offset=q_offset)


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    impl: str = "auto",
    q_chunk: int = 512,
    kv_chunk: int = 512,
    triangle: bool = False,
    q_offset: int = 0,
) -> tuple:
    """The attention backward -> (dq, dk, dv) from the forward's inputs, its
    output and lse, and the output's gradient ``do``.

    ``impl`` follows :func:`flash_attention`'s rule: ``"auto"`` launches the
    CUDA kernel (``flash_attention_bwd_cuda``) on CUDA tensors and runs the
    plain version (``ref.flash_attention_bwd_ref``, the twin of the
    reference's jnp ``_flash_bwd_impl``) on CPU tensors; ``"cuda"`` raises on
    CPU tensors and ``"ref"`` on CUDA tensors.  ``q_chunk``, ``kv_chunk``
    and ``triangle`` shape only the plain version's blocks, as the
    reference's do; ``q_offset`` is the forward's.  On ``meta`` tensors (the
    dry run) the shapes only.
    """
    if q.device.type == "meta":
        return _flash_bwd_meta(q, k, v, out, lse, do)
    if _flash_impl(impl, q.device) == "cuda":
        return flash_kernel.flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal,
                                                     q_offset=q_offset)
    return ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal, q_chunk=q_chunk,
                                       kv_chunk=kv_chunk, triangle=triangle, q_offset=q_offset)
