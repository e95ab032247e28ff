"""The indexed driver's kernels (CUDA C++, ``csrc/postings.cu``).

* :func:`entry_filter_cuda` replaces
  ``repro.kernels.postings.entry_filter_pallas``: the admission test of
  every expanded postings entry.
* :func:`pair_verdict_cuda` replaces ``pair_verdict_pallas`` (one thread per
  candidate, a loop over its words; ``impl="swar"``).
* :func:`pair_verdict_tiled_cuda` replaces ``pair_verdict_tiled_pallas``
  (candidate-major: a block's words staged through shared memory, or a
  group of lanes per candidate for wide rows; ``impl="swar_tiled"``, what
  ``auto`` picks on the card below b = 512).
* :func:`pair_verdict_bitplane_cuda` replaces
  ``pair_verdict_bitplane_pallas`` (a per-candidate inner product of int8
  bit planes; ``impl="mxu"``, what ``auto`` picks at b >= 512).

The indexed driver's two stages run, under ``impl="auto"`` on the card, one
kernel each in place of the PyTorch compositions around the kernels above:

* :func:`expand_filter_cuda` (the redesign of ``entry_filter_pallas``): the
  CSR expansion of a probe chunk and the admission test, straight from the
  postings arrays into the sentinel-keyed entry streams.
* :func:`verdict_verify_cuda` (the redesign of
  ``pair_verdict_tiled_pallas``): the packed-word verdict read at each
  candidate's own rows, and exact verification of the bitmap survivors.

Their plain versions are :func:`repro_torch.kernels.ref.entry_filter_ref`,
:func:`repro_torch.kernels.ref.pair_verdict_ref`,
:func:`repro_torch.kernels.ref.bitplane_pair_hamming_ref` (plus
:func:`repro_torch.core.bounds.verdict_from_hamming`),
:func:`repro_torch.kernels.ref.expand_filter_ref` and
:func:`repro_torch.kernels.ref.verdict_verify_ref`; callers go through
:mod:`repro_torch.kernels.ops`.  Every threshold is the int32 prune
``table`` (``bounds.prune_table``), which must cover every key of the
lengths given (``lr+ls``, or ``lr*ls`` when ``key_prod``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitmap_filter import check_operands
from repro_torch.kernels.bitplane import check_planes

_C = ctypes.c_void_p
_I = ctypes.c_int
_MAX_G = (1 << 31) - 1


def _fn(name: str, argtypes):
    return _build.function("postings", name, argtypes)


def _check_vector(t: torch.Tensor, n: int, dev: torch.device, dtype=torch.int32) -> None:
    if (t.device != dev or t.dtype != dtype or not t.is_contiguous()
            or t.dim() != 1 or t.shape[0] != n):
        raise ValueError(f"expected a contiguous {dtype}[{n}] on {dev}, got "
                         f"{t.dtype}{list(t.shape)} on {t.device}")


def _launch(fn, name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def entry_filter_cuda(len_r: torch.Tensor, pos_r: torch.Tensor,
                      len_s: torch.Tensor, pos_s: torch.Tensor,
                      lo: torch.Tensor, hi: torch.Tensor,
                      idx_r: torch.Tensor, idx_s: torch.Tensor,
                      valid: torch.Tensor, table: torch.Tensor, *,
                      key_prod: bool, self_join: bool) -> torch.Tensor:
    """bool[G] admission mask of G postings entries: eight contiguous
    int32[G] CUDA tensors, ``valid`` bool[G] and the int32 prune table."""
    dev = len_r.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    g = len_r.shape[0] if len_r.dim() == 1 else -1
    if not 0 <= g <= _MAX_G:
        raise ValueError(f"entries must be 1-D with at most 2^31 - 1 of them, "
                         f"got {list(len_r.shape)}")
    for t in (len_r, pos_r, len_s, pos_s, lo, hi, idx_r, idx_s):
        _check_vector(t, g, dev)
    _check_vector(valid, g, dev, torch.bool)
    _check_vector(table, table.shape[0], dev)
    out = torch.empty(g, dtype=torch.bool, device=dev)
    if g == 0:
        return out
    fn = _fn("entry_filter_launch", [_C] * 10 + [_I, _I, _I, _C, _C])
    _launch(fn, "entry_filter", dev, len_r.data_ptr(), pos_r.data_ptr(),
            len_s.data_ptr(), pos_s.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            idx_r.data_ptr(), idx_s.data_ptr(), valid.data_ptr(), table.data_ptr(),
            g, int(key_prod), int(self_join), out.data_ptr())
    entry_filter_cuda.launches += 1
    return out


entry_filter_cuda.launches = 0


def _pair_verdict(launcher: str, words_r: torch.Tensor, words_s: torch.Tensor,
                  len_r: torch.Tensor, len_s: torch.Tensor, table: torch.Tensor,
                  *, key_prod: bool, cutoff: int) -> torch.Tensor:
    g = words_r.shape[0] if words_r.dim() == 2 else -1
    if words_s.dim() != 2 or words_s.shape[0] != g:
        raise ValueError(f"gathered words must be [G, W] on both sides, got "
                         f"{list(words_r.shape)} and {list(words_s.shape)}")
    if g > _MAX_G:
        raise ValueError(f"G={g} exceeds 2^31 - 1 candidates")
    check_operands(words_r, words_s, (len_r, g), (len_s, g), (table, table.shape[0]))
    out = torch.empty(g, dtype=torch.bool, device=words_r.device)
    if g == 0:
        return out
    fn = _fn(launcher, [_C] * 5 + [_I, _I, _I, _I, _C, _C])
    _launch(fn, launcher, words_r.device, words_r.data_ptr(), words_s.data_ptr(),
            len_r.data_ptr(), len_s.data_ptr(), table.data_ptr(), g,
            words_r.shape[1], int(key_prod), int(cutoff), out.data_ptr())
    return out


def pair_verdict_cuda(words_r: torch.Tensor, words_s: torch.Tensor,
                      len_r: torch.Tensor, len_s: torch.Tensor, table: torch.Tensor,
                      *, key_prod: bool, cutoff: int) -> torch.Tensor:
    """bool[G] verdicts of G gathered candidate pairs (int32[G, W] words on
    each side, int32[G] lengths), one thread per candidate."""
    out = _pair_verdict("pair_verdict_launch", words_r, words_s, len_r, len_s,
                        table, key_prod=key_prod, cutoff=cutoff)
    if out.numel():
        pair_verdict_cuda.launches += 1
    return out


pair_verdict_cuda.launches = 0


def pair_verdict_tiled_cuda(words_r: torch.Tensor, words_s: torch.Tensor,
                            len_r: torch.Tensor, len_s: torch.Tensor,
                            table: torch.Tensor, *, key_prod: bool,
                            cutoff: int) -> torch.Tensor:
    """Same contract as :func:`pair_verdict_cuda`, candidate-major."""
    out = _pair_verdict("pair_verdict_tiled_launch", words_r, words_s, len_r,
                        len_s, table, key_prod=key_prod, cutoff=cutoff)
    if out.numel():
        pair_verdict_tiled_cuda.launches += 1
    return out


pair_verdict_tiled_cuda.launches = 0


def pair_verdict_bitplane_cuda(planes_r: torch.Tensor, planes_s: torch.Tensor,
                               pc_r: torch.Tensor, pc_s: torch.Tensor,
                               len_r: torch.Tensor, len_s: torch.Tensor,
                               table: torch.Tensor, *, key_prod: bool,
                               cutoff: int) -> torch.Tensor:
    """bool[G] verdicts of G candidate pairs given as int8[G, b] bit planes
    on each side, their int32[G] popcounts and int32[G] lengths."""
    g = planes_r.shape[0] if planes_r.dim() == 2 else -1
    if planes_s.dim() != 2 or planes_s.shape[0] != g:
        raise ValueError(f"gathered planes must be [G, b] on both sides, got "
                         f"{list(planes_r.shape)} and {list(planes_s.shape)}")
    if g > _MAX_G:
        raise ValueError(f"G={g} exceeds 2^31 - 1 candidates")
    check_planes(planes_r, planes_s, (pc_r, g), (pc_s, g), (len_r, g), (len_s, g),
                 (table, table.shape[0]))
    out = torch.empty(g, dtype=torch.bool, device=planes_r.device)
    if g == 0:
        return out
    fn = _fn("pair_verdict_bitplane_launch", [_C] * 7 + [_I, _I, _I, _I, _C, _C])
    _launch(fn, "pair_verdict_bitplane", planes_r.device, planes_r.data_ptr(),
            planes_s.data_ptr(), pc_r.data_ptr(), pc_s.data_ptr(), len_r.data_ptr(),
            len_s.data_ptr(), table.data_ptr(), g, planes_r.shape[1], int(key_prod),
            int(cutoff), out.data_ptr())
    pair_verdict_bitplane_cuda.launches += 1
    return out


pair_verdict_bitplane_cuda.launches = 0


# expand_filter's slots per block (csrc/postings.cu kExpandTile): its slot
# indices stay below 2^31 with a block's worth to spare.
_EXPAND_TILE = 1024


def expand_filter_cuda(rng_flat: torch.Tensor, cnt: torch.Tensor, seg_end: torch.Tensor,
                       post_set: torch.Tensor, post_pos: torch.Tensor,
                       post_len: torch.Tensor, probe_lengths: torch.Tensor,
                       lo_r: torch.Tensor, hi_r: torch.Tensor, s0: int,
                       table: torch.Tensor, *, cap: int, lp: int, key_prod: bool,
                       self_join: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``(rr, ss)``, int32[cap] each: a probe chunk's expanded and admitted
    postings entries, ``INT32_MAX`` in every other slot.  ``rng_flat``,
    ``cnt`` and ``seg_end`` are int32[C * lp] (the window-narrowed CSR start
    and count of each (probe, prefix position), and the counts' inclusive
    prefix sum, whose last element the kernel reads as the stream's
    length); the postings arrays are int32[P]; ``probe_lengths``, ``lo_r``
    and ``hi_r`` int32[C]; ``table`` the int32 prune table."""
    dev = rng_flat.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    nseg = rng_flat.shape[0] if rng_flat.dim() == 1 else -1
    c = probe_lengths.shape[0] if probe_lengths.dim() == 1 else -1
    if nseg <= 0 or lp <= 0 or c * lp != nseg:
        raise ValueError(f"segments must be int32[C * lp], got {list(rng_flat.shape)} "
                         f"for C={c}, lp={lp}")
    if not 0 < cap <= _MAX_G - _EXPAND_TILE:
        raise ValueError(f"cap={cap} must lie in [1, 2^31 - {_EXPAND_TILE + 1}]")
    npost = post_set.shape[0] if post_set.dim() == 1 else -1
    if npost <= 0:
        raise ValueError(f"the postings must be a non-empty int32[P], got "
                         f"{list(post_set.shape)}")
    for t, n in ((rng_flat, nseg), (cnt, nseg), (seg_end, nseg), (post_set, npost),
                 (post_pos, npost), (post_len, npost), (probe_lengths, c), (lo_r, c),
                 (hi_r, c), (table, table.shape[0])):
        _check_vector(t, n, dev)
    rr = torch.empty(cap, dtype=torch.int32, device=dev)
    ss = torch.empty(cap, dtype=torch.int32, device=dev)
    fn = _fn("expand_filter_launch", [_C, _C, _C, _I, _C, _C, _C, _I, _C, _C, _C, _C,
                                      _I, _I, _I, _I, _I, _C, _C, _C])
    _launch(fn, "expand_filter", dev, rng_flat.data_ptr(), cnt.data_ptr(),
            seg_end.data_ptr(), nseg, post_set.data_ptr(), post_pos.data_ptr(),
            post_len.data_ptr(), npost, probe_lengths.data_ptr(), lo_r.data_ptr(),
            hi_r.data_ptr(), table.data_ptr(), cap, lp, int(s0), int(key_prod),
            int(self_join), rr.data_ptr(), ss.data_ptr())
    expand_filter_cuda.launches += 1
    return rr, ss


expand_filter_cuda.launches = 0


def verdict_verify_cuda(tokens_r: torch.Tensor, lengths_r: torch.Tensor,
                        words_r: torch.Tensor, probe_tokens: torch.Tensor,
                        probe_lengths: torch.Tensor, probe_words: torch.Tensor,
                        cand_r: torch.Tensor, cand_s: torch.Tensor,
                        slot_ok: torch.Tensor, table: torch.Tensor,
                        need_tab: torch.Tensor, *, key_prod: bool,
                        cutoff: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cand_mask, ok)``, bool[cap] each: the bitmap verdict of each
    candidate slot where ``slot_ok`` holds, and of those that pass, whether
    the exact overlap of ``tokens_r[cand_r]`` and ``probe_tokens[cand_s]``
    reaches ``need_tab`` (the min-overlap table) at the pair's key.  Words
    are int32[N, W] of one width, tokens int32[N, L] sorted rows with a PAD
    tail, lengths int32[N]; ``cand_r``/``cand_s`` int32[cap] must index
    them where ``slot_ok`` holds and are not read elsewhere."""
    dev = cand_r.device
    cap = cand_r.shape[0] if cand_r.dim() == 1 else -1
    if not 0 <= cap <= _MAX_G:
        raise ValueError(f"candidates must be 1-D with at most 2^31 - 1 of them, got "
                         f"{list(cand_r.shape)}")
    nr, ns = words_r.shape[0], probe_words.shape[0]
    check_operands(words_r, probe_words, (lengths_r, nr), (probe_lengths, ns),
                   (cand_r, cap), (cand_s, cap), (table, table.shape[0]),
                   (need_tab, need_tab.shape[0]))
    for t, n in ((tokens_r, nr), (probe_tokens, ns)):
        if (t.device != dev or t.dtype != torch.int32 or not t.is_contiguous()
                or t.dim() != 2 or t.shape[0] != n):
            raise ValueError(f"tokens must be a contiguous int32[{n}, L] on {dev}, got "
                             f"{t.dtype}{list(t.shape)} on {t.device}")
    _check_vector(slot_ok, cap, dev, torch.bool)
    cand_mask = torch.empty(cap, dtype=torch.bool, device=dev)
    ok = torch.empty(cap, dtype=torch.bool, device=dev)
    if cap == 0:
        return cand_mask, ok
    fn = _fn("verdict_verify_launch", [_C, _C, _C, _C, _C, _I, _C, _C, _C, _I, _C, _I,
                                       _C, _C, _I, _I, _I, _C, _C, _C])
    _launch(fn, "verdict_verify", dev, cand_r.data_ptr(), cand_s.data_ptr(),
            slot_ok.data_ptr(), words_r.data_ptr(), probe_words.data_ptr(),
            words_r.shape[1], lengths_r.data_ptr(), probe_lengths.data_ptr(),
            tokens_r.data_ptr(), tokens_r.shape[1], probe_tokens.data_ptr(),
            probe_tokens.shape[1], table.data_ptr(), need_tab.data_ptr(), cap,
            int(key_prod), int(cutoff), cand_mask.data_ptr(), ok.data_ptr())
    verdict_verify_cuda.launches += 1
    return cand_mask, ok


verdict_verify_cuda.launches = 0
