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

Their plain versions are :func:`repro_torch.kernels.ref.entry_filter_ref`,
:func:`repro_torch.kernels.ref.pair_verdict_ref` and
:func:`repro_torch.kernels.ref.bitplane_pair_hamming_ref` (plus
:func:`repro_torch.core.bounds.verdict_from_hamming`); callers go through
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
    fn = getattr(_build.library("postings"), name)
    fn.argtypes = argtypes
    fn.restype = _I
    return fn


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
