"""The tile-count prepass kernel (CUDA C++, ``csrc/compaction.cu``).

Replaces ``repro.kernels.compaction.count_candidates_pallas``: per tile of
the pair grid, the number of window pairs and of bitmap candidates, so the
device-resident join can size its compaction capacity.  Its plain version
is :func:`repro_torch.kernels.ref.count_candidates_ref`; callers go through
:func:`repro_torch.kernels.ops.count_candidates`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitmap_filter import check_operands

_C = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.library("compaction")
    fn = lib.count_candidates_launch
    fn.argtypes = [_C, _C, _C, _C, _C, _C, _C, _I, _I, _I, _I, _I, _I, _I, _I,
                   _C, _C, _C]
    fn.restype = _I
    return fn


def count_candidates_cuda(words_r: torch.Tensor, words_s: torch.Tensor,
                          len_r: torch.Tensor, len_s: torch.Tensor,
                          lo_s: torch.Tensor | None, hi_s: torch.Tensor | None,
                          table: torch.Tensor, *, key_prod: bool, self_join: bool,
                          cutoff: int, tile_r: int, tile_s: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(window counts, candidate counts), two int32[ceil(NR/tile_r),
    ceil(NS/tile_s)].  ``lo_s``/``hi_s`` (int32[NR]) are the admissible
    |s| windows per R row, or both ``None`` to count without the window."""
    nr, ns = words_r.shape[0], words_s.shape[0]
    if (lo_s is None) != (hi_s is None):
        raise ValueError("pass both lo_s and hi_s, or neither")
    windows = [] if lo_s is None else [(lo_s, nr), (hi_s, nr)]
    check_operands(words_r, words_s, (len_r, nr), (len_s, ns),
                   (table, table.shape[0]), *windows)
    if tile_r <= 0 or tile_s <= 0:
        raise ValueError(f"tiles must be positive, got {tile_r}x{tile_s}")
    gr, gs = -(-nr // tile_r), -(-ns // tile_s)
    if gr > 65535:
        raise ValueError(f"NR={nr} exceeds the kernel's grid at tile {tile_r}")
    out_win = torch.empty((gr, gs), dtype=torch.int32, device=words_r.device)
    out_cand = torch.empty((gr, gs), dtype=torch.int32, device=words_r.device)
    if nr == 0 or ns == 0:
        return out_win, out_cand
    with torch.cuda.device(words_r.device):
        rc = _lib()(words_r.data_ptr(), words_s.data_ptr(), len_r.data_ptr(),
                    len_s.data_ptr(), None if lo_s is None else lo_s.data_ptr(),
                    None if hi_s is None else hi_s.data_ptr(), table.data_ptr(),
                    nr, ns, words_r.shape[1], int(key_prod), int(self_join),
                    int(cutoff), tile_r, tile_s, out_win.data_ptr(),
                    out_cand.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"count_candidates kernel launch failed: CUDA error {rc}")
    count_candidates_cuda.launches += 1
    return out_win, out_cand


count_candidates_cuda.launches = 0
