"""The tile-count prepass kernels (CUDA C++, ``csrc/compaction.cu``).

Both replace ``repro.kernels.compaction.count_candidates_pallas``: per tile
of the pair grid, the number of window pairs and of bitmap candidates, so
the device-resident join can size its compaction capacity.

* :func:`count_candidates_cuda` is the packed-word SWAR kernel (XOR and
  popcount per word);
* :func:`count_candidates_mxu_cuda` takes the bit-plane inner product on
  the tensor cores from the same packed words, with the window, the
  triangle, the verdict and the per-tile sums in its epilogue
  (``csrc/planes_mma.cuh``).

Their plain version is :func:`repro_torch.kernels.ref.count_candidates_ref`
(``bitplane=True`` repeats the tensor-core form's arithmetic); callers go
through :func:`repro_torch.kernels.ops.count_candidates`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitmap_filter import check_operands

_C = ctypes.c_void_p
_I = ctypes.c_int


def _lib(entry: str = "count_candidates_launch"):
    return _build.function("compaction", entry,
                           [_C, _C, _C, _C, _C, _C, _C, _I, _I, _I, _I, _I, _I, _I, _I,
                            _C, _C, _C])


def _check(words_r, words_s, len_r, len_s, lo_s, hi_s, table, tile_r, tile_s):
    """Raise on operands neither kernel takes; return the output grid."""
    nr, ns = words_r.shape[0], words_s.shape[0]
    if (lo_s is None) != (hi_s is None):
        raise ValueError("pass both lo_s and hi_s, or neither")
    windows = [] if lo_s is None else [(lo_s, nr), (hi_s, nr)]
    check_operands(words_r, words_s, (len_r, nr), (len_s, ns),
                   (table, table.shape[0]), *windows)
    if tile_r <= 0 or tile_s <= 0:
        raise ValueError(f"tiles must be positive, got {tile_r}x{tile_s}")
    return -(-nr // tile_r), -(-ns // tile_s)


def _launch(fn, words_r, words_s, len_r, len_s, lo_s, hi_s, table, key_prod, self_join,
            cutoff, tile_r, tile_s, out_win, out_cand) -> int:
    with torch.cuda.device(words_r.device):
        return fn(words_r.data_ptr(), words_s.data_ptr(), len_r.data_ptr(),
                  len_s.data_ptr(), None if lo_s is None else lo_s.data_ptr(),
                  None if hi_s is None else hi_s.data_ptr(), table.data_ptr(),
                  words_r.shape[0], words_s.shape[0], words_r.shape[1], int(key_prod),
                  int(self_join), int(cutoff), tile_r, tile_s, out_win.data_ptr(),
                  out_cand.data_ptr(), torch.cuda.current_stream().cuda_stream)


def count_candidates_cuda(words_r: torch.Tensor, words_s: torch.Tensor,
                          len_r: torch.Tensor, len_s: torch.Tensor,
                          lo_s: torch.Tensor | None, hi_s: torch.Tensor | None,
                          table: torch.Tensor, *, key_prod: bool, self_join: bool,
                          cutoff: int, tile_r: int, tile_s: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(window counts, candidate counts), two int32[ceil(NR/tile_r),
    ceil(NS/tile_s)], from the SWAR kernel.  ``lo_s``/``hi_s`` (int32[NR])
    are the admissible |s| windows per R row, or both ``None`` to count
    without the window."""
    gr, gs = _check(words_r, words_s, len_r, len_s, lo_s, hi_s, table, tile_r, tile_s)
    if gr > 65535:
        raise ValueError(f"NR={words_r.shape[0]} exceeds the kernel's grid at tile {tile_r}")
    out_win = torch.empty((gr, gs), dtype=torch.int32, device=words_r.device)
    out_cand = torch.empty((gr, gs), dtype=torch.int32, device=words_r.device)
    if words_r.shape[0] == 0 or words_s.shape[0] == 0:
        return out_win, out_cand
    rc = _launch(_lib(), words_r, words_s, len_r, len_s, lo_s, hi_s, table, key_prod,
                 self_join, cutoff, tile_r, tile_s, out_win, out_cand)
    if rc != 0:
        raise RuntimeError(f"count_candidates kernel launch failed: CUDA error {rc}")
    count_candidates_cuda.launches += 1
    return out_win, out_cand


count_candidates_cuda.launches = 0


def count_candidates_mxu_cuda(words_r: torch.Tensor, words_s: torch.Tensor,
                              len_r: torch.Tensor, len_s: torch.Tensor,
                              lo_s: torch.Tensor | None, hi_s: torch.Tensor | None,
                              table: torch.Tensor, *, key_prod: bool, self_join: bool,
                              cutoff: int, tile_r: int, tile_s: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The counts of :func:`count_candidates_cuda`, equal to them, from the
    tensor-core kernel (any W >= 1, any tile)."""
    gr, gs = _check(words_r, words_s, len_r, len_s, lo_s, hi_s, table, tile_r, tile_s)
    if words_r.shape[1] == 0:
        raise ValueError("words must have at least one column")
    # The kernel adds its sums into zeroed outputs (one fill for both).
    out_win, out_cand = torch.zeros((2, gr, gs), dtype=torch.int32, device=words_r.device)
    if words_r.shape[0] == 0 or words_s.shape[0] == 0:
        return out_win, out_cand
    rc = _launch(_lib("count_candidates_mxu_launch"), words_r, words_s, len_r, len_s,
                 lo_s, hi_s, table, key_prod, self_join, cutoff, tile_r, tile_s, out_win,
                 out_cand)
    if rc != 0:
        raise RuntimeError(f"count_candidates_mxu kernel launch failed: CUDA error {rc}")
    count_candidates_mxu_cuda.launches += 1
    return out_win, out_cand


count_candidates_mxu_cuda.launches = 0
