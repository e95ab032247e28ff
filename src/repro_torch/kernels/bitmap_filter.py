"""The dense bitmap-filter kernels (CUDA C++, ``csrc/bitmap_filter.cu``).

* :func:`candidate_matrix_cuda` (the packed-word SWAR kernel) and
  :func:`candidate_matrix_mxu_cuda` (the bit-plane product on the tensor
  cores from the same packed words, with the verdict in its epilogue,
  ``csrc/planes_mma.cuh``) replace
  ``repro.kernels.bitmap_filter.candidate_matrix_pallas``; their plain
  version is :func:`repro_torch.kernels.ref.candidate_matrix_ref`.
* :func:`hamming_matrix_cuda` replaces ``hamming_matrix_pallas``; its plain
  version is :func:`repro_torch.kernels.ref.hamming_matrix_ref`.

Callers go through :mod:`repro_torch.kernels.ops`, which picks the plain
version for CPU tensors and these kernels for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_C = ctypes.c_void_p
_I = ctypes.c_int


def _lib(entry: str = "candidate_matrix_launch"):
    return _build.function("bitmap_filter", entry,
                           [_C, _C, _C, _C, _C, _I, _I, _I, _I, _I, _I, _C, _C])


def _hamming_lib():
    return _build.function("bitmap_filter", "hamming_matrix_launch",
                           [_C, _C, _I, _I, _I, _C, _C])


def check_operands(words_r: torch.Tensor, words_s: torch.Tensor,
                   *vectors: tuple[torch.Tensor, int]) -> None:
    """Raise unless everything is a contiguous int32 CUDA tensor on one
    device, the words are 2-D with one width, and each ``(vector, n)`` is
    1-D of length ``n``."""
    dev = words_r.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if words_r.dim() != 2 or words_s.dim() != 2 or words_r.shape[1] != words_s.shape[1]:
        raise ValueError(f"words must be [NR, W] and [NS, W], got "
                         f"{list(words_r.shape)} and {list(words_s.shape)}")
    for t in (words_r, words_s):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("words must be contiguous int32 on one CUDA device")
    for t, n in vectors:
        if (t.device != dev or t.dtype != torch.int32 or not t.is_contiguous()
                or t.dim() != 1 or t.shape[0] != n):
            raise ValueError(f"expected a contiguous int32[{n}] on {dev}, got "
                             f"{t.dtype}{list(t.shape)} on {t.device}")


def candidate_matrix_cuda(words_r: torch.Tensor, words_s: torch.Tensor,
                          len_r: torch.Tensor, len_s: torch.Tensor,
                          table: torch.Tensor, *, key_prod: bool,
                          self_join: bool, cutoff: int) -> torch.Tensor:
    """bool[NR, NS] verdicts.  ``table`` is the int32 prune table
    (``bounds.prune_table``) covering every key of these lengths, indexed by
    ``lr*ls`` when ``key_prod`` (cosine) and ``lr+ls`` otherwise."""
    nr, ns = words_r.shape[0], words_s.shape[0]
    check_operands(words_r, words_s, (len_r, nr), (len_s, ns),
                   (table, table.shape[0]))
    if nr > 65535 * 64:
        raise ValueError(f"NR={nr} exceeds the kernel's grid")
    out = torch.empty((nr, ns), dtype=torch.bool, device=words_r.device)
    if nr == 0 or ns == 0:
        return out
    with torch.cuda.device(words_r.device):
        rc = _lib()(words_r.data_ptr(), words_s.data_ptr(), len_r.data_ptr(),
                    len_s.data_ptr(), table.data_ptr(), nr, ns, words_r.shape[1],
                    int(key_prod), int(self_join), int(cutoff), out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"candidate_matrix kernel launch failed: CUDA error {rc}")
    candidate_matrix_cuda.launches += 1
    return out


candidate_matrix_cuda.launches = 0


def candidate_matrix_mxu_cuda(words_r: torch.Tensor, words_s: torch.Tensor,
                              len_r: torch.Tensor, len_s: torch.Tensor,
                              table: torch.Tensor, *, key_prod: bool,
                              self_join: bool, cutoff: int) -> torch.Tensor:
    """The verdicts of :func:`candidate_matrix_cuda`, equal to them, from the
    tensor-core kernel (any W >= 1)."""
    nr, ns = words_r.shape[0], words_s.shape[0]
    check_operands(words_r, words_s, (len_r, nr), (len_s, ns),
                   (table, table.shape[0]))
    if words_r.shape[1] == 0:
        raise ValueError("words must have at least one column")
    out = torch.empty((nr, ns), dtype=torch.bool, device=words_r.device)
    if nr == 0 or ns == 0:
        return out
    with torch.cuda.device(words_r.device):
        rc = _lib("candidate_matrix_mxu_launch")(
            words_r.data_ptr(), words_s.data_ptr(), len_r.data_ptr(), len_s.data_ptr(),
            table.data_ptr(), nr, ns, words_r.shape[1], int(key_prod), int(self_join),
            int(cutoff), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"candidate_matrix_mxu kernel launch failed: CUDA error {rc}")
    candidate_matrix_mxu_cuda.launches += 1
    return out


candidate_matrix_mxu_cuda.launches = 0


def hamming_matrix_cuda(words_r: torch.Tensor, words_s: torch.Tensor) -> torch.Tensor:
    """int32[NR, NS] all-pairs Hamming distances of int32[NR, W] and
    int32[NS, W] word rows (uint32 bit patterns)."""
    nr, ns = words_r.shape[0], words_s.shape[0]
    check_operands(words_r, words_s)
    if nr > 65535 * 64:
        raise ValueError(f"NR={nr} exceeds the kernel's grid")
    out = torch.empty((nr, ns), dtype=torch.int32, device=words_r.device)
    if nr == 0 or ns == 0:
        return out
    with torch.cuda.device(words_r.device):
        rc = _hamming_lib()(words_r.data_ptr(), words_s.data_ptr(), nr, ns,
                            words_r.shape[1], out.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hamming_matrix kernel launch failed: CUDA error {rc}")
    hamming_matrix_cuda.launches += 1
    return out


hamming_matrix_cuda.launches = 0
