"""The bit-plane Hamming kernel (CUDA C++, ``csrc/bitplane.cu``).

:func:`bitplane_hamming_cuda` replaces
``repro.kernels.bitplane.bitplane_hamming_pallas``: the all-pairs Hamming
distance of {0, 1} int8 bit planes as an int8 tensor-core product plus the
row popcounts.  Its plain version is
:func:`repro_torch.kernels.ref.bitplane_hamming_ref`; callers go through
:mod:`repro_torch.kernels.ops` (``impl="mxu"``), which unpacks the words.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_C = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    return _build.function("bitplane", "bitplane_hamming_launch",
                           [_C, _C, _C, _C, _I, _I, _I, _C, _C])


def check_planes(planes_r: torch.Tensor, planes_s: torch.Tensor,
                 *vectors: tuple[torch.Tensor, int]) -> None:
    """Raise unless the planes are contiguous, 16-byte aligned int8 CUDA
    tensors ``[N, b]`` of one width ``b % 32 == 0`` on one device, and each
    ``(vector, n)`` is a contiguous int32[n] there."""
    dev = planes_r.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if (planes_r.dim() != 2 or planes_s.dim() != 2
            or planes_r.shape[1] != planes_s.shape[1] or planes_r.shape[1] % 32):
        raise ValueError(f"planes must be [NR, b] and [NS, b] with b % 32 == 0, got "
                         f"{list(planes_r.shape)} and {list(planes_s.shape)}")
    for t in (planes_r, planes_s):
        if (t.device != dev or t.dtype != torch.int8 or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("planes must be contiguous, 16-byte aligned int8 on one "
                             "CUDA device")
    for t, n in vectors:
        if (t.device != dev or t.dtype != torch.int32 or not t.is_contiguous()
                or t.dim() != 1 or t.shape[0] != n):
            raise ValueError(f"expected a contiguous int32[{n}] on {dev}, got "
                             f"{t.dtype}{list(t.shape)} on {t.device}")


def bitplane_hamming_cuda(planes_r: torch.Tensor, planes_s: torch.Tensor,
                          pc_r: torch.Tensor, pc_s: torch.Tensor) -> torch.Tensor:
    """int32[NR, NS] Hamming distances ``pc_r[i] + pc_s[j] - 2 <r_i, s_j>``
    of int8[NR, b] and int8[NS, b] bit planes with int32 row popcounts."""
    nr, ns = planes_r.shape[0], planes_s.shape[0]
    check_planes(planes_r, planes_s, (pc_r, nr), (pc_s, ns))
    out = torch.empty((nr, ns), dtype=torch.int32, device=planes_r.device)
    if nr == 0 or ns == 0:
        return out
    with torch.cuda.device(planes_r.device):
        rc = _fn()(planes_r.data_ptr(), planes_s.data_ptr(), pc_r.data_ptr(),
                   pc_s.data_ptr(), nr, ns, planes_r.shape[1], out.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bitplane_hamming kernel launch failed: CUDA error {rc}")
    bitplane_hamming_cuda.launches += 1
    return out


bitplane_hamming_cuda.launches = 0
