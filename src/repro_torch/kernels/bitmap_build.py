"""The bitmap build's kernel (CUDA C++, ``csrc/bitmap_build.cu``).

Bitmap-Set, -Xor and -Next (paper Algorithms 3-5) in one kernel that
writes the packed words, one warp a set.  It replaces no TPU kernel: the
reference builds bitmaps in jnp (``repro.core.bitmap.bitmap_set_bits`` and
``bitmap_xor_bits``, a scatter-add; ``bitmap_next_bits``, a ``lax.scan``).
It was added because the port's plain version is a long run of launches
over ``[N, b]`` temporaries.

One wrapper a method, each counting its own launches:
:func:`bitmap_build_set_cuda`, :func:`bitmap_build_xor_cuda` and
:func:`bitmap_build_next_cuda`; :func:`bitmap_build_cuda` picks one by
name.  The plain version is :func:`repro_torch.kernels.ref.bitmap_build_ref`;
callers go through :func:`repro_torch.kernels.ops.bitmap_build`.
"""

from __future__ import annotations

import ctypes
import operator

import torch

from repro_torch.core.constants import BITMAP_NEXT, BITMAP_SET, BITMAP_XOR
from repro_torch.kernels import _build

_C = ctypes.c_void_p
_I = ctypes.c_int
_MAX_INT = (1 << 31) - 1
_METHOD_CODES = {BITMAP_SET: 0, BITMAP_XOR: 1, BITMAP_NEXT: 2}


def check_operands(tokens: torch.Tensor, lengths: torch.Tensor, b: int) -> int:
    """``b`` as an int; raises ``ValueError`` unless ``tokens`` is a
    contiguous int32[N, L] CUDA tensor, ``lengths`` a contiguous int32[N] on
    the same device and ``b`` a positive multiple of 32 below 2^31."""
    dev = tokens.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if tokens.dtype != torch.int32 or tokens.dim() != 2 or not tokens.is_contiguous():
        raise ValueError(f"tokens must be a contiguous int32[N, L], got "
                         f"{tokens.dtype}{list(tokens.shape)}")
    n, l = tokens.shape
    if n > _MAX_INT or l > _MAX_INT:
        raise ValueError(f"tokens {list(tokens.shape)} exceed 2^31 - 1 rows or columns")
    if (lengths.device != dev or lengths.dtype != torch.int32 or lengths.dim() != 1
            or lengths.shape[0] != n or not lengths.is_contiguous()):
        raise ValueError(f"lengths must be a contiguous int32[{n}] on {dev}, got "
                         f"{lengths.dtype}{list(lengths.shape)} on {lengths.device}")
    try:
        width = None if isinstance(b, bool) else operator.index(b)
    except TypeError:
        width = None
    if width is None or not 0 < width <= _MAX_INT or width % 32:
        raise ValueError(f"bitmap width b={b!r} must be a positive multiple of 32 "
                         f"below 2^31")
    return width


def _launch(wrapper, method: str, tokens: torch.Tensor, lengths: torch.Tensor, b: int,
             mix: bool) -> torch.Tensor:
    """The words int32[N, b // 32]; a launch (counted on ``wrapper``) unless
    N = 0."""
    b = check_operands(tokens, lengths, b)
    n, l = tokens.shape
    out = torch.empty((n, b // 32), dtype=torch.int32, device=tokens.device)
    if n == 0:
        return out
    fn = _build.function("bitmap_build", "bitmap_build_launch",
                         [_C, _C, _I, _I, _I, _I, _I, _C, _C])
    with torch.cuda.device(tokens.device):
        rc = fn(tokens.data_ptr(), lengths.data_ptr(), n, l, b, _METHOD_CODES[method],
                int(bool(mix)), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bitmap_build ({method}) kernel launch failed: CUDA error {rc}")
    wrapper.launches += 1
    return out


def bitmap_build_set_cuda(tokens: torch.Tensor, lengths: torch.Tensor, b: int,
                          mix: bool = False) -> torch.Tensor:
    """Bitmap-Set words int32[N, b // 32] of int32[N, L] tokens (PAD_TOKEN
    and positions past ``lengths`` are not tokens of a set)."""
    return _launch(bitmap_build_set_cuda, BITMAP_SET, tokens, lengths, b, mix)


def bitmap_build_xor_cuda(tokens: torch.Tensor, lengths: torch.Tensor, b: int,
                          mix: bool = False) -> torch.Tensor:
    """Bitmap-Xor words, as :func:`bitmap_build_set_cuda`."""
    return _launch(bitmap_build_xor_cuda, BITMAP_XOR, tokens, lengths, b, mix)


def bitmap_build_next_cuda(tokens: torch.Tensor, lengths: torch.Tensor, b: int,
                           mix: bool = False) -> torch.Tensor:
    """Bitmap-Next words, as :func:`bitmap_build_set_cuda`; each row's
    tokens are probed in the order they are stored."""
    return _launch(bitmap_build_next_cuda, BITMAP_NEXT, tokens, lengths, b, mix)


bitmap_build_set_cuda.launches = 0
bitmap_build_xor_cuda.launches = 0
bitmap_build_next_cuda.launches = 0

WRAPPERS = {BITMAP_SET: bitmap_build_set_cuda, BITMAP_XOR: bitmap_build_xor_cuda,
            BITMAP_NEXT: bitmap_build_next_cuda}


def bitmap_build_cuda(tokens: torch.Tensor, lengths: torch.Tensor, b: int, method: str,
                      mix: bool = False) -> torch.Tensor:
    """The packed words of ``method`` ('set', 'xor' or 'next')."""
    if method not in WRAPPERS:
        raise ValueError(f"unknown bitmap method {method!r}; one of {sorted(WRAPPERS)}")
    return WRAPPERS[method](tokens, lengths, b, mix)
