"""The bitmap build's kernel (CUDA C++, ``csrc/bitmap_build.cu``).

Bitmap-Set, -Xor and -Next (paper Algorithms 3-5) in one source that
writes the packed words.  It replaces no TPU kernel: the reference builds
bitmaps in jnp (``repro.core.bitmap.bitmap_set_bits`` and
``bitmap_xor_bits``, a scatter-add; ``bitmap_next_bits``, a ``lax.scan``).
It was added because the port's plain version is a long run of launches
over ``[N, b]`` temporaries.

Two forms (:data:`FORMS`): ``"lane"``, one lane a set (its words in
registers or in shared memory, Next's probes on one lane; up to b = 1,024),
and ``"warp"``, one warp a set (shared-memory atomics; Next probed by the
whole warp; every b).  :func:`form` is the fixed rule that picks one from the method, b
and N; the wrappers' ``form=`` overrides it, for timing one form against
the other.

One wrapper a method, each counting its own launches (``launches``) and
its launches by form (``form_launches``): :func:`bitmap_build_set_cuda`,
:func:`bitmap_build_xor_cuda` and :func:`bitmap_build_next_cuda`;
:func:`bitmap_build_cuda` picks one by name.  The plain version is
:func:`repro_torch.kernels.ref.bitmap_build_ref`; callers go through
:func:`repro_torch.kernels.ops.bitmap_build`.
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
FORMS = ("warp", "lane")   # codes 0, 1 of the C entry point
# The lane form's widest bitmap in words (``kLaneMaxWords`` in the source):
# b = 1,024, the widest it was timed at (PERF.md, row 10); wider bitmaps
# take the warp form.
LANE_MAX_WORDS = 32
# Set and Xor take the lane form from this many rows up: below it too few
# warps share the card, and their warp form, one warp a set, measured
# faster (the two tie at 8,192 ZIPF rows; PERF.md, row 10).
SET_XOR_LANE_MIN_ROWS = 8192


def form(method: str, b: int, n: int, requested: str | None = None) -> str:
    """The form that builds ``n`` rows of ``method`` at width ``b``: the
    fixed rule when ``requested`` is None (the lane form up to
    ``LANE_MAX_WORDS`` words, Set and Xor only from
    ``SET_XOR_LANE_MIN_ROWS`` rows), else ``requested``, which must have a
    kernel at that width (``ValueError``)."""
    lane_ok = b // 32 <= LANE_MAX_WORDS
    if requested is None:
        if not lane_ok or (method != BITMAP_NEXT and n < SET_XOR_LANE_MIN_ROWS):
            return "warp"
        return "lane"
    if requested not in FORMS:
        raise ValueError(f"unknown form {requested!r}; one of {FORMS}")
    if requested == "lane" and not lane_ok:
        raise ValueError(f"the lane form builds at most {32 * LANE_MAX_WORDS} bits, not b={b}")
    return requested


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
            mix: bool, requested: str | None) -> torch.Tensor:
    """The words int32[N, b // 32]; a launch (counted on ``wrapper``, and
    by form) unless N = 0."""
    b = check_operands(tokens, lengths, b)
    n, l = tokens.shape
    name = form(method, b, n, requested)
    out = torch.empty((n, b // 32), dtype=torch.int32, device=tokens.device)
    if n == 0:
        return out
    fn = _build.function("bitmap_build", "bitmap_build_launch",
                         [_C, _C, _I, _I, _I, _I, _I, _I, _C, _C])
    with torch.cuda.device(tokens.device):
        rc = fn(tokens.data_ptr(), lengths.data_ptr(), n, l, b, _METHOD_CODES[method],
                int(bool(mix)), FORMS.index(name), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bitmap_build ({method}, {name} form) kernel launch failed: "
                           f"CUDA error {rc}")
    wrapper.launches += 1
    wrapper.form_launches[name] += 1
    return out


def bitmap_build_set_cuda(tokens: torch.Tensor, lengths: torch.Tensor, b: int,
                          mix: bool = False, *, form: str | None = None) -> torch.Tensor:
    """Bitmap-Set words int32[N, b // 32] of int32[N, L] tokens (PAD_TOKEN
    and positions past ``lengths`` are not tokens of a set); ``form``
    overrides the rule (:func:`form`)."""
    return _launch(bitmap_build_set_cuda, BITMAP_SET, tokens, lengths, b, mix, form)


def bitmap_build_xor_cuda(tokens: torch.Tensor, lengths: torch.Tensor, b: int,
                          mix: bool = False, *, form: str | None = None) -> torch.Tensor:
    """Bitmap-Xor words, as :func:`bitmap_build_set_cuda`."""
    return _launch(bitmap_build_xor_cuda, BITMAP_XOR, tokens, lengths, b, mix, form)


def bitmap_build_next_cuda(tokens: torch.Tensor, lengths: torch.Tensor, b: int,
                           mix: bool = False, *, form: str | None = None) -> torch.Tensor:
    """Bitmap-Next words, as :func:`bitmap_build_set_cuda`; each row's
    tokens are probed in the order they are stored."""
    return _launch(bitmap_build_next_cuda, BITMAP_NEXT, tokens, lengths, b, mix, form)


WRAPPERS = {BITMAP_SET: bitmap_build_set_cuda, BITMAP_XOR: bitmap_build_xor_cuda,
            BITMAP_NEXT: bitmap_build_next_cuda}
for _wrapper in WRAPPERS.values():
    _wrapper.launches = 0
    _wrapper.form_launches = dict.fromkeys(FORMS, 0)


def bitmap_build_cuda(tokens: torch.Tensor, lengths: torch.Tensor, b: int, method: str,
                      mix: bool = False, *, form: str | None = None) -> torch.Tensor:
    """The packed words of ``method`` ('set', 'xor' or 'next')."""
    if method not in WRAPPERS:
        raise ValueError(f"unknown bitmap method {method!r}; one of {sorted(WRAPPERS)}")
    return WRAPPERS[method](tokens, lengths, b, mix, form=form)
