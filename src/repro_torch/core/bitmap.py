"""Bitmap generation (paper Section 3.2) and bit packing, in PyTorch.

The port of ``repro.core.bitmap``; every method produces words bit-identical
to the reference:

* **Bitmap-Set** (Algorithm 3): bit ``h(t)`` is OR-ed for every token.
* **Bitmap-Xor** (Algorithm 4): bit ``h(t)`` is XOR-ed for every token.
* **Bitmap-Next** (Algorithm 5): linear probing — each token sets the first
  unset bit at or cyclically after ``h(t)``.

Packed bitmaps are ``int32[N, W]`` tensors (``W = b // 32``) holding the
reference's ``uint32`` words as bit patterns: bit ``i`` lives at word
``i // 32``, bit ``i % 32``.  PyTorch's CPU ``uint32`` lacks ``>>`` and
``-``, so words stay int32 everywhere in the port and become ``uint32``
only at the numpy boundary, through ``.view`` (never by value); the CUDA
kernels read the same buffer as ``const uint32_t*``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import expected
from repro_torch.core.constants import (
    BITMAP_COMBINED,
    BITMAP_NEXT,
    BITMAP_SET,
    BITMAP_XOR,
    PAD_TOKEN,
)

_KNUTH = 2654435761
_MASK32 = 0xFFFFFFFF


def hash_positions(tokens: torch.Tensor, b: int, mix: bool = False) -> torch.Tensor:
    """``h(t)``: int32 bit positions in ``[0, b)`` (``t mod b``, optionally
    after the Knuth multiplicative mixer, with uint32 wraparound)."""
    t = tokens.to(torch.int64) & _MASK32
    if mix:
        # t * K mod 2^32 without int64 overflow: split K into 16-bit halves.
        lo = t * (_KNUTH & 0xFFFF)
        hi = ((t * (_KNUTH >> 16)) & 0xFFFF) << 16
        t = (lo + hi) & _MASK32
        t = t ^ (t >> 16)
    return (t % b).to(torch.int32)


def _valid(tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    l = tokens.shape[1]
    pos = torch.arange(l, device=tokens.device)
    return (tokens != PAD_TOKEN) & (pos[None, :] < lengths.to(torch.int64)[:, None])


def _bit_counts(tokens: torch.Tensor, lengths: torch.Tensor, b: int, mix: bool) -> torch.Tensor:
    """int32[N, b] — how many (valid) tokens of each set hash to each bit."""
    pos = hash_positions(tokens, b, mix).to(torch.int64)
    counts = torch.zeros((tokens.shape[0], b), dtype=torch.int32, device=tokens.device)
    return counts.scatter_add_(1, pos, _valid(tokens, lengths).to(torch.int32))


def bitmap_set_bits(tokens: torch.Tensor, lengths: torch.Tensor, b: int, mix: bool = False) -> torch.Tensor:
    """Bitmap-Set as a bool[N, b] bit matrix."""
    return _bit_counts(tokens, lengths, b, mix) > 0


def bitmap_xor_bits(tokens: torch.Tensor, lengths: torch.Tensor, b: int, mix: bool = False) -> torch.Tensor:
    """Bitmap-Xor as a bool[N, b] bit matrix."""
    return (_bit_counts(tokens, lengths, b, mix) % 2) == 1


def bitmap_next_bits(tokens: torch.Tensor, lengths: torch.Tensor, b: int, mix: bool = False) -> torch.Tensor:
    """Bitmap-Next as a bool[N, b] bit matrix.

    Linear probing is sequential per set, so the loop runs over token
    positions and is vectorised over sets: among unset bits, each probe
    picks the one minimising the cyclic distance ``(i - h(t)) mod b``
    (``argmin`` takes the first minimum, as ``jnp.argmin`` does).  Saturated
    bitmaps (n >= b) come out all-ones.
    """
    n, l = tokens.shape
    pos = hash_positions(tokens, b, mix).to(torch.int64)
    valid = _valid(tokens, lengths)
    idx = torch.arange(b, dtype=torch.int64, device=tokens.device)
    bits = torch.zeros((n, b), dtype=torch.bool, device=tokens.device)
    rows = torch.arange(n, device=tokens.device)
    for p in range(l):
        dist = (idx[None, :] - pos[:, p:p + 1]) % b
        dist = torch.where(bits, b, dist)  # occupied bits are never chosen
        j = torch.argmin(dist, dim=1)
        bits[rows, j] |= valid[:, p]
    return bits


def _validate_width(b: int) -> None:
    """Reject widths that would silently mis-pack (b <= 0, or bits that do
    not fill whole 32-bit words)."""
    if not isinstance(b, (int, np.integer)):
        raise ValueError(f"bitmap width must be an int, got {type(b).__name__}")
    if b <= 0 or b % 32:
        raise ValueError(
            f"bitmap width b={b} must be a positive multiple of 32 "
            f"(bitmaps are packed into uint32 words)")


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool[N, b] -> int32[N, b//32] bit patterns (little-endian bit order)."""
    n, b = bits.shape
    _validate_width(b)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, device=bits.device)
    v = (bits.reshape(n, b // 32, 32).to(torch.int64) * weights).sum(-1)
    # v is the uint32 word in [0, 2^32): wrap it to the same int32 bit pattern.
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def unpack_bits(words: torch.Tensor, b: int | None = None) -> torch.Tensor:
    """int32[N, W] bit patterns -> bool[N, 32*W]."""
    n, w = words.shape
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    # Arithmetic >> still leaves bit k of the pattern at bit 0.
    bits = ((words[:, :, None] >> shifts) & 1).to(torch.bool).reshape(n, w * 32)
    return bits if b is None else bits[:, :b]


def unpack_planes(words: torch.Tensor) -> torch.Tensor:
    """int32[N, W] bit patterns -> int8[N, 32*W] {0, 1} bit planes: the
    bit-plane kernels' operand, equal to ``unpack_bits(words).to(int8)``.
    Works a byte at a time (bit ``i`` is bit ``i % 8`` of little-endian byte
    ``i // 8``), so no intermediate is wider than the planes themselves."""
    n, w = words.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    octets = words.contiguous().view(torch.uint8)
    return ((octets[:, :, None] >> shifts) & 1).view(torch.int8).reshape(n, 32 * w)


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """SWAR population count of int32 bit patterns -> int32, computed in
    int64 so that no step can overflow."""
    v = v.to(torch.int64) & _MASK32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24 & 0xFF).to(torch.int32)


def popcount_rows(words: torch.Tensor) -> torch.Tensor:
    """int32[N, W] -> int32[N] total ones per row."""
    return popcount32(words).sum(-1, dtype=torch.int32)


# The plain generators (bit matrices), by method: the CPU path, and the
# plain version (``kernels.ref.bitmap_build_ref``) of the card's kernel.
GENERATORS = {
    BITMAP_SET: bitmap_set_bits,
    BITMAP_XOR: bitmap_xor_bits,
    BITMAP_NEXT: bitmap_next_bits,
}


def choose_method(tau_jaccard: float, b: int = 64) -> str:
    """Bitmap-Combined policy (Algorithm 6), crossovers from Eq. 4-6."""
    lo, hi = expected.combined_crossovers(b)
    if tau_jaccard <= lo:
        return BITMAP_NEXT
    if tau_jaccard >= hi:
        return BITMAP_XOR
    return BITMAP_SET


def generate_bitmaps(
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    b: int,
    method: str = BITMAP_COMBINED,
    tau_jaccard: float | None = None,
    mix: bool = False,
    packed: bool = True,
) -> torch.Tensor:
    """Generate bitmaps for a padded collection, on the tensors' device.

    On CUDA tensors every method runs the hand-written kernel
    (``kernels.ops.bitmap_build``), which writes the packed words; on
    other devices the plain generators above run, then :func:`pack_bits`.

    Args:
      tokens: int32[N, L] padded tokens.
      lengths: int32[N].
      b: bitmap width in bits (multiple of 32).
      method: 'set' | 'xor' | 'next' | 'combined'.
      tau_jaccard: required when method == 'combined'.
      packed: return packed int32[N, b//32] (default) or bool[N, b].

    Raises:
      ValueError: if ``b`` is not a positive multiple of 32, or for an
        unknown method.
    """
    _validate_width(b)
    if method == BITMAP_COMBINED:
        if tau_jaccard is None:
            raise ValueError("combined method needs tau_jaccard")
        method = choose_method(tau_jaccard, b)
    if method not in GENERATORS:
        raise ValueError(f"unknown bitmap method {method!r}; "
                         f"one of {sorted(GENERATORS)} or 'combined'")
    if tokens.device.type == "cuda":
        # Imported here: kernels.ops imports this module.
        from repro_torch.kernels import ops

        words = ops.bitmap_build(tokens.to(torch.int32).contiguous(),
                                 lengths.to(torch.int32).contiguous(), b, method, mix)
        return words if packed else unpack_bits(words)
    bits = GENERATORS[method](tokens, lengths, b, mix)
    return pack_bits(bits) if packed else bits


def hamming_packed(words_r: torch.Tensor, words_s: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distance: int32[NR, W] x int32[NS, W] -> int32[NR, NS]."""
    out = torch.zeros((words_r.shape[0], words_s.shape[0]), dtype=torch.int32,
                      device=words_r.device)
    for k in range(words_r.shape[1]):
        out += popcount32(words_r[:, k, None] ^ words_s[None, :, k])
    return out
