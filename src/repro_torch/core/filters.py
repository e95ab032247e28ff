"""Classic filters of the Filter-Verification framework (Section 2.3).

The port of ``repro.core.filters``: the length filter (2.3.2), the
positional filter (2.3.3) and the bitmap filter itself (Section 3.6,
Algorithm 7) in the numpy flavour the CPU algorithms use.  The bitmap
words are generated by :mod:`repro_torch.core.bitmap` on a device (the
card unless the caller passes ``device="cpu"``) and come back to the host
as numpy ``uint32``; the per-pair test (:meth:`BitmapFilter.prune_mask`) is
numpy, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import bounds, expected
from repro_torch.core.constants import BITMAP_COMBINED


def length_window(sim: str, tau: float, len_r) -> tuple[np.ndarray, np.ndarray]:
    """Inclusive integer (lo, hi) admissible |s| window for the length filter.

    Routed through :func:`repro_torch.core.bounds.length_window_int`, the
    window every device driver applies.
    """
    return bounds.length_window_int(sim, tau, len_r)


def length_filter_mask(sim: str, tau: float, len_r, len_s):
    """True where the pair *survives* the length filter (elementwise)."""
    lo, hi = bounds.length_window_int(sim, tau, len_r)
    return (len_s >= lo) & (len_s <= hi)


def positional_filter_mask(sim: str, tau: float, len_r, len_s, pos_r, pos_s):
    """True where the pair survives the positional filter."""
    ub = bounds.positional_upper_bound(len_r, len_s, pos_r, pos_s)
    need = bounds.equivalent_overlap(sim, tau, len_r, len_s)
    return ub >= need


def words_numpy(tokens: np.ndarray, lengths: np.ndarray, b: int, method: str,
                mix: bool, device) -> np.ndarray:
    """Packed ``uint32[N, b//32]`` bitmap words of a padded collection,
    generated on ``device`` (the card when ``None``) and returned to the
    host: the int32 bit patterns viewed as ``uint32``."""
    # Imported here: the engine imports this module.
    from repro_torch.core.engine import resolve_device

    dev = resolve_device(device)
    # Copies: torch.from_numpy warns on a prepared collection's sealed arrays.
    words = bm.generate_bitmaps(
        torch.from_numpy(np.array(tokens, dtype=np.int32)).to(dev),
        torch.from_numpy(np.array(lengths, dtype=np.int32)).to(dev),
        b, method=method, mix=mix)
    return words.cpu().numpy().view(np.uint32)


@dataclasses.dataclass
class BitmapFilter:
    """Algorithm 7 — precomputed bitmaps + cutoff, reusable across probes.

    For a self-join the probe and the index are the same collection.  For an
    R×S join build with :meth:`build_rs`: the index side holds R (the
    candidates), the probe side holds S; ``prune_mask(s, r_cands)`` then
    compares the probe set's bitmap against index-side bitmaps.  Both sides
    must share one token space (``h(t) = t mod b`` is token-value based, so
    bitmaps are comparable across collections).
    """

    words: np.ndarray  # uint32[N, W] packed bitmaps (index side)
    lengths: np.ndarray  # int32[N]
    sim: str
    tau: float
    b: int
    cutoff: int
    method: str
    probe_words: np.ndarray | None = None   # probe side; defaults to index side
    probe_lengths: np.ndarray | None = None

    # 8-bit popcount LUT shared by all instances.
    _LUT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1).astype(np.int32)

    def __post_init__(self):
        if self.probe_words is None:
            self.probe_words = self.words
        if self.probe_lengths is None:
            self.probe_lengths = self.lengths

    @classmethod
    def build(
        cls,
        tokens: np.ndarray,
        lengths: np.ndarray,
        sim: str,
        tau: float,
        b: int = 64,
        method: str = BITMAP_COMBINED,
        use_cutoff: bool = True,
        mix: bool = False,
        *,
        device=None,
    ) -> "BitmapFilter":
        """Self-join filter; the words are generated on ``device``."""
        # The cutoff policy is parameterised on the Jaccard scale, whatever
        # the similarity, as in the reference.
        chosen = bm.choose_method(tau, b) if method == BITMAP_COMBINED else method
        words = words_numpy(tokens, lengths, b, chosen, mix, device)
        cutoff = (expected.cutoff_point(chosen, b, float(tau)) if use_cutoff
                  else np.iinfo(np.int32).max)
        return cls(words=words, lengths=np.asarray(lengths), sim=sim, tau=tau, b=b,
                   cutoff=int(cutoff), method=chosen)

    @classmethod
    def build_rs(
        cls,
        tokens_r: np.ndarray,
        lengths_r: np.ndarray,
        tokens_s: np.ndarray,
        lengths_s: np.ndarray,
        sim: str,
        tau: float,
        b: int = 64,
        method: str = BITMAP_COMBINED,
        use_cutoff: bool = True,
        mix: bool = False,
        *,
        device=None,
    ) -> "BitmapFilter":
        """Cross-collection filter: index side R, probe side S."""
        chosen = bm.choose_method(tau, b) if method == BITMAP_COMBINED else method
        words_r = words_numpy(tokens_r, lengths_r, b, chosen, mix, device)
        words_s = words_numpy(tokens_s, lengths_s, b, chosen, mix, device)
        cutoff = (expected.cutoff_point(chosen, b, float(tau)) if use_cutoff
                  else np.iinfo(np.int32).max)
        return cls(words=words_r, lengths=np.asarray(lengths_r), sim=sim, tau=tau, b=b,
                   cutoff=int(cutoff), method=chosen, probe_words=words_s,
                   probe_lengths=np.asarray(lengths_s))

    def hamming(self, i: int, js: np.ndarray) -> np.ndarray:
        """Hamming distances between probe set ``i`` and index sets ``js``."""
        x = self.probe_words[i][None, :] ^ self.words[js]
        return self._LUT[x.view(np.uint8)].reshape(len(js), -1).sum(axis=1)

    def prune_mask(self, i: int, js: np.ndarray) -> np.ndarray:
        """True where the pair (i, j) is *pruned* by the bitmap filter.

        ``i`` indexes the probe side, ``js`` the index side (identical for a
        self-join).  Mirrors Algorithm 7: above the cutoff the filter is a
        no-op.
        """
        js = np.asarray(js, dtype=np.int64)
        if len(js) == 0:
            return np.zeros((0,), dtype=bool)
        if self.probe_lengths[i] > self.cutoff:
            return np.zeros(js.shape, dtype=bool)
        ham = self.hamming(i, js)
        ub = bounds.overlap_upper_bound(self.probe_lengths[i], self.lengths[js], ham)
        need = bounds.equivalent_overlap(self.sim, self.tau,
                                         self.probe_lengths[i], self.lengths[js])
        return ub < need
