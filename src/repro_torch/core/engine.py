"""Build-once join artifacts: :class:`PreparedCollection`.

The port of the ``PreparedCollection`` part of ``repro.core.engine``: a
length-sorted view of a :class:`~repro_torch.core.collection.Collection`
with the inverse permutation, the sorted token/length tensors on one device,
packed bitmap words cached per ``(b, method, mix)`` and integer length
windows cached per ``(sim, tau)``.  ``builds`` counts each build so reuse
is assertable.

Entry points run on the card: ``prepare(col)`` without a ``device`` resolves
to ``cuda`` and raises when no card is present; tests pass ``device="cpu"``.

:func:`prepared_from_numpy` carries state across from the JAX package: it
takes a collection's numpy ``tokens``/``lengths`` and packed ``uint32`` words
built there, and returns a prepared collection whose word cache already
holds them.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import bounds
from repro_torch.core.collection import Collection
from repro_torch.core.constants import BITMAP_COMBINED


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card, and raises
    when there is none (the caller must ask for the CPU explicitly)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


class PreparedCollection:
    """Build-once join artifacts for one collection on one device.

    Construction performs the only eager step — the stable length sort.
    Everything else (device tensors, packed words per ``(b, method, mix)``,
    integer length windows per ``(sim, tau)``) is built on first use and
    cached; ``builds`` counts each build.
    """

    def __init__(self, source: Collection, device=None):
        self.device = resolve_device(device)
        order = np.argsort(source.lengths, kind="stable")
        inverse = np.empty_like(order)
        inverse[order] = np.arange(len(order))
        self.source = source
        self.order = order          # sorted index -> original index
        self.inverse = inverse      # original index -> sorted index
        self.tokens = source.tokens[order]    # length-sorted view (numpy)
        self.lengths = source.lengths[order]
        # Cached artifacts derive from these arrays: an in-place edit after
        # prepare() would silently serve stale sorts and bitmaps.
        for arr in (source.tokens, source.lengths, self.tokens, self.lengths):
            arr.flags.writeable = False
        self.builds: Dict[str, int] = {"sort": 1, "bitmap": 0, "window": 0}
        self._device_arrays: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._words: Dict[Tuple[int, str, bool], torch.Tensor] = {}
        self._windows: Dict[Tuple[str, float], Tuple] = {}

    # -- Collection duck-typing (over the length-sorted view) ---------------

    @property
    def num_sets(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def max_len(self) -> int:
        return int(self.tokens.shape[1])

    def __len__(self) -> int:
        return self.num_sets

    def row(self, i: int) -> np.ndarray:
        return self.tokens[i, : self.lengths[i]]

    # -- cached artifacts ----------------------------------------------------

    def device_arrays(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(tokens int32[N, L], lengths int32[N]) on :attr:`device`, cached."""
        if self._device_arrays is None:
            self._device_arrays = (torch.from_numpy(self.tokens.copy()).to(self.device),
                                   torch.from_numpy(self.lengths.copy()).to(self.device))
        return self._device_arrays

    def bitmap_words(self, b: int, method: str, *, mix: bool = False,
                     tau: Optional[float] = None) -> torch.Tensor:
        """Packed int32[N, b//32] words over the sorted view, cached per
        ``(b, resolved method, mix)``; ``method='combined'`` needs ``tau``."""
        if method == BITMAP_COMBINED:
            if tau is None:
                raise ValueError("combined method needs tau to resolve")
            method = bm.choose_method(float(tau), b)
        key = (int(b), method, bool(mix))
        if key not in self._words:
            tokens, lengths = self.device_arrays()
            self._words[key] = bm.generate_bitmaps(tokens, lengths, b,
                                                   method=method, mix=mix)
            self.builds["bitmap"] += 1
        return self._words[key]

    def length_window_int(self, sim: str, tau: float):
        """Integer-exact Table 2 windows for every sorted row, cached per
        ``(sim, tau)``.  Returns ``(lo_np, hi_np, lo_dev, hi_dev)``."""
        key = (sim, float(tau))
        if key not in self._windows:
            lo, hi = bounds.length_window_int(sim, tau, self.lengths)
            self._windows[key] = (lo, hi, torch.from_numpy(lo).to(self.device),
                                  torch.from_numpy(hi).to(self.device))
            self.builds["window"] += 1
        return self._windows[key]

    def build_counts(self) -> Dict[str, int]:
        """A copy of the build counters (sort/bitmap/window)."""
        return dict(self.builds)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"PreparedCollection(n={self.num_sets}, max_len={self.max_len}, "
                f"device={self.device}, builds={self.builds})")


def prepare(col: Collection | PreparedCollection, device=None) -> PreparedCollection:
    """Build the reusable join artifact for ``col`` on ``device`` (the card
    when ``None``).  A prepared collection is returned as is; asking for
    another device than the one it lives on raises."""
    if isinstance(col, PreparedCollection):
        if device is not None and torch.device(device) != col.device:
            raise ValueError(f"collection is prepared on {col.device}, "
                             f"not on {torch.device(device)}")
        return col
    return PreparedCollection(col, device)


def as_prepared(col: Collection | PreparedCollection, device=None) -> PreparedCollection:
    """Alias of :func:`prepare`; reads better at driver entry points."""
    return prepare(col, device)


def prepared_from_numpy(
    tokens: np.ndarray,
    lengths: np.ndarray,
    *,
    words: Optional[Mapping[Tuple[int, str, bool], np.ndarray]] = None,
    device,
) -> PreparedCollection:
    """A :class:`PreparedCollection` over numpy arrays built elsewhere.

    ``tokens``/``lengths`` are a collection's padded int32 arrays in
    original row order.  ``words`` maps ``(b, method, mix)`` to packed
    ``uint32[N, b//32]`` words over the *length-sorted* view (the stable
    sort here is the one ``repro.core.engine.PreparedCollection`` applies);
    they enter the word cache as is, so ``builds["bitmap"]`` stays 0 until
    another key is asked for.
    """
    prep = PreparedCollection(
        Collection(tokens=np.ascontiguousarray(tokens, dtype=np.int32),
                   lengths=np.ascontiguousarray(lengths, dtype=np.int32)),
        device)
    for (b, method, mix), w in (words or {}).items():
        w = np.asarray(w)
        if w.dtype != np.uint32 or w.shape != (prep.num_sets, int(b) // 32):
            raise ValueError(
                f"words for {(b, method, mix)} must be uint32"
                f"[{prep.num_sets}, {int(b) // 32}], got {w.dtype}{list(w.shape)}")
        bits = torch.from_numpy(np.ascontiguousarray(w).view(np.int32).copy())
        prep._words[(int(b), method, bool(mix))] = bits.to(prep.device)
    return prep
