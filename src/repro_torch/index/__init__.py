"""The inverted prefix-index subsystem of the port (the twin of
``repro.index``): CSR ℓ-prefix postings and the ``"indexed"`` join driver,
whose work scales with the candidate count instead of |R|·|S|.

* :mod:`repro_torch.index.postings` — :class:`PostingsIndex` +
  :func:`build_postings`, cached on
  :class:`~repro_torch.core.engine.PreparedCollection` per
  ``(sim, tau, ell)``.
* :mod:`repro_torch.index.candidates` — :func:`indexed_join_prepared` /
  :func:`indexed_bitmap_join`, executed by
  :class:`~repro_torch.core.engine.JoinEngine` for ``"indexed"`` plans.
"""

from repro_torch.index.candidates import indexed_bitmap_join, indexed_join_prepared
from repro_torch.index.postings import PostingsIndex, build_postings
