"""The join core of the PyTorch port (the twin of ``repro.core``).

* :mod:`repro_torch.core.bitmap` — Bitmap-Set / Xor / Next generation.
* :mod:`repro_torch.core.bounds` — Table 1/2 conversions, threshold tables.
* :mod:`repro_torch.core.expected` — Eq. 4-6 expected bounds, cutoff ω(b, τ).
* :mod:`repro_torch.core.join` — naive oracle and the blocked device join.
* :mod:`repro_torch.core.filters` — length, positional and Bitmap Filter.
* :mod:`repro_torch.core.cpu_algos` — AllPairs/PPJoin/GroupJoin/AdaptJoin.
* :mod:`repro_torch.core.engine` — build-once :class:`PreparedCollection`
  artifacts and the batched-probe :class:`JoinEngine`.
* :mod:`repro_torch.core.plan` — :class:`JoinPlanner` resolving workloads
  into explicit :class:`JoinPlan` configurations.
"""

from repro_torch.core.collection import (
    Collection,
    from_lists,
    pad_collection,
    preprocess,
    preprocess_rs,
)
from repro_torch.core.engine import (
    JoinEngine,
    PreparedCollection,
    as_prepared,
    prepare,
    prepared_bitmap_filter,
    prepared_from_numpy,
)
from repro_torch.core.plan import JoinPlan, JoinPlanner
from repro_torch.core.constants import (
    BITMAP_COMBINED,
    BITMAP_METHODS,
    BITMAP_NEXT,
    BITMAP_SET,
    BITMAP_XOR,
    COSINE,
    DICE,
    JACCARD,
    OVERLAP,
    PAD_TOKEN,
    SIM_FUNCTIONS,
)
