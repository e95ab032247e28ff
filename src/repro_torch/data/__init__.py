"""Data pipeline of the port (the twin of ``repro.data``): synthetic
collections (paper §5 methodology), shingling, the bitmap-join dedup stage
(``data.dedup``) and the checkpointable LM batch loader (``data.loader``)."""

from repro_torch.data.collections import (
    dblp_like_collection,
    skewed_collection,
    uniform_collection,
    with_duplicates,
    zipf_collection,
)
from repro_torch.data.dedup import (
    dedup_against,
    dedup_collection,
    dedup_documents,
    dedup_shards,
    shingle,
)
from repro_torch.data.loader import LoaderConfig, SyntheticLMLoader
