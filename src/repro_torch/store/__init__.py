"""Appendable corpus store: a sealed base plus delta segments and LSM
compaction over the prepared-collection engine (the port of
``repro.store``)."""

from repro_torch.store.store import (
    FUNNEL_SUM_FIELDS,
    PROBE_SUM_FIELDS,
    CompactionPolicy,
    CorpusStore,
    Segment,
    StoreStats,
    empty_collection,
    merge_pairs,
    sum_stats,
)

__all__ = [
    "FUNNEL_SUM_FIELDS",
    "PROBE_SUM_FIELDS",
    "CompactionPolicy",
    "CorpusStore",
    "Segment",
    "StoreStats",
    "empty_collection",
    "merge_pairs",
    "sum_stats",
]
