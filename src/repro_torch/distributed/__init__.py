"""Distributed runtime of the port: checkpointing, the fault-tolerant
runner, and the join drivers over a device mesh (one process per device on
``torch.distributed``; meshes from :mod:`repro_torch.launch.mesh`): the
``sharded-indexed`` driver here, the ring in :mod:`repro_torch.core.join`.
The training half (sharded parameters and optimizer state, the activation
constraints of ``sharding.py``, ``compressed_pmean``, sharded checkpoints)
waits for ROADMAP Queue 1 item 11b."""

from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.fault import FaultTolerantRunner, RunnerConfig
from repro_torch.distributed.sharded_index import (sharded_indexed_bitmap_join,
                                                   sharded_indexed_join_prepared)
