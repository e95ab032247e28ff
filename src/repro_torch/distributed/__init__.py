"""Distributed runtime of the port: checkpointing (sharded and elastic),
the fault-tolerant runner (with ``remesh``), the partition specs, activation
layout and autograd collectives of ``sharding.py`` that the sharded train
step (``repro_torch.train.step.sharded_train_step``) runs on, and the join
drivers over a device mesh (one process per device on
``torch.distributed``; meshes from :mod:`repro_torch.launch.mesh`): the
``sharded-indexed`` driver here, the ring in :mod:`repro_torch.core.join`."""

from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.fault import FaultTolerantRunner, RunnerConfig
from repro_torch.distributed.sharded_index import (sharded_indexed_bitmap_join,
                                                   sharded_indexed_join_prepared)
