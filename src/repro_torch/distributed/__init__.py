"""Distributed runtime of the port, single-process parts: checkpointing and
the fault-tolerant runner.  Sharded checkpoints, meshes and the
sharded-indexed join wait for multi-GPU (ROADMAP Queue 1 item 11)."""

from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.fault import FaultTolerantRunner, RunnerConfig
