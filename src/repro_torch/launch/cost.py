"""What one rank's program costs, counted while it runs on ``meta`` tensors
under a fake process group: the dry run's counterpart of the reference's
``hlo_analysis`` (which parses XLA's partitioned HLO; eager PyTorch has no
HLO).

:func:`fake_world` makes this process rank 0 of a world of N ranks in a
``"fake"`` process group (``torch.testing._internal.distributed.fake_pg``):
collectives return at once and move nothing, so a mesh of 256 or 512 ranks
can be built in one process and the sharded step run on this rank's shard
shapes, with no storage.  :func:`measure` runs a function so and counts:

* **flops** per rank, by ``torch.utils.flop_counter.FlopCounterMode`` (the
  matrix products: ``mm``, ``bmm``, ``addmm``, einsums lowered to them),
  by op in ``per_opcode_flops``.  The flash entry points return shapes
  only on ``meta`` tensors (``kernels.ops.counting_meta_attention``; the
  dry run only: on the card they launch the kernels) and count the plain
  version's products, every (q, k) pair of the square as the reference's
  jnp path computes them: 4 B H Sq Sk D forward, 10 B H Sq Sk D backward;
* **hbm_bytes** per rank: each op's operand and result bytes (views,
  metadata ops and allocations excluded; attention the kernel's, each
  operand and result once).  Elsewhere this is an unfused count: every
  intermediate is written and read back, unlike XLA's fusion-level count,
  where a fused chain of elementwise ops moves its inputs and outputs only;
* **collectives**, as ``distributed/sharding.py``'s mesh code records them
  (``MeshLayout``'s all-reduces and all-gathers, ``RingShift``'s hops), with
  the reference's per-rank ring formulas: all-gather (g-1)/g x result,
  all-reduce 2(g-1)/g x result, collective-permute 1 x result.
  ``MeshLayout.reduce_scatter`` is an all-reduce and a slice, and is counted
  as the all-reduce it runs.  Each group's link: NVLink when its ranks lie
  in one node of 8 (``GPUS_PER_NODE``), the network otherwise;
* **memory**: the arguments' bytes, exact from the local shapes (in all
  and each); the outputs' (those not aliasing an argument); and a peak
  estimate from
  ``torch.distributed._tools.mem_tracker.MemTracker`` (live storages, the
  arguments included; the caching allocator's rounding and fragmentation
  are not modelled).
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.train.tree import leaves


@dataclasses.dataclass
class CollectiveInfo:
    opcode: str
    group_size: int
    result_bytes: int
    traffic_bytes: float   # per rank, ring model, times count
    count: float
    link: str = "network"  # "nvlink" inside one node, else "network"


@dataclasses.dataclass
class Costs:
    """A rank's costs, shaped as the reference's ``HloCosts``."""
    flops: float
    hbm_bytes: float
    collective_traffic: float
    collectives: List[CollectiveInfo]
    per_opcode_flops: Dict[str, float]


def fake_world(n: int) -> None:
    """Make this process rank 0 of a fake process group of ``n`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def collective_traffic(opcode: str, g: int, result_bytes: int) -> float:
    """Per-rank bytes on the wire for one collective over ``g`` ranks."""
    if g <= 1:
        return 0.0
    if opcode == "all-gather":
        return (g - 1) / g * result_bytes
    if opcode == "all-reduce":
        return 2.0 * (g - 1) / g * result_bytes
    if opcode == "reduce-scatter":
        return (g - 1) * result_bytes
    if opcode == "collective-permute":
        return float(result_bytes)
    raise ValueError(opcode)


# An HGX H100 node holds 8 GPUs on NVLink; consecutive ranks share a node.
GPUS_PER_NODE = 8


def summarise_collectives(records) -> List[CollectiveInfo]:
    """``sharding.recording_collectives`` records grouped by kind, group size,
    bytes and link, largest traffic first."""
    out: Dict[tuple, CollectiveInfo] = {}
    for kind, ranks, nbytes in records:
        link = "nvlink" if len({r // GPUS_PER_NODE for r in ranks}) == 1 else "network"
        key = (kind, len(ranks), nbytes, link)
        info = out.setdefault(key, CollectiveInfo(kind, len(ranks), nbytes, 0.0, 0.0, link))
        info.count += 1
        info.traffic_bytes += collective_traffic(kind, len(ranks), nbytes)
    return sorted(out.values(), key=lambda c: -c.traffic_bytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _ByteCounter(TorchDispatchMode):
    """Sums each op's operand and result bytes; views are free."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False) and func not in _FREE:
            ins = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
            outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        return out


_FREE = {torch.ops.aten.detach.default, torch.ops.aten.alias.default,
         torch.ops.aten.lift_fresh.default, torch.ops.aten.empty.memory_format,
         torch.ops.aten.empty_like.default, torch.ops.aten.empty_strided.default}


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


@dataclasses.dataclass
class Measured:
    result: object
    costs: Costs
    memory: Dict[str, float]
    seconds: float


def measure(fn, *args, arguments=()) -> Measured:
    """Run ``fn(*args)`` once, counting its flops, bytes, collectives and
    memory (module docstring).  ``arguments``: the tensors (or trees of
    them) that are the program's arguments, the parameters or state, the
    batch and the cache, whose bytes the memory record counts and whose
    storages the peak includes."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed.sharding import recording_collectives
    from repro_torch.kernels.ops import counting_meta_attention

    groups = [[t for t in (leaves(a) if isinstance(a, dict) else [a])
               if isinstance(t, torch.Tensor)] for a in arguments]
    arg_tensors = [t for g in groups for t in g]
    arg_bytes = sum(map(_nbytes, arg_tensors))
    arg_storages = {_storage_key(t) for t in arg_tensors}
    tracker = MemTracker()
    tracker.track_external(*arg_tensors)
    flops = FlopCounterMode(display=False)
    counter = _ByteCounter()
    t0 = time.perf_counter()
    with recording_collectives() as records, counting_meta_attention() as attention, \
            tracker, flops, counter:
        result = fn(*args)
    seconds = time.perf_counter() - t0
    peak = max(snap["Total"] for snap in tracker.get_tracker_snapshot("peak").values())
    outs = [o for o in tree_flatten(result)[0] if isinstance(o, torch.Tensor)]
    seen = set(arg_storages)
    out_bytes = 0
    for o in outs:
        key = _storage_key(o)
        if key not in seen:
            seen.add(key)
            out_bytes += _nbytes(o)
    per_op: Dict[str, float] = defaultdict(float)
    for op, n in flops.get_flop_counts().get("Global", {}).items():
        per_op[str(op)] += float(n)
    for name, n, _ in attention:
        per_op[name] += n
    collectives = summarise_collectives(records)
    costs = Costs(flops=float(flops.get_total_flops()) + sum(n for _, n, _ in attention),
                  hbm_bytes=float(counter.bytes) + sum(b for _, _, b in attention),
                  collective_traffic=sum(c.traffic_bytes for c in collectives),
                  collectives=collectives, per_opcode_flops=dict(per_op))
    memory = {"argument_size_in_bytes": arg_bytes,
              "argument_bytes_each": [sum(map(_nbytes, g)) for g in groups],
              "output_size_in_bytes": out_bytes,
              "temp_size_in_bytes": max(peak - arg_bytes, 0), "peak_bytes": peak}
    return Measured(result, costs, memory, seconds)
