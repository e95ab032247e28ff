"""Join planning: resolve (sim, tau, sizes, device) into a :class:`JoinPlan`.

The port of ``repro.core.plan``: the same drivers, fields, validation,
heuristics and ``reasons`` strings, so a plan made here and one made by the
JAX package for the same workload are equal field for field.

Backends keep the reference's names: a CUDA device plans as ``"gpu"``
(device-resident compaction), the CPU as ``"cpu"``.  ``backend=None`` means
the card, and raises when there is none; ``n_devices=None`` is the world
size when a default process group is initialised (one process per device,
the counterpart of ``jax.device_count()``), else
``torch.cuda.device_count()``.

Driver vocabulary (see the reference for the full story):

* ``"naive"`` — the O(|R|·|S|) oracle; cheapest below a few thousand cells.
* ``"blocked"`` — the blocked device join (Algorithm 8).
* ``"ring"`` — the multi-device ring sweep
  (:func:`repro_torch.core.join.ring_join_prepared`).
* ``"indexed"`` — CSR prefix-index candidate generation
  (:mod:`repro_torch.index`).
* ``"sharded-indexed"`` — the indexed path over a device mesh
  (:mod:`repro_torch.distributed.sharded_index`).
* ``"allpairs" | "ppjoin" | "groupjoin" | "adaptjoin"`` — the CPU
  algorithms (:mod:`repro_torch.core.cpu_algos`).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import expected
from repro_torch.core.constants import BITMAP_COMBINED, OVERLAP

DEVICE_DRIVERS = ("naive", "blocked", "ring", "indexed", "sharded-indexed")
CPU_DRIVERS = ("allpairs", "ppjoin", "groupjoin", "adaptjoin")
DRIVERS = DEVICE_DRIVERS + CPU_DRIVERS

#: What each driver guarantees under the segment-union join of an
#: appendable corpus store: ``"exact"`` pairs and summed funnel counters for
#: the device drivers, ``"pairs"`` only for the CPU algorithms (their
#: counters depend on collection composition).
STORE_SUPPORT = {
    **{d: "exact" for d in DEVICE_DRIVERS},
    **{d: "pairs" for d in CPU_DRIVERS},
}


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def backend_of(device) -> str:
    """The planner's backend name for a torch device: ``"gpu"`` for CUDA,
    ``"cpu"`` for the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "gpu"
    if kind == "cpu":
        return "cpu"
    raise ValueError(f"no planner backend for device type {kind!r}")


def default_device_count() -> int:
    """The planner's device count: the world size of an initialised default
    process group (one process per device), else the cards this process
    sees."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return torch.cuda.device_count()


def _resolve_backend(backend: Optional[str]) -> str:
    if backend is not None:
        return backend
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass backend='cpu' to plan for the CPU")
    return "gpu"


@dataclasses.dataclass(frozen=True)
class JoinPlan:
    """A fully-resolved join configuration: immutable, JSON-able, made by
    :class:`JoinPlanner` (or by hand) and executed by
    :class:`~repro_torch.core.engine.JoinEngine`.  ``reasons`` records why
    each load-bearing choice was made."""

    driver: str
    sim: str
    tau: float
    b: int = 128
    method: str = BITMAP_COMBINED   # resolved: never 'combined' after planning
    mix: bool = False
    block: int = 4096               # block size / indexed probe-chunk size
    compaction: str = "host"        # 'host' | 'device' (blocked driver only)
    capacity: Optional[int] = None  # None -> prepass-sized per block pair
    impl: str = "auto"
    use_cutoff: bool = True
    cutoff: int = 1 << 30           # resolved Eq. 4-6 cutoff (informational)
    ell: int = 1                    # indexed driver: ℓ-prefix index schema
    reasons: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.driver not in DRIVERS:
            raise ValueError(f"unknown driver {self.driver!r}; one of {DRIVERS}")
        if self.compaction not in ("host", "device"):
            raise ValueError(f"compaction must be 'host' or 'device', "
                             f"got {self.compaction!r}")
        if self.b <= 0 or self.b % 32:
            raise ValueError(f"bitmap width b={self.b} must be a positive "
                             f"multiple of 32")
        if self.block <= 0:
            raise ValueError(f"block size must be positive, got {self.block}")
        if self.ell < 1:
            raise ValueError(f"ell must be >= 1, got {self.ell}")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["reasons"] = list(self.reasons)
        return d

    def describe(self) -> str:
        """Human-readable one-plan report (for logs / notebooks)."""
        head = (f"JoinPlan[{self.driver}] sim={self.sim} tau={self.tau} "
                f"b={self.b} method={self.method} mix={self.mix} "
                f"block={self.block} compaction={self.compaction} "
                f"capacity={self.capacity} cutoff={self.cutoff} "
                f"ell={self.ell}")
        return "\n".join([head] + [f"  - {r}" for r in self.reasons])

    def to_json(self) -> str:
        return json.dumps(self.to_dict())


class JoinPlanner:
    """Resolve workload shape + device availability into a :class:`JoinPlan`
    with the reference's deterministic heuristics: ``naive`` for tiny cross
    products; ``sharded-indexed`` or ``ring`` on several devices;
    ``indexed`` on one device when the grid exceeds ``indexed_cells`` at
    ``tau >= indexed_min_tau`` (normalised similarities); ``blocked``
    otherwise; a CPU algorithm under ``prefer="cpu"``.  Accelerators get
    device-resident compaction; the method comes from Algorithm 6 and the
    cutoff from Eq. 4-6."""

    def __init__(self, *, b: int = 128, block: int = 4096,
                 naive_cells: int = 4096, mix: bool = False,
                 use_cutoff: bool = True, impl: str = "auto",
                 adaptjoin_below_tau: float = 0.6,
                 indexed_cells: int = 1 << 25,
                 indexed_min_tau: float = 0.6):
        self.b = b
        self.block = block
        self.naive_cells = naive_cells
        self.mix = mix
        self.use_cutoff = use_cutoff
        self.impl = impl
        self.adaptjoin_below_tau = adaptjoin_below_tau
        self.indexed_cells = indexed_cells
        self.indexed_min_tau = indexed_min_tau

    def plan(self, sim: str, tau: float, n_r: int,
             n_s: Optional[int] = None, *,
             prefer: str = "auto",
             backend: Optional[str] = None,
             n_devices: Optional[int] = None,
             b: Optional[int] = None,
             block: Optional[int] = None) -> JoinPlan:
        """Resolve a plan for an ``n_r`` × ``n_s`` join (self-join if ``n_s``
        is omitted).  ``prefer`` is ``"auto"`` | ``"device"`` | ``"cpu"``."""
        if prefer not in ("auto", "device", "cpu"):
            raise ValueError(f"prefer must be auto|device|cpu, got {prefer!r}")
        if n_r <= 0:
            raise ValueError(f"n_r must be positive, got {n_r}")
        backend = _resolve_backend(backend)
        if n_devices is None:
            n_devices = default_device_count()
        b = b or self.b
        reasons = []

        cells = n_r * (n_s if n_s is not None else n_r)
        if prefer != "cpu" and cells <= self.naive_cells:
            driver = "naive"
            reasons.append(
                f"naive: {cells} cells <= naive_cells={self.naive_cells}; "
                f"the O(N^2) oracle beats building join artifacts")
        elif prefer == "cpu":
            if sim != "overlap" and tau < self.adaptjoin_below_tau:
                driver = "adaptjoin"
                reasons.append(
                    f"adaptjoin: prefer=cpu and tau={tau} < "
                    f"{self.adaptjoin_below_tau} (ℓ-prefix schema pays at low τ)")
            else:
                driver = "ppjoin"
                reasons.append("ppjoin: prefer=cpu (positional filter is the "
                               "best general-purpose CPU prefix algorithm)")
        elif n_devices > 1:
            if (sim != OVERLAP and tau >= self.indexed_min_tau
                    and cells > self.indexed_cells):
                driver = "sharded-indexed"
                reasons.append(
                    f"sharded-indexed: {n_devices} devices and {cells} cells "
                    f"> indexed_cells={self.indexed_cells} at tau={tau} >= "
                    f"{self.indexed_min_tau} (selective prefixes); the CSR "
                    f"postings shard into per-device token slabs, so "
                    f"candidate generation scales with devices instead of "
                    f"re-walking the grid")
            else:
                driver = "ring"
                reasons.append(
                    f"ring: {n_devices} devices available; R shards stay "
                    f"resident, S circulates via collective_permute "
                    f"(grid too small or tau too low for sharded postings)")
        elif (sim != OVERLAP and tau >= self.indexed_min_tau
              and cells > self.indexed_cells):
            driver = "indexed"
            reasons.append(
                f"indexed: {cells} cells > indexed_cells="
                f"{self.indexed_cells} and tau={tau} >= "
                f"{self.indexed_min_tau} (selective prefixes); CSR "
                f"prefix-index candidate generation scales with candidates, "
                f"not |R|x|S|")
        else:
            driver = "blocked"
            reasons.append("blocked: single device; blocked length-sorted "
                           "walk with fused bitmap-filter tiles")

        on_accelerator = backend in ("tpu", "gpu")
        compaction = "device" if on_accelerator else "host"
        reasons.append(
            f"compaction={compaction}: backend={backend} "
            + ("(keep candidate lists resident, ship only compacted pairs)"
               if on_accelerator else
               "(dense np.nonzero on host is the fast path on CPU)"))

        if block is None:
            largest = max(n_r, n_s or n_r)
            block = min(self.block, max(128, _pow2_at_least(largest)))
        reasons.append(f"block={block}: min(default {self.block}, pow2 cover "
                       f"of max collection size)")

        if tau <= 0 and sim != "overlap":
            raise ValueError(f"tau must be positive for sim={sim!r}, got {tau}")
        method = bm.choose_method(float(tau), b)
        reasons.append(f"method={method}: Algorithm 6 crossovers at b={b}, "
                       f"tau={tau}")
        cutoff = (expected.cutoff_point(method, b, float(tau))
                  if self.use_cutoff else 1 << 30)
        reasons.append(f"cutoff={cutoff}: Eq. 4-6 expected bound "
                       + ("" if self.use_cutoff else "(disabled)"))

        return JoinPlan(
            driver=driver, sim=sim, tau=float(tau), b=b, method=method,
            mix=self.mix, block=block, compaction=compaction, capacity=None,
            impl=self.impl, use_cutoff=self.use_cutoff, cutoff=int(cutoff),
            reasons=tuple(reasons))

    def serving_plan(self, sim: str, tau: float, n_r: int, *,
                     b: Optional[int] = None,
                     block: Optional[int] = None,
                     backend: Optional[str] = None) -> JoinPlan:
        """Resolve a plan for a resident serving session: many small probe
        batches against one long-lived corpus, so the postings index pays
        even below the one-shot ``indexed_cells`` floor (``overlap`` has no
        normalised prefix schema and gets ``blocked``)."""
        if n_r <= 0:
            raise ValueError(f"n_r must be positive, got {n_r}")
        if tau <= 0 and sim != OVERLAP:
            raise ValueError(f"tau must be positive for sim={sim!r}, got {tau}")
        backend = _resolve_backend(backend)
        b = b or self.b
        block = block or self.block
        reasons = []
        if sim != OVERLAP and tau >= self.indexed_min_tau:
            driver = "indexed"
            reasons.append(
                f"indexed: resident session amortizes the postings CSR over "
                f"every probe; per-probe work scales with candidates, "
                f"not |R|x|batch| (tau={tau} >= {self.indexed_min_tau})")
        elif sim != OVERLAP:
            driver = "indexed"
            reasons.append(
                f"indexed: tau={tau} < indexed_min_tau="
                f"{self.indexed_min_tau} makes prefixes long, but a "
                f"resident session still amortizes the index build and "
                f"keeps the coalesced entrypoint path; expect a weaker "
                f"candidate-generation win")
        else:
            driver = "blocked"
            reasons.append("blocked: overlap similarity has no normalised "
                           "prefix schema for the postings index; the "
                           "session serves it without batch coalescing")
        compaction = "device" if backend in ("tpu", "gpu") else "host"
        reasons.append(f"compaction={compaction}: backend={backend}")
        method = bm.choose_method(float(tau), b)
        cutoff = (expected.cutoff_point(method, b, float(tau))
                  if self.use_cutoff else 1 << 30)
        reasons.append(f"method={method} cutoff={cutoff}: Algorithm 6 / "
                       f"Eq. 4-6 at b={b}, tau={tau}")
        return JoinPlan(
            driver=driver, sim=sim, tau=float(tau), b=b, method=method,
            mix=self.mix, block=block, compaction=compaction, capacity=None,
            impl=self.impl, use_cutoff=self.use_cutoff, cutoff=int(cutoff),
            reasons=tuple(reasons))
