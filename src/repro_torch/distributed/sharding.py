"""Mesh axes, partition specs and the collectives of the port's mesh code
(the port of ``repro.distributed.sharding``), one process per device over
``torch.distributed``.

* **Join drivers**: :func:`join_axes`, :func:`all_gather_stacked` and
  :class:`RingShift` (the ring and sharded-indexed drivers).
* **Specs as plain data**: :class:`PartitionSpec` (``P``) mirrors
  ``jax.sharding.PartitionSpec``: one entry a tensor dim, each ``None``,
  an axis name or a tuple of axis names (a composite axis, sharded in the
  mesh's row-major order).  The spec functions (``Model.param_specs``,
  ``opt_state_specs``, ``state_specs``, ``batch_specs``,
  ``DecodeEngine.cache_specs``) take any mesh-like object that gives axis
  names and sizes (:func:`mesh_sizes`): a ``DeviceMesh``, a plain ``{name:
  size}`` mapping, or an object with ``.shape`` (a mapping) and
  ``.axis_names``, as the reference's ``jax.sharding.Mesh``.
  :func:`local_slices` is the local-shard arithmetic; :func:`to_placements`
  gives DTensor's placements for the same layout; :class:`NamedSharding`
  binds a spec to a ``DeviceMesh`` (checkpoints restore through it) and
  :func:`shard_tree` / :func:`unshard_tree` move a tree between whole
  tensors and this rank's slices.
* **Activation layout**: :func:`activation_sharding` binds a mesh (and the
  batch and tensor-parallel axes) for the sharded train step;
  :func:`constrain`, :func:`constrain_residual` and :func:`attn_partition`
  keep the reference's rules but, with no XLA to hint, they return the
  decision: the spec a tensor of a given global shape takes, and which
  heads this rank computes.  The sharded dense block
  (``models/model.py``) reads them to pick its local layout and its
  collectives.  Without an active context they return the replicated
  layout, as the reference's calls are no-ops.
* **Collectives under autograd** (:class:`MeshLayout`): every rank's
  backward differentiates its own share of the loss, and the shares sum to
  the loss (the TP ranks that compute the same rows each take 1 / TP of
  them).  Under that rule each collective's backward is its exact adjoint:
  an all-reduce sums in both passes, an all-gather's backward is a
  reduce-scatter, and a gradient held by several replicas of a parameter is
  summed over them once the backward is done.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import threading
from collections.abc import Mapping
from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_TLS = threading.local()


def join_axes(mesh, axis=None):
    """Resolve a mesh and an axis spec for the distributed join drivers.

    ``axis`` is one axis name, a tuple of names in the mesh's order, or
    ``None`` (all of the mesh's axes).  Returns ``(axes, group, n_dev,
    index)``: the normalised axes tuple, the process group spanning them
    (a composite axis flattened into one group), the number of ranks along
    them, and this rank's row-major index along them, the counterpart of
    the reference's ``axis_index`` over a composite axis.  The index is
    also this rank's rank in ``group``, so collectives over ``group``
    return their pieces in index order.  Every rank of the mesh must call
    it (a composite axis's group is created collectively, once per mesh).
    """
    names = tuple(mesh.mesh_dim_names)
    if axis is None:
        axes = names
    elif isinstance(axis, str):
        axes = (axis,)
    else:
        axes = tuple(axis)
    for a in axes:
        if a not in names:
            raise ValueError(f"axis {a!r} not in mesh axes {names}")
    if list(axes) != sorted(axes, key=names.index):
        raise ValueError(f"axes {axes} must follow the mesh's order {names}")
    sizes = [mesh.shape[names.index(a)] for a in axes]
    index = 0
    for a, n in zip(axes, sizes):
        index = index * n + mesh.get_local_rank(a)
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    else:
        group = mesh[axes]._flatten().get_group()
    if dist.get_group_rank(group, dist.get_rank()) != index:
        raise RuntimeError(f"the group over {axes} does not rank its members in "
                           f"row-major order")
    return axes, group, math.prod(sizes), index


# Transport.  NCCL moves the tensors where they lie, on the card; gloo takes
# CPU tensors, so under gloo (the CPU tests, or several ranks sharing one
# card) they cross through host copies.  The choice follows the group's
# backend; the drivers' kernels run on the tensors' device either way.

def _via_host(group) -> bool:
    return dist.get_backend(group) == "gloo"


# A dry run (``repro_torch.launch.cost``) records each collective the mesh
# code issues: its kind, the group's ranks, and the bytes of its result (a
# ring hop: of what it sends).  Nothing is recorded outside a recorder.

@contextmanager
def recording_collectives():
    """Record every collective issued inside into the yielded list, as
    ``(kind, ranks of the group, result bytes)``; kinds as XLA names them
    (``all-reduce``, ``all-gather``, ``collective-permute``)."""
    prev = getattr(_TLS, "collectives", None)
    _TLS.collectives = out = []
    try:
        yield out
    finally:
        _TLS.collectives = prev


def _record(kind: str, group, nbytes: int) -> None:
    out = getattr(_TLS, "collectives", None)
    if out is not None:
        out.append((kind, tuple(dist.get_process_group_ranks(group)), int(nbytes)))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_gather_stacked(t: torch.Tensor, group, n_dev: int, device=None) -> torch.Tensor:
    """``t`` from every rank of ``group``, stacked in rank (= index) order:
    ``[n_dev, *t.shape]`` on ``device`` (``t``'s by default; a caller that
    reads the result on the host passes ``"cpu"``, so gloo's host parts are
    not copied to the card and back).  Every rank passes the same shape and
    type."""
    device = t.device if device is None else torch.device(device)
    if n_dev == 1:
        return t[None].to(device)
    send = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    if _via_host(group):
        send = send.cpu()
    parts = [torch.empty_like(send) for _ in range(n_dev)]
    _record("all-gather", group, _nbytes(send) * n_dev)
    dist.all_gather(parts, send, group=group)
    return torch.stack(parts).to(device=device, dtype=t.dtype)


class RingShift:
    """One hop of a ring over ``group``: send to index ``(i + 1) % n`` and
    receive from ``(i - 1) % n`` at once, posted before a step's compute and
    waited after it.  :meth:`outbound` makes the tensor to send (a host copy
    under gloo), :meth:`inbound` the received one on ``device``."""

    def __init__(self, group, index: int, n_dev: int, device):
        if n_dev < 2:
            raise ValueError("a ring needs two ranks: torch refuses a send to self")
        self.group, self.device = group, torch.device(device)
        self.host = _via_host(group)
        # A fake group (the dry run's) moves nothing: a hop then receives what
        # it sends, as the fake all-gather returns the sender's part.
        self.fake = dist.get_backend(group) == "fake"
        self.next = dist.get_global_rank(group, (index + 1) % n_dev)
        self.prev = dist.get_global_rank(group, (index - 1) % n_dev)

    def outbound(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.host else t.contiguous()

    def start(self, send: torch.Tensor):
        """Post the hop of ``send`` (from :meth:`outbound`); returns the
        handle for :meth:`finish`."""
        recv = send.clone() if self.fake else torch.empty_like(send)
        _record("collective-permute", self.group, _nbytes(send))
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, self.next, self.group),
            dist.P2POp(dist.irecv, recv, self.prev, self.group)])
        return reqs, recv

    def finish(self, handle) -> tuple[torch.Tensor, torch.Tensor]:
        """Wait for the hop; returns ``(received, received on device)``: the
        first to send on at the next hop, the second to compute with."""
        reqs, recv = handle
        for req in reqs:
            req.wait()
        return recv, recv.to(self.device)


# ---------------------------------------------------------------------------
# Partition specs as plain data
# ---------------------------------------------------------------------------

def _entry(e):
    """A spec entry in the reference's normal form: ``None``, a name, or a
    tuple of two or more names (``()`` is ``None``, ``("data",)`` is
    ``"data"``, as ``PartitionSpec`` normalises them)."""
    if e is None or isinstance(e, str):
        return e
    e = tuple(e)
    if not e:
        return None
    return e[0] if len(e) == 1 else e


def entry_axes(e) -> Tuple[str, ...]:
    """The axis names of one spec entry, as a tuple."""
    e = _entry(e)
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else e


class PartitionSpec(tuple):
    """The port's ``jax.sharding.PartitionSpec``: a tuple with one entry a
    tensor dim (``None``, an axis name, or a tuple of axis names), the
    entries normalised as the reference normalises them, so ``tuple(spec)``
    equals ``tuple(reference_spec)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)

    def axes(self) -> Tuple[str, ...]:
        """Every axis the spec shards over, in entry order."""
        return tuple(a for e in self for a in entry_axes(e))


P = PartitionSpec


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a mesh-like object, in its axis order: a
    ``DeviceMesh`` (``mesh_dim_names`` and its ``shape`` tuple), a plain
    mapping, or an object whose ``.shape`` is a mapping (the reference's
    ``jax.sharding.Mesh``, or a stub with ``.shape`` and ``.axis_names``)."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {str(n): int(v) for n, v in zip(names, tuple(mesh.shape))}
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, Mapping):
        order = tuple(getattr(mesh, "axis_names", shape.keys()))
        return {str(n): int(shape[n]) for n in order}
    raise TypeError(f"not a mesh: {mesh!r} (want a DeviceMesh, a mapping of axis sizes, "
                    f"or an object with a .shape mapping)")


def axes_size(sizes: dict, axes) -> int:
    return math.prod(sizes[a] for a in axes)


def local_slices(shape, spec, sizes: dict, coord: dict) -> Tuple[slice, ...]:
    """This rank's slice of a tensor of global ``shape`` laid out by
    ``spec``: along each dim, block ``index`` of ``n`` equal blocks, where
    ``n`` is the product of the entry's axis sizes and ``index`` this rank's
    row-major coordinate over them (``coord``: its coordinate on each axis).
    A dim that does not divide raises; a dim beyond the spec is whole."""
    spec = tuple(spec)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {tuple(shape)}")
    out = []
    for d, n_elems in enumerate(shape):
        axes = entry_axes(spec[d]) if d < len(spec) else ()
        n, index = 1, 0
        for a in axes:
            n *= sizes[a]
            index = index * sizes[a] + coord[a]
        if n_elems % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {axes} ({n})")
        step = n_elems // n
        out.append(slice(index * step, (index + 1) * step))
    return tuple(out)


def local_shape(shape, spec, sizes: dict) -> Tuple[int, ...]:
    """The shape of each rank's slice of a tensor of global ``shape``."""
    spec = tuple(spec)
    return tuple(n // (axes_size(sizes, entry_axes(spec[d])) if d < len(spec) else 1)
                 for d, n in enumerate(shape))


def to_placements(spec, mesh) -> tuple:
    """DTensor's placements (one a mesh dim) for ``spec`` on ``mesh``:
    ``Shard(d)`` on each mesh axis that shards tensor dim ``d``, else
    ``Replicate()``.  A composite entry must follow the mesh's axis order,
    the order in which DTensor shards one tensor dim over several mesh dims
    (the reference's row-major order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, e in enumerate(tuple(spec)):
        axes = entry_axes(e)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"entry {e} must follow the mesh's order {names}")
        for a in axes:
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"axis {a!r} shards two dims in {spec}")
            out[names.index(a)] = Shard(d)
    return tuple(out)


# ---------------------------------------------------------------------------
# A mesh seen from this rank
# ---------------------------------------------------------------------------

class MeshLayout:
    """A ``DeviceMesh`` seen from this rank: each axis's size and this rank's
    coordinate, a process group over every set of its axes (made when the
    layout is, collectively, in one order on every rank: the mesh's axes,
    then each pair, and so on; a composite set through :func:`join_axes`),
    and the collectives the sharded train step runs over them.  Get it with
    :func:`layout_of`, which makes it once per mesh."""

    def __init__(self, mesh):
        if not dist.is_initialized():
            raise RuntimeError("a mesh layout needs an initialised process group")
        self.mesh = mesh
        self.sizes = mesh_sizes(mesh)
        self.names = tuple(self.sizes)
        self.coord = dict(zip(self.names, (int(c) for c in mesh.get_coordinate())))
        self._groups = {}
        for n in range(1, len(self.names) + 1):
            for axes in itertools.combinations(self.names, n):
                if axes_size(self.sizes, axes) > 1:
                    self._groups[axes] = join_axes(mesh, axes)[1]

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.names if a in axes)

    def size(self, axes) -> int:
        return axes_size(self.sizes, self._axes(axes))

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes``."""
        index = 0
        for a in self._axes(axes):
            index = index * self.sizes[a] + self.coord[a]
        return index

    def group(self, axes):
        """The group over ``axes`` holding this rank; None when they span one rank."""
        return self._groups.get(self._axes(axes))

    def first_replica(self, axes) -> bool:
        """Whether this rank has coordinate 0 on every axis of ``axes``."""
        return all(self.coord[a] == 0 for a in self._axes(axes))

    def slices(self, shape, spec) -> Tuple[slice, ...]:
        return local_slices(shape, spec, self.sizes, self.coord)

    # --- collectives without autograd (transport as _via_host says) ---
    def all_reduce(self, t: torch.Tensor, axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """The reduction of ``t`` over ``axes`` (a new tensor on t's device)."""
        group = self.group(axes)
        if group is None:
            return t.clone()
        buf = t.detach().cpu().clone() if _via_host(group) else t.detach().clone()
        _record("all-reduce", group, _nbytes(buf))
        dist.all_reduce(buf, op=op, group=group)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
        """``t`` of every rank over ``axes`` concatenated along ``dim`` in
        row-major order."""
        group = self.group(axes)
        if group is None:
            return t.clone()
        send = t.detach().contiguous()
        if _via_host(group):
            send = send.cpu()
        parts = [torch.empty_like(send) for _ in range(self.size(axes))]
        _record("all-gather", group, _nbytes(send) * len(parts))
        dist.all_gather(parts, send, group=group)
        return torch.cat(parts, dim=dim).to(t.device)

    def reduce_scatter(self, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
        """This rank's block along ``dim`` of the sum of ``t`` over ``axes``:
        an all-reduce and a slice, under gloo and NCCL alike (a reduce-scatter
        moves half the bytes; NCCL with several ranks is not exercised)."""
        n = self.size(axes)
        if n == 1:
            return t.clone()
        total = self.all_reduce(t, axes)
        step = t.shape[dim] // n
        return total.narrow(dim, self.index(axes) * step, step).contiguous()

    # --- the same under autograd (each backward the exact adjoint) ---
    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum over ``axes``; its backward sums the gradients over them."""
        if self.size(axes) == 1:
            return x
        return _PSum.apply(x, self, self._axes(axes))

    def psum_scatter(self, x: torch.Tensor, dim: int, axes) -> torch.Tensor:
        """This rank's block along ``dim`` of the sum over ``axes`` (the
        sequence-parallel block's reduce-scatter); its backward all-gathers
        the gradient."""
        if self.size(axes) == 1:
            return x
        return _PSumScatter.apply(x, self, dim, self._axes(axes))

    def gather(self, x: torch.Tensor, dim: int, axes, dtype=None) -> torch.Tensor:
        """All-gather along ``dim``, cast to ``dtype`` first when given (a
        bf16 step moves half the bytes); its backward is the reduce-scatter,
        summed in x's own type."""
        if self.size(axes) == 1:
            return x if dtype is None else x.to(dtype)
        return _Gather.apply(x, self, dim, self._axes(axes), dtype)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, axes):
        ctx.layout, ctx.axes = layout, axes
        return layout.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout.all_reduce(g, ctx.axes), None, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, dim, axes):
        ctx.layout, ctx.dim, ctx.axes = layout, dim, axes
        return layout.reduce_scatter(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout.all_gather(g.contiguous(), ctx.dim, ctx.axes), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, dim, axes, dtype):
        ctx.layout, ctx.dim, ctx.axes, ctx.dtype = layout, dim, axes, x.dtype
        return layout.all_gather(x if dtype is None else x.to(dtype), dim, axes)

    @staticmethod
    def backward(ctx, g):
        return (ctx.layout.reduce_scatter(g.to(ctx.dtype), ctx.dim, ctx.axes),
                None, None, None, None)


def layout_of(mesh) -> MeshLayout:
    """The :class:`MeshLayout` of a ``DeviceMesh``, made on first use (a
    collective: every rank of the mesh must call it) and kept on the mesh."""
    layout = mesh.__dict__.get("_repro_torch_layout")
    if layout is None:
        layout = MeshLayout(mesh)
        mesh.__dict__["_repro_torch_layout"] = layout
    return layout


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a ``DeviceMesh`` (the reference's ``NamedSharding``):
    this rank's slice of a tensor of a given global shape."""
    mesh: object
    spec: PartitionSpec

    def slices(self, shape) -> Tuple[slice, ...]:
        return layout_of(self.mesh).slices(shape, self.spec)

    def local_shape(self, shape) -> Tuple[int, ...]:
        return local_shape(shape, self.spec, mesh_sizes(self.mesh))

    def global_shape(self, local) -> Tuple[int, ...]:
        """The whole shape of a tensor whose slices have shape ``local``."""
        sizes, spec = mesh_sizes(self.mesh), tuple(self.spec)
        return tuple(n * (axes_size(sizes, entry_axes(spec[d])) if d < len(spec) else 1)
                     for d, n in enumerate(local))

    def writes(self) -> bool:
        """Whether this rank writes its slice in a sharded save: the first
        replica on every axis the spec does not shard over."""
        layout = layout_of(self.mesh)
        return layout.first_replica([a for a in layout.names if a not in self.spec.axes()])


def named(mesh, spec_tree):
    """A tree of :class:`NamedSharding` over ``mesh`` for a tree of specs."""
    from repro_torch.train.tree import tree_map

    return tree_map(lambda sp: NamedSharding(mesh, PartitionSpec(*sp)), spec_tree)


def shard_tree(tree, specs, mesh):
    """This rank's slice of every tensor of ``tree`` (whole tensors, laid out
    by the matching ``specs``), each a contiguous copy outside any graph."""
    from repro_torch.train.tree import tree_map

    layout = layout_of(mesh)
    return tree_map(lambda t, sp: t.detach()[layout.slices(t.shape, sp)].clone(), tree, specs)


def unshard_tree(tree, specs, mesh):
    """Whole tensors from every rank's slices (``tree`` holds this rank's):
    an all-gather along each sharded dim.  Every rank gets them."""
    from repro_torch.train.tree import tree_map

    layout = layout_of(mesh)

    def whole(t, sp):
        with torch.no_grad():
            for d, e in enumerate(tuple(sp)):
                if entry_axes(e):
                    t = layout.all_gather(t, d, entry_axes(e))
        return t

    return tree_map(whole, tree, specs)


# ---------------------------------------------------------------------------
# Activation layout (the reference's constraints, as decisions)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardingContext:
    """What :func:`activation_sharding` binds: the mesh's sizes, the batch
    axes and the tensor-parallel axis it has, (for a ``DeviceMesh``) its
    :class:`MeshLayout`, and whether the residual is sequence-parallel."""
    mesh: object
    sizes: dict
    batch_axes: Tuple[str, ...]
    tp: Optional[str]
    layout: Optional[MeshLayout]
    seq_parallel: bool = False

    @property
    def batch_size(self) -> int:
        return axes_size(self.sizes, self.batch_axes)

    @property
    def tp_size(self) -> int:
        return self.sizes[self.tp] if self.tp else 1


@contextmanager
def activation_sharding(mesh, batch_axes: Tuple[str, ...] = ("pod", "data"),
                        tp_axis: str = "model", seq_parallel: bool = False):
    """Bind ``mesh`` for the sharded step: the residual stream sharded over
    the batch axes the mesh has, heads and the MLP's hidden dim over
    ``tp_axis`` (when it has it).  A ``DeviceMesh`` also gets its
    :class:`MeshLayout` (a collective on first use).  ``seq_parallel``
    (Megatron-SP, the reference's dry-run option) also shards the
    residual's sequence over ``tp_axis`` between blocks, where it divides:
    each block all-gathers it before its norm and reduce-scatters its
    output in place of the all-reduce."""
    sizes = mesh_sizes(mesh)
    prev = getattr(_TLS, "ctx", None)
    layout = layout_of(mesh) if hasattr(mesh, "get_coordinate") else None
    _TLS.ctx = ShardingContext(mesh, sizes, tuple(a for a in batch_axes if a in sizes),
                               tp_axis if tp_axis in sizes else None, layout,
                               bool(seq_parallel))
    try:
        yield _TLS.ctx
    finally:
        _TLS.ctx = prev


def current_context() -> Optional[ShardingContext]:
    return getattr(_TLS, "ctx", None)


def constrain(shape, dims: Sequence[Optional[str]]) -> PartitionSpec:
    """The spec of a tensor of global ``shape`` with per-dim roles ``dims``:
    ``"batch"`` (sharded over the batch axes), ``"tp"`` (over the TP axis)
    or None (replicated), a dim that does not divide replicated, as the
    reference's ``with_sharding_constraint`` pins it.  Replicated without
    an active context."""
    ctx = current_context()
    if ctx is None:
        return PartitionSpec(*([None] * len(shape)))
    spec = []
    for size, role in zip(shape, dims):
        if role == "batch" and ctx.batch_axes and size % ctx.batch_size == 0:
            spec.append(ctx.batch_axes)
        elif role == "tp" and ctx.tp and size % ctx.tp_size == 0:
            spec.append(ctx.tp)
        else:
            spec.append(None)
    return PartitionSpec(*spec)


def constrain_residual(shape) -> PartitionSpec:
    """The residual stream's spec between blocks: (batch, None, ...), or
    (batch, tp, None, ...) under ``seq_parallel``."""
    ctx = current_context()
    seq = "tp" if ctx is not None and ctx.seq_parallel and len(shape) > 2 else None
    return constrain(shape, ("batch", seq) + (None,) * (len(shape) - 2))


@dataclasses.dataclass(frozen=True)
class AttnPartition:
    """The attention layout :func:`attn_partition` picks for this rank.

    ``case``: ``"heads"`` (q, k and v head-parallel: this rank computes
    ``q_heads`` and ``kv_heads``, the kernel's own GQA mapping between
    them), ``"q_heads"`` (q head-parallel, k and v replicated: this rank
    computes the KV heads ``kv_heads`` its query heads read, and
    ``kv_index`` maps them, None when the kernel's GQA mapping does) or
    ``"q_sequence"`` (every head, this rank's slice of the q rows against
    the whole K and V: :meth:`q_rows`).  Heads are ``(first, count)``;
    ``rank`` and ``tp`` are this rank's TP coordinate and the TP size."""
    case: str
    q_heads: Tuple[int, int]
    kv_heads: Tuple[int, int]
    kv_index: Optional[Tuple[int, ...]] = None
    rank: int = 0
    tp: int = 1

    @property
    def tp_parallel(self) -> bool:
        """Whether the heads are split over TP (the output after wo partial)."""
        return self.case in ("heads", "q_heads")

    def q_rows(self, seq: int) -> Optional[Tuple[int, int]]:
        """In the ``q_sequence`` case, this rank's q rows ``(first, count)``
        of a sequence of ``seq``: ``[r seq / tp, (r + 1) seq / tp)``, the
        first its causal offset; None in the other cases, or where ``seq``
        does not divide TP (a decode step), where attention runs
        replicated over the TP group as the reference's ``constrain``
        replicates a dim that does not divide."""
        if self.case != "q_sequence" or seq % self.tp:
            return None
        n = seq // self.tp
        return self.rank * n, n


def attn_partition(num_heads: int, num_kv_heads: int) -> Optional[AttnPartition]:
    """The reference's three cases over the active context's TP axis: KV
    heads divide it (head-parallel q, k, v), only the q heads do (q
    head-parallel, k and v replicated), neither (the q sequence split over
    TP, k and v replicated: :meth:`AttnPartition.q_rows`).  None without a
    context or a TP axis."""
    ctx = current_context()
    if ctx is None or ctx.tp is None:
        return None
    tp, rank = ctx.tp_size, (ctx.layout.coord[ctx.tp] if ctx.layout else 0)
    if num_kv_heads % tp == 0:
        hq, hk = num_heads // tp, num_kv_heads // tp
        return AttnPartition("heads", (rank * hq, hq), (rank * hk, hk), rank=rank, tp=tp)
    if num_heads % tp == 0:
        hq, group = num_heads // tp, num_heads // num_kv_heads
        first = rank * hq
        kv = [h // group for h in range(first, first + hq)]
        lo, n_kv = kv[0], kv[-1] - kv[0] + 1
        rel = tuple(k - lo for k in kv)
        even = hq % n_kv == 0 and rel == tuple(i // (hq // n_kv) for i in range(hq))
        return AttnPartition("q_heads", (first, hq), (lo, n_kv), None if even else rel,
                             rank=rank, tp=tp)
    return AttnPartition("q_sequence", (0, num_heads), (0, num_kv_heads), rank=rank, tp=tp)
