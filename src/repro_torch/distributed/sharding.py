"""Mesh axes for the distributed join drivers (the join half of the port of
``repro.distributed.sharding``).

``activation_sharding``, ``constrain`` and ``attn_partition``, the training
half, wait for sharded training (ROADMAP Queue 1 item 11b).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


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
        self.next = dist.get_global_rank(group, (index + 1) % n_dev)
        self.prev = dist.get_global_rank(group, (index - 1) % n_dev)

    def outbound(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.host else t.contiguous()

    def start(self, send: torch.Tensor):
        """Post the hop of ``send`` (from :meth:`outbound`); returns the
        handle for :meth:`finish`."""
        recv = torch.empty_like(send)
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
