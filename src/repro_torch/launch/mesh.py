"""Device meshes over ``torch.distributed`` (the port of
``repro.launch.mesh``).

The reference builds a mesh of JAX devices under one controller.  The port
runs one process per device (``torchrun --nproc-per-node N``, or ranks
started by hand with ``RANK`` / ``WORLD_SIZE`` and an init method), and a
mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
default process group, which must be initialised first.  Every rank builds
the same mesh.

:func:`make_production_mesh` is the dry run's mesh: (16, 16) over
("data", "model"), or (2, 16, 16) over ("pod", "data", "model"), over a
world of 256 or 512 ranks (the dry run's is a fake process group, see
``repro_torch.launch.cost``).  Like the reference's, these are functions
and no module-level state.  ``named`` is
``repro_torch.distributed.sharding.named``, re-exported here where the
reference keeps it.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import named  # noqa: F401  (the reference's home)


def make_mesh(shape, axes, device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    initialised default group, whose world size must be the mesh's size.

    ``device_type`` defaults to ``"cuda"``; the CPU tests pass ``"cpu"``.
    Under NCCL each rank needs a card of its own: a mesh with more ranks
    than ``torch.cuda.device_count()`` raises (share one card between ranks
    through a gloo group instead).
    """
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    device_type = device_type or "cuda"
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group "
                           "(torch.distributed.init_process_group)")
    n = math.prod(shape)
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {shape} needs {n} ranks; the world has "
                         f"{dist.get_world_size()}")
    if (device_type == "cuda" and dist.get_backend() == "nccl"
            and n > torch.cuda.device_count()):
        raise RuntimeError(
            f"NCCL needs one GPU per rank: a mesh of {n} ranks on "
            f"{torch.cuda.device_count()} GPU(s); run several ranks on one card "
            f"through a gloo group")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(multi_pod: bool = False, device_type: str | None = None):
    """The production mesh: (16, 16) over ("data", "model"), 256 ranks, or
    with ``multi_pod`` (2, 16, 16) over ("pod", "data", "model"), 512 ranks;
    ``pod`` composes with ``data`` into the batch / FSDP axes, ``model`` is
    tensor parallel.  The default group must hold that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def batch_axes(mesh) -> tuple:
    """The mesh's batch axes: ``pod`` and ``data``, those it has."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
