"""The flash-attention forward kernel (CUDA C++, ``csrc/flash_attention.cu``).

:func:`flash_attention_cuda` replaces
``repro.kernels.flash_attention.flash_attention_fwd_pallas``: GQA attention
forward with an online softmax over K/V tiles and, when causal, the
lower-triangle schedule.  Its plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`; callers go through
:func:`repro_torch.kernels.ops.flash_attention`.

The kernel has three instances, chosen statically by type (:func:`instance`,
the same rule as ``flash_attention_launch``): ``wgmma`` for bf16 at every
head dim, ``simt_f32`` for float32.  The ``mma_sync`` instance (bf16, head
dims 16 and 32; the rule until the wgmma instance took those head dims)
stays callable for measurement and tests through ``instance="mma_sync"``.
``flash_attention_cuda.launches`` counts every launch;
``flash_attention_cuda.instance_launches`` counts them by the instance that
ran.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_C = ctypes.c_void_p
_I = ctypes.c_int
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
INSTANCES = ("wgmma", "mma_sync", "simt_f32")   # codes 0, 1, 2 of the C entry point


def instances(dtype: torch.dtype, head_dim: int) -> tuple[str, ...]:
    """Every instance with a kernel for this type and head dim, the static
    rule's first."""
    if dtype == torch.float32:
        return ("simt_f32",)
    return ("wgmma", "mma_sync") if head_dim in (16, 32) else ("wgmma",)


def instance(dtype: torch.dtype, head_dim: int, requested: str | None = None) -> str:
    """The kernel instance that runs for this type and head dim: the static
    rule of ``flash_attention_launch`` when ``requested`` is None, else
    ``requested``, which must have a kernel for them (``ValueError``)."""
    if requested is None:
        return instances(dtype, head_dim)[0]
    if requested not in INSTANCES:
        raise ValueError(f"unknown instance {requested!r}; one of {INSTANCES}")
    if requested not in instances(dtype, head_dim):
        raise ValueError(f"the {requested} instance has no kernel for {dtype} at head dim "
                         f"{head_dim}")
    return requested


_instance = instance   # flash_attention_cuda's keyword hides the name


def _fn():
    fn = _build.library("flash_attention").flash_attention_launch_instance
    fn.argtypes = [_C, _C, _C, _C, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _C]
    fn.restype = _I
    return fn


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q (B, Sq, H, D) and k, v (B, Sk, KV, D) are contiguous,
    16-byte aligned CUDA tensors of one supported type on one device, with
    H % KV == 0, Sk >= 1 and D in ``HEAD_DIMS``."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, Sq, H, D) and k, v (B, Sk, KV, D), got "
                         f"{list(q.shape)}, {list(k.shape)}, {list(v.shape)}")
    b, _, h, d = q.shape
    _, sk, kv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or h % kv or sk < 1:
        raise ValueError(f"q {list(q.shape)} and k/v {list(k.shape)} disagree (batch, "
                         f"head dim, H % KV == 0, Sk >= 1)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} has no kernel instance; supported {HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype {q.dtype} has no kernel instance; supported "
                         f"{list(DTYPES)}")
    if b > 65535 or h > 65535:
        raise ValueError(f"B={b}, H={h} exceed the kernel's grid")
    for t in (q, k, v):
        if (t.device != dev or t.dtype != q.dtype or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("q, k and v must be contiguous, 16-byte aligned tensors of "
                             "one dtype on one CUDA device")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, instance: str | None = None) -> torch.Tensor:
    """(B, Sq, H, D) attention output in q's type: query head h attends KV
    head h // (H / KV) with scale D^-0.5, causal with positions from 0.

    ``instance`` (one of ``INSTANCES``) picks a kernel for measurement and
    tests; None is the static rule (:func:`instance`), the only choice the
    port's callers make."""
    name = _instance(q.dtype, q.shape[-1] if q.dim() else 0, instance)
    check_operands(q, k, v)
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    if b == 0 or sq == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
                   k.shape[1], h, k.shape[2], d, DTYPES[q.dtype], int(causal), d ** -0.5,
                   INSTANCES.index(name), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({name} instance): CUDA "
                           f"error {rc}")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.instance_launches[name] += 1
    return out


def reset_launches() -> None:
    """Zero every launch counter of the wrapper."""
    flash_attention_cuda.launches = 0
    flash_attention_cuda.instance_launches = dict.fromkeys(INSTANCES, 0)


reset_launches()
