"""The flash-attention kernels (CUDA C++): the forward
(``csrc/flash_attention.cu``) and the backward (``csrc/flash_attention_bwd.cu``).

:func:`flash_attention_cuda` replaces
``repro.kernels.flash_attention.flash_attention_fwd_pallas``: GQA attention
forward with an online softmax over K/V tiles and, when causal, the
lower-triangle schedule.  Its plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`; callers go through
:func:`repro_torch.kernels.ops.flash_attention`.

The kernel has three instances, chosen statically by type (:func:`instance`,
the same rule as ``flash_attention_launch``): ``wgmma`` for bf16 and
``wgmma_tf32x3`` (three TF32 products a float32 product, on the tensor
cores) for float32, at every head dim of ``HEAD_DIMS`` (D = 112 on D =
128's tiles, zero-filled past 112 by TMA).  ``simt_f32`` (float32 on the CUDA
cores, the rule until the 3xTF32 instance measured faster) stays callable for
measurement and tests through ``instance="simt_f32"``.  The 3xTF32 instance
reads K and V split into TF32 parts by a prepass kernel,
:func:`split_kv_cuda` (plain version :func:`repro_torch.kernels.ref.split_kv_ref`).
``return_lse=True`` also asks the kernel for each query row's
log-sum-exp (float32, the reference's (B, KV, G, Sq)), which the training
path's backward reads; without it the kernel writes none.
``q_offset`` (both kernels) places query row i at position ``q_offset +
i`` against keys from 0: a causal call keeps key j iff ``j <= q_offset +
i`` (a slice of the q sequence, ``distributed.sharding``'s ``q_sequence``
case); a non-causal call ignores it.
``flash_attention_cuda.launches`` counts every launch of the attention
kernel; ``flash_attention_cuda.instance_launches`` counts them by the
instance that ran, ``lse_launches`` those that wrote lse, and
``split_kv_cuda.launches`` the prepass's.

:func:`flash_attention_bwd_cuda` is the training path's backward, (dq, dk,
dv) from the forward's inputs, its output and lse and the output's gradient.
It replaces no TPU kernel: the reference's backward is jnp
(``repro.models.layers._flash_bwd_impl``), and its plain version here is
:func:`repro_torch.kernels.ref.flash_attention_bwd_ref`; callers go through
:func:`repro_torch.kernels.ops.flash_attention_bwd`.  Its instances are
chosen statically by type (:func:`bwd_instance`): ``wgmma`` for bf16 and
``simt_f32`` (the CUDA cores) for float32, at every head dim; each call is
two launches on the current stream (dq query-major, then dk and dv
key-major), counted once in ``flash_attention_bwd_cuda.launches`` and in
``instance_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_C = ctypes.c_void_p
_I = ctypes.c_int
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 112, 128)   # 112: zamba2-7b's shared attention
INSTANCES = ("wgmma", "wgmma_tf32x3", "simt_f32")   # codes 0, 1, 2 of the C entry point


def instances(dtype: torch.dtype, head_dim: int) -> tuple[str, ...]:
    """Every instance with a kernel for this type and head dim, the static
    rule's first."""
    return ("wgmma_tf32x3", "simt_f32") if dtype == torch.float32 else ("wgmma",)


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
    return _build.function(
        "flash_attention", "flash_attention_launch_instance",
        [_C, _C, _C, _C, _C, _C, _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _C])


def _bwd_fn():
    return _build.function(
        "flash_attention_bwd", "flash_attention_bwd_launch",
        [_C] * 10 + [_I] * 9 + [ctypes.c_float, _C])


def _split_fn():
    return _build.function("flash_attention", "flash_split_kv_launch",
                           [_C, _C, _C, _I, _I, _I, _I, _C])


def split_views(flat: torch.Tensor, b: int, sk: int, kv: int, d: int) -> tuple:
    """(k_hi, k_lo, vt_hi, vt_lo) as views of one flat float32 buffer, in the
    layout the C entry points share: k's parts (B, Sk, KV, D), then V's
    transposed parts (B, KV, D, Skp), Skp = Sk rounded up to 8.  ``flat``
    must hold ``split_numel(b, sk, kv, d)`` floats."""
    skp = -(-sk // 8) * 8
    nk, nv = b * sk * kv * d, b * kv * d * skp
    k_hi, k_lo, vt_hi, vt_lo = flat.split([nk, nk, nv, nv])
    return (k_hi.view(b, sk, kv, d), k_lo.view(b, sk, kv, d),
            vt_hi.view(b, kv, d, skp), vt_lo.view(b, kv, d, skp))


def split_numel(b: int, sk: int, kv: int, d: int) -> int:
    return 2 * b * kv * d * (sk + -(-sk // 8) * 8)


def split_kv_cuda(k: torch.Tensor, v: torch.Tensor) -> tuple:
    """The 3xTF32 instance's prepass: k and v (B, Sk, KV, D) float32 on the
    card -> (k_hi, k_lo, vt_hi, vt_lo) of :func:`split_views`, each value x
    split as hi = tf32(x), lo = tf32(x - hi) (round to nearest, ties away),
    V transposed with each group of 8 keys in the order 0, 2, 4, 6, 1, 3, 5,
    7 and zeros past Sk.  Bit-identical to ``ref.split_kv_ref``."""
    if k.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {k.device}")
    if (k.dim() != 4 or k.shape != v.shape or k.dtype != torch.float32
            or v.dtype != torch.float32 or v.device != k.device or k.shape[1] < 1
            or k.shape[3] not in HEAD_DIMS):
        raise ValueError(f"expected float32 k, v (B, Sk >= 1, KV, D in {HEAD_DIMS}) alike, "
                         f"got {k.dtype}{list(k.shape)}, {v.dtype}{list(v.shape)}")
    if not (k.is_contiguous() and v.is_contiguous()) or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must be contiguous, 16-byte aligned tensors")
    b, sk, kv, d = k.shape
    if b > 65535 or kv > 65535:
        raise ValueError(f"B={b}, KV={kv} exceed the kernel's grid")
    flat = torch.empty(split_numel(b, sk, kv, d), dtype=torch.float32, device=k.device)
    if b:
        with torch.cuda.device(k.device):
            rc = _split_fn()(k.data_ptr(), v.data_ptr(), flat.data_ptr(), b, sk, kv, d,
                             torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"flash split_kv kernel launch failed: CUDA error {rc}")
        split_kv_cuda.launches += 1
    return split_views(flat, b, sk, kv, d)


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


def check_offset(q_offset) -> None:
    """Raise unless ``q_offset`` is an int >= 0 that fits the kernels' int."""
    if isinstance(q_offset, bool) or not isinstance(q_offset, int) or not 0 <= q_offset < 2**30:
        raise ValueError(f"q_offset must be an int in [0, 2**30), got {q_offset!r}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, q_offset: int = 0, instance: str | None = None,
                         return_lse: bool = False):
    """(B, Sq, H, D) attention output in q's type: query head h attends KV
    head h // (H / KV) with scale D^-0.5; when causal, query row i (at
    position ``q_offset + i``) sees keys 0 .. q_offset + i.
    With ``return_lse``, ``(out, lse)``: lse the float32 log-sum-exp of each
    query row's scaled scores, (B, KV, G, Sq) with G = H / KV (a view of the
    kernel's (B, H, Sq), head h = kv G + g).

    ``instance`` (one of ``INSTANCES``) picks a kernel for measurement and
    tests; None is the static rule (:func:`instance`), the only choice the
    port's callers make."""
    name = _instance(q.dtype, q.shape[-1] if q.dim() else 0, instance)
    check_operands(q, k, v)
    check_offset(q_offset)
    b, sq, h, d = q.shape
    kv = k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((b, kv, h // kv, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if b == 0 or sq == 0:
        return (out, lse) if return_lse else out
    # The split K and V stay referenced until the launch is queued; the
    # caching allocator orders their reuse after it on this stream.
    split = split_kv_cuda(k, v) if name == "wgmma_tf32x3" else None
    with torch.cuda.device(q.device):
        rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   split[0].data_ptr() if split else None,
                   lse.data_ptr() if return_lse else None, b, sq, k.shape[1], h, kv, d,
                   DTYPES[q.dtype], int(causal), int(q_offset), d ** -0.5,
                   INSTANCES.index(name),
                   torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({name} instance): CUDA "
                           f"error {rc}")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.instance_launches[name] += 1
    flash_attention_cuda.lse_launches += bool(return_lse)
    return (out, lse) if return_lse else out


BWD_INSTANCES = ("wgmma", "simt_f32")   # the backward's, by dtype code 1 and 0


def bwd_instance(dtype: torch.dtype) -> str:
    """The backward's instance for this type: ``wgmma`` for bf16,
    ``simt_f32`` for float32."""
    return "simt_f32" if dtype == torch.float32 else "wgmma"


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, q_offset: int = 0) -> tuple:
    """The attention backward on the card -> (dq, dk, dv) in q's, k's and
    v's types: ``ref.flash_attention_bwd_ref``'s function (p recomputed
    from lse, D_i = rowsum(do * out), float32 sums, GQA groups summed into
    dk and dv), computed by the hand-written kernel.  q, out, do (B, Sq, H,
    D) and k, v (B, Sk, KV, D) as :func:`check_operands` takes them; lse
    float32 (B, KV, G, Sq) from ``flash_attention_cuda(...,
    return_lse=True)``, with the forward's ``causal`` and ``q_offset``.  Keys
    that no query row sees get zero dk and dv.  Two calls on the same inputs
    give bit-identical gradients (no atomics)."""
    check_operands(q, k, v)
    check_offset(q_offset)
    b, sq, h, d = q.shape
    kv = k.shape[2]
    for name, t in (("out", out), ("do", do)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned tensor like q "
                             f"{q.dtype}{list(q.shape)}, got {t.dtype}{list(t.shape)}")
    if (lse.shape != (b, kv, h // kv, sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 (B, KV, G, Sq) = "
                         f"{[b, kv, h // kv, sq]} tensor on {q.device}, got "
                         f"{lse.dtype}{list(lse.shape)} on {lse.device}")
    name = bwd_instance(q.dtype)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b == 0 or sq == 0:
        return dq, dk.zero_(), dv.zero_()
    dsum = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _bwd_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                       lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                       dv.data_ptr(), dsum.data_ptr(), b, sq, k.shape[1], h, kv, d,
                       DTYPES[q.dtype], int(causal), int(q_offset), d ** -0.5,
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed ({name} "
                           f"instance): CUDA error {rc}")
    flash_attention_bwd_cuda.launches += 1
    flash_attention_bwd_cuda.instance_launches[name] += 1
    return dq, dk, dv


def reset_launches() -> None:
    """Zero every launch counter of the module's wrappers."""
    flash_attention_cuda.launches = 0
    flash_attention_cuda.instance_launches = dict.fromkeys(INSTANCES, 0)
    flash_attention_cuda.lse_launches = 0
    split_kv_cuda.launches = 0
    flash_attention_bwd_cuda.launches = 0
    flash_attention_bwd_cuda.instance_launches = dict.fromkeys(BWD_INSTANCES, 0)


reset_launches()


def analytic_hbm_bytes(b: int, s: int, h: int, d: int, dtype_bytes: int = 2) -> dict:
    """Device-memory bytes of one attention forward over (b, s, h, d):
    ``fused`` moves q, k, v and the output once (this kernel's way);
    ``unfused`` also round-trips the (s, s) score tiles of every head (the
    scores in float32, p in the compute type, p @ v in float32); ``ratio``
    is unfused over fused.  Counted as the reference counts them."""
    operands = 3 * b * s * h * d * dtype_bytes + b * s * h * d * dtype_bytes
    unfused_tiles = b * h * s * s * (4 + 2 + 4)
    return {"fused": operands, "unfused": operands + unfused_tiles,
            "ratio": (operands + unfused_tiles) / operands}
