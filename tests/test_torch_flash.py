"""The port's attention and layer functions against the JAX package's, on
the CPU.

The port's ``layers.flash_attention`` runs its plain version here
(``kernels.ref.flash_attention_ref``; the CUDA kernel is held against it on
the card in ``tests/test_torch_cuda.py``).  In float32 it must equal
``repro.models.layers.flash_attention`` at rtol = atol = 2e-5 on the shapes
of the reference's own flash tests; the other layers at 1e-5 (the same
float32 arithmetic, summed in another order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as TL

F32_TOL = dict(rtol=2e-5, atol=2e-5)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)

# b, sq, sk, h, kv, d, causal, q_chunk, kv_chunk: the five cases of
# tests/test_flash_attention.py and the three of tests/test_kernels.py.
SHAPES = [
    (2, 16, 16, 4, 2, 8, True, 4, 4),
    (1, 32, 32, 6, 3, 16, True, 8, 16),
    (2, 16, 24, 4, 4, 8, False, 4, 8),
    (1, 64, 64, 2, 1, 8, True, 16, 16),
    (1, 24, 40, 8, 2, 4, False, 8, 8),
    (2, 64, 64, 4, 2, 16, True, 16, 16),
    (1, 128, 128, 6, 3, 32, True, 16, 16),
    (2, 32, 64, 4, 4, 16, False, 16, 16),
]


def _qkv(rng, b, sq, sk, h, kv, d):
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, kv, d)).astype(np.float32),
            rng.normal(size=(b, sk, kv, d)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,qc,kc", SHAPES)
def test_flash_attention_matches_reference(b, sq, sk, h, kv, d, causal, qc, kc):
    q, k, v = _qkv(np.random.default_rng(b + sq + h), b, sq, sk, h, kv, d)
    want = JL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, q_chunk=qc, kv_chunk=kc)
    got = TL.flash_attention(*_t(q, k, v), causal=causal, q_chunk=qc, kv_chunk=kc)
    assert got.dtype == torch.float32 and got.shape == (b, sq, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("sq,sk,causal", [(33, 33, True), (100, 100, True), (24, 40, False),
                                          (1, 7, False)])
def test_flash_attention_at_the_reference_chunk_rule(sq, sk, causal):
    """Lengths that are not powers of two go through the halving chunk rule
    (``flash_chunks``) on both sides; the triangle schedule changes nothing."""
    q, k, v = _qkv(np.random.default_rng(sq), 2, sq, sk, 4, 2, 16)
    want = np.asarray(JL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal=causal))
    for triangle in (False, True):
        got = TL.flash_attention(*_t(q, k, v), causal=causal, triangle_schedule=triangle)
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_flash_chunks_follow_the_reference_rule():
    assert ref.flash_chunks(4096, 4096) == (256, 512)
    assert ref.flash_chunks(24, 40) == (24, 40)
    assert ref.flash_chunks(100, 100) == (4, 100)
    assert ref.flash_chunks(33, 7, 4, 4) == (1, 1)


@pytest.mark.parametrize("shape", [(1, 128, 4, 64, 2), (8, 2048, 9, 64, 2),
                                   (4, 4096, 32, 128, 4)])
def test_analytic_hbm_bytes_equal_the_reference(shape):
    from repro.kernels.flash_attention import analytic_hbm_bytes

    *bshd, dtype_bytes = shape
    assert (flash_kernel.analytic_hbm_bytes(*bshd, dtype_bytes=dtype_bytes)
            == analytic_hbm_bytes(*bshd, dtype_bytes=dtype_bytes))


def test_flash_attention_bf16_rounds_where_the_kernel_rounds():
    """In bf16 the plain version widens q and k, rounds p to bf16 and sums in
    float32: it stays within two bf16 ulps (2^-7) of float32 attention over
    the same bf16 values."""
    q, k, v = _t(*_qkv(np.random.default_rng(5), 2, 64, 64, 8, 2, 32))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    got = ref.flash_attention_ref(q, k, v, causal=True, q_chunk=16, kv_chunk=16)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=1e-2, atol=1e-2)


# b, sq, sk, h, kv, d, causal, q_chunk, kv_chunk, triangle: GQA groups 1, 2,
# 3 and 4, causal and not, odd chunk counts (3 and 5 query chunks, 3 and 5
# key chunks), the triangle schedule on and off.
BWD_SHAPES = [
    (2, 16, 16, 4, 2, 8, True, 4, 4, False),
    (2, 16, 16, 4, 2, 8, True, 4, 4, True),
    (1, 24, 24, 6, 2, 16, True, 8, 8, False),
    (1, 24, 24, 6, 2, 16, True, 8, 8, True),
    (2, 24, 40, 4, 4, 8, False, 8, 8, False),
    (1, 40, 24, 8, 2, 4, False, 8, 8, True),
    (1, 20, 20, 3, 1, 16, True, 4, 4, True),
    (2, 32, 32, 6, 3, 16, True, 16, 8, False),
]


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,qc,kc,triangle", BWD_SHAPES)
def test_flash_attention_backward_matches_reference(b, sq, sk, h, kv, d, causal, qc, kc,
                                                    triangle):
    """The plain forward's lse against ``_flash_fwd``'s, the plain backward
    against ``_flash_bwd_impl`` on the same (q, k, v, out, lse, do), and the
    autograd ``flash_attention`` against ``jax.grad`` of the reference's,
    each within 2e-5 (1 + |want|)."""
    rng = np.random.default_rng(b + sq + sk + h + int(triangle))
    q, k, v = _qkv(rng, b, sq, sk, h, kv, d)
    w = rng.normal(size=(b, sq, h, d)).astype(np.float32)   # the output's cotangent
    jq, jk, jv, jw = map(jnp.asarray, (q, k, v, w))

    def close(got, want):
        got, want = got.detach().numpy(), np.asarray(want)
        assert got.shape == want.shape
        assert np.all(np.abs(got - want) <= 2e-5 * (1 + np.abs(want)))

    out, lse = JL._flash_fwd(jq, jk, jv, causal, qc, kc, triangle)
    got_out, got_lse = ref.flash_attention_ref(*_t(q, k, v), causal=causal, q_chunk=qc,
                                               kv_chunk=kc, triangle=triangle, return_lse=True)
    close(got_out, out)
    close(got_lse, lse)
    want = JL._flash_bwd_impl(jq, jk, jv, out, lse, jw, causal, qc, kc, triangle)
    got = ref.flash_attention_bwd_ref(*_t(q, k, v, np.array(out), np.array(lse), w),
                                      causal=causal, q_chunk=qc, kv_chunk=kc, triangle=triangle)
    for g, wnt in zip(got, want):
        close(g, wnt)

    def jloss(q_, k_, v_):
        return jnp.sum(JL.flash_attention(q_, k_, v_, causal=causal, q_chunk=qc, kv_chunk=kc,
                                          triangle_schedule=triangle) * jw)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    (TL.flash_attention(tq, tk, tv, causal=causal, q_chunk=qc, kv_chunk=kc,
                        triangle_schedule=triangle) * torch.from_numpy(w)).sum().backward()
    for g, wnt in zip((tq.grad, tk.grad, tv.grad), want):
        close(g, wnt)


@pytest.mark.parametrize("b,sq,sk,h,kv,causal,qc,kc", [
    (2, 48, 48, 4, 4, True, 16, 16), (1, 24, 40, 4, 2, False, 8, 8),
    (1, 48, 48, 6, 3, True, 48, 48)])
def test_flash_attention_at_head_dim_112_matches_reference(b, sq, sk, h, kv, causal, qc, kc):
    """zamba2-7b's head dim (the reduced configs use 16): the plain forward
    with lse against ``_flash_fwd``, the plain backward against
    ``_flash_bwd_impl`` and the autograd layer against ``jax.grad``, each
    within 2e-5 (1 + |want|)."""
    rng = np.random.default_rng(112 + sq + h)
    q, k, v = _qkv(rng, b, sq, sk, h, kv, 112)
    w = rng.normal(size=q.shape).astype(np.float32)
    jq, jk, jv, jw = map(jnp.asarray, (q, k, v, w))

    def close(got, want):
        got, want = got.detach().numpy(), np.asarray(want)
        assert got.shape == want.shape
        assert np.all(np.abs(got - want) <= 2e-5 * (1 + np.abs(want)))

    out, lse = JL._flash_fwd(jq, jk, jv, causal, qc, kc, False)
    got_out, got_lse = ref.flash_attention_ref(*_t(q, k, v), causal=causal, q_chunk=qc,
                                               kv_chunk=kc, return_lse=True)
    close(got_out, out)
    close(got_lse, lse)
    want = JL._flash_bwd_impl(jq, jk, jv, out, lse, jw, causal, qc, kc, False)
    got = ref.flash_attention_bwd_ref(*_t(q, k, v, np.array(out), np.array(lse), w),
                                      causal=causal, q_chunk=qc, kv_chunk=kc)
    for g, wnt in zip(got, want):
        close(g, wnt)
    want = jax.grad(lambda *a: jnp.sum(JL.flash_attention(*a, causal=causal, q_chunk=qc,
                                                          kv_chunk=kc) * jw),
                    argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    (TL.flash_attention(tq, tk, tv, causal=causal, q_chunk=qc, kv_chunk=kc)
     * torch.from_numpy(w)).sum().backward()
    for g, wnt in zip((tq.grad, tk.grad, tv.grad), want):
        close(g, wnt)
    assert 112 in flash_kernel.HEAD_DIMS
    assert flash_kernel.instances(torch.bfloat16, 112) == ("wgmma",)
    assert flash_kernel.instances(torch.float32, 112) == ("wgmma_tf32x3", "simt_f32")


def test_flash_attention_forward_alone_saves_nothing():
    """Without grad (or under no_grad) the layer returns the forward's
    output alone, equal to the autograd path's, and builds no graph."""
    q, k, v = _t(*_qkv(np.random.default_rng(0), 1, 8, 8, 2, 1, 8))
    plain = TL.flash_attention(q, k, v)
    assert plain.grad_fn is None
    with torch.no_grad():
        assert TL.flash_attention(q.clone().requires_grad_(), k, v).grad_fn is None
    traced = TL.flash_attention(q.clone().requires_grad_(), k, v)
    assert traced.grad_fn is not None and torch.equal(traced.detach(), plain)


def test_flash_attention_dispatch_never_falls_back():
    q, k, v = _t(*_qkv(np.random.default_rng(0), 1, 8, 8, 2, 1, 8))
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.flash_attention(q, k, v, impl="mxu")
    assert torch.equal(ops.flash_attention(q, k, v, impl="ref"),
                       ops.flash_attention(q, k, v))


def test_flash_attention_bwd_dispatch_never_falls_back():
    """``ops.flash_attention_bwd`` on CPU tensors: ``impl="cuda"`` raises,
    an unknown impl raises, and ``"ref"`` equals ``"auto"``, which is the
    reference's ``_flash_bwd_impl``.  Nothing launches."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 1, 16, 16, 4, 2, 8)
    w = rng.normal(size=q.shape).astype(np.float32)
    out, lse = JL._flash_fwd(*map(jnp.asarray, (q, k, v)), True, 8, 8, False)
    args = _t(q, k, v, np.array(out), np.array(lse), w)
    before = flash_kernel.flash_attention_bwd_cuda.launches
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.flash_attention_bwd(*args, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.flash_attention_bwd(*args, impl="mxu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_kernel.flash_attention_bwd_cuda(*args)
    auto = ops.flash_attention_bwd(*args, q_chunk=8, kv_chunk=8)
    plain = ops.flash_attention_bwd(*args, impl="ref", q_chunk=8, kv_chunk=8)
    want = JL._flash_bwd_impl(*map(jnp.asarray, (q, k, v)), out, lse, jnp.asarray(w), True, 8,
                              8, False)
    for a, p_, wnt in zip(auto, plain, want):
        assert torch.equal(a, p_)
        np.testing.assert_allclose(a.numpy(), np.asarray(wnt), **F32_TOL)
    assert flash_kernel.flash_attention_bwd_cuda.launches == before


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "wgmma"), (torch.float32, "simt_f32")])
def test_flash_bwd_kernel_instance_is_static_by_type(dtype, want):
    """The backward's instance follows the type alone (wgmma for bf16, the
    CUDA cores for float32) and is one of ``BWD_INSTANCES``, whose counters
    ``reset_launches`` keeps."""
    assert flash_kernel.bwd_instance(dtype) == want
    assert want in flash_kernel.BWD_INSTANCES
    assert set(flash_kernel.flash_attention_bwd_cuda.instance_launches) == set(
        flash_kernel.BWD_INSTANCES)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 16, "wgmma"), (torch.bfloat16, 32, "wgmma"),
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 16, "wgmma_tf32x3"), (torch.float32, 128, "wgmma_tf32x3")])
def test_flash_kernel_instance_is_static_by_type_and_head_dim(dtype, d, want):
    """The wrapper counts launches by the instance the CUDA entry point picks:
    wgmma for bf16 at every head dim, the 3xTF32 one for float32 (it
    measured faster than the CUDA-core instance).  CPU tensors launch
    nothing, the prepass neither."""
    assert flash_kernel.instance(dtype, d) == want
    assert set(flash_kernel.flash_attention_cuda.instance_launches) == set(
        flash_kernel.INSTANCES)
    before = (flash_kernel.flash_attention_cuda.launches,
              dict(flash_kernel.flash_attention_cuda.instance_launches),
              flash_kernel.split_kv_cuda.launches)
    q, k, v = (t.to(dtype) for t in _t(*_qkv(np.random.default_rng(0), 1, 8, 8, 2, 1, d)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_kernel.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_kernel.split_kv_cuda(k.float(), v.float())
    assert (flash_kernel.flash_attention_cuda.launches,
            flash_kernel.flash_attention_cuda.instance_launches,
            flash_kernel.split_kv_cuda.launches) == before


@pytest.mark.parametrize("dtype,d,requested,error", [
    (torch.bfloat16, 16, "wgmma", None), (torch.float32, 16, "wgmma_tf32x3", None),
    (torch.float32, 32, "wgmma_tf32x3", None), (torch.bfloat16, 128, "wgmma", None),
    (torch.float32, 64, "simt_f32", None),
    (torch.bfloat16, 64, "wgmma_tf32x3", "no kernel"),
    (torch.bfloat16, 128, "wgmma_tf32x3", "no kernel"),
    (torch.bfloat16, 32, "simt_f32", "no kernel"), (torch.float32, 32, "wgmma", "no kernel"),
    (torch.float32, 16, "mma_sync", "unknown"), (torch.bfloat16, 32, "swar", "unknown")])
def test_flash_kernel_instance_keyword(dtype, d, requested, error):
    """``instance=`` picks a kernel for measurement and tests: a name with
    no kernel for the type and head dim raises ValueError before anything
    else; a valid one still needs CUDA tensors.  Nothing launches."""
    before = (flash_kernel.flash_attention_cuda.launches,
              dict(flash_kernel.flash_attention_cuda.instance_launches))
    q, k, v = (t.to(dtype) for t in _t(*_qkv(np.random.default_rng(1), 1, 8, 8, 2, 1, d)))
    if error is None:
        assert flash_kernel.instance(dtype, d, requested) == requested
        assert requested in flash_kernel.instances(dtype, d)
        error = "CUDA tensors"
    else:
        with pytest.raises(ValueError, match=error):
            flash_kernel.instance(dtype, d, requested)
    with pytest.raises(ValueError, match=error):
        flash_kernel.flash_attention_cuda(q, k, v, instance=requested)
    assert (flash_kernel.flash_attention_cuda.launches,
            flash_kernel.flash_attention_cuda.instance_launches) == before


def test_flash_kernel_instances_put_the_static_rule_first():
    for dtype in (torch.bfloat16, torch.float32):
        for d in flash_kernel.HEAD_DIMS:
            names = flash_kernel.instances(dtype, d)
            assert names[0] == flash_kernel.instance(dtype, d)
            assert set(names) <= set(flash_kernel.INSTANCES)
    assert flash_kernel.instances(torch.bfloat16, 32) == ("wgmma",)
    assert flash_kernel.instances(torch.bfloat16, 64) == ("wgmma",)
    assert flash_kernel.instances(torch.float32, 16) == ("wgmma_tf32x3", "simt_f32")


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 4, 2, 16)])
def test_rms_norm_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    scale = rng.normal(size=shape[-1:]).astype(np.float32)
    want = JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    got = TL.rms_norm(*_t(x, scale), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("theta,positions", [(1e4, "arange"), (1e6, "arange"),
                                             (1e6, "per_row")])
def test_apply_rope_matches_reference(theta, positions):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    pos = (np.arange(12)[None, :] if positions == "arange"
           else rng.integers(0, 64, (2, 12))).astype(np.int32)
    np.testing.assert_allclose(TL.rope_frequencies(16, theta).numpy(),
                               np.asarray(JL.rope_frequencies(16, theta)), rtol=1e-7)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(*_t(x, pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_swiglu_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 32)).astype(np.float32)
    w = [(rng.normal(size=s) * 0.2).astype(np.float32) for s in ((32, 48), (32, 48), (48, 32))]
    want = JL.swiglu(jnp.asarray(x), *map(jnp.asarray, w))
    got = TL.swiglu(*_t(x, *w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("kv", [1, 2, 4])
def test_decode_attention_matches_reference(kv):
    rng = np.random.default_rng(kv)
    q = rng.normal(size=(3, 1, 4, 16)).astype(np.float32)
    kc = rng.normal(size=(3, 20, kv, 16)).astype(np.float32)
    vc = rng.normal(size=(3, 20, kv, 16)).astype(np.float32)
    cur = np.array([1, 13, 20], np.int32)
    want = JL.decode_attention(*map(jnp.asarray, (q, kc, vc, cur)))
    got = TL.decode_attention(*_t(q, kc, vc, cur))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_attention_block_matches_reference(qk_norm):
    rng = np.random.default_rng(11)
    d, h, kv, hd = 32, 4, 2, 8
    x = rng.normal(size=(2, 16, d)).astype(np.float32)
    params = {"wq": rng.normal(size=(d, h * hd)), "wk": rng.normal(size=(d, kv * hd)),
              "wv": rng.normal(size=(d, kv * hd)), "wo": rng.normal(size=(h * hd, d))}
    params = {n: (a / np.sqrt(a.shape[0])).astype(np.float32) for n, a in params.items()}
    if qk_norm:
        params["q_norm"] = rng.normal(size=(hd,)).astype(np.float32)
        params["k_norm"] = rng.normal(size=(hd,)).astype(np.float32)
    kw = dict(num_heads=h, num_kv_heads=kv, head_dim=hd, rope_theta=1e6, qk_norm=qk_norm,
              norm_eps=1e-6, q_chunk=8, kv_chunk=8)
    want = JL.attention_block(jnp.asarray(x), jax.tree.map(jnp.asarray, params), **kw)
    got = TL.attention_block(torch.from_numpy(x),
                             {n: torch.from_numpy(a) for n, a in params.items()}, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
