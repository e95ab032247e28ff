"""The arithmetic of the flash kernel's 3xTF32 instance, on the CPU.

The instance splits each float32 operand into two TF32 parts, hi = tf32(x)
and lo = tf32(x - hi) (``cvt.rna.tf32.f32``: 10 mantissa bits, round to
nearest, ties away from zero), and takes each product as a_lo b_hi +
a_hi b_lo + a_hi b_hi.  Here the plain versions of the split
(``ref.tf32_round``, ``ref.split_tf32``, ``ref.split_kv_ref``, the prepass
kernel's layout) are checked bit by bit, and the plain 3xTF32 attention
(``flash_attention_ref(tf32x3=True)``) is held against the JAX package's
float32 attention at the port's flash tolerance, rtol = atol = 2e-5, before
any card runs the kernel (``tests/test_torch_cuda.py`` holds the kernel to
the exact plain version there).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import ref

F32_TOL = dict(rtol=2e-5, atol=2e-5)
SPLIT_BOUND = 2.0 ** -22       # |x - (hi + lo)| <= SPLIT_BOUND * |x| for normal x
SUBNORMAL_BOUND = 2.0 ** -137  # the absolute bound below the normal range


def _inputs(kind: str) -> np.ndarray:
    rng = np.random.default_rng(len(kind))
    if kind == "random":
        x = rng.normal(size=4096) * np.exp(rng.normal(size=4096) * 8)
    elif kind == "tiny":
        x = rng.normal(size=4096) * 1e-30
    elif kind == "huge":
        x = rng.normal(size=4096) * 1e37
    elif kind == "signed zero":
        x = np.array([0.0, -0.0] * 8)
    elif kind == "subnormal":
        x = rng.normal(size=4096) * 1e-40
    else:
        # float32 patterns whose dropped 13 bits are exactly half a TF32 unit
        bits = (rng.integers(0x00800000, 0x7F000000, 4096) & ~0x1FFF) | 0x1000
        x = bits.astype(np.uint32).view(np.float32) * rng.choice([-1, 1], 4096)
    return x.astype(np.float32)


KINDS = ["random", "tiny", "huge", "signed zero", "subnormal", "ties"]


@pytest.mark.parametrize("kind", KINDS)
def test_tf32_round_is_round_to_nearest_ties_away(kind):
    """Against its two TF32 neighbours (the pattern with the 13 bits cleared
    and the next one away from zero), in float64: hi is the nearer, and
    the one away from zero on a tie."""
    x = _inputs(kind)
    hi = ref.tf32_round(torch.from_numpy(x)).numpy()
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    down = (x.view(np.uint32) & ~np.uint32(0x1FFF)).view(np.float32)
    up = (down.view(np.uint32) + np.uint32(0x2000)).view(np.float32)
    d_down = np.abs(x.astype(np.float64) - down)
    d_up = np.abs(x.astype(np.float64) - up)
    want = np.where(d_up <= d_down, up, down)
    assert np.array_equal(hi.view(np.uint32), want.view(np.uint32))
    if kind == "ties":
        assert np.array_equal(np.abs(hi), np.abs(up))


@pytest.mark.parametrize("kind", KINDS)
def test_split_tf32_parts_are_tf32_and_sum_to_x(kind):
    x = torch.from_numpy(_inputs(kind))
    hi, lo = ref.split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= SPLIT_BOUND * x.double().abs() + SUBNORMAL_BOUND).all()
    if kind == "signed zero":
        assert (hi == 0).all() and (lo == 0).all()
        assert torch.equal(torch.signbit(hi), torch.signbit(x))


def test_tf32_round_keeps_inf_and_nan_and_carries_to_inf():
    big = np.finfo(np.float32).max
    x = torch.tensor([float("inf"), -float("inf"), float("nan"), big, -big])
    hi = ref.tf32_round(x)
    assert hi[0] == float("inf") and hi[1] == -float("inf") and torch.isnan(hi[2])
    assert hi[3] == float("inf") and hi[4] == -float("inf")


@pytest.mark.parametrize("b,sk,kv,d", [(2, 13, 3, 16), (1, 64, 2, 32), (1, 1, 1, 128),
                                       (2, 37, 1, 64)])
def test_split_kv_ref_layout(b, sk, kv, d):
    """The prepass's plain version: K's parts in k's layout, V's transposed
    with each group of 8 keys in the slot order 0, 2, 4, 6, 1, 3, 5, 7 and
    zeros past Sk; the wrapper's views of one buffer have the same shapes."""
    rng = np.random.default_rng(sk)
    k, v = (torch.from_numpy(rng.normal(size=(b, sk, kv, d)).astype(np.float32))
            for _ in range(2))
    k_hi, k_lo, vt_hi, vt_lo = ref.split_kv_ref(k, v)
    skp = -(-sk // 8) * 8
    assert torch.equal(torch.stack([k_hi, k_lo]), torch.stack(ref.split_tf32(k)))
    assert vt_hi.shape == vt_lo.shape == (b, kv, d, skp)
    v_hi, v_lo = ref.split_tf32(v)
    for slot in range(skp):
        key = slot // 8 * 8 + ref.SLOT_KEYS[slot % 8]
        for part, want in ((vt_hi, v_hi), (vt_lo, v_lo)):
            got = part[..., slot]
            if key < sk:
                assert torch.equal(got, want[:, key])
            else:
                assert not got.any()
    flat = torch.zeros(flash_kernel.split_numel(b, sk, kv, d))
    views = flash_kernel.split_views(flat, b, sk, kv, d)
    assert [t.shape for t in views] == [k_hi.shape, k_lo.shape, vt_hi.shape, vt_lo.shape]
    assert views[0].data_ptr() == flat.data_ptr()


# b, sq, sk, h, kv, d, causal: the float32 parity shapes of
# tests/test_torch_flash.py, and one at qwen3-8b's head dim 128.
SHAPES = [
    (2, 16, 16, 4, 2, 8, True), (1, 32, 32, 6, 3, 16, True), (2, 16, 24, 4, 4, 8, False),
    (1, 64, 64, 2, 1, 8, True), (1, 24, 40, 8, 2, 4, False), (2, 64, 64, 4, 2, 16, True),
    (1, 128, 128, 6, 3, 32, True), (2, 32, 64, 4, 4, 16, False), (1, 256, 256, 8, 2, 128, True),
]


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", SHAPES)
def test_tf32x3_attention_matches_reference(b, sq, sk, h, kv, d, causal):
    """The 3xTF32 arithmetic (both products from split parts, the lo x lo
    term dropped) meets the float32 tolerance against the JAX package's
    attention and against the exact float32 plain version."""
    rng = np.random.default_rng(b + sq + h + d)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, sk, kv, d)).astype(np.float32) for _ in range(2))
    want = np.asarray(JL.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         causal=causal))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = ref.flash_attention_ref(qt, kt, vt, causal=causal, tf32x3=True)
    assert got.dtype == torch.float32 and got.shape == (b, sq, h, d)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    exact = ref.flash_attention_ref(qt, kt, vt, causal=causal)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), **F32_TOL)
