"""The flash attention plain versions with a query offset, against the JAX
package's ``repro.models.layers.flash_attention`` on the whole q, on the
CPU.

A slice of the q sequence, rows ``[r0, r1)`` with ``q_offset = r0``,
against the whole K and V, is the work one rank of the ``q_sequence``
attention split does (``distributed.sharding.attn_partition``).  In float32,
at row 9's oracle tolerance (rtol = atol = 2e-5):

* each slice's output equals those rows of the whole's output;
* each slice's dq equals those rows of the whole's dq;
* the slices' dk and dv summed equal the whole's.

The cases cover offsets that are not multiples of any chunk, slices of one
row and of a few rows (shorter than a kernel tile), Sq != Sk, and a
non-causal call (which ignores the offset).  Both the plain versions
(``kernels.ref``) and the autograd path (``layers.flash_attention``) run.
The CUDA kernels are held to the same on the card in
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as TL

TOL = dict(rtol=2e-5, atol=2e-5)

# b, sq, sk, h, kv, d, causal, the slices' boundaries, q_chunk, kv_chunk of
# the reference (dividing sq and sk)
CASES = {
    "even_4way": (2, 64, 64, 6, 2, 16, True, (0, 16, 32, 48, 64), 16, 16),
    "odd_offsets": (1, 48, 48, 4, 1, 8, True, (0, 7, 30, 31, 48), 16, 16),
    "short_slices": (2, 40, 40, 3, 3, 8, True, (0, 1, 4, 37, 40), 8, 8),
    "sk_longer": (1, 32, 56, 4, 2, 8, True, (0, 5, 19, 32), 16, 8),
    "sq_longer": (1, 56, 32, 2, 1, 16, True, (0, 33, 41, 56), 8, 16),
    "non_causal": (2, 32, 24, 4, 2, 8, False, (0, 9, 17, 32), 8, 8),
}


def _inputs(b, sq, sk, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, kv, d)).astype(np.float32),
            rng.normal(size=(b, sk, kv, d)).astype(np.float32),
            rng.normal(size=(b, sq, h, d)).astype(np.float32))


def _whole(q, k, v, do, causal, qc, kc):
    """The JAX package's output and (dq, dk, dv) of <out, do> on the whole q."""
    f = lambda q_, k_, v_: JL.flash_attention(q_, k_, v_, causal=causal, q_chunk=qc,  # noqa
                                              kv_chunk=kc)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    name = request.param
    b, sq, sk, h, kv, d, causal, bounds, qc, kc = CASES[name]
    q, k, v, do = _inputs(b, sq, sk, h, kv, d, seed=sorted(CASES).index(name))
    out, grads = _whole(q, k, v, do, causal, qc, kc)
    return dict(q=q, k=k, v=v, do=do, causal=causal, bounds=bounds, out=out, grads=grads)


def _slices(c):
    return list(zip(c["bounds"][:-1], c["bounds"][1:]))


def test_offset_slice_forward_equals_rows_of_the_whole(case):
    k, v = torch.from_numpy(case["k"]), torch.from_numpy(case["v"])
    for r0, r1 in _slices(case):
        q = torch.from_numpy(case["q"][:, r0:r1].copy())
        got = ref.flash_attention_ref(q, k, v, causal=case["causal"], q_offset=r0)
        np.testing.assert_allclose(got.numpy(), case["out"][:, r0:r1], **TOL,
                                   err_msg=f"rows {r0}:{r1}")


def test_offset_slice_backward_matches_the_whole(case):
    """The plain backward on each slice (lse from the plain forward with the
    same offset): dq is the whole's rows, dk and dv sum to the whole's."""
    k, v = torch.from_numpy(case["k"]), torch.from_numpy(case["v"])
    dk_sum, dv_sum = torch.zeros_like(k), torch.zeros_like(v)
    for r0, r1 in _slices(case):
        q = torch.from_numpy(case["q"][:, r0:r1].copy())
        do = torch.from_numpy(case["do"][:, r0:r1].copy())
        out, lse = ref.flash_attention_ref(q, k, v, causal=case["causal"], q_offset=r0,
                                           return_lse=True)
        dq, dk, dv = ops.flash_attention_bwd(q, k, v, out, lse, do, causal=case["causal"],
                                             q_offset=r0)
        np.testing.assert_allclose(dq.numpy(), case["grads"][0][:, r0:r1], **TOL,
                                   err_msg=f"dq rows {r0}:{r1}")
        dk_sum += dk
        dv_sum += dv
    np.testing.assert_allclose(dk_sum.numpy(), case["grads"][1], **TOL)
    np.testing.assert_allclose(dv_sum.numpy(), case["grads"][2], **TOL)


def test_offset_slices_through_autograd_match_the_whole(case):
    """``layers.flash_attention`` with ``q_offset`` under autograd (the
    sharded step's path): the same three equalities."""
    k = torch.from_numpy(case["k"]).requires_grad_(True)
    v = torch.from_numpy(case["v"]).requires_grad_(True)
    for r0, r1 in _slices(case):
        q = torch.from_numpy(case["q"][:, r0:r1].copy()).requires_grad_(True)
        out = TL.flash_attention(q, k, v, causal=case["causal"], q_offset=r0)
        np.testing.assert_allclose(out.detach().numpy(), case["out"][:, r0:r1], **TOL)
        (dq,) = torch.autograd.grad(out, q, torch.from_numpy(case["do"][:, r0:r1].copy()),
                                    retain_graph=True)
        np.testing.assert_allclose(dq.numpy(), case["grads"][0][:, r0:r1], **TOL)
        out.backward(torch.from_numpy(case["do"][:, r0:r1].copy()))
    np.testing.assert_allclose(k.grad.numpy(), case["grads"][1], **TOL)
    np.testing.assert_allclose(v.grad.numpy(), case["grads"][2], **TOL)


def test_zero_offset_on_a_later_slice_fails():
    """The control: a slice past row 0 given ``q_offset = 0`` must not
    match the whole's rows (its causal mask hides keys those rows see)."""
    b, sq, sk, h, kv, d, causal, bounds, qc, kc = CASES["even_4way"]
    q, k, v, do = _inputs(b, sq, sk, h, kv, d, seed=sorted(CASES).index("even_4way"))
    out, _ = _whole(q, k, v, do, causal, qc, kc)
    r0, r1 = bounds[2], bounds[3]
    got = ref.flash_attention_ref(torch.from_numpy(q[:, r0:r1].copy()), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True, q_offset=0)
    assert not np.allclose(got.numpy(), out[:, r0:r1], **TOL)


@pytest.mark.parametrize("offset", [-1, 1.5, True])
def test_kernel_wrappers_reject_a_bad_offset(offset):
    from repro_torch.kernels import flash_attention as flash_kernel

    with pytest.raises(ValueError, match="q_offset"):
        flash_kernel.check_offset(offset)
