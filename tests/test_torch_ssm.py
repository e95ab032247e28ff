"""The port's Mamba2 / SSD blocks (``repro_torch.models.ssm``) against the
JAX package's (``repro.models.ssm``), on the CPU, from the same numpy
inputs.

Tolerances: float32 at rtol = atol = 1e-5 (the same float32 arithmetic; the
four-operand einsums are taken as pairwise products in another order), the
SSM states and a whole block at 1e-5 relative to the leaf's largest
magnitude.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, rel=1e-5):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert float(np.abs(got - want).max()) <= rel * max(1.0, float(np.abs(want).max()))


def _scan_inputs(rng, b=2, s=16, h=3, p=4, n=5):
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    a = -rng.uniform(0.01, 1.0, size=(b, s, h)).astype(np.float32)
    bmat = rng.normal(size=(b, s, n)).astype(np.float32)
    cmat = rng.normal(size=(b, s, n)).astype(np.float32)
    init = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return x, a, bmat, cmat, init


def test_segsum_matches_reference():
    a = -np.random.default_rng(0).uniform(0, 1, size=(2, 3, 7)).astype(np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    got = ssm._segsum(torch.from_numpy(a)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


@pytest.mark.parametrize("chunk", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_matches_reference(chunk, with_state):
    """Every chunk size of a 16-step sequence (32: one chunk of 16, the
    reference's min(chunk, S)), with and without an initial state."""
    x, a, bmat, cmat, init = _scan_inputs(np.random.default_rng(chunk + 10 * with_state))
    state = init if with_state else None
    want_y, want_st = jssm.ssd_scan(jnp.asarray(x), jnp.asarray(a), jnp.asarray(bmat),
                                    jnp.asarray(cmat), chunk,
                                    None if state is None else jnp.asarray(state))
    got_y, got_st = ssm.ssd_scan(torch.from_numpy(x), torch.from_numpy(a),
                                 torch.from_numpy(bmat), torch.from_numpy(cmat), chunk,
                                 None if state is None else torch.from_numpy(state))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    _close(got_st, want_st)


def test_ssd_scan_equals_the_step_recurrence():
    """The chunked scan against the plain recurrence state' = exp(a) state +
    x (outer) B, y = state C, step by step."""
    x, a, bmat, cmat, init = (torch.from_numpy(t) for t in
                              _scan_inputs(np.random.default_rng(5), s=12))
    y, final = ssm.ssd_scan(x, a, bmat, cmat, 4, init)
    st = init.clone()
    for t in range(x.shape[1]):
        st = st * torch.exp(a[:, t])[..., None, None] + x[:, t, :, :, None] * bmat[:, t, None, None]
        torch.testing.assert_close(y[:, t], torch.einsum("bhpn,bn->bhp", st, cmat[:, t]),
                                   rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(final, st, rtol=1e-5, atol=1e-5)


def test_ssd_scan_keeps_the_chunk_rule():
    x, a, bmat, cmat, _ = (torch.from_numpy(t) for t in
                           _scan_inputs(np.random.default_rng(6), s=12))
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        ssm.ssd_scan(x, a, bmat, cmat, 8)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 5])
def test_causal_conv_matches_reference(with_state, s):
    rng = np.random.default_rng(s + 2 * with_state)
    x = rng.normal(size=(2, s, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    state = rng.normal(size=(2, 3, 6)).astype(np.float32) if with_state else None
    want, want_state = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                         None if state is None else jnp.asarray(state))
    got, got_state = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                      None if state is None else torch.from_numpy(state))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_state.numpy(), np.asarray(want_state), **TOL)


def _block_params(rng, d=8, din=16, n=6, h=4, k=4):
    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {"w_z": normal(d, din, scale=d ** -0.5), "w_x": normal(d, din, scale=d ** -0.5),
            "w_b": normal(d, n, scale=d ** -0.5), "w_c": normal(d, n, scale=d ** -0.5),
            "w_dt": normal(d, h, scale=d ** -0.5), "conv_x": normal(k, din, scale=0.5),
            "conv_b": normal(k, n, scale=0.5), "conv_c": normal(k, n, scale=0.5),
            "a_log": normal(h, scale=0.5), "dt_bias": normal(h, scale=0.5),
            "d_skip": normal(h), "norm": 1 + normal(din, scale=0.1),
            "w_out": normal(din, d, scale=din ** -0.5)}


@pytest.mark.parametrize("chunk", [4, 16])
def test_mamba2_block_prefill_and_decode_match_reference(chunk):
    """A 12-step prefill (the chunked scan, the decode-ready cache) then 4
    single-step decodes against the carried cache, each against the
    reference's; nonzero a_log and dt_bias."""
    rng = np.random.default_rng(chunk)
    params = _block_params(rng)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    x = rng.normal(size=(2, 16, 8)).astype(np.float32)
    kw = dict(d_state=6, head_dim=4, chunk=chunk, norm_eps=1e-5)
    want, jcache = jssm.mamba2_block(jnp.asarray(x[:, :12]), jp, **kw)
    got, cache = ssm.mamba2_block(torch.from_numpy(x[:, :12]), tp, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert set(cache) == set(jcache) == set(ssm.CACHE_LEAVES)
    for t in range(12, 16):
        for name in ssm.CACHE_LEAVES:
            _close(cache[name], jcache[name])
        want, jcache = jssm.mamba2_block(jnp.asarray(x[:, t:t + 1]), jp, cache=jcache, **kw)
        got, cache = ssm.mamba2_block(torch.from_numpy(x[:, t:t + 1]), tp, cache=cache, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=f"step {t}")
    # The decode steps continue the sequence: the prefill over all 16 steps
    # gives the last step's output and state.
    full, full_cache = ssm.mamba2_block(torch.from_numpy(x), tp, **kw)
    np.testing.assert_allclose(got.numpy(), full[:, -1:].numpy(), **TOL)
    for name in ssm.CACHE_LEAVES:
        torch.testing.assert_close(cache[name], full_cache[name], rtol=1e-5, atol=1e-5)


def test_mamba2_block_gradients_match_reference():
    """Gradients of a scalar of the block's output with respect to its input
    and every parameter, against ``jax.grad``."""
    import jax

    rng = np.random.default_rng(3)
    params = _block_params(rng)
    x = rng.normal(size=(2, 8, 8)).astype(np.float32)
    w = rng.normal(size=(2, 8, 8)).astype(np.float32)
    kw = dict(d_state=6, head_dim=4, chunk=4, norm_eps=1e-5)

    def jloss(p, xx):
        return jnp.sum(jssm.mamba2_block(xx, p, **kw)[0] * w)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in params.items()},
                                              jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    (ssm.mamba2_block(tx, tp, **kw)[0] * torch.from_numpy(w)).sum().backward()
    _close(tx.grad, jgx)
    for k in params:
        _close(tp[k].grad, jg[k])



def test_bf16_block_error_is_within_the_references():
    """One Mamba2 block (width 64, 8 heads of 16, state 16, chunk 16, 64
    steps) in bf16 in both packages from the same inputs: its output and the
    gradients of a scalar of it with respect to its input and every
    parameter, each against the JAX package's float32 run.  A single block
    is not chaotic, so the port's mean error over 6 seeds is held to 1.1
    times the reference's own.  Measured: 0.0115 (port) against 0.0156
    (JAX); the port with its log decays rounded to bf16 before the cumsum
    reaches 0.0196 and fails."""
    import jax

    kw = dict(d_state=16, head_dim=16, chunk=16, norm_eps=1e-5)

    def rel(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    def jloss(p, xx, w, dtype):
        out = jssm.mamba2_block(xx.astype(dtype), p, **kw)[0]
        return jnp.sum(out.astype(jnp.float32) * w), out

    jgrad = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True), static_argnums=3)

    def run(params, x, w, dtype):
        """(JAX's, the port's) output and gradients, as float32 numpy."""
        (_, jout), (jg, jgx) = jgrad({k: jnp.asarray(v) for k, v in params.items()},
                                     jnp.asarray(x), jnp.asarray(w), getattr(jnp, dtype))
        tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
        tx = torch.from_numpy(x).requires_grad_()
        out = ssm.mamba2_block(tx.to(getattr(torch, dtype)), tp, **kw)[0]
        (out.float() * torch.from_numpy(w)).sum().backward()
        return ({"out": np.asarray(jout.astype(jnp.float32)), "x": np.asarray(jgx),
                 **{k: np.asarray(v) for k, v in jg.items()}},
                {"out": out.detach().float().numpy(), "x": tx.grad.numpy(),
                 **{k: tp[k].grad.numpy() for k in params}})

    errs = []   # (JAX's, the port's) mean error a seed
    for seed in range(6):
        rng = np.random.default_rng(seed)
        params = _block_params(rng, d=64, din=128, n=16, h=8)
        x = rng.normal(size=(2, 64, 64)).astype(np.float32)
        w = rng.normal(size=(2, 64, 64)).astype(np.float32)
        want, _ = run(params, x, w, "float32")
        jgot, tgot = run(params, x, w, "bfloat16")
        errs.append((np.mean([rel(jgot[k], want[k]) for k in want]),
                     np.mean([rel(tgot[k], want[k]) for k in want])))
    jerr, terr = np.mean(errs, axis=0)
    assert np.isfinite(errs).all() and jerr > 1e-3, errs
    assert terr <= 1.1 * jerr, errs

def _drift(decode_logits, forward_logits, prompt):
    """Relative RMS of each decode step's logits against the forward's at
    the same position."""
    out = []
    for t, lg in enumerate(decode_logits):
        got = np.asarray(lg, np.float32)
        want = np.asarray(forward_logits[:, prompt + t], np.float32)
        out.append(float(np.linalg.norm(got - want) / np.linalg.norm(want)))
    return out


def test_bf16_decode_drift_is_the_references():
    """Teacher-forced decode against the forward pass, in both packages on
    the same weights and tokens (a zamba2-7b cut to 6 layers of width 256,
    chunk 64): in float32 both agree to 1e-4, so the caches are exact; in
    bf16 both drift by percents, the port no more than the JAX package
    (bf16 rounding grows through the Mamba2 stack).  This is why
    ``chip_smoke.py`` gates its full-size teacher-forced checks in float32."""
    import dataclasses

    import jax

    from repro import configs as jconfigs
    from repro.models import DecodeEngine as JDecodeEngine
    from repro.models import Model as JModel
    from repro_torch import configs
    from repro_torch.models import DecodeEngine, Model
    from repro_torch.models.convert import params_from_numpy

    p, n = 128, 6
    tokens = np.random.default_rng(4).integers(0, 512, (2, p + n + 58)).astype(np.int32)
    drift = {}
    for dtype in ("float32", "bfloat16"):
        cut = dict(d_model=256, d_ff=512, num_heads=4, num_kv_heads=4, head_dim=64,
                   num_layers=6, attn_every=2, vocab_size=512, ssm_chunk=64, dtype=dtype)
        jcfg = dataclasses.replace(jconfigs.get("zamba2-7b"), **cut)
        jm = JModel(jcfg)
        jp = jm.init(jax.random.PRNGKey(1))
        jeng = JDecodeEngine(jm)
        want, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(tokens)})
        logits, cache = jax.jit(lambda a, b: jeng.prefill(a, b, max_len=p + n))(
            jp, {"tokens": jnp.asarray(tokens[:, :p])})
        step = jax.jit(jeng.decode_step)
        steps = []
        for t in range(p, p + n):
            lg, cache = step(jp, cache, {"tokens": jnp.asarray(tokens[:, t:t + 1])})
            steps.append(lg[:, 0])
        jdrift = _drift(steps, want, p)

        model = params_from_numpy(Model(dataclasses.replace(configs.get("zamba2-7b"), **cut),
                                        device="cpu"), jax.tree.map(np.asarray, jp))
        eng = DecodeEngine(model)
        with torch.inference_mode():
            want, _ = model({"tokens": torch.from_numpy(tokens)})
            _, cache = eng.prefill(model, {"tokens": torch.from_numpy(tokens[:, :p])},
                                   max_len=p + n, last_only=True)
            steps = []
            for t in range(p, p + n):
                lg, cache = eng.decode_step(model, cache,
                                            {"tokens": torch.from_numpy(tokens[:, t:t + 1])})
                steps.append(lg[:, 0].float().numpy())
        drift[dtype] = (jdrift, _drift(steps, want.float().numpy(), p))
    (j32, t32), (j16, t16) = drift["float32"], drift["bfloat16"]
    assert max(j32) <= 1e-4 and max(t32) <= 1e-4, (j32, t32)
    assert max(j16) >= 100 * max(j32), (j16, j32)
    # Measured: mean over the steps 0.0285 (port) against 0.0329 (JAX).
    assert np.mean(t16) <= 1.5 * np.mean(j16), (t16, j16)


def test_bf16_gradients_are_as_close_as_the_references():
    """The loss and every gradient leaf of reduced zamba2-7b in bf16, in
    both packages on the same weights and batch (8 seeds), each measured
    against the JAX package's float32 run: the port's mean error is held to
    1.5 times the reference's own bf16 error.  One seed's leaves move
    together (the same rounding runs through the whole stack), so the means
    are taken over the seeds.  Measured: mean leaf error 0.0875 (port)
    against 0.0861 (JAX), loss 2.6e-4 against 6.8e-4."""
    import jax

    from repro import configs as jconfigs
    from repro.models import Model as JModel
    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.train.tree import leaves_with_paths

    def rel(got, want):
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    arch = "zamba2-7b"
    jm = {d: JModel(jconfigs.get_reduced(arch, dtype=d)) for d in ("float32", "bfloat16")}
    jgrad = {d: jax.jit(jax.value_and_grad(m.loss, has_aux=True)) for d, m in jm.items()}
    tm = Model(configs.get_reduced(arch, dtype="bfloat16"), device="cpu")
    vocab = tm.cfg.vocab_size
    errs = []   # (JAX loss, port loss, JAX mean leaf, port mean leaf) a seed
    for seed in range(8):
        jp = jm["float32"].init(jax.random.PRNGKey(seed))
        toks = np.random.default_rng(seed).integers(0, vocab, (2, 33)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        (want_loss, _), want = jgrad["float32"](jp, jbatch)
        (jloss, _), jg = jgrad["bfloat16"](jp, jbatch)
        want, jg = ({"/".join(str(k.key) for k in path): np.asarray(v, np.float64)
                     for path, v in jax.tree_util.tree_flatten_with_path(t)[0]}
                    for t in (want, jg))
        params_from_numpy(tm, jax.tree.map(np.asarray, jp))
        named = leaves_with_paths(tm.param_tree())
        for _, p in named:
            p.requires_grad_(True)
        loss, _ = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, [p for _, p in named])
        tg = {"/".join(n): g.double().numpy() for (n, _), g in zip(named, grads)}
        assert set(tg) == set(want)
        want_loss = float(want_loss)
        errs.append((abs(float(jloss) - want_loss) / want_loss,
                     abs(float(loss.detach()) - want_loss) / want_loss,
                     np.mean([rel(jg[n], want[n]) for n in want]),
                     np.mean([rel(tg[n], want[n]) for n in want])))
    jl, tl, jleaf, tleaf = np.mean(errs, axis=0)
    assert np.isfinite(errs).all() and jleaf > 1e-3, errs
    assert tleaf <= 1.5 * jleaf and tl <= 1.5 * jl, errs
