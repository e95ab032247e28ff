"""The port's moe family (phi3.5-moe, arctic) against the JAX package's, on
the CPU, from the same seeded numpy inputs.

``moe_block`` alone in float32 within 1e-6 (relative to the output's
largest magnitude) and its aux metrics within 1e-6, at a capacity that
drops nothing (cf = 8) and one that drops choices (cf = 0.5: the same
``moe_dropped``, above 0), in one group and in several; in bf16 its error
against the float32 result no larger than the reference's, and where the
experts' bf16 outputs are exact, its output the reference's bit for bit
(the combine weights are rounded to bf16 before the combine, as the
reference's ``combine.astype`` does).  On the reduced configs (float32): forward logits
and aux within 1e-5 relative, the loss within 1e-5 relative, every
gradient leaf within 1e-5 of its largest magnitude, three AdamW steps
(parameters within 1e-4, the ``eps`` effect of ``tests/test_torch_train.py``),
prefill and decode against the reference's ``DecodeEngine`` within 1e-4;
and the parameter counts of all ten full configs from ``param_layout``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import DecodeEngine as JDecodeEngine
from repro.models import Model as JModel
from repro.models.moe import moe_block as j_moe_block
from repro.train import OptimizerConfig as JOptimizerConfig
from repro.train import init_state as j_init_state
from repro.train import make_train_step as j_make_train_step
from repro_torch import configs as TC
from repro_torch.models import DecodeEngine, Model
from repro_torch.models import model as model_lib
from repro_torch.models.convert import params_from_numpy, state_from_numpy
from repro_torch.models.moe import moe_block
from repro_torch.train import OptimizerConfig, make_train_step
from repro_torch.train.tree import leaves_with_paths

ARCHS = ["phi3.5-moe-42b-a6.6b", "arctic-480b"]
B, PROMPT, S = 2, 24, 32
OPT = dict(learning_rate=3e-3, warmup_steps=2, decay_steps=10)


def _named(tree) -> dict:
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        return {"/".join(p): v.detach().numpy() for p, v in leaves_with_paths(tree)}
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(got, want) -> float:
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(np.asarray(got, dtype=np.float64) - want).max() / np.abs(want).max())


def _moe_inputs(seed, b, s, d=32, e=8, f=48):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    params = {"router": rng.normal(size=(d, e)).astype(np.float32) / d ** 0.5,
              "w_gate": rng.normal(size=(e, d, f)).astype(np.float32) / d ** 0.5,
              "w_up": rng.normal(size=(e, d, f)).astype(np.float32) / d ** 0.5,
              "w_down": rng.normal(size=(e, f, d)).astype(np.float32) / f ** 0.5}
    return x, params


def _both_moe(x, params, dtype, **kw):
    jout, jaux = j_moe_block(jnp.asarray(x, dtype=dtype), jax.tree.map(jnp.asarray, params), **kw)
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    out, aux = moe_block(torch.from_numpy(np.array(x)).to(tdt),
                         {k: torch.from_numpy(v) for k, v in params.items()}, **kw)
    return (np.asarray(jout.astype(jnp.float32)), {k: float(v) for k, v in jaux.items()},
            out.float().numpy(), {k: float(v) for k, v in aux.items()})


@pytest.mark.parametrize("b,s,group_size", [(2, 64, 1024), (3, 64, 16), (1, 1, 1024)])
@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_moe_block_matches_reference(b, s, group_size, cf):
    x, params = _moe_inputs(s + b, b, s)
    jout, jaux, out, aux = _both_moe(x, params, jnp.float32, num_experts=8, k=2,
                                     capacity_factor=cf, group_size=group_size)
    assert _rel(out, jout) <= 1e-6
    assert set(aux) == set(jaux) == {"moe_aux_loss", "moe_z_loss", "moe_dropped"}
    for k in jaux:
        assert abs(aux[k] - jaux[k]) <= 1e-6 * max(1.0, abs(jaux[k])), (k, aux[k], jaux[k])
    # One token a group has capacity 4 and never drops; 64 tokens at cf 0.5
    # (capacity 8 of 16 choices an expert on average) drop some.
    assert (aux["moe_dropped"] > 0) == (cf == 0.5 and s > 1)
    assert aux["moe_dropped"] == jaux["moe_dropped"]


def test_moe_block_keeps_the_group_rule():
    x, params = _moe_inputs(0, 1, 48)
    with pytest.raises(AssertionError):
        moe_block(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in params.items()},
                  num_experts=8, k=2, group_size=32)


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_moe_block_bf16_error_no_larger_than_the_references(cf):
    """In bf16 both packages' outputs against the float32 result on the same
    (bf16-rounded) input: the port's RMS error is no larger than the
    reference's (their routing is the same float32 router).  Combining in
    float32 weights, which the reference does not, lands elsewhere."""
    x, params = _moe_inputs(7, 2, 128)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    kw = dict(num_experts=8, k=2, capacity_factor=cf)
    truth, _, _, _ = _both_moe(x, params, jnp.float32, **kw)
    jout, jaux, out, aux = _both_moe(x, params, jnp.bfloat16, **kw)
    rms = lambda a: float(np.sqrt(np.mean((a - truth) ** 2)))  # noqa: E731
    assert aux["moe_dropped"] == jaux["moe_dropped"]
    assert aux == pytest.approx(jaux, rel=1e-6)
    assert rms(out) <= rms(jout)
    assert _rel(out, jout) <= 2 ** -7     # one bf16 rounding of the output apart at most


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_moe_block_bf16_combine_rounds_the_gates(cf):
    """Experts whose bf16 outputs are exact (integer inputs and weights, a
    SwiGLU gate past sigmoid's rounding to 1), so that only the combine
    rounds: the port's output equals the reference's bit for bit, and a
    combine with float32 gates (the float32 result rounded once) would not."""
    rng = np.random.default_rng(3)
    b, s, d, e, f = 2, 64, 9, 8, 4
    x = np.ones((b, s, d), np.float32)
    x[..., 0] = np.asarray(jnp.asarray(rng.normal(size=(b, s)), jnp.bfloat16).astype(jnp.float32))
    router = np.zeros((d, e), np.float32)
    router[0] = rng.normal(size=e) * 3                  # routing reads coordinate 0 alone
    w_gate = np.full((e, d, f), 4.0, np.float32)        # h_gate = 32: silu(32) = 32
    w_gate[:, 0] = 0
    w_up = rng.integers(0, 2, (e, d, f)).astype(np.float32)
    w_up[:, 0] = 0
    w_down = rng.integers(0, 2, (e, f, d)).astype(np.float32)
    params = dict(router=router, w_gate=w_gate, w_up=w_up, w_down=w_down)
    kw = dict(num_experts=e, k=2, capacity_factor=cf)
    truth, _, _, _ = _both_moe(x, params, jnp.float32, **kw)
    jout, _, out, _ = _both_moe(x, params, jnp.bfloat16, **kw)
    np.testing.assert_array_equal(out, jout)
    unrounded = np.asarray(jnp.asarray(truth, jnp.bfloat16).astype(jnp.float32))
    assert (unrounded != jout).mean() > 0.01


@pytest.fixture(scope="module", params=ARCHS)
def built(request):
    """The reduced reference model with seeded parameters, the port's model
    holding them, and a batch."""
    name = request.param
    jm = JModel(JC.get_reduced(name))
    params = jm.init(jax.random.PRNGKey(0))
    tm = params_from_numpy(Model(TC.get_reduced(name), device="cpu"),
                           jax.tree.map(np.asarray, params))
    toks = np.random.default_rng(len(name)).integers(0, jm.cfg.vocab_size, (B, S + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
    return name, jm, params, tm, batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("cf", [None, 0.5])
def test_forward_and_aux_match_reference(built, cf):
    """Logits and the layers' mean aux metrics; at cf = 0.5 (the model's
    groups of 32 tokens drop choices) the same ``moe_dropped``."""
    name, jm, params, tm, batch = built
    if cf is not None:
        jm = JModel(dataclasses.replace(jm.cfg, capacity_factor=cf))
        tm.cfg = dataclasses.replace(tm.cfg, capacity_factor=cf)
    try:
        jlogits, jaux = jax.jit(jm.forward)(params, _jb(batch))
        with torch.no_grad():
            logits, aux = tm(_tb(batch))
    finally:
        tm.cfg = TC.get_reduced(name)
    assert _rel(logits.numpy(), jlogits) <= 1e-5
    assert set(aux) == set(jaux) == {"moe_aux_loss", "moe_z_loss", "moe_dropped"}
    for k in jaux:
        assert abs(float(aux[k]) - float(jaux[k])) <= 1e-5 * max(1.0, abs(float(jaux[k]))), k
    assert (float(aux["moe_dropped"]) > 0) == (cf == 0.5)
    assert float(aux["moe_dropped"]) == pytest.approx(float(jaux["moe_dropped"]), abs=1e-7)


def test_loss_and_gradients_match_reference(built):
    """``Model.loss`` (the nll plus the aux and z terms) and every gradient
    leaf (the router's through the gates and the aux terms) against
    ``jax.value_and_grad`` of the reference's."""
    _, jm, params, tm, batch = built
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, _jb(batch))
    tree = tm.param_tree()
    paths = [p for p, _ in leaves_with_paths(tree)]
    for p in tm.parameters():
        p.requires_grad_(True)
    try:
        loss, metrics = tm.loss(_tb(batch))
        grads = torch.autograd.grad(loss, [leaf for _, leaf in leaves_with_paths(tree)])
    finally:
        for p in tm.parameters():
            p.requires_grad_(False)
    assert set(metrics) == set(jmetrics) == {"nll", "loss", "moe_aux_loss", "moe_z_loss",
                                             "moe_dropped"}
    assert float(loss.detach()) > float(metrics["nll"])
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = _named(jgrads)
    assert set(want) == {"/".join(p) for p in paths}
    for path, g in zip(paths, grads):
        w = want["/".join(path)]
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * float(np.abs(w).max()), path


def test_train_steps_match_reference(built):
    """Three AdamW steps of both packages from the same train state."""
    name, jm, _, _, batch = built
    jcfg = JOptimizerConfig(**OPT)
    jstate = j_init_state(jm, jcfg, jax.random.PRNGKey(0))
    tm = Model(TC.get_reduced(name), device="cpu")
    cfg = OptimizerConfig(**OPT)
    tstate = state_from_numpy(tm, cfg, jax.tree.map(np.asarray, jstate))
    jstep, tstep = jax.jit(j_make_train_step(jm, jcfg)), make_train_step(tm, cfg)
    for _ in range(3):
        jstate, jmet = jstep(jstate, _jb(batch))
        tstate, tmet = tstep(tstate, _tb(batch))
        assert set(tmet) == set(jmet)
        for k in ("loss", "nll", "moe_aux_loss", "moe_z_loss", "grad_norm"):
            assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-5 * abs(float(jmet[k])), k
    want, got = _named(jstate["params"]), _named(tstate["params"])
    assert max(float(np.abs(got[k] - want[k]).max()) for k in want) <= 1e-4


def test_prefill_and_decode_match_reference(built):
    """Prefill of 24 tokens into a 32-slot cache, then 8 teacher-forced
    decode steps (groups of one token), against the reference's
    DecodeEngine; every cache leaf too; and the decode steps reproduce the
    port's own forward (no choice is dropped at the reduced cf = 8)."""
    _, jm, params, tm, batch = built
    toks = batch["tokens"]
    jeng, eng = JDecodeEngine(jm), DecodeEngine(tm)
    jlogits, jcache = jax.jit(lambda p, b: jeng.prefill(p, b, max_len=S))(
        params, {"tokens": jnp.asarray(toks[:, :PROMPT])})
    with torch.no_grad():
        full, _ = tm({"tokens": torch.from_numpy(toks)})
        logits, cache = eng.prefill(tm, {"tokens": torch.from_numpy(toks[:, :PROMPT])},
                                    max_len=S)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
        step = jax.jit(jeng.decode_step)
        for t in range(PROMPT, S):
            jl, jcache = step(params, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1])})
            lt, cache = eng.decode_step(tm, cache, {"tokens": torch.from_numpy(toks[:, t:t + 1])})
            np.testing.assert_allclose(lt.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(lt[:, 0].numpy(), full[:, t].numpy(), rtol=1e-4,
                                       atol=1e-4)
    assert sorted(cache) == sorted(jcache) == ["cur", "k", "v"]
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", JC.ARCHS)
def test_param_counts_of_the_full_configs(name):
    """``param_count`` and ``active_param_count`` of each full config, from
    ``param_layout`` alone, equal the reference's ``num_params`` and
    ``num_active_params`` (the experts counted k / E); names and shapes
    equal its ``param_shapes``."""
    jm = JModel(JC.get(name))
    cfg = TC.get(name)
    want = {"/".join(str(k.key) for k in path): tuple(s.shape)
            for path, s in jax.tree_util.tree_flatten_with_path(jm.param_shapes())[0]}
    got = {"/".join(p): tuple(v.shape)
           for p, v in leaves_with_paths(model_lib.param_shapes(cfg))}
    assert got == want
    assert model_lib.param_count(cfg) == jm.num_params()
    assert model_lib.active_param_count(cfg) == jm.num_active_params()
    assert (model_lib.active_param_count(cfg) < model_lib.param_count(cfg)) == (cfg.family == "moe")
