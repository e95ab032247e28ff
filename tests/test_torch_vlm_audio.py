"""The port's vlm (llama-3.2-vision) and audio (musicgen) families against the
JAX package's, on the CPU, from the same seeded numpy inputs.

The vision model's ``cross_blocks.gate`` starts at zero, and tanh(0) = 0
switches its cross-attention off, so every comparison here runs with the
gates set to seeded non-zero values in the numpy tree that feeds both
packages; zeroed image embeddings must then move the logits past the
forward's tolerance.  On the reduced configs (float32): forward logits
within 1e-5 relative, the loss within 1e-5 relative, every gradient leaf
within 1e-5 of its largest magnitude (musicgen's ``embed``, which frame
inputs never read, gets zeros in both), three AdamW steps (musicgen's
``embed`` decays alike), prefill and decode against the reference's
``DecodeEngine`` within 1e-4 (the image K/V cache too), greedy generation
against ``examples/serve_lm.py``'s loop (musicgen fed a seeded frame a
step), and the loader's frame and image embeddings bit-equal to the
reference's.

After three AdamW steps the parameters are held to 1e-4, as in
``tests/test_torch_train.py``, and musicgen's to 3e-4, as zamba2-7b's are
there, for the same cause: they differ by up to 1.05e-4 at one element of
``blocks/attn/wo`` whose gradient is -1.0e-8, the size of AdamW's ``eps``
(2e-7 of the leaf's largest, below the 1e-5 the gradients are held to),
where float32 rounding of g moves g / (|g| + eps); the first and second
moments there differ by 5e-4 and 1e-3 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.data.loader import LoaderConfig as JLoaderConfig
from repro.data.loader import SyntheticLMLoader as JLoader
from repro.models import DecodeEngine as JDecodeEngine
from repro.models import Model as JModel
from repro.train import OptimizerConfig as JOptimizerConfig
from repro.train import make_train_step as j_make_train_step
from repro.train import optimizer as jopt
from repro_torch import configs as TC
from repro_torch.data.loader import LoaderConfig, SyntheticLMLoader
from repro_torch.kernels import ops
from repro_torch.models import DecodeEngine, Model
from repro_torch.models.convert import params_from_numpy, state_from_numpy
from repro_torch.models.generate import greedy_generate, main as generate_main
from repro_torch.models.model import attention_applications, num_cross_layers
from repro_torch.train import OptimizerConfig, make_train_step
from repro_torch.train.tree import leaves_with_paths

ARCHS = ["llama-3.2-vision-11b", "musicgen-medium"]
B, PROMPT, S = 2, 24, 32
OPT = dict(learning_rate=3e-3, warmup_steps=2, decay_steps=10)
TOL = dict(rtol=1e-4, atol=1e-4)
STEP_TOL = {"musicgen-medium": 3e-4}   # parameters after three AdamW steps (docstring)


def _named(tree) -> dict:
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        return {"/".join(p): v.detach().numpy() for p, v in leaves_with_paths(tree)}
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(got, want) -> float:
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(np.asarray(got, dtype=np.float64) - want).max() / np.abs(want).max())


def _np_params(jm, seed=0):
    """The reference's seeded parameters as numpy, the vision gates set to
    seeded non-zero values."""
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    if "cross_blocks" in params:
        gate = params["cross_blocks"]["gate"]
        params["cross_blocks"]["gate"] = np.random.default_rng(seed + 11).uniform(
            0.5, 1.5, gate.shape).astype(np.float32) * np.array([1, -1] * gate.size)[:gate.size]
    return params


def _batch(cfg, seed=1, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, s + 1)).astype(np.int32)
    batch = {"labels": toks[:, 1:]}
    if cfg.frame_inputs:
        batch["frame_embeds"] = rng.normal(size=(B, s, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = toks[:, :-1]
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.normal(
            size=(B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def built(request):
    name = request.param
    jm = JModel(JC.get_reduced(name))
    np_params = _np_params(jm)
    tm = params_from_numpy(Model(TC.get_reduced(name), device="cpu"), np_params)
    return name, jm, jax.tree.map(jnp.asarray, np_params), tm, _batch(jm.cfg)


def test_forward_matches_reference(built):
    name, jm, params, tm, batch = built
    if name.startswith("llama"):
        assert np.all(np.asarray(params["cross_blocks"]["gate"]) != 0)
        assert torch.equal(tm.cross_blocks.gate, torch.from_numpy(
            np.array(params["cross_blocks"]["gate"])))
    jlogits, jaux = jax.jit(jm.forward)(params, _jb(batch))
    with torch.no_grad():
        logits, aux = tm(_tb(batch))
    assert aux == {} and jaux == {}
    assert logits.shape == (B, S, tm.cfg.vocab_size)
    assert _rel(logits.numpy(), jlogits) <= 1e-5
    if name.startswith("llama"):
        # The control: the same tokens against zeroed image embeddings.
        dark = dict(batch, image_embeds=np.zeros_like(batch["image_embeds"]))
        with torch.no_grad():
            moved, _ = tm(_tb(dark))
        assert _rel(moved.numpy(), jlogits) > 1e-2


def test_vision_layout_and_schedule():
    """n_cross cross layers (gate zeros at init, a 1-D leaf) after every
    cross_attn_every self layers; attention runs once a layer of either
    kind; the full config's cache shape for the image K/V."""
    cfg = TC.get_reduced("llama-3.2-vision-11b")
    tm = Model(cfg, device="cpu")
    n_cross = num_cross_layers(cfg)
    assert (n_cross, cfg.cross_attn_every) == (2, 2)
    assert torch.equal(tm.cross_blocks.gate, torch.zeros(n_cross))
    assert tm.blocks.attn.wq.shape[0] == cfg.num_layers - n_cross
    assert attention_applications(cfg) == cfg.num_layers
    full = TC.get("llama-3.2-vision-11b")
    assert (num_cross_layers(full), attention_applications(full)) == (8, 40)
    cache = DecodeEngine(tm).init_cache(3, 10)
    assert cache["img_k"].shape == (n_cross, 3, cfg.num_image_tokens, cfg.num_kv_heads,
                                    cfg.head_dim)
    assert cache["k"].shape[0] == cfg.num_layers - n_cross


def test_loss_and_gradients_match_reference(built):
    name, jm, params, tm, batch = built
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, _jb(batch))
    tree = tm.param_tree()
    paths = [p for p, _ in leaves_with_paths(tree)]
    for p in tm.parameters():
        p.requires_grad_(True)
    try:
        loss, metrics = tm.loss(_tb(batch))
        grads = torch.autograd.grad(loss, [leaf for _, leaf in leaves_with_paths(tree)],
                                    allow_unused=True, materialize_grads=True)
    finally:
        for p in tm.parameters():
            p.requires_grad_(False)
    assert set(metrics) == set(jmetrics) == {"nll", "loss"}
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = _named(jgrads)
    assert set(want) == {"/".join(p) for p in paths}
    for path, g in zip(paths, grads):
        w = want["/".join(path)]
        if not np.abs(w).max():      # musicgen's embed: frame inputs never read it
            assert name.startswith("musicgen") and path == ("embed",)
            assert not g.abs().max()
            continue
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * float(np.abs(w).max()), path


def test_train_steps_match_reference(built):
    """Three AdamW steps of both packages from the same train state: the
    port's step gives musicgen's unread embed zero gradients, so weight
    decay moves it as the reference's does."""
    name, jm, params, _, batch = built
    jcfg = JOptimizerConfig(**OPT)
    jstate = {"step": jnp.zeros((), jnp.int32), "params": params,
              "opt": jopt.opt_init(jcfg, params)}
    tm = Model(TC.get_reduced(name), device="cpu")
    cfg = OptimizerConfig(**OPT)
    tstate = state_from_numpy(tm, cfg, jax.tree.map(np.asarray, jstate))
    jstep, tstep = jax.jit(j_make_train_step(jm, jcfg)), make_train_step(tm, cfg)
    embed0 = tm.embed.detach().clone()
    for _ in range(3):
        jstate, jmet = jstep(jstate, _jb(batch))
        tstate, tmet = tstep(tstate, _tb(batch))
        assert set(tmet) == set(jmet)
        for k in ("loss", "grad_norm"):
            assert abs(float(tmet[k]) - float(jmet[k])) <= 1e-5 * abs(float(jmet[k])), k
    want, got = _named(jstate["params"]), _named(tstate["params"])
    assert max(float(np.abs(got[k] - want[k]).max()) for k in want) <= STEP_TOL.get(name, 1e-4)
    if name.startswith("musicgen"):
        assert not torch.equal(tm.embed.detach(), embed0)
        np.testing.assert_allclose(got["embed"], want["embed"], rtol=0, atol=1e-6)


def _prefill_batch(batch):
    return {k: (v if k == "image_embeds" else v[:, :PROMPT]) for k, v in batch.items()
            if k != "labels"}


def _step_batch(batch, t):
    return {k: v[:, t:t + 1] for k, v in batch.items() if k in ("tokens", "frame_embeds")}


def test_prefill_and_decode_match_reference(built):
    """Prefill of 24 positions into a 32-slot cache, then 8 teacher-forced
    decode steps (tokens, or frames), against the reference's DecodeEngine
    and the port's own forward; every cache leaf, the image K/V included."""
    _, jm, params, tm, batch = built
    jeng, eng = JDecodeEngine(jm), DecodeEngine(tm)
    jlogits, jcache = jax.jit(lambda p, b: jeng.prefill(p, b, max_len=S))(
        params, _jb(_prefill_batch(batch)))
    with torch.no_grad():
        full, _ = tm(_tb(batch))
        logits, cache = eng.prefill(tm, _tb(_prefill_batch(batch)), max_len=S)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        step = jax.jit(jeng.decode_step)
        for t in range(PROMPT, S):
            jl, jcache = step(params, jcache, _jb(_step_batch(batch, t)))
            lt, cache = eng.decode_step(tm, cache, _tb(_step_batch(batch, t)))
            np.testing.assert_allclose(lt.numpy(), np.asarray(jl), **TOL, err_msg=f"step {t}")
            np.testing.assert_allclose(lt[:, 0].numpy(), full[:, t].numpy(), **TOL)
    assert sorted(cache) == sorted(jcache)
    for k in jcache:
        np.testing.assert_allclose(np.asarray(cache[k]), np.asarray(jcache[k]), **TOL, err_msg=k)


def test_greedy_generate_matches_the_reference_loop(built):
    """``examples/serve_lm.py``'s loop in the JAX package against
    ``greedy_generate``: the vision model with its image embeddings, the
    audio model fed one seeded frame a decode step."""
    _, jm, params, tm, batch = built
    gen = 6
    jeng = JDecodeEngine(jm)
    pre = _prefill_batch(batch)
    jlogits, jcache = jax.jit(lambda p, b: jeng.prefill(p, b, max_len=PROMPT + gen))(
        params, _jb(pre))
    tok = jnp.argmax(jlogits[:, -1:], axis=-1).astype(jnp.int32)
    want = [tok]
    step = jax.jit(jeng.decode_step)
    for t in range(gen - 1):
        sb = ({"frame_embeds": jnp.asarray(batch["frame_embeds"][:, PROMPT + t:PROMPT + t + 1])}
              if jm.cfg.frame_inputs else {"tokens": tok})
        jl, jcache = step(params, jcache, sb)
        tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        want.append(tok)
    tb = _tb(batch)
    if jm.cfg.frame_inputs:
        out = greedy_generate(DecodeEngine(tm), None, gen,
                              frame_embeds=tb["frame_embeds"][:, :PROMPT + gen - 1])
    else:
        out = greedy_generate(DecodeEngine(tm), tb["tokens"][:, :PROMPT], gen,
                              image_embeds=tb["image_embeds"])
    assert out.tokens.tolist() == np.asarray(jnp.concatenate(want, axis=1)).tolist()


def test_remat_recomputes_the_self_layers_only(monkeypatch):
    """With remat the vision model's train step runs each self layer's
    attention twice (the forward and the recomputation) and each cross
    layer's once, as the reference checkpoints its self layers alone; the
    backward runs once a layer; the gradients equal those without remat."""
    cfg = TC.get_reduced("llama-3.2-vision-11b")
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ops.flash_attention, ops.flash_attention_bwd

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(ops, "flash_attention", count("fwd", fwd))
    monkeypatch.setattr(ops, "flash_attention_bwd", count("bwd", bwd))
    batch = _tb(_batch(cfg))
    grads = []
    for remat in (False, True):
        tm = params_from_numpy(Model(TC.get_reduced("llama-3.2-vision-11b", remat=remat),
                                     device="cpu"), _np_params(JModel(JC.get_reduced(
                                         "llama-3.2-vision-11b"))))
        for p in tm.parameters():
            p.requires_grad_(True)
        calls.update(fwd=0, bwd=0)
        loss, _ = tm.loss(batch)
        grads.append(torch.autograd.grad(loss, list(tm.parameters())))
        n_cross = num_cross_layers(cfg)
        n_self = cfg.num_layers - n_cross
        assert calls == {"fwd": (2 if remat else 1) * n_self + n_cross, "bwd": cfg.num_layers}
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ARCHS)
def test_loader_batches_are_the_references(name):
    """Frame and image embeddings from the loader, bit for bit the
    reference's bf16 arrays (tokens, then frames, then images drawn from
    one generator), as bf16 tensors; labels equal too."""
    lc = dict(batch_size=2, seq_len=12, seed=3)
    jl = JLoader(JC.get_reduced(name), JLoaderConfig(**lc))
    tl = SyntheticLMLoader(TC.get_reduced(name), LoaderConfig(**lc), device="cpu")
    for step in range(2):
        want = jl._host_batch(step)
        got = tl.host_batch(step)
        assert set(got) == set(want)
        for k in want:
            w = np.asarray(want[k])
            if k.endswith("_embeds"):
                assert got[k].dtype == torch.bfloat16 and str(w.dtype) == "bfloat16"
                np.testing.assert_array_equal(got[k].float().numpy(), w.astype(np.float32))
            else:
                np.testing.assert_array_equal(got[k].numpy(), w)
    batch = next(tl)
    assert batch["labels"].dtype == torch.int32
    assert all(v.dtype == torch.bfloat16 for k, v in batch.items() if k.endswith("_embeds"))


@pytest.mark.parametrize("name", ARCHS)
def test_generate_cli_runs_on_the_cpu(name, capsys):
    assert generate_main([name, "--device", "cpu"]) == 0
    assert f"{name}-smoke on cpu" in capsys.readouterr().out
