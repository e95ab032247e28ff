"""The port's LM serving path against the JAX package's, on the CPU.

For the dense, ssm and hybrid configs at reduced size (float32 compute), the JAX
package's parameters (``Model(cfg).init(PRNGKey(0))``) are carried into the
port by ``params_from_numpy``; ``Model.forward``, ``DecodeEngine.prefill``
and teacher-forced ``decode_step`` logits must then equal the reference's
at rtol = atol = 1e-4 (float32 matmuls summed in another order), and
greedy generation must pick the same tokens; every cache leaf (the KV
caches, the Mamba2 layers' conv and SSM states, the hybrid family's shared
K/V) must equal the reference's at the same tolerance.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.models import DecodeEngine as JDecodeEngine
from repro.models import Model as JModel
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.models import DecodeEngine, Model, ModelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.generate import greedy_generate, main as generate_main
from repro_torch.models.model import param_count

TOL = dict(rtol=1e-4, atol=1e-4)
B, PROMPT, S = 2, 24, 32
# The token-input archs without aux metrics (dense, ssm, hybrid); the moe,
# vlm and audio archs are held to the reference in tests/test_torch_moe.py
# and tests/test_torch_vlm_audio.py.
TOKEN_ARCHS = ["smollm-135m", "qwen3-8b", "minitron-8b", "internlm2-20b", "zamba2-7b",
               "mamba2-2.7b"]


def _leaves(tree, prefix=""):
    """``{"a.b": leaf}`` of a nested cache dict."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_leaves(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = val
    return out


@pytest.fixture(scope="module")
def built():
    out = {}
    for name in TOKEN_ARCHS:
        jcfg = jconfigs.get_reduced(name)
        jmodel = JModel(jcfg)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        model = params_from_numpy(Model(configs.get_reduced(name), device="cpu"),
                                  jax.tree.map(np.asarray, jparams))
        tokens = np.random.default_rng(len(name)).integers(
            0, jcfg.vocab_size, (B, S)).astype(np.int32)
        out[name] = (jmodel, jparams, model, tokens)
    return out


@pytest.mark.parametrize("name", configs.ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_equal_the_reference(name, reduced):
    get = "get_reduced" if reduced else "get"
    assert (dataclasses.asdict(getattr(configs, get)(name))
            == dataclasses.asdict(getattr(jconfigs, get)(name)))


def test_all_configs_equal_the_reference():
    got, want = configs.all_configs(), jconfigs.all_configs()
    assert list(got) == list(want) == configs.ARCHS
    assert {n: dataclasses.asdict(c) for n, c in got.items()} == {
        n: dataclasses.asdict(c) for n, c in want.items()}


@pytest.mark.parametrize("name", configs.ARCHS)
def test_param_counts_equal_the_reference(name):
    assert param_count(configs.get(name)) == JModel(jconfigs.get(name)).num_params()
    reduced = configs.get_reduced(name)
    assert Model(reduced, device="cpu").num_params() == param_count(reduced)


@pytest.mark.parametrize("name", TOKEN_ARCHS)
def test_forward_matches_reference(built, name):
    jmodel, jparams, model, tokens = built[name]
    want, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(tokens)})
    got, aux = model({"tokens": torch.from_numpy(tokens)})
    assert got.shape == (B, S, model.cfg.vocab_size) and aux == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", TOKEN_ARCHS)
def test_prefill_and_decode_match_reference(built, name):
    """Prefill of a 24-token prompt (not a power of two) into a 32-slot
    cache, then 8 teacher-forced decode steps, against the reference's
    DecodeEngine at each step; the cache matches too."""
    jmodel, jparams, model, tokens = built[name]
    jeng, eng = JDecodeEngine(jmodel), DecodeEngine(model)
    jlogits, jcache = jax.jit(lambda p, b: jeng.prefill(p, b, max_len=S))(
        jparams, {"tokens": jnp.asarray(tokens[:, :PROMPT])})
    logits, cache = eng.prefill(model, {"tokens": torch.from_numpy(tokens[:, :PROMPT])},
                                max_len=S)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    last, _ = eng.prefill(model, {"tokens": torch.from_numpy(tokens[:, :PROMPT])},
                          max_len=S, last_only=True)
    np.testing.assert_allclose(last.numpy(), logits[:, -1:].numpy(), **TOL)
    step = jax.jit(jeng.decode_step)
    for t in range(PROMPT, S):
        jl, jcache = step(jparams, jcache, {"tokens": jnp.asarray(tokens[:, t:t + 1])})
        lt, cache = eng.decode_step(model, cache, {"tokens": torch.from_numpy(tokens[:, t:t + 1])})
        np.testing.assert_allclose(lt.numpy(), np.asarray(jl), **TOL, err_msg=f"step {t}")
    assert cache["cur"].tolist() == np.asarray(jcache["cur"]).tolist() == [S] * B
    got, want = _leaves(cache), _leaves(jcache)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL, err_msg=key)


@pytest.mark.parametrize("name", TOKEN_ARCHS)
def test_greedy_generate_matches_the_reference_loop(built, name):
    """examples/serve_lm.py's loop (prefill, argmax, gen - 1 decode steps)
    in the JAX package against ``greedy_generate``."""
    jmodel, jparams, model, tokens = built[name]
    gen = 6
    jeng = JDecodeEngine(jmodel)
    prompt = jnp.asarray(tokens[:, :PROMPT])
    jlogits, jcache = jax.jit(lambda p, b: jeng.prefill(p, b, max_len=PROMPT + gen))(
        jparams, {"tokens": prompt})
    tok = jnp.argmax(jlogits[:, -1:], axis=-1).astype(jnp.int32)
    want, want_logits = [tok], [jlogits[:, -1]]
    step = jax.jit(jeng.decode_step)
    for _ in range(gen - 1):
        jl, jcache = step(jparams, jcache, {"tokens": tok})
        tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        want.append(tok)
        want_logits.append(jl[:, -1])
    out = greedy_generate(DecodeEngine(model), torch.from_numpy(tokens[:, :PROMPT]), gen)
    assert out.tokens.dtype == torch.int32 and len(out.logits) == gen
    assert out.tokens.tolist() == np.asarray(jnp.concatenate(want, axis=1)).tolist()
    assert out.prefill_s > 0 and out.decode_s > 0
    for g, w in zip(out.logits, want_logits):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("name", TOKEN_ARCHS)
def test_decode_matches_forward_teacher_forced(built, name):
    """The port's own cache check: decode steps reproduce the forward pass."""
    _, _, model, tokens = built[name]
    t = torch.from_numpy(tokens)
    ref, _ = model({"tokens": t})
    eng = DecodeEngine(model)
    logits, cache = eng.prefill(model, {"tokens": t[:, :PROMPT]}, max_len=S, last_only=True)
    np.testing.assert_allclose(logits[:, 0].numpy(), ref[:, PROMPT - 1].numpy(), **TOL)
    for i in range(PROMPT, S):
        logits, cache = eng.decode_step(model, cache, {"tokens": t[:, i:i + 1]})
        np.testing.assert_allclose(logits[:, 0].numpy(), ref[:, i].numpy(), **TOL)


def test_seeded_init_is_reproducible_and_follows_the_layout():
    cfg = configs.get_reduced("qwen3-8b")
    a = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    c = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.embed, c.embed)
    assert torch.equal(a.blocks.attn.q_norm, torch.ones(cfg.num_layers, cfg.head_dim))
    std = a.blocks.mlp.w_down.std().item() * cfg.d_ff ** 0.5
    assert 0.9 < std < 1.1
    assert not any(p.requires_grad for p in a.parameters())


@pytest.mark.parametrize("name", ["mamba2-2.7b", "zamba2-7b"])
def test_ssm_and_hybrid_init_follow_the_reference_layout(name):
    """The reference's ``Model.init``: a_log and dt_bias zeros, d_skip and
    the norm scales ones, the shared block's leaves with a leading dim of 1,
    the projections N(0, 1 / fan); the flash attention runs once a group."""
    from repro_torch.models.model import attention_applications, param_layout

    cfg = configs.get_reduced(name)
    model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    mamba = model.blocks.mamba
    assert torch.equal(mamba.a_log, torch.zeros(cfg.num_layers, cfg.ssm_heads))
    assert torch.equal(mamba.dt_bias, torch.zeros(cfg.num_layers, cfg.ssm_heads))
    assert torch.equal(mamba.d_skip, torch.ones(cfg.num_layers, cfg.ssm_heads))
    assert torch.equal(mamba.norm, torch.ones(cfg.num_layers, cfg.ssm_inner))
    assert torch.equal(model.blocks.norm, torch.ones(cfg.num_layers, cfg.d_model))
    assert 0.8 < float(mamba.w_out.std()) * cfg.ssm_inner ** 0.5 < 1.2
    assert param_layout(cfg)["blocks.mamba.conv_x"] == ((cfg.num_layers, 4, cfg.ssm_inner), 4)
    if name == "zamba2-7b":
        assert model.shared_attn.attn.wq.shape == (1, cfg.d_model, cfg.attn_dim)
        assert [i for i in range(cfg.num_layers) if model.shared_before(i)] == [0, 2]
        assert attention_applications(cfg) == 2
        assert attention_applications(configs.get(name)) == 13
    else:
        assert not hasattr(model, "shared_attn") and attention_applications(cfg) == 0


@pytest.mark.parametrize("name", ["mamba2-2.7b", "zamba2-7b"])
def test_generate_cli_runs_the_ssm_and_hybrid_families_on_the_cpu(name, capsys):
    assert generate_main([name, "--device", "cpu"]) == 0
    assert f"{name}-smoke on cpu" in capsys.readouterr().out


def test_entry_points_run_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_reduced("smollm-135m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_main(["smollm-135m"])
    assert Model(cfg, device="cpu").device == torch.device("cpu")


def test_generate_cli_runs_on_the_cpu(capsys):
    assert generate_main(["smollm-135m", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "smollm-135m-smoke on cpu" in out and "greedy-decoded 16 tokens" in out


def test_shapes_equal_the_reference():
    assert ({n: dataclasses.asdict(sp) for n, sp in shapes.SHAPES.items()}
            == {n: dataclasses.asdict(sp) for n, sp in jshapes.SHAPES.items()})
    for name in configs.ARCHS:
        for shape in shapes.SHAPES:
            assert (shapes.shape_applicable(configs.get(name), shape)
                    == jshapes.shape_applicable(jconfigs.get(name), shape))


@pytest.mark.parametrize("name", ["zamba2-7b", "phi3.5-moe-42b-a6.6b", "arctic-480b",
                                  "mamba2-2.7b", "llama-3.2-vision-11b", "musicgen-medium"])
def test_unported_archs_name_their_roadmap_item(name):
    """The reference's six non-dense archs, which the port once lacked, are
    all registered now, in the reference's order, and equal its configs
    (full and reduced); a model of each builds on the CPU."""
    assert configs.ARCHS == jconfigs.ARCHS and not hasattr(configs, "NOT_PORTED")
    for get in ("get", "get_reduced"):
        assert (dataclasses.asdict(getattr(configs, get)(name))
                == dataclasses.asdict(getattr(jconfigs, get)(name)))
    assert Model(configs.get_reduced(name), device="cpu").cfg.family == jconfigs.get(name).family


def test_other_families_and_bad_trees_raise():
    """Every family of the reference builds; an unknown one raises, and so do
    parameter trees with a missing or misshapen leaf."""
    moe = ModelConfig(name="m", family="moe", num_layers=1, d_model=8, d_ff=8, vocab_size=8,
                      num_heads=2, num_kv_heads=1, head_dim=4, num_experts=2,
                      experts_per_token=1)
    assert Model(moe, device="cpu").blocks.moe.w_gate.shape == (1, 2, 8, 8)
    with pytest.raises(ValueError, match="unknown family 'rnn'"):
        Model(dataclasses.replace(moe, family="rnn"), device="cpu")
    model = Model(configs.get_reduced("smollm-135m"), device="cpu")
    tree = {n: p.numpy() for n, p in model.named_parameters() if "." not in n}
    with pytest.raises(KeyError, match="missing"):
        params_from_numpy(model, tree)
    tree = {"embed": np.zeros((3, 3), np.float32), "final_norm": model.final_norm.numpy(),
            "blocks": {n.split(".", 1)[1]: p.numpy() for n, p in model.named_parameters()
                       if n.startswith("blocks.") and n.count(".") == 1}}
    tree["blocks"]["attn"] = {n: p.numpy() for n, p in model.blocks.attn.named_parameters()}
    tree["blocks"]["mlp"] = {n: p.numpy() for n, p in model.blocks.mlp.named_parameters()}
    with pytest.raises(ValueError, match="embed: shape"):
        params_from_numpy(model, tree)
