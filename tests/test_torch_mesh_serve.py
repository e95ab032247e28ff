"""The port's sharded serving (``models/decode.py``: ``sharded_prefill``,
``sharded_decode_step``) on 4 gloo ranks against the JAX package's
single-device ``DecodeEngine``.

Reduced dense configs in float32, the JAX package's seeded parameters
carried into both packages, a global batch of 4 prompts of 12 tokens and 4
teacher-forced decode steps (seeded tokens, so no argmax tie can fork the
two).  Each rank serves from its slices (``convert.shards_from_numpy``) and
its rows of the batch, over the meshes and head counts that give every
layout:

* ``heads_tp4``: (1, 4), 8 / 4 heads: head-parallel q, k, v; the cache's KV
  heads over TP;
* ``q_heads_hd_tp4``: (1, 4), 4 / 2 heads: q head-parallel, k and v every
  KV head; the cache's head dim over TP (the MHA fallback: partial scores
  summed over TP before the softmax);
* ``heads_2x2``: (2, 2): rows over ``data``, heads over ``model``;
* ``replicated_hd_2x2``: (2, 2), 3 / 1 heads and a vocabulary of 255:
  the prefill's attention split over the q sequence (``q_sequence``), the
  decode's replicated over TP, the head-dim cache, the head gathered whole;
* ``q_heads_whole_tp4``: (1, 4), 4 / 1 heads of 18 and d_ff 130: q
  head-parallel, a cache whole on every TP rank, the MLP replicated;
* ``fsdp_4x1``: (4, 1), reduced smollm-135m (tied embeddings): FSDP only.

Held to: every step's logits (each rank's rows and vocabulary slice) within
``LOGITS_TOL`` of the JAX package's (largest difference measured on this
CPU: under 2e-6); each rank's cache shard (K, V after the last step, and the
whole ``cur``) equal to the single-device cache's slice under
``cache_specs`` within the same tolerance; ``last_only`` within 1e-5 of
the last position of the full prefill (the head's product over one row
rounds apart from the product over all of them).  Under ``seq_parallel`` (the residual's
sequence over TP between blocks) on (2, 2): the loss and every gradient
equal the path without it (``SP_TOL``), and so do the prefill's logits.
"""

import numpy as np
import pytest

import _torch_mesh as tm
import jax
import jax.numpy as jnp
from repro import configs as JC
from repro.models import DecodeEngine as JDecodeEngine
from repro.models import Model as JModel

B, S, GEN = 4, 12, 4
LOGITS_TOL = 1e-4
SP_TOL = 1e-5
# name: (arch, config overrides, mesh shape, mesh axes)
CASES = {
    "heads_tp4": ("qwen3-8b", {"num_heads": 8, "num_kv_heads": 4}, (1, 4), ("data", "model")),
    "q_heads_hd_tp4": ("qwen3-8b", {}, (1, 4), ("data", "model")),
    "heads_2x2": ("qwen3-8b", {}, (2, 2), ("data", "model")),
    "replicated_hd_2x2": ("qwen3-8b", {"num_heads": 3, "num_kv_heads": 1, "vocab_size": 255},
                          (2, 2), ("data", "model")),
    "q_heads_whole_tp4": ("qwen3-8b", {"num_kv_heads": 1, "head_dim": 18, "d_ff": 130},
                          (1, 4), ("data", "model")),
    "fsdp_4x1": ("smollm-135m", {}, (4, 1), ("data", "model")),
}
# The cache layout each case must produce: (KV heads over TP, head dim over TP).
LAYOUT = {"heads_tp4": ("model", None), "q_heads_hd_tp4": (None, "model"),
          "heads_2x2": ("model", None), "replicated_hd_2x2": (None, "model"),
          "q_heads_whole_tp4": (None, None), "fsdp_4x1": (None, None)}
PARTITION = {"heads_tp4": "heads", "q_heads_hd_tp4": "q_heads", "heads_2x2": "heads",
             "replicated_hd_2x2": "q_sequence", "q_heads_whole_tp4": "q_heads",
             "fsdp_4x1": "heads"}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, dtype=np.float32)
    return out


_PORT = tm.PORT_PRELUDE + r"""
from repro_torch import configs
from repro_torch.distributed.sharding import activation_sharding, attn_partition, layout_of
from repro_torch.models.convert import shards_from_numpy
from repro_torch.models.decode import cache_specs, sharded_decode_step, sharded_prefill
from repro_torch.models.model import nest, param_specs, sharded_loss
from repro_torch.train.tree import leaves

CASES = %r
B, S, GEN = %d, %d, %d
for name, (arch, over, shape, axes) in CASES.items():
    cfg = configs.get_reduced(arch, **over)
    data = np.load(os.environ["OUT"].rsplit("/", 1)[0] + f"/in_{name}.npz")
    params = nest((k[len("params."):], data[k]) for k in data.files if k.startswith("params."))
    mesh = make_mesh(shape, axes, device_type="cpu")
    layout = layout_of(mesh)
    n, i = layout.size(("data",)), layout.index(("data",))
    rows = slice(i * B // n, (i + 1) * B // n)
    specs = param_specs(cfg, mesh)
    p = shards_from_numpy(cfg, params, mesh, device="cpu")
    tok = torch.from_numpy(data["prompt"][rows])
    steps = [torch.from_numpy(data["steps"][rows, t:t + 1]) for t in range(GEN)]
    with torch.no_grad(), activation_sharding(mesh):
        RES[name + "/partition"] = np.array(attn_partition(cfg.num_heads, cfg.num_kv_heads).case)
        logits, cache = sharded_prefill(cfg, p, specs, {"tokens": tok}, max_len=S + GEN)
        last, _ = sharded_prefill(cfg, p, specs, {"tokens": tok}, max_len=S + GEN,
                                  last_only=True)
        RES[name + "/last_only"] = last.numpy()
        RES[name + "/logits0"] = logits.numpy()
        for t in range(GEN):
            logits, cache = sharded_decode_step(cfg, p, specs, cache, {"tokens": steps[t]})
            RES[name + f"/logits{t + 1}"] = logits.numpy()
    for leaf in ("k", "v", "cur"):
        RES[f"{name}/cache/{leaf}"] = cache[leaf].numpy()
    RES[name + "/coord"] = np.array([layout.coord[a] for a in axes])
    RES[name + "/cache_spec"] = np.array(repr(tuple(cache_specs(cfg, mesh, B)["k"])))

# seq_parallel: the loss, its gradients and the prefill against the path without it.
cfg = configs.get_reduced("qwen3-8b")
data = np.load(os.environ["OUT"].rsplit("/", 1)[0] + "/in_heads_2x2.npz")
params = nest((k[len("params."):], data[k]) for k in data.files if k.startswith("params."))
mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
layout = layout_of(mesh)
i = layout.index(("data",))
rows = slice(i * B // 2, (i + 1) * B // 2)
specs = param_specs(cfg, mesh)
batch = {"tokens": torch.from_numpy(data["prompt"][rows]),
         "labels": torch.from_numpy(data["labels"][rows])}
count = torch.tensor(float(B * S))
for sp in (False, True):
    p = shards_from_numpy(cfg, params, mesh, device="cpu")
    with activation_sharding(mesh, seq_parallel=sp):
        objective, nll_sum = sharded_loss(cfg, p, specs, batch, count=count)
        grads = torch.autograd.grad(objective, leaves(p))
        with torch.no_grad():
            logits, _ = sharded_prefill(cfg, p, specs, {"tokens": batch["tokens"]})
    RES[f"sp{int(sp)}/objective"] = objective.detach().numpy()
    RES[f"sp{int(sp)}/nll_sum"] = nll_sum.numpy()
    RES[f"sp{int(sp)}/logits"] = logits.numpy()
    for k, g in enumerate(grads):
        RES[f"sp{int(sp)}/grad{k}"] = g.numpy()
""" % (CASES, B, S, GEN) + tm.PORT_EPILOGUE


def _jax_serve(arch, over, params, prompt, steps):
    model = JModel(JC.get_reduced(arch, **over))
    eng = JDecodeEngine(model)
    jp = jax.tree.map(jnp.asarray, params)
    logits, cache = jax.jit(lambda p, b: eng.prefill(p, b, max_len=S + GEN))(
        jp, {"tokens": jnp.asarray(prompt)})
    out = [np.asarray(logits)]
    step = jax.jit(eng.decode_step)
    for t in range(GEN):
        logits, cache = step(jp, cache, {"tokens": jnp.asarray(steps[:, t:t + 1])})
        out.append(np.asarray(logits))
    return out, {k: np.asarray(cache[k]) for k in ("k", "v", "cur")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_serve")
    inputs = {}
    for name, (arch, over, _, _) in CASES.items():
        jcfg = JC.get_reduced(arch, **over)
        params = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(1)))
        rng = np.random.default_rng(11)
        prompt = rng.integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
        steps = rng.integers(0, jcfg.vocab_size, size=(B, GEN)).astype(np.int32)
        labels = rng.integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
        inputs[name] = (params, prompt, steps)
        np.savez(out / f"in_{name}.npz",
                 **{"params." + k: v for k, v in _flat(params).items()},
                 prompt=prompt, steps=steps, labels=labels)
    procs = tm.start_port(_PORT, out)
    want = {}
    try:
        for name, (arch, over, _, _) in CASES.items():
            want[name] = _jax_serve(arch, over, *inputs[name])
    finally:
        tm.wait(procs)
    ports = [dict(np.load(out / f"port{r}.npz")) for r in range(tm.WORLD)]
    return want, ports


def _local(name, rank_res, whole, spec):
    """The slice of ``whole`` that the rank with ``rank_res``'s coordinates
    holds under ``spec`` (entries ``None``, ``"data"``, ``"model"``)."""
    from repro_torch.distributed.sharding import local_slices

    _, _, shape, axes = CASES[name]
    sizes = dict(zip(axes, shape))
    coord = dict(zip(axes, (int(c) for c in rank_res[name + "/coord"])))
    return whole[local_slices(whole.shape, spec, sizes, coord)]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_serving_matches_single_device(runs, name):
    want, ports = runs
    ref_logits, ref_cache = want[name]
    _, _, shape, _ = CASES[name]
    kv_ax, hd_ax = LAYOUT[name]
    vocab_tp = "model" if ref_logits[0].shape[-1] % shape[1] == 0 and shape[1] > 1 else None
    for r, got in enumerate(ports):
        assert str(got[name + "/partition"]) == PARTITION[name]
        assert str(got[name + "/cache_spec"]) == repr((None, "data", None, kv_ax, hd_ax)), r
        for t, ref in enumerate(ref_logits):
            mine = got[f"{name}/logits{t}"]
            np.testing.assert_allclose(mine, _local(name, got, ref, ("data", None, vocab_tp)),
                                       rtol=LOGITS_TOL, atol=LOGITS_TOL,
                                       err_msg=f"rank {r} step {t}")
        np.testing.assert_allclose(got[name + "/last_only"], got[name + "/logits0"][:, -1:],
                                   rtol=1e-5, atol=1e-5)
        for leaf in ("k", "v"):
            spec = (None, "data", None, kv_ax, hd_ax)
            np.testing.assert_allclose(got[f"{name}/cache/{leaf}"],
                                       _local(name, got, ref_cache[leaf], spec),
                                       rtol=LOGITS_TOL, atol=LOGITS_TOL, err_msg=f"rank {r} {leaf}")
        np.testing.assert_array_equal(got[name + "/cache/cur"], ref_cache["cur"])
        assert (got[name + "/cache/cur"] == S + GEN).all()


def test_seq_parallel_equals_without(runs):
    """The loss, its gradients and the prefill's logits with the residual's
    sequence sharded over TP between blocks equal those without it."""
    _, ports = runs
    for r, got in enumerate(ports):
        for key in [k for k in got if k.startswith("sp0/")]:
            other = "sp1/" + key[len("sp0/"):]
            np.testing.assert_allclose(got[other], got[key], rtol=SP_TOL, atol=SP_TOL * 1e-2,
                                       err_msg=f"rank {r} {key}")
        assert np.abs(got["sp0/grad0"]).max() > 0
