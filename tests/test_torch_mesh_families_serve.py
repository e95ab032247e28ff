"""The port's sharded serving (``sharded_prefill``, ``sharded_decode_step``)
of the moe, vlm and audio families on 4 gloo ranks against the JAX
package's single-device ``DecodeEngine``, the counterpart of
``tests/test_torch_mesh_serve.py`` (the dense family).

Reduced configs in float32, the JAX package's seeded parameters carried
into both packages (the vision model's cross gates seeded non-zero), a
global batch of 4 prompts of 12 positions and 4 teacher-forced decode steps
(seeded tokens, or frame embeddings).  The cases:

* ``phi_moe``: reduced phi3.5-moe on (2, 2), capacity factor 0.5: the
  prefill drops choices as the single device does, the decode routes groups
  of one; experts and KV heads over TP;
* ``arctic``: reduced arctic on (1, 4), its dense MLP beside the experts;
  q head-parallel, the head-dim cache (the MHA fallback);
* ``vision``: reduced llama-3.2-vision on (2, 2): the ``img_k`` / ``img_v``
  cache split over the KV heads and filled at prefill;
* ``vision_q_sequence``: 3 / 1 heads: the prefill's self and cross layers
  split the q sequence over TP, the caches (self and image) over the head
  dim;
* ``musicgen``: reduced musicgen on (2, 2): ``frame_embeds`` at prefill and
  at each decode step.

Held to: every step's logits (each rank's rows and vocabulary slice)
within ``LOGITS_TOL`` of the JAX package's; each rank's cache shard (every
K/V leaf after the last step) equal to the single device's slice under
``cache_specs`` within the same tolerance, ``cur`` exactly.  The control:
``vision`` decoded from a cache whose ``cur`` is one short of the prompt
(the off-by-one cache: each step overwrites the position before its own)
must not match.
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
# name: (arch, config overrides, mesh shape)
CASES = {
    "phi_moe": ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 0.5}, (2, 2)),
    "arctic": ("arctic-480b", {}, (1, 4)),
    "vision": ("llama-3.2-vision-11b", {}, (2, 2)),
    "vision_q_sequence": ("llama-3.2-vision-11b", {"num_heads": 3, "num_kv_heads": 1}, (2, 2)),
    "musicgen": ("musicgen-medium", {}, (2, 2)),
}
PARTITION = {"phi_moe": "heads", "arctic": "q_heads", "vision": "heads",
             "vision_q_sequence": "q_sequence", "musicgen": "heads"}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, dtype=np.float32)
    return out


def _inputs(jcfg):
    """Prefill and decode-step batches (numpy), the same for both packages."""
    rng = np.random.default_rng(5)
    if jcfg.frame_inputs:
        frames = rng.normal(size=(B, S + GEN, jcfg.d_model)).astype(np.float32)
        prefill = {"frame_embeds": frames[:, :S]}
        steps = [{"frame_embeds": frames[:, S + t:S + t + 1]} for t in range(GEN)]
    else:
        prompt = rng.integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
        toks = rng.integers(0, jcfg.vocab_size, size=(B, GEN)).astype(np.int32)
        prefill = {"tokens": prompt}
        steps = [{"tokens": toks[:, t:t + 1]} for t in range(GEN)]
    if jcfg.family == "vlm":
        prefill["image_embeds"] = rng.normal(
            size=(B, jcfg.num_image_tokens, jcfg.d_model)).astype(np.float32)
    return prefill, steps


_PORT = tm.PORT_PRELUDE + r"""
from repro_torch import configs
from repro_torch.distributed.sharding import activation_sharding, attn_partition, layout_of
from repro_torch.models.convert import shards_from_numpy
from repro_torch.models.decode import cache_specs, sharded_decode_step, sharded_prefill
from repro_torch.models.model import nest, param_specs

CASES = %r
B, S, GEN = %d, %d, %d
for name, (arch, over, shape) in CASES.items():
    cfg = configs.get_reduced(arch, **over)
    data = np.load(os.environ["OUT"].rsplit("/", 1)[0] + f"/in_{name}.npz")
    params = nest((k[len("params."):], data[k]) for k in data.files if k.startswith("params."))
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    layout = layout_of(mesh)
    n, i = layout.size(("data",)), layout.index(("data",))
    rows = slice(i * B // n, (i + 1) * B // n)
    specs = param_specs(cfg, mesh)
    p = shards_from_numpy(cfg, params, mesh, device="cpu")

    def batch(prefix):
        return {k[len(prefix):]: torch.from_numpy(data[k][rows]) for k in data.files
                if k.startswith(prefix)}

    controls = (True, False) if name == "vision" else (False,)   # the cache kept: the last
    for control in controls:
        tag = "control" if control else name
        with torch.no_grad(), activation_sharding(mesh):
            RES[tag + "/partition"] = np.array(
                attn_partition(cfg.num_heads, cfg.num_kv_heads).case)
            logits, cache = sharded_prefill(cfg, p, specs, batch("pre."), max_len=S + GEN)
            RES[tag + "/logits0"] = logits.numpy()
            if control:   # the off-by-one cache
                cache["cur"] = cache["cur"] - 1
            for t in range(GEN):
                logits, cache = sharded_decode_step(cfg, p, specs, cache, batch(f"s{t}."))
                RES[tag + f"/logits{t + 1}"] = logits.numpy()
    cspecs = cache_specs(cfg, mesh, B)
    for leaf, t in cache.items():
        RES[f"{name}/cache/{leaf}"] = t.numpy()
        RES[f"{name}/slice/{leaf}"] = np.array(
            [(s.start or 0, s.stop if s.stop is not None else -1)
             for s in layout.slices(tuple(t.shape) if leaf == "cur" else
                                    tuple(d * (1 if e is None else layout.size(e)) for d, e in
                                          zip(t.shape, tuple(cspecs[leaf]))), cspecs[leaf])])
    RES[name + "/coord"] = np.array([layout.coord[a] for a in ("data", "model")])
""" % (CASES, B, S, GEN) + tm.PORT_EPILOGUE


def _jax_serve(arch, over, params, prefill, steps):
    eng = JDecodeEngine(JModel(JC.get_reduced(arch, **over)))
    jp = jax.tree.map(jnp.asarray, params)
    logits, cache = jax.jit(lambda p, b: eng.prefill(p, b, max_len=S + GEN))(
        jp, {k: jnp.asarray(v) for k, v in prefill.items()})
    out = [np.asarray(logits)]
    step = jax.jit(eng.decode_step)
    for b in steps:
        logits, cache = step(jp, cache, {k: jnp.asarray(v) for k, v in b.items()})
        out.append(np.asarray(logits))
    return out, {k: np.asarray(v) for k, v in cache.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_families_serve")
    inputs = {}
    for name, (arch, over, _) in CASES.items():
        jcfg = JC.get_reduced(arch, **over)
        params = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(1)))
        if jcfg.family == "vlm":
            gate = params["cross_blocks"]["gate"]
            params["cross_blocks"]["gate"] = np.random.default_rng(3).uniform(
                0.3, 0.9, gate.shape).astype(gate.dtype)
        prefill, steps = _inputs(jcfg)
        inputs[name] = (params, prefill, steps)
        np.savez(out / f"in_{name}.npz",
                 **{"params." + k: v for k, v in _flat(params).items()},
                 **{f"pre.{k}": v for k, v in prefill.items()},
                 **{f"s{t}.{k}": v for t, b in enumerate(steps) for k, v in b.items()})
    procs = tm.start_port(_PORT, out)
    want = {}
    try:
        for name, (arch, over, _) in CASES.items():
            want[name] = _jax_serve(arch, over, *inputs[name])
    finally:
        tm.wait(procs)
    ports = [dict(np.load(out / f"port{r}.npz")) for r in range(tm.WORLD)]
    return want, ports


def _logits_within(got: dict, tag: str, ref_logits: list, shape) -> None:
    """Each step's logits of one rank against its rows and vocabulary slice
    of the single device's (raises)."""
    data, model = (int(c) for c in got[tag.replace("control", "vision") + "/coord"])
    for t, ref in enumerate(ref_logits):
        rows = ref.shape[0] // shape[0]
        ref = ref[data * rows:(data + 1) * rows]
        v = ref.shape[-1] // shape[1] if ref.shape[-1] % shape[1] == 0 else ref.shape[-1]
        if v < ref.shape[-1]:
            ref = ref[..., model * v:(model + 1) * v]
        np.testing.assert_allclose(got[f"{tag}/logits{t}"], ref, rtol=LOGITS_TOL,
                                   atol=LOGITS_TOL, err_msg=f"{tag} step {t}")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_family_serving_matches_single_device(runs, name):
    want, ports = runs
    ref_logits, ref_cache = want[name]
    shape = CASES[name][2]
    for r, got in enumerate(ports):
        assert str(got[name + "/partition"]) == PARTITION[name]
        _logits_within(got, name, ref_logits, shape)
        leaves = {k[len(f"{name}/cache/"):] for k in got if k.startswith(f"{name}/cache/")}
        assert leaves == set(ref_cache), (leaves, set(ref_cache))
        for leaf in leaves:
            idx = tuple(slice(a, None if b == -1 else b)
                        for a, b in got[f"{name}/slice/{leaf}"])
            mine, whole = got[f"{name}/cache/{leaf}"], ref_cache[leaf][idx]
            if leaf == "cur":
                np.testing.assert_array_equal(mine, whole)
                assert (mine == S + GEN).all()
            else:
                np.testing.assert_allclose(mine, whole, rtol=LOGITS_TOL, atol=LOGITS_TOL,
                                           err_msg=f"rank {r} {leaf}")


def test_vision_image_cache_is_split_over_kv_heads(runs):
    """The vision model's ``img_k`` / ``img_v`` shards hold one KV head of 2
    (its TP rank's), those of the q-sequence case a slice of the head dim."""
    _, ports = runs
    for got in ports:
        assert got["vision/cache/img_k"].shape[-2:] == (1, 16)
        assert got["vision_q_sequence/cache/img_v"].shape[-2:] == (1, 8)


def test_off_by_one_cache_fails(runs):
    """The control: decoding from a cache one position short must miss."""
    want, ports = runs
    _logits_within(ports[0], "vision", want["vision"][0], CASES["vision"][2])
    with pytest.raises(AssertionError):
        _logits_within(ports[0], "control", want["vision"][0], CASES["vision"][2])
