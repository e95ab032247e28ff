"""The port's sharded serving (``sharded_prefill``, ``sharded_decode_step``)
of the ssm and hybrid families on 4 gloo ranks against the JAX package's
single-device ``DecodeEngine``, the counterpart of
``tests/test_torch_mesh_families_serve.py``, and the cache's sequence
fallback for every family.

Reduced configs in float32, the JAX package's seeded parameters carried
into both packages (each Mamba2 layer's ``a_log`` and ``dt_bias`` seeded
non-zero), prompts of 16 positions (two SSD chunks) and 4 teacher-forced
decode steps into a cache of 20.  The cases:

* ``mamba``: reduced mamba2-2.7b on (2, 2), 4 prompts: the SSD heads and
  their conv and SSM states over TP, ``conv_b`` / ``conv_c`` on N;
* ``zamba``: reduced zamba2-7b on (2, 2), 4 prompts: the shared block's K/V
  (``shared``) over its KV heads;
* ``zamba_q_heads``: the same on (1, 4): ``conv_b`` / ``conv_c`` in N slices
  of 4, all-gathered before each decode step's conv; the shared block q
  head-parallel;
* ``straddle``: mamba2 with 3 SSD heads of 32 on (2, 2): each layer runs
  whole on every TP rank, its ``conv_x`` state in channel slices;
* ``zamba_fallback``: reduced zamba2-7b, 1 prompt on (2, 2): the batch does
  not divide the data axis, so every rank holds the prompt and the shared
  K/V's sequence is split over ``data`` (each rank writes its positions at
  prefill, the rank holding ``cur`` writes each new token, decode attention
  combines the ranks' max, sum and output);
* ``qwen_fallback``: reduced qwen3-8b, 1 prompt on (2, 2), the same
  fallback for the dense family.

Held to: every step's logits (each rank's rows and vocabulary slice)
within ``LOGITS_TOL`` of the JAX package's; each rank's cache shard (every
leaf after the last step, ``shared`` included) equal to the JAX cache
sliced by the JAX package's ``cache_specs`` at the rank's coordinates
within the same tolerance, ``cur`` exactly.  The control: ``mamba`` decoded
after layer 0's SSM state is zeroed must not match.
"""

import concurrent.futures
import types

import numpy as np
import pytest

import _torch_mesh as tm
import jax
import jax.numpy as jnp
from repro import configs as JC
from repro.models import DecodeEngine as JDecodeEngine
from repro.models import Model as JModel

S, GEN = 16, 4
LOGITS_TOL = 1e-4
STRADDLE = {"d_model": 48, "ssm_head_dim": 32}
# name: (arch, config overrides, mesh shape, batch)
CASES = {
    "mamba": ("mamba2-2.7b", {}, (2, 2), 4),
    "zamba": ("zamba2-7b", {}, (2, 2), 4),
    "zamba_q_heads": ("zamba2-7b", {}, (1, 4), 4),
    "straddle": ("mamba2-2.7b", STRADDLE, (2, 2), 4),
    "zamba_fallback": ("zamba2-7b", {}, (2, 2), 1),
    "qwen_fallback": ("qwen3-8b", {}, (2, 2), 1),
}


def _key(name):
    arch, over, _, b = CASES[name]
    return arch, repr(over), b


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _params(jcfg):
    params = jax.tree.map(np.asarray, jax.jit(JModel(jcfg).init)(jax.random.PRNGKey(1)))
    if "mamba" in params.get("blocks", {}):
        rng = np.random.default_rng(6)
        m = params["blocks"]["mamba"]
        for leaf in ("a_log", "dt_bias"):
            m[leaf] = rng.uniform(-1.0, 1.0, m[leaf].shape).astype(m[leaf].dtype)
    return params


def _inputs(jcfg, b):
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, jcfg.vocab_size, size=(b, S)).astype(np.int32)
    toks = rng.integers(0, jcfg.vocab_size, size=(b, GEN)).astype(np.int32)
    return {"tokens": prompt}, [{"tokens": toks[:, t:t + 1]} for t in range(GEN)]


_PORT = tm.PORT_PRELUDE + r"""
from repro_torch import configs
from repro_torch.distributed.sharding import activation_sharding, layout_of
from repro_torch.models.convert import shards_from_numpy
from repro_torch.models.decode import sharded_decode_step, sharded_prefill
from repro_torch.models.model import nest, param_specs

CASES = %r
S, GEN = %d, %d
for name, (arch, over, shape, B) in CASES.items():
    cfg = configs.get_reduced(arch, **over)
    data = np.load(os.environ["OUT"].rsplit("/", 1)[0] + f"/in_{name}.npz")
    params = nest((k[len("params."):], data[k]) for k in data.files if k.startswith("params."))
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    layout = layout_of(mesh)
    n, i = layout.size(("data",)), layout.index(("data",))
    rows = slice(i * B // n, (i + 1) * B // n) if B %% n == 0 else slice(0, B)
    specs = param_specs(cfg, mesh)
    p = shards_from_numpy(cfg, params, mesh, device="cpu")

    def batch(prefix):
        return {k[len(prefix):]: torch.from_numpy(data[k][rows]) for k in data.files
                if k.startswith(prefix)}

    for control in ((True, False) if name == "mamba" else (False,)):   # the cache kept: the last
        tag = name + "_control" if control else name
        with torch.no_grad(), activation_sharding(mesh):
            logits, cache = sharded_prefill(cfg, p, specs, batch("pre."), max_len=S + GEN,
                                            global_batch=B)
            RES[tag + "/logits0"] = logits.numpy()
            if control:   # layer 0's SSM state lost
                cache["ssm"][0].zero_()
            for t in range(GEN):
                logits, cache = sharded_decode_step(cfg, p, specs, cache, batch(f"s{t}."))
                RES[tag + f"/logits{t + 1}"] = logits.numpy()
    for path, t in ((k, v) for k, v in cache.items() if not isinstance(v, dict)):
        RES[f"{name}/cache/{path}"] = t.numpy()
    for path, t in cache.get("shared", {}).items():
        RES[f"{name}/cache/shared.{path}"] = t.numpy()
    RES[name + "/coord"] = np.array([layout.coord[a] for a in ("data", "model")])
""" % (CASES, S, GEN) + tm.PORT_EPILOGUE


def _jax_serve(name, params):
    arch, over, _, b = CASES[name]
    jcfg = JC.get_reduced(arch, **over)
    prefill, steps = _inputs(jcfg, b)
    eng = JDecodeEngine(JModel(jcfg))
    jp = jax.tree.map(jnp.asarray, params)
    logits, cache = jax.jit(lambda p, x: eng.prefill(p, x, max_len=S + GEN))(
        jp, {k: jnp.asarray(v) for k, v in prefill.items()})
    out = [np.asarray(logits)]
    step = jax.jit(eng.decode_step)
    for x in steps:
        logits, cache = step(jp, cache, {k: jnp.asarray(v) for k, v in x.items()})
        out.append(np.asarray(logits))
    return out, _flat(cache)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ssm_serve")
    first = {}
    for name in CASES:
        first.setdefault(_key(name), name)
    leads = sorted(set(first.values()))

    def reference(name, ready):
        """A config's seeded parameters (handed to ``ready``), then its
        single-device serving."""
        try:
            ready.set_result(_params(JC.get_reduced(*CASES[name][:1], **CASES[name][1])))
        except BaseException as e:
            ready.set_exception(e)
            raise
        return _jax_serve(name, ready.result())

    with concurrent.futures.ThreadPoolExecutor(len(leads)) as pool:
        ready = {name: concurrent.futures.Future() for name in leads}
        jax_runs = {name: pool.submit(reference, name, ready[name]) for name in leads}
        params = {name: ready[name].result() for name in leads}
        for name, (arch, over, _, b) in CASES.items():
            prefill, steps = _inputs(JC.get_reduced(arch, **over), b)
            np.savez(out / f"in_{name}.npz",
                     **{"params." + k: v.astype(np.float32)
                        for k, v in _flat(params[first[_key(name)]]).items()},
                     **{f"pre.{k}": v for k, v in prefill.items()},
                     **{f"s{t}.{k}": v for t, x in enumerate(steps) for k, v in x.items()})
        procs = tm.start_port(_PORT, out)
        try:
            want = {name: jax_runs[first[_key(name)]].result() for name in CASES}
        finally:
            tm.wait(procs)
    ports = [dict(np.load(out / f"port{r}.npz")) for r in range(tm.WORLD)]
    return want, ports


def _ref_slices(name, leaf: str, shape, coord) -> tuple:
    """The rank's block of a reference cache leaf of ``shape`` under the JAX
    package's ``cache_specs`` at coordinates ``coord`` (data, model)."""
    arch, over, mesh_shape, b = CASES[name]
    sizes = {"data": mesh_shape[0], "model": mesh_shape[1]}
    specs = JDecodeEngine(JModel(JC.get_reduced(arch, **over))).cache_specs(
        types.SimpleNamespace(shape=sizes, axis_names=("data", "model")), b)
    spec = specs
    for part in leaf.split("."):
        spec = spec[part]
    at = dict(zip(("data", "model"), coord))
    out = []
    for d, n in enumerate(shape):
        e = tuple(spec)[d] if d < len(tuple(spec)) else None
        axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        parts, index = 1, 0
        for a in axes:
            parts, index = parts * sizes[a], index * sizes[a] + at[a]
        out.append(slice(index * n // parts, (index + 1) * n // parts))
    return tuple(out)


def _logits_within(got: dict, tag: str, name: str, ref_logits: list) -> None:
    """Each step's logits of one rank against its rows and vocabulary slice
    of the single device's (raises)."""
    _, _, shape, b = CASES[name]
    data, model = (int(c) for c in got[name + "/coord"])
    for t, ref in enumerate(ref_logits):
        if b % shape[0] == 0:
            rows = b // shape[0]
            ref = ref[data * rows:(data + 1) * rows]
        v = ref.shape[-1] // shape[1] if ref.shape[-1] % shape[1] == 0 else ref.shape[-1]
        if v < ref.shape[-1]:
            ref = ref[..., model * v:(model + 1) * v]
        np.testing.assert_allclose(got[f"{tag}/logits{t}"], ref, rtol=LOGITS_TOL,
                                   atol=LOGITS_TOL, err_msg=f"{tag} step {t}")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_ssm_serving_matches_single_device(runs, name):
    want, ports = runs
    ref_logits, ref_cache = want[name]
    for r, got in enumerate(ports):
        _logits_within(got, name, name, ref_logits)
        leaves = {k[len(f"{name}/cache/"):] for k in got if k.startswith(f"{name}/cache/")}
        assert leaves == set(ref_cache), (leaves, set(ref_cache))
        for leaf in leaves:
            whole = ref_cache[leaf]
            mine = got[f"{name}/cache/{leaf}"]
            idx = _ref_slices(name, leaf, whole.shape, got[name + "/coord"])
            if leaf == "cur":
                np.testing.assert_array_equal(mine, whole)
                assert (mine == S + GEN).all()
            else:
                np.testing.assert_allclose(mine, whole[idx], rtol=LOGITS_TOL, atol=LOGITS_TOL,
                                           err_msg=f"rank {r} {leaf}")


def test_cache_shards_take_their_layouts(runs):
    """The shards hold what the layouts say: ``conv_b`` / ``conv_c`` N
    slices (16 over TP 2 and 4), ``shared`` K/V's KV heads at TP 2, the
    straddling layer's ``ssm`` state whole (3 heads), and in the fallback
    half the sequence (10 of 20 positions) a rank, the prompt's 16 split
    10 / 6 and the 4 decoded tokens on the rank holding positions 10-19."""
    _, ports = runs
    for got in ports:
        assert got["mamba/cache/conv_b"].shape[-1] == 8
        assert got["zamba_q_heads/cache/conv_c"].shape[-1] == 4
        assert got["zamba/cache/shared.k"].shape[-2] == 1
        assert got["straddle/cache/ssm"].shape[2] == 3
        assert got["straddle/cache/conv_x"].shape[-1] == 48
        for name in ("zamba_fallback", "qwen_fallback"):
            k = got[f"{name}/cache/shared.k" if name.startswith("zamba") else f"{name}/cache/k"]
            assert k.shape[1:3] == (1, 10), k.shape
            assert (np.abs(k).sum(axis=(0, 1, 3, 4)) > 0).all()   # every position written


def test_zeroed_ssm_state_fails(runs):
    """The control: decoding after layer 0's SSM state is zeroed must miss."""
    want, ports = runs
    _logits_within(ports[0], "mamba", "mamba", want["mamba"][0])
    with pytest.raises(AssertionError):
        _logits_within(ports[0], "mamba_control", "mamba", want["mamba"][0])
