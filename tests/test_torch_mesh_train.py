"""The port's sharded train step on 4 gloo ranks against single-device steps,
the twin of the reference's ``test_sharded_train_step_matches_single_device``
(``tests/test_multidevice.py``).

Reduced qwen3-8b, a global batch of 8 x 16 tokens, 3 steps (lr 0, 5e-4,
1e-3 under the warmup of 2), the JAX package's seeded parameters carried
into both packages.  The port runs ``sharded_train_step`` over a (2, 2)
data x model mesh (FSDP over ``data``, TP over ``model``) from each rank's
slices (``convert.shards_from_numpy``), each rank fed its rows of the batch;
the JAX package runs ``make_train_step`` on one device in this process, and
the port's ``make_train_step`` on one device here too.  The cases cover
``attn_partition``'s three branches (KV heads dividing TP; only the q heads,
with a loss mask and remat; neither, ``q_sequence``, with 2 microbatches:
each TP rank's flash calls, forward and backward, take its S / TP q rows
at their offset), Adafactor, and a composite ("pod", "data") FSDP axis.
Held to:

* the JAX package's step at the reference test's tolerances: every step's
  loss rtol 1e-4, parameters rtol 3e-3 / atol 3e-4;
* the port's single-device step, tighter: losses rtol 1e-6; the optimizer
  state rtol 1e-4 / atol 1e-8 (largest difference measured on this CPU:
  4.7e-9); each parameter leaf's difference within ``PARAM_REL_RMS`` (1%)
  of its update over the steps, as a relative RMS (measured: at most 0.12%,
  ``pod_data``'s embedding).  Element by element the parameters may differ
  by more (2.3e-4 measured, about a sixth of an update): AdamW divides by
  sqrt(nu) + 1e-8, so where a gradient is near 1e-8 the order of the
  sharded sums moves the step;
* every rank the same (losses, grad norms, the gathered state), and each
  rank's slices of the shapes the specs give.

A control run (``control``: the ``heads`` case with rank 0's rows shifted
by one) must fail the gate against the port's single-device step.
"""

import numpy as np
import pytest
import torch

import _torch_mesh as tm
import jax
import jax.numpy as jnp
from repro import configs as JC
from repro.models import Model as JModel
from repro.train import OptimizerConfig as JOptimizerConfig
from repro.train import init_state as jinit_state
from repro.train import make_train_step as jmake_train_step
from repro_torch import configs as TC
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import OptimizerConfig, init_state, make_train_step
from repro_torch.train.tree import leaves_with_paths

B, S, STEPS = 8, 16, 3
PARAM_REL_RMS = 1e-2
# name: (config overrides, mesh shape, mesh axes, optimizer, microbatches, loss mask,
#        rank 0's rows shifted by one)
CASES = {
    "heads": ({}, (2, 2), ("data", "model"), "adamw", 1, False, False),
    "q_heads": ({"num_kv_heads": 1, "remat": True}, (2, 2), ("data", "model"), "adamw", 1, True,
                False),
    "q_sequence": ({"num_heads": 3, "num_kv_heads": 1}, (2, 2), ("data", "model"), "adamw", 2,
                   False, False),
    "adafactor": ({}, (2, 2), ("data", "model"), "adafactor", 1, False, False),
    "pod_data": ({}, (2, 2), ("pod", "data"), "adamw", 1, False, False),
    "control": ({}, (2, 2), ("data", "model"), "adamw", 1, False, True),
}
TWINS = [name for name in CASES if name != "control"]


def _opt(cls, name):
    return cls(name=name, learning_rate=1e-3, warmup_steps=2, decay_steps=10)


def _batches(cfg, mask: bool) -> list:
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if mask:
            b["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
        out.append(b)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, dtype=np.float32)
    return out


_PORT = tm.PORT_PRELUDE + r"""
from repro_torch import configs
from repro_torch.distributed.sharding import layout_of, local_shape, unshard_tree
from repro_torch.kernels import ops

# Each flash call's q rows and query offset, forward and backward.
CALLS = []
for fn_name in ("flash_attention", "flash_attention_bwd"):
    def traced(q, *args, _fn=getattr(ops, fn_name), _name=fn_name, **kw):
        CALLS.append((_name == "flash_attention_bwd", q.shape[1], kw.get("q_offset", 0)))
        return _fn(q, *args, **kw)
    setattr(ops, fn_name, traced)
from repro_torch.models.convert import shards_from_numpy
from repro_torch.models.model import nest
from repro_torch.train import OptimizerConfig
from repro_torch.train.optimizer import opt_init
from repro_torch.train.step import sharded_train_step
from repro_torch.train.tree import leaves_with_paths

CASES = %r
B, STEPS = %d, %d
for name, (over, shape, axes, opt_name, mb, mask, shift) in CASES.items():
    cfg = configs.get_reduced("qwen3-8b", **over)
    opt = OptimizerConfig(name=opt_name, learning_rate=1e-3, warmup_steps=2, decay_steps=10)
    data = np.load(os.environ["OUT"].rsplit("/", 1)[0] + f"/in_{name}.npz")
    params = nest((k[len("params."):], data[k]) for k in data.files if k.startswith("params."))
    mesh = make_mesh(shape, axes, device_type="cpu")
    layout = layout_of(mesh)
    bax = tuple(a for a in ("pod", "data") if a in axes)
    n, i = layout.size(bax), layout.index(bax)
    step, sspecs, bspecs = sharded_train_step(cfg, opt, mesh, microbatches=mb)
    p = shards_from_numpy(cfg, params, mesh, device="cpu")
    state = {"step": torch.zeros((), dtype=torch.int32), "params": p,
             "opt": opt_init(opt, p)}
    for path, leaf in leaves_with_paths(state["params"]):
        spec = dict(leaves_with_paths(sspecs["params"]))[path]
        whole = params
        for key in path:
            whole = whole[key]
        assert tuple(leaf.shape) == local_shape(whole.shape, spec, layout.sizes), path
    losses, norms = [], []
    CALLS.clear()
    lo = i * B // n + (1 if shift and RANK == 0 else 0)
    for s in range(STEPS):
        batch = {k[len(f"b{s}."):]: torch.from_numpy(data[k][lo:lo + B // n])
                 for k in data.files if k.startswith(f"b{s}.")}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    RES["trace/" + name + "/flash_calls"] = np.array(CALLS)
    RES["trace/" + name + "/tp_rank"] = np.array(layout.coord.get("model", 0))
    RES[name + "/losses"] = np.array(losses)
    RES[name + "/norms"] = np.array(norms)
    for part in ("params", "opt"):
        whole = unshard_tree(state[part], sspecs[part], mesh)
        for path, t in leaves_with_paths(whole):
            RES[f"{name}/{part}/" + "/".join(path)] = t.detach().numpy()
""" % (CASES, B, STEPS) + tm.PORT_EPILOGUE


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_train")
    inputs = {}
    for name, (over, _, _, opt_name, _, mask, _) in CASES.items():
        jcfg = JC.get_reduced("qwen3-8b", **over)
        params = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(0)))
        batches = _batches(jcfg, mask)
        inputs[name] = (params, batches)
        np.savez(out / f"in_{name}.npz",
                 **{"params." + k.replace("/", "."): v for k, v in _flat(params).items()},
                 **{f"b{s}.{k}": v for s, b in enumerate(batches) for k, v in b.items()})
    procs = tm.start_port(_PORT, out)
    want = {}
    try:
        for name, (over, _, _, opt_name, mb, _, _) in CASES.items():
            params, batches = inputs[name]
            want[name] = {"jax": _jax_steps(over, opt_name, mb, params, batches),
                          "port": _port_steps(over, opt_name, mb, params, batches),
                          "initial": _flat(params)}
    finally:
        tm.wait(procs)
    ports = [dict(np.load(out / f"port{r}.npz")) for r in range(tm.WORLD)]
    return want, ports


def _jax_steps(over, opt_name, mb, params, batches):
    model = JModel(JC.get_reduced("qwen3-8b", **over))
    opt = _opt(JOptimizerConfig, opt_name)
    state = jinit_state(model, opt, jax.random.PRNGKey(0))
    state["params"] = jax.tree.map(jnp.asarray, params)
    step = jax.jit(jmake_train_step(model, opt, microbatches=mb))
    losses = []
    for b in batches:
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    return {"losses": np.array(losses), "params": _flat(state["params"]),
            "opt": _flat(state["opt"])}


def _port_steps(over, opt_name, mb, params, batches):
    model = params_from_numpy(Model(TC.get_reduced("qwen3-8b", **over), device="cpu"), params)
    opt = _opt(OptimizerConfig, opt_name)
    state = init_state(model, opt)
    step = make_train_step(model, opt, microbatches=mb)
    losses = []
    for b in batches:
        state, metrics = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    flat = lambda t: {"/".join(p): v.detach().numpy() for p, v in leaves_with_paths(t)}  # noqa
    return {"losses": np.array(losses), "params": flat(state["params"]), "opt": flat(state["opt"])}


def _port_gate(got: dict, name: str, single: dict, initial: dict) -> None:
    """The tight gate against the port's single-device step (raises)."""
    np.testing.assert_allclose(got[f"{name}/losses"], single["losses"], rtol=1e-6)
    for key, value in single["opt"].items():
        np.testing.assert_allclose(got[f"{name}/opt/{key}"], value, rtol=1e-4, atol=1e-8,
                                   err_msg=key)
    for key, value in single["params"].items():
        update = np.sqrt(np.mean((value - initial[key]) ** 2))
        diff = np.sqrt(np.mean((got[f"{name}/params/{key}"] - value) ** 2))
        assert diff <= PARAM_REL_RMS * update, (key, diff, update)


@pytest.mark.parametrize("name", TWINS)
def test_sharded_train_step_matches_single_device(runs, name):
    want, ports = runs
    got = ports[0]
    ref, single = want[name]["jax"], want[name]["port"]
    # The JAX package's single-device step, at the reference test's tolerances.
    np.testing.assert_allclose(got[f"{name}/losses"], ref["losses"], rtol=1e-4)
    for key, value in ref["params"].items():
        np.testing.assert_allclose(got[f"{name}/params/{key}"], value, rtol=3e-3, atol=3e-4,
                                   err_msg=key)
    # The port's single-device step, tighter.
    _port_gate(got, name, single, want[name]["initial"])
    assert got[f"{name}/losses"][-1] != got[f"{name}/losses"][0]
    # Every rank the same: metrics and the gathered state.
    for other in ports[1:]:
        for key in got:
            if key.startswith(name + "/"):
                np.testing.assert_array_equal(other[key], got[key], err_msg=key)


def test_q_sequence_ranks_attend_their_own_rows(runs):
    """In the ``q_sequence`` case (3 heads, 1 KV head over TP 2) every
    flash call of each rank, forward and backward, takes S / TP = 8 q rows
    at offset 8 * its TP coordinate: no rank runs attention over rows
    outside its slice.  In the ``heads`` case every call takes all S rows
    at offset 0."""
    _, ports = runs
    for got in ports:
        calls = got["trace/q_sequence/flash_calls"]
        assert len(calls) and calls[:, 0].any() and not calls[:, 0].all()   # both passes
        assert (calls[:, 1] == S // 2).all(), calls
        assert (calls[:, 2] == S // 2 * int(got["trace/q_sequence/tp_rank"])).all(), calls
        heads = got["trace/heads/flash_calls"]
        assert len(heads) and (heads[:, 1] == S).all() and (heads[:, 2] == 0).all()


def test_sharded_step_control_fails(runs):
    """Rank 0's rows shifted by one: the gate must fail."""
    want, ports = runs
    with pytest.raises(AssertionError):
        _port_gate(ports[0], "control", want["control"]["port"], want["control"]["initial"])
