"""The port's sharded train step for the moe, vlm and audio families on 4
gloo ranks against the JAX package's single-device step, the counterpart of
``tests/test_torch_mesh_train.py`` (the dense family).

Reduced configs in float32, the JAX package's seeded parameters carried
into both packages, a global batch of 8 x 16 positions, 3 steps (lr 0,
5e-4, 1e-3 under the warmup of 2).  The port runs ``sharded_train_step``
from each rank's slices (``convert.shards_from_numpy``), each rank fed its
rows; the JAX package runs ``make_train_step`` on one device, and the
port's ``make_train_step`` on one device too.  The cases:

* ``phi_moe``: reduced phi3.5-moe on (2, 2) data x model, capacity factor
  0.5, so choices are dropped: 4 experts, 2 a TP rank (expert parallelism),
  heads over TP;
* ``arctic``: reduced arctic on (1, 4): 4 experts, one a rank, and the
  ``dense_residual`` MLP column / row parallel; 4 / 2 heads, so q
  head-parallel;
* ``vision``: reduced llama-3.2-vision on (2, 2), its cross gates seeded
  non-zero (they start at zero, and tanh(0) switches cross-attention off);
* ``vision_q_sequence``: the same with 3 / 1 heads, so the self and the
  cross layers split the q sequence over TP;
* ``musicgen``: reduced musicgen on (2, 2), frame inputs, the head
  vocab-parallel;
* ``control``: ``phi_moe`` with the expert leaves rolled by one TP rank's
  share, so each rank runs another rank's experts under its own indices.

The moe cases also record a checksum of every routing (``moe.route``) on
each rank: the TP ranks of a group must route alike.

Held to ``tests/test_torch_mesh_train.py``'s tolerances: against the JAX package's step, every step's
loss rtol 1e-4, parameters rtol 3e-3 / atol 3e-4; against the port's
single-device step, losses rtol 1e-6 and each parameter leaf's difference
within 1% of its update (relative RMS); ``moe_dropped`` of every step equal
to both single-device steps' (and non-zero in ``phi_moe``); every rank
the same.  The control must fail the port gate.
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
# name: (arch, config overrides, mesh shape, experts rolled across ranks)
CASES = {
    "phi_moe": ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 0.5}, (2, 2), False),
    "arctic": ("arctic-480b", {}, (1, 4), False),
    "vision": ("llama-3.2-vision-11b", {}, (2, 2), False),
    "vision_q_sequence": ("llama-3.2-vision-11b", {"num_heads": 3, "num_kv_heads": 1}, (2, 2),
                          False),
    "musicgen": ("musicgen-medium", {}, (2, 2), False),
    "control": ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 0.5}, (2, 2), True),
}
TWINS = [name for name in CASES if name != "control"]


def _opt(cls):
    return cls(name="adamw", learning_rate=1e-3, warmup_steps=2, decay_steps=10)


def _batches(cfg) -> list:
    rng = np.random.default_rng(11)
    out = []
    for _ in range(STEPS):
        b = {"labels": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)}
        if cfg.frame_inputs:
            b["frame_embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        else:
            b["tokens"] = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
        if cfg.family == "vlm":
            b["image_embeds"] = rng.normal(
                size=(B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _params(jcfg):
    params = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(0)))
    if jcfg.family == "vlm":
        gate = params["cross_blocks"]["gate"]
        params["cross_blocks"]["gate"] = np.random.default_rng(3).uniform(
            0.3, 0.9, gate.shape).astype(gate.dtype)
    return params


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
from repro_torch.distributed.sharding import layout_of, unshard_tree
from repro_torch.models.convert import shards_from_numpy
from repro_torch.models.model import nest
from repro_torch.train import OptimizerConfig
from repro_torch.train.optimizer import opt_init
from repro_torch.train.step import sharded_train_step
from repro_torch.train.tree import leaves_with_paths

import zlib

from repro_torch.models import moe as moe_lib

ROUTES = []
_route = moe_lib.route


def _recording_route(*a, **kw):   # a checksum of each routing's choices and keeps
    r = _route(*a, **kw)
    ROUTES.append(zlib.crc32(r.choice.numpy().tobytes() + r.keep.numpy().tobytes()))
    return r


moe_lib.route = _recording_route
CASES = %r
B, STEPS = %d, %d
for name, (arch, over, shape, roll) in CASES.items():
    cfg = configs.get_reduced(arch, **over)
    opt = OptimizerConfig(name="adamw", learning_rate=1e-3, warmup_steps=2, decay_steps=10)
    data = np.load(os.environ["OUT"].rsplit("/", 1)[0] + f"/in_{name}.npz")
    params = nest((k[len("params."):], data[k]) for k in data.files if k.startswith("params."))
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    layout = layout_of(mesh)
    if roll:   # each rank gets the next TP rank's experts under its own indices
        for leaf in ("w_gate", "w_up", "w_down"):
            a = params["blocks"]["moe"][leaf]
            params["blocks"]["moe"][leaf] = np.roll(a, a.shape[1] // shape[1], axis=1)
    n, i = layout.size("data"), layout.index("data")
    step, sspecs, _ = sharded_train_step(cfg, opt, mesh)
    p = shards_from_numpy(cfg, params, mesh, device="cpu")
    state = {"step": torch.zeros((), dtype=torch.int32), "params": p, "opt": opt_init(opt, p)}
    losses, dropped = [], []
    for s in range(STEPS):
        batch = {k[len(f"b{s}."):]: torch.from_numpy(data[k][i * B // n:(i + 1) * B // n])
                 for k in data.files if k.startswith(f"b{s}.")}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        dropped.append(float(metrics.get("moe_dropped", -1.0)))
    RES[name + "/losses"] = np.array(losses)
    RES[name + "/dropped"] = np.array(dropped)
    if ROUTES:   # every routing's checksum on each TP rank of this rank's group
        mine = torch.tensor(ROUTES, dtype=torch.int64)[None]
        RES["routes/" + name] = layout.all_gather(mine, 0, "model").numpy()
        ROUTES.clear()
    whole = unshard_tree(state["params"], sspecs["params"], mesh)
    for path, t in leaves_with_paths(whole):
        RES[f"{name}/params/" + "/".join(path)] = t.detach().numpy()

# seq_parallel under the q_sequence split (the attention output already this
# rank's rows, the residual's slice): the loss and its gradients, a replicated
# leaf's summed over the TP ranks as the step sums it, equal the path without
# it.  (A TP rank's own share of a replicated leaf's gradient differs: under
# SP the cross gate multiplies only the rank's rows.)
from repro_torch.distributed.sharding import activation_sharding
from repro_torch.models.model import param_specs, sharded_loss
cfg = configs.get_reduced("llama-3.2-vision-11b", num_heads=3, num_kv_heads=1)
data = np.load(os.environ["OUT"].rsplit("/", 1)[0] + "/in_vision_q_sequence.npz")
params = nest((k[len("params."):], data[k]) for k in data.files if k.startswith("params."))
mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
i = layout_of(mesh).index("data")
batch = {k[len("b0."):]: torch.from_numpy(data[k][i * B // 2:(i + 1) * B // 2])
         for k in data.files if k.startswith("b0.")}
specs = param_specs(cfg, mesh)
spec_of = dict(leaves_with_paths(specs))
for sp in (False, True):
    p = shards_from_numpy(cfg, params, mesh, device="cpu")
    named = leaves_with_paths(p)
    with activation_sharding(mesh, seq_parallel=sp):
        objective, _ = sharded_loss(cfg, p, specs, batch, count=torch.tensor(float(B * 16)))
        grads = torch.autograd.grad(objective, [t for _, t in named])
    RES[f"sp{int(sp)}/objective"] = objective.detach().numpy()
    for (path, _), g in zip(named, grads):
        if "model" not in spec_of[path].axes():
            g = layout_of(mesh).all_reduce(g, "model")
        RES[f"sp{int(sp)}/" + "/".join(path)] = g.numpy()
""" % (CASES, B, STEPS) + tm.PORT_EPILOGUE


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_families")
    inputs = {}
    for name, (arch, over, _, _) in CASES.items():
        jcfg = JC.get_reduced(arch, **over)
        params, batches = _params(jcfg), _batches(jcfg)
        inputs[name] = (params, batches)
        np.savez(out / f"in_{name}.npz",
                 **{"params." + k.replace("/", "."): v for k, v in _flat(params).items()},
                 **{f"b{s}.{k}": v for s, b in enumerate(batches) for k, v in b.items()})
    procs = tm.start_port(_PORT, out)
    want = {}
    try:
        for name, (arch, over, _, _) in CASES.items():
            params, batches = inputs[name]
            want[name] = {"jax": _jax_steps(arch, over, params, batches),
                          "port": _port_steps(arch, over, params, batches),
                          "initial": _flat(params)}
    finally:
        tm.wait(procs)
    ports = [dict(np.load(out / f"port{r}.npz")) for r in range(tm.WORLD)]
    return want, ports


def _jax_steps(arch, over, params, batches):
    model = JModel(JC.get_reduced(arch, **over))
    state = jinit_state(model, _opt(JOptimizerConfig), jax.random.PRNGKey(0))
    state["params"] = jax.tree.map(jnp.asarray, params)
    step = jax.jit(jmake_train_step(model, _opt(JOptimizerConfig)))
    losses, dropped = [], []
    for b in batches:
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
        dropped.append(float(metrics.get("moe_dropped", -1.0)))
    return {"losses": np.array(losses), "dropped": np.array(dropped),
            "params": _flat(state["params"])}


def _port_steps(arch, over, params, batches):
    model = params_from_numpy(Model(TC.get_reduced(arch, **over), device="cpu"), params)
    state = init_state(model, _opt(OptimizerConfig))
    step = make_train_step(model, _opt(OptimizerConfig))
    losses, dropped = [], []
    for b in batches:
        state, metrics = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
        dropped.append(float(metrics.get("moe_dropped", -1.0)))
    flat = {"/".join(p): v.detach().numpy() for p, v in leaves_with_paths(state["params"])}
    return {"losses": np.array(losses), "dropped": np.array(dropped), "params": flat}


def _port_gate(got: dict, name: str, single: dict, initial: dict) -> None:
    """The tight gate against the port's single-device step (raises)."""
    np.testing.assert_allclose(got[f"{name}/losses"], single["losses"], rtol=1e-6)
    np.testing.assert_allclose(got[f"{name}/dropped"], single["dropped"], rtol=0, atol=1e-7)
    for key, value in single["params"].items():
        update = np.sqrt(np.mean((value - initial[key]) ** 2))
        diff = np.sqrt(np.mean((got[f"{name}/params/{key}"] - value) ** 2))
        assert diff <= PARAM_REL_RMS * update, (key, diff, update)


@pytest.mark.parametrize("name", TWINS)
def test_sharded_family_step_matches_single_device(runs, name):
    want, ports = runs
    got = ports[0]
    ref, single = want[name]["jax"], want[name]["port"]
    np.testing.assert_allclose(got[f"{name}/losses"], ref["losses"], rtol=1e-4)
    for key, value in ref["params"].items():
        np.testing.assert_allclose(got[f"{name}/params/{key}"], value, rtol=3e-3, atol=3e-4,
                                   err_msg=key)
    np.testing.assert_array_equal(got[f"{name}/dropped"], ref["dropped"])
    _port_gate(got, name, single, want[name]["initial"])
    assert got[f"{name}/losses"][-1] != got[f"{name}/losses"][0]
    for other in ports[1:]:
        for key in got:
            if key.startswith(name + "/"):
                np.testing.assert_array_equal(other[key], got[key], err_msg=key)


@pytest.mark.parametrize("name", ["phi_moe", "arctic"])
def test_tp_ranks_route_alike(runs, name):
    """Expert parallelism sums each TP rank's experts' kept choices, so
    every TP rank must make the same routing decisions: the checksum of
    each routing's choices and keeps (every layer's forward and its remat
    replay, every step), all-gathered over TP, is the same on every rank of
    the group.  Ranks of another data coordinate route other rows, so their
    checksums differ (the checksum tells routings apart)."""
    _, ports = runs
    shape = CASES[name][2]
    for r, got in enumerate(ports):
        routes = got[f"routes/{name}"]
        assert routes.shape[0] == shape[1] and routes.shape[1] >= 2 * STEPS, routes.shape
        np.testing.assert_array_equal(routes, np.broadcast_to(routes[0], routes.shape),
                                      err_msg=f"rank {r}")
        assert len(set(routes[0].tolist())) > 1
    if shape[0] > 1:
        assert (ports[0][f"routes/{name}"] != ports[-1][f"routes/{name}"]).any()


def test_moe_case_drops_choices(runs):
    """Capacity factor 0.5 drops choices, so ``moe_dropped``'s equality
    above is not that of zeros."""
    want, ports = runs
    assert (want["phi_moe"]["jax"]["dropped"] > 0).all()
    assert (ports[0]["phi_moe/dropped"] > 0).all()


def test_seq_parallel_q_sequence_equals_without(runs):
    """The vision model with 3 heads on 1 KV head over TP 2 (the q_sequence
    split in its self and cross layers) under ``seq_parallel``: the
    objective and every gradient (a replicated leaf's summed over TP) equal
    the path without it (1e-5)."""
    _, ports = runs
    for r, got in enumerate(ports):
        keys = [k for k in got if k.startswith("sp0/")]
        assert len(keys) > 10
        for key in keys:
            np.testing.assert_allclose(got["sp1/" + key[len("sp0/"):]], got[key], rtol=1e-5,
                                       atol=1e-7, err_msg=f"rank {r} {key}")


def test_experts_permuted_across_ranks_fail(runs):
    """The control: each rank holding another rank's experts must fail."""
    want, ports = runs
    with pytest.raises(AssertionError):
        _port_gate(ports[0], "control", want["control"]["port"], want["control"]["initial"])
