"""The port's sharded train step for the ssm and hybrid families on 4 gloo
ranks against the JAX package's single-device step, the counterpart of
``tests/test_torch_mesh_families.py`` (the moe, vlm and audio families).

Reduced configs in float32, the JAX package's seeded parameters carried
into both packages (each Mamba2 layer's ``a_log`` and ``dt_bias`` seeded
non-zero: they start at zero, every head alike), a global batch of 8 x 16
positions, 3 steps (lr 0, 5e-4, 1e-3 under the warmup of 2).  The port runs
``sharded_train_step`` from each rank's slices (``convert.shards_from_numpy``),
each rank fed its rows; the JAX package runs ``make_train_step`` on one
device, and the port's ``make_train_step`` on one device too.  The cases:

* ``mamba``: reduced mamba2-2.7b on (2, 2) data x model: 8 SSD heads of 16,
  4 a TP rank; B and C (N = 16) sharded over TP by their spec and gathered
  whole, the gated norm's sum of squares all-reduced over TP;
* ``zamba_heads``: reduced zamba2-7b on (2, 2): the SSD heads over TP, and
  the shared attention + MLP block (4 / 2 heads) head-parallel, run before
  each of its 2 groups;
* ``zamba_q_heads``: the same on (1, 4): 2 SSD heads a rank, N over TP 4,
  the shared block q head-parallel;
* ``zamba_q_sequence``: 3 / 1 heads on (2, 2): the shared block splits the
  q sequence over TP;
* ``straddle``: reduced mamba2-2.7b with d_model 48 and SSD heads of 32 on
  (2, 2): 3 heads over TP 2 straddle the ranks while ``ssm_inner`` (96)
  divides, so each layer gathers its slices and runs whole on every TP
  rank;
* ``control``: ``mamba`` with every per-head leaf but ``w_out`` and the gated
  norm's scale rolled by one TP rank's share, so each rank runs the next
  rank's heads into its own rows of ``w_out``.

Held to ``tests/test_torch_mesh_families.py``'s tolerances: against the
JAX package's step, every step's loss rtol 1e-4, parameters rtol 3e-3 /
atol 3e-4; against the port's single-device step, losses rtol 1e-6 and
each parameter leaf's difference within 1% of its update (relative RMS);
every rank the same.  The control must fail the port gate.  Beside them,
``seq_parallel`` on ``zamba_heads``: the objective and every gradient (a
replicated leaf's summed over TP) equal the path without it; and on
``mamba`` and ``zamba_q_heads`` each leaf's gradient, summed over its
replicas, equals the port's single-device gradient (``GRAD_RTOL``).
"""

import concurrent.futures

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
STRADDLE = {"d_model": 48, "ssm_head_dim": 32}
# name: (arch, config overrides, mesh shape, heads rolled across ranks)
CASES = {
    "mamba": ("mamba2-2.7b", {}, (2, 2), False),
    "zamba_heads": ("zamba2-7b", {}, (2, 2), False),
    "zamba_q_heads": ("zamba2-7b", {}, (1, 4), False),
    "zamba_q_sequence": ("zamba2-7b", {"num_heads": 3, "num_kv_heads": 1}, (2, 2), False),
    "straddle": ("mamba2-2.7b", STRADDLE, (2, 2), False),
    "control": ("mamba2-2.7b", {}, (2, 2), True),
}
TWINS = [name for name in CASES if name != "control"]
# The cases whose gradients are compared leaf by leaf: B and C sharded over
# TP 2 and 4 by their spec, the shared block over heads and q heads.
GRAD_CASES = ("mamba", "zamba_q_heads")
GRAD_RTOL = 1e-4
# The per-head leaves the control rolls, by their heads' dim (stacked: axis 0 is the layer).
ROLLED = {"w_z": 2, "w_x": 2, "w_dt": 2, "conv_x": 2, "a_log": 1, "dt_bias": 1, "d_skip": 1}


def _opt(cls):
    return cls(name="adamw", learning_rate=1e-3, warmup_steps=2, decay_steps=10)


def _batches(cfg) -> list:
    rng = np.random.default_rng(13)
    return [{"tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)}
            for _ in range(STEPS)]


def _params(jcfg):
    params = jax.tree.map(np.asarray, jax.jit(JModel(jcfg).init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    m = params["blocks"]["mamba"]
    m["a_log"] = rng.uniform(-1.0, 1.0, m["a_log"].shape).astype(m["a_log"].dtype)
    m["dt_bias"] = rng.uniform(-1.0, 1.0, m["dt_bias"].shape).astype(m["dt_bias"].dtype)
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
from repro_torch.distributed.sharding import activation_sharding, layout_of, unshard_tree
from repro_torch.models.convert import shards_from_numpy
from repro_torch.models.model import nest, param_specs, sharded_loss
from repro_torch.train import OptimizerConfig
from repro_torch.train.optimizer import opt_init
from repro_torch.train.step import sharded_train_step
from repro_torch.train.tree import leaves_with_paths

CASES, ROLLED = %r, %r
B, S, STEPS = %d, %d, %d
GRAD_CASES = %r


def inputs(name):
    data = np.load(os.environ["OUT"].rsplit("/", 1)[0] + f"/in_{name}.npz")
    params = nest((k[len("params."):], data[k]) for k in data.files if k.startswith("params."))
    return data, params


for name, (arch, over, shape, roll) in CASES.items():
    cfg = configs.get_reduced(arch, **over)
    opt = OptimizerConfig(name="adamw", learning_rate=1e-3, warmup_steps=2, decay_steps=10)
    data, params = inputs(name)
    if roll:   # each rank runs the next TP rank's heads into its own rows of w_out
        for leaf, axis in ROLLED.items():
            a = params["blocks"]["mamba"][leaf]
            params["blocks"]["mamba"][leaf] = np.roll(a, -(a.shape[axis] // shape[1]), axis=axis)
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    layout = layout_of(mesh)
    n, i = layout.size("data"), layout.index("data")
    step, sspecs, _ = sharded_train_step(cfg, opt, mesh)
    p = shards_from_numpy(cfg, params, mesh, device="cpu")
    state = {"step": torch.zeros((), dtype=torch.int32), "params": p, "opt": opt_init(opt, p)}
    losses = []
    for s in range(STEPS):
        batch = {k[len(f"b{s}."):]: torch.from_numpy(data[k][i * B // n:(i + 1) * B // n])
                 for k in data.files if k.startswith(f"b{s}.")}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    RES[name + "/losses"] = np.array(losses)
    whole = unshard_tree(state["params"], sspecs["params"], mesh)
    for path, t in leaves_with_paths(whole):
        RES[f"{name}/params/" + "/".join(path)] = t.detach().numpy()

# seq_parallel: the loss and its gradients, a replicated leaf's summed over
# the TP ranks as the step sums it, equal the path without it.
cfg = configs.get_reduced("zamba2-7b")
data, params = inputs("zamba_heads")
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
        objective, _ = sharded_loss(cfg, p, specs, batch, count=torch.tensor(float(B * S)))
        grads = torch.autograd.grad(objective, [t for _, t in named])
    RES[f"sp{int(sp)}/objective"] = objective.detach().numpy()
    for (path, _), g in zip(named, grads):
        if "model" not in spec_of[path].axes():
            g = layout_of(mesh).all_reduce(g, "model")
        RES[f"sp{int(sp)}/" + "/".join(path)] = g.numpy()

# The gradients themselves: each leaf's summed over the ranks holding a
# replica of it (as the step sums them), then gathered whole.
from repro_torch.train.tree import unflatten
for name in GRAD_CASES:
    arch, over, shape, _ = CASES[name]
    cfg = configs.get_reduced(arch, **over)
    data, params = inputs(name)
    mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
    layout = layout_of(mesh)
    n, i = layout.size("data"), layout.index("data")
    batch = {k[len("b0."):]: torch.from_numpy(data[k][i * B // n:(i + 1) * B // n])
             for k in data.files if k.startswith("b0.")}
    specs = param_specs(cfg, mesh)
    spec_of = dict(leaves_with_paths(specs))
    p = shards_from_numpy(cfg, params, mesh, device="cpu")
    named = leaves_with_paths(p)
    with activation_sharding(mesh):
        objective, _ = sharded_loss(cfg, p, specs, batch, count=torch.tensor(float(B * S)))
        grads = torch.autograd.grad(objective, [t for _, t in named])
    summed = []
    for (path, _), g in zip(named, grads):
        for a in layout.names:
            if a not in spec_of[path].axes():
                g = layout.all_reduce(g, a)
        summed.append(g)
    whole = unshard_tree(unflatten(p, summed), specs, mesh)
    for path, g in leaves_with_paths(whole):
        RES[f"grad/{name}/" + "/".join(path)] = g.numpy()
""" % (CASES, ROLLED, B, S, STEPS, GRAD_CASES) + tm.PORT_EPILOGUE


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ssm")
    first = {}   # cases of one config share its inputs and single-device steps
    for name, (arch, over, _, _) in CASES.items():
        first.setdefault((arch, repr(over)), name)
    leads = sorted(set(first.values()))

    def reference(name, ready):
        """A config's seeded inputs (handed to ``ready``), then its JAX steps."""
        arch, over = CASES[name][:2]
        try:
            jcfg = JC.get_reduced(arch, **over)
            ready.set_result((_params(jcfg), _batches(jcfg)))
        except BaseException as e:
            ready.set_exception(e)
            raise
        return _jax_steps(arch, over, *ready.result())

    # XLA traces and compiles largely outside the GIL: the configs side by side.
    with concurrent.futures.ThreadPoolExecutor(len(leads)) as pool:
        ready = {name: concurrent.futures.Future() for name in leads}
        jax_runs = {name: pool.submit(reference, name, ready[name]) for name in leads}
        inputs = {name: ready[name].result() for name in leads}
        for name, (arch, over, _, _) in CASES.items():
            params, batches = inputs[first[(arch, repr(over))]]
            np.savez(out / f"in_{name}.npz",
                     **{"params." + k.replace("/", "."): v for k, v in _flat(params).items()},
                     **{f"b{s}.{k}": v for s, b in enumerate(batches) for k, v in b.items()})
        procs = tm.start_port(_PORT, out)
        try:
            want = {}
            for name in leads:
                arch, over = CASES[name][:2]
                want[name] = {"port": _port_steps(arch, over, *inputs[name]),
                              "initial": _flat(inputs[name][0]), "inputs": inputs[name],
                              "jax": jax_runs[name].result()}
            want = {name: want[first[(arch, repr(over))]]
                    for name, (arch, over, _, _) in CASES.items()}
        finally:
            tm.wait(procs)
    ports = [dict(np.load(out / f"port{r}.npz")) for r in range(tm.WORLD)]
    return want, ports


def _jax_steps(arch, over, params, batches):
    model = JModel(JC.get_reduced(arch, **over))
    state = jinit_state(model, _opt(JOptimizerConfig), jax.random.PRNGKey(0))
    state["params"] = jax.tree.map(jnp.asarray, params)
    step = jax.jit(jmake_train_step(model, _opt(JOptimizerConfig)))
    losses = []
    for b in batches:
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    return {"losses": np.array(losses), "params": _flat(state["params"])}


def _port_steps(arch, over, params, batches):
    model = params_from_numpy(Model(TC.get_reduced(arch, **over), device="cpu"), params)
    state = init_state(model, _opt(OptimizerConfig))
    step = make_train_step(model, _opt(OptimizerConfig))
    losses = []
    for b in batches:
        state, metrics = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    flat = {"/".join(p): v.detach().numpy() for p, v in leaves_with_paths(state["params"])}
    return {"losses": np.array(losses), "params": flat}


def _port_gate(got: dict, name: str, single: dict, initial: dict) -> None:
    """The tight gate against the port's single-device step (raises)."""
    np.testing.assert_allclose(got[f"{name}/losses"], single["losses"], rtol=1e-6)
    for key, value in single["params"].items():
        update = np.sqrt(np.mean((value - initial[key]) ** 2))
        diff = np.sqrt(np.mean((got[f"{name}/params/{key}"] - value) ** 2))
        assert diff <= PARAM_REL_RMS * update, (key, diff, update)


@pytest.mark.parametrize("name", TWINS)
def test_sharded_ssm_step_matches_single_device(runs, name):
    want, ports = runs
    got = ports[0]
    ref, single = want[name]["jax"], want[name]["port"]
    np.testing.assert_allclose(got[f"{name}/losses"], ref["losses"], rtol=1e-4)
    for key, value in ref["params"].items():
        np.testing.assert_allclose(got[f"{name}/params/{key}"], value, rtol=3e-3, atol=3e-4,
                                   err_msg=key)
    _port_gate(got, name, single, want[name]["initial"])
    assert got[f"{name}/losses"][-1] != got[f"{name}/losses"][0]
    for other in ports[1:]:
        for key in got:
            if key.startswith(name + "/"):
                np.testing.assert_array_equal(other[key], got[key], err_msg=key)


def test_cases_take_their_layouts():
    """Each case's config lays its SSD heads and attention over the TP axis
    as its name says."""
    from repro_torch.distributed.sharding import activation_sharding, attn_partition, constrain

    for name, (arch, over, shape, _) in CASES.items():
        cfg = TC.get_reduced(arch, **over)
        with activation_sharding({"data": shape[0], "model": shape[1]}):
            ssm_tp = constrain((cfg.ssm_heads,), ("tp",))[0] is not None
            part = attn_partition(cfg.num_heads, cfg.num_kv_heads)
        assert ssm_tp == (name != "straddle"), name
        assert cfg.ssm_inner % shape[1] == 0
        if name.startswith("zamba_"):
            assert part.case == name[len("zamba_"):], (name, part)


def test_seq_parallel_equals_without(runs):
    """Reduced zamba2-7b on (2, 2) under ``seq_parallel`` (each Mamba2 and
    shared block all-gathers the residual's sequence before its norm and
    reduce-scatters its partial output): the objective and every gradient
    (a replicated leaf's summed over TP) equal the path without it (1e-5)."""
    _, ports = runs
    for r, got in enumerate(ports):
        keys = [k for k in got if k.startswith("sp0/")]
        assert len(keys) > 20
        for key in keys:
            # Float32 sums in another order: within 1e-6 of the leaf's largest gradient.
            np.testing.assert_allclose(got["sp1/" + key[len("sp0/"):]], got[key], rtol=1e-5,
                                       atol=1e-6 * np.abs(got[key]).max(),
                                       err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("name", GRAD_CASES)
def test_gradients_summed_once(runs, name):
    """Each leaf's gradient, summed over the ranks that hold a replica of
    it, equals the port's single-device gradient of the same batch
    (relative norm within ``GRAD_RTOL``): ``w_b``, ``w_c``, ``conv_b``,
    ``conv_c`` and the shared block's norms, which every TP rank uses whole
    while its heads take a partial share, come out summed once, not TP
    times (AdamW's steps alone cannot tell a leaf's gradient from a multiple
    of it)."""
    want, ports = runs
    single = _single_grads(name, *want[name]["inputs"])
    for key, g in single.items():
        for r, got in enumerate(ports):
            mine = got[f"grad/{name}/{key}"]
            err = np.linalg.norm(mine - g) / max(np.linalg.norm(g), 1e-30)
            assert err <= GRAD_RTOL, (r, key, err)


def _single_grads(name, params, batches):
    arch, over = CASES[name][:2]
    model = params_from_numpy(Model(TC.get_reduced(arch, **over), device="cpu"), params)
    named = list(model.named_parameters())
    for _, t in named:
        t.requires_grad_(True)
    loss, _ = model.loss({k: torch.from_numpy(v) for k, v in batches[0].items()})
    grads = torch.autograd.grad(loss, [t for _, t in named])
    return {n.replace(".", "/"): g.numpy() for (n, _), g in zip(named, grads)}


def test_heads_rolled_across_ranks_fail(runs):
    """The control: each rank running another rank's heads must fail."""
    want, ports = runs
    with pytest.raises(AssertionError):
        _port_gate(ports[0], "control", want["control"]["port"], want["control"]["initial"])
