"""Elastic checkpoints, the runner's remesh and ``compressed_pmean`` on 4
gloo ranks: twins of the reference's ``test_elastic_restore_different_mesh``
and ``test_compressed_pmean_unbiased`` (``tests/test_multidevice.py``).

* **Elastic restore**: the reference test's (64, 8) array saved by the port
  from a (4,) mesh as ("data", None), sharded and async, restored onto a
  (2, 2) mesh as ("data", "model"): each rank holds exactly its slice, and
  the JAX package's ``CheckpointManager`` reads the port's files whole.
  The JAX package on 4 fake devices saves the same array sharded over (4,)
  and a reduced qwen3-8b train state sharded by its ``state_specs``; the
  port restores both onto (2, 2), each rank only its slices.
* **Remesh**: ``FaultTolerantRunner`` over ``sharded_train_step`` with
  sharded async checkpoints takes a failure injected at step 3 on every
  rank, rebuilds its state on ``remesh()``'s (2, 2) data x model mesh
  (it started on (4,) data), restores step 2 and finishes; its parameters
  equal an uninterrupted single-device run's (the step's gate of
  ``test_torch_mesh_train.py``).
* **compressed_pmean** over the 4 ranks, the reference's criteria: every
  rank gets the same mean, the average of 24 seeds beats one seed, and one
  seed's error stays under 2 x the int8 scale.
* DTensor's own sharding (``distribute_tensor`` with ``to_placements``)
  gives each rank the slice ``local_slices`` computes.

And the driver: ``torchrun ... -m repro_torch.launch.train --mesh 2x2``
on the CPU, whose last checkpoint matches the single-device driver's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_mesh as tm
from repro.distributed import CheckpointManager as JCheckpointManager
from repro_torch import configs as TC
from repro_torch.distributed import CheckpointManager
from repro_torch.models import Model
from repro_torch.train import OptimizerConfig, init_state, make_train_step
from repro_torch.train.tree import leaves_with_paths

PARAM_REL_RMS = 1e-2
REMESH_STEPS, FAIL_AT = 4, 3

_REF = tm.REF_PRELUDE + r"""
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.distributed import CheckpointManager
from repro.launch.mesh import named
from repro.models import Model
from repro.train import OptimizerConfig, init_state
from repro.train import step as step_lib

out = os.path.dirname(os.environ["OUT"])
mesh = make_mesh((4,), ("data",))
x = jnp.arange(64 * 8, dtype=jnp.float32).reshape(64, 8)
CheckpointManager(out + "/jax_w").save(1, {"w": jax.device_put(x, NamedSharding(mesh, P("data", None)))})
model, opt = Model(configs.get_reduced("qwen3-8b")), OptimizerConfig()
state = init_state(model, opt, jax.random.PRNGKey(0))
state = jax.device_put(state, named(mesh, step_lib.state_specs(model, opt, mesh)))
CheckpointManager(out + "/jax_state").save(5, state)
for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
    RES["state/" + "/".join(str(getattr(k, "key", k)) for k in path)] = np.asarray(leaf)
""" + tm.REF_EPILOGUE + r"""
open(os.environ["OUT"] + ".done", "w").close()
"""

_PORT = tm.PORT_PRELUDE + r"""
import time
from repro_torch import configs
from repro_torch.distributed import CheckpointManager, FaultTolerantRunner, RunnerConfig
from repro_torch.distributed.sharding import (P, NamedSharding, layout_of, named, to_placements,
                                              unshard_tree)
from repro_torch.models import Model
from repro_torch.train import OptimizerConfig
from repro_torch.train.compress import compressed_pmean
from repro_torch.train.step import sharded_state, sharded_train_step, state_specs
from repro_torch.train.tree import leaves_with_paths

out = os.path.dirname(os.environ["OUT"])
mesh4 = make_mesh((4,), ("data",), device_type="cpu")
mesh22 = make_mesh((2, 2), ("data", "model"), device_type="cpu")
lay4, lay22 = layout_of(mesh4), layout_of(mesh22)

# compressed_pmean over the 4 ranks (the reference's "pod" axis).
rng = np.random.default_rng(0)
g = torch.from_numpy((rng.normal(size=(4, 1024)) * 0.01).astype(np.float32))
outs = []
for s in range(24):
    gen = torch.Generator().manual_seed(s * 4 + RANK)
    outs.append(compressed_pmean({"g": g[RANK]}, lay4.group("data"), gen)["g"].numpy())
RES["pmean"] = np.stack(outs)

# DTensor's sharding against local_slices.
from torch.distributed.tensor import distribute_tensor
full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
for spec in (P("data", "model"), P(("data", "model"), None), P(None, "model"), P("model", "data")):
    got = distribute_tensor(full, mesh22, to_placements(spec, mesh22)).to_local()
    assert torch.equal(got, full[lay22.slices(full.shape, spec)]), spec

# The port's own elastic round trip: (4,) ("data", None) -> (2, 2) ("data", "model").
x = torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)
src = NamedSharding(mesh4, P("data", None))
dst = NamedSharding(mesh22, P("data", "model"))
for mode in ("sync", "async"):
    mgr = CheckpointManager(out + "/port_" + mode)
    shard = {"w": x[src.slices(x.shape)].clone()}
    if mode == "sync":
        mgr.save(1, shard, {"w": src})
    else:
        mgr.save_async(1, shard, {"w": src})
        mgr.wait()
    like = {"w": torch.zeros(dst.local_shape(x.shape))}
    got, at = mgr.restore(like, {"w": dst})
    assert at == 1 and got["w"].shape == (32, 4)
    RES["elastic_" + mode] = got["w"].numpy()

# The runner: a failure at step FAIL_AT on every rank, remesh to (2, 2).
cfg = configs.get_reduced("qwen3-8b")
opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=2, decay_steps=10)
toks = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(8, 17)).astype(np.int64)
meshes = iter([mesh4, mesh22])
holder = {}

def remesh():
    return next(meshes)

def make_state(mesh):
    layout = layout_of(mesh)
    step, sspecs, _ = sharded_train_step(cfg, opt, mesh)
    n, i = layout.size("data"), layout.index("data")
    holder.update(step=step, rows=slice(i * 8 // n, (i + 1) * 8 // n), mesh=mesh)
    model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    return sharded_state(model, opt, mesh), named(mesh, sspecs)

def batches():
    while True:
        t = torch.from_numpy(toks[holder["rows"]])
        yield {"tokens": t[:, :-1], "labels": t[:, 1:]}

def step_fn(state, batch):
    if int(state["step"]) == FAIL_AT and not holder.get("failed"):
        holder["failed"] = True
        raise RuntimeError("injected failure")
    return holder["step"](state, batch)

runner = FaultTolerantRunner(step_fn, make_state, batches(), CheckpointManager(out + "/runner"),
                             RunnerConfig(checkpoint_every=2), remesh=remesh)
res = runner.run(REMESH_STEPS)
assert holder["mesh"] is mesh22 and res["restarts"] == 1, (holder["mesh"], res)
RES["runner_events"] = np.array([f"{e.kind}@{e.step}" for e in res["events"]])
specs22 = state_specs(cfg, opt, mesh22)
for path, t in leaves_with_paths(unshard_tree(res["state"]["params"], specs22["params"], mesh22)):
    RES["runner/" + "/".join(path)] = t.detach().numpy()

# The JAX package's checkpoints, restored onto (2, 2).
deadline = time.monotonic() + 200
while not os.path.exists(out + "/ref.npz.done"):
    assert time.monotonic() < deadline, "the reference side did not finish"
    time.sleep(0.2)
w, at = CheckpointManager(out + "/jax_w").restore({"w": torch.zeros(32, 4)}, {"w": dst})
assert at == 1
RES["jax_w"] = w["w"].numpy()
specs = state_specs(cfg, OptimizerConfig(), mesh22)
like = sharded_state(Model(cfg, device="cpu"), OptimizerConfig(), mesh22)
state, at = CheckpointManager(out + "/jax_state").restore(like, named(mesh22, specs))
assert at == 5
ref = np.load(out + "/ref.npz")
for path, t in leaves_with_paths(state):
    spec = dict(leaves_with_paths(specs))[path]
    whole = ref["state/" + "/".join(path)]
    assert np.array_equal(t.detach().numpy(), whole[lay22.slices(whole.shape, spec)]), path
RES["jax_state_leaves"] = np.array(len(leaves_with_paths(state)))
RES["coord"] = np.array([lay22.coord["data"], lay22.coord["model"]])
""".replace("FAIL_AT", str(FAIL_AT)).replace("REMESH_STEPS", str(REMESH_STEPS)) + \
    tm.PORT_EPILOGUE


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_elastic")
    ref = tm.start_reference(_REF, out / "ref.npz")
    ports = tm.start_port(_PORT, out)
    tm.wait([ref] + ports)
    return out, [dict(np.load(out / f"port{r}.npz")) for r in range(tm.WORLD)]


def test_elastic_restore_different_mesh(runs):
    out, ports = runs
    x = np.arange(64 * 8, dtype=np.float32).reshape(64, 8)
    for r, res in enumerate(ports):
        d, m = res["coord"]
        want = x[d * 32:(d + 1) * 32, m * 4:(m + 1) * 4]
        for key in ("elastic_sync", "elastic_async", "jax_w"):
            assert res[key].shape == (32, 4)
            np.testing.assert_array_equal(res[key], want, err_msg=f"rank {r} {key}")
        assert int(res["jax_state_leaves"]) > 10
    # The JAX package restores the port's sharded save whole.
    import jax

    for mode in ("sync", "async"):
        got, at = JCheckpointManager(str(out / f"port_{mode}")).restore(
            {"w": jax.ShapeDtypeStruct((64, 8), np.float32)})
        assert at == 1
        np.testing.assert_array_equal(np.asarray(got["w"]), x)


def test_runner_remesh_after_failure(runs):
    _, ports = runs
    events = [str(e) for e in ports[0]["runner_events"]]
    assert f"failure@{FAIL_AT}" in events and "restore@2" in events, events
    cfg = TC.get_reduced("qwen3-8b")
    opt = OptimizerConfig(learning_rate=1e-3, warmup_steps=2, decay_steps=10)
    model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    initial = {"/".join(p): t.detach().clone().numpy() for p, t in
               leaves_with_paths(model.param_tree())}
    state = init_state(model, opt)
    step = make_train_step(model, opt)
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, size=(8, 17)).astype(np.int64))
    for _ in range(REMESH_STEPS):
        state, _ = step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    for path, t in leaves_with_paths(state["params"]):
        key = "/".join(path)
        want = t.detach().numpy()
        update = np.sqrt(np.mean((want - initial[key]) ** 2))
        for res in ports:
            diff = np.sqrt(np.mean((res["runner/" + key] - want) ** 2))
            assert diff <= PARAM_REL_RMS * update, (key, diff, update)


def test_compressed_pmean_unbiased(runs):
    _, ports = runs
    g = (np.random.default_rng(0).normal(size=(4, 1024)) * 0.01).astype(np.float32)
    outs = ports[0]["pmean"]
    for res in ports[1:]:
        np.testing.assert_array_equal(res["pmean"], outs)      # all ranks agree
    true_mean = g.mean(axis=0)
    err_single = np.abs(outs[0] - true_mean).max()
    err_avg = np.abs(outs.mean(axis=0) - true_mean).max()
    assert err_avg < err_single          # stochastic rounding averages out (unbiased)
    assert err_single < 2 * np.abs(g).max() / 127


def test_train_cli_on_a_mesh_matches_one_device(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(tm.ROOT / "src"), OMP_NUM_THREADS="1")
    args = ["--device", "cpu", "--reduced", "--steps", "4", "--batch", "8", "--seq", "16",
            "--log-every", "1", "--ckpt-every", "2"]
    mesh = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "repro_torch.launch.train", *args, "--mesh", "2x2",
         "--ckpt-dir", str(tmp_path / "mesh")],
        env=env, cwd=tm.ROOT, capture_output=True, text=True, timeout=tm.TIMEOUT)
    assert mesh.returncode == 0, mesh.stderr[-4000:]
    steps = [ln for ln in mesh.stdout.splitlines() if ln.startswith("step ")]
    assert [ln.split(":")[0] for ln in steps] == ["step 1", "step 2", "step 3", "step 4"]
    assert "mesh 2x2" in mesh.stdout and "restarts=0" in mesh.stdout
    one = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         "--ckpt-dir", str(tmp_path / "one")],
        env=env, cwd=tm.ROOT, capture_output=True, text=True, timeout=tm.TIMEOUT)
    assert one.returncode == 0, one.stderr[-4000:]
    for a, b in zip(steps, [ln for ln in one.stdout.splitlines() if ln.startswith("step ")]):
        assert a.split("gnorm")[0] == b.split("gnorm")[0], (a, b)       # the same losses
    cfg = TC.get_reduced("smollm-135m")
    model = Model(cfg, device="cpu")
    initial = {"/".join(p): t.detach().clone() for p, t in leaves_with_paths(model.param_tree())}
    got = {}
    for name in ("mesh", "one"):
        mgr = CheckpointManager(str(tmp_path / name))
        assert mgr.latest_step() == 4
        state, _ = mgr.restore(init_state(Model(cfg, device="cpu"), OptimizerConfig()))
        got[name] = {"/".join(p): t.detach() for p, t in leaves_with_paths(state["params"])}
    for key, want in got["one"].items():
        update = float((want - initial[key]).pow(2).mean().sqrt())
        diff = float((got["mesh"][key] - want).pow(2).mean().sqrt())
        assert diff <= PARAM_REL_RMS * update, (key, diff, update)
