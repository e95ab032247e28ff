"""The port's training substrate around the step, on the CPU: the loader
(bit-identical batches to the JAX package's), checkpoints (each package
restores the other's), the fault-tolerant runner, int8 gradient
compression and the training driver's command line."""

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.data.loader import LoaderConfig as JLoaderConfig
from repro.data.loader import SyntheticLMLoader as JLoader
from repro.distributed import CheckpointManager as JCheckpointManager
from repro.models import Model as JModel
from repro.train import OptimizerConfig as JOptimizerConfig
from repro.train import compress as jcompress
from repro.train import init_state as j_init_state
from repro.train import make_train_step as j_make_train_step
from repro_torch import configs as TC
from repro_torch.data.loader import LoaderConfig, SyntheticLMLoader
from repro_torch.distributed import CheckpointManager, FaultTolerantRunner, RunnerConfig
from repro_torch.launch.train import train_main
from repro_torch.models import Model
from repro_torch.models.convert import state_from_numpy
from repro_torch.train import OptimizerConfig, compress, init_state, make_train_step
from repro_torch.train.tree import leaves_with_paths

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(learning_rate=3e-3, warmup_steps=2, decay_steps=20)


def _named(tree) -> dict:
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        return {"/".join(p): v.detach().numpy() for p, v in leaves_with_paths(tree)}
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(seed, b=2, s=16, vocab=256):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# Loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,b,s,seed", [("smollm-135m", 2, 8, 7), ("qwen3-8b", 3, 33, 0)])
def test_loader_batches_are_the_references(arch, b, s, seed):
    """Batch after batch, and after a resume from a saved cursor, the port's
    tokens and labels equal the JAX loader's bit for bit."""
    jl = JLoader(JC.get_reduced(arch), JLoaderConfig(batch_size=b, seq_len=s, seed=seed))
    tl = SyntheticLMLoader(TC.get_reduced(arch), LoaderConfig(batch_size=b, seq_len=s, seed=seed),
                           device="cpu")
    for _ in range(3):
        want, got = next(jl), next(tl)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    st = tl.state_dict()
    assert st == jl.state_dict()
    resumed = SyntheticLMLoader(TC.get_reduced(arch), LoaderConfig(batch_size=b, seq_len=s,
                                                                   seed=seed), device="cpu")
    resumed.load_state_dict(st)
    np.testing.assert_array_equal(next(resumed)["tokens"].numpy(), np.asarray(next(jl)["tokens"]))


def test_loader_needs_a_card_or_a_device_and_a_token_family(monkeypatch):
    """A frame-input model's batch holds bf16 frame embeddings in place of
    tokens (the vision batch is in tests/test_torch_vlm_audio.py); without
    a card and without ``device`` the loader raises."""
    cfg = TC.get_reduced("smollm-135m")
    batch = next(SyntheticLMLoader(dataclasses.replace(cfg, frame_inputs=True),
                                   LoaderConfig(batch_size=2, seq_len=8), device="cpu"))
    assert set(batch) == {"frame_embeds", "labels"}
    assert batch["frame_embeds"].dtype == torch.bfloat16
    assert batch["frame_embeds"].shape == (2, 8, cfg.d_model)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticLMLoader(cfg, LoaderConfig())


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """A reduced smollm-135m train state of the reference and the port's
    copy of it, with one more batch."""
    jm = JModel(JC.get_reduced("smollm-135m"))
    jcfg = JOptimizerConfig(**OPT)
    jstate = j_init_state(jm, jcfg, jax.random.PRNGKey(0))
    jstep = jax.jit(j_make_train_step(jm, jcfg))
    for i in range(2):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in _batch(i).items()})
    return jm, jcfg, jstep, jstate


def _port_state(opt_cfg=OptimizerConfig(**OPT), tree=None):
    tm = Model(TC.get_reduced("smollm-135m"), device="cpu")
    state = (init_state(tm, opt_cfg) if tree is None else
             state_from_numpy(tm, opt_cfg, jax.tree.map(np.asarray, tree)))
    return tm, state


def test_checkpoint_roundtrip_and_gc(tmp_path, tiny):
    _, _, _, jstate = tiny
    _, state = _port_state(tree=jstate)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        mgr.save(s, state)
    assert mgr.all_steps() == [20, 30]
    _, fresh = _port_state()
    restored, at = mgr.restore(fresh)
    assert at == 30 and restored is fresh
    want, got = _named(state), _named(restored)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_checkpoint_async_and_atomic(tmp_path, tiny):
    _, state = _port_state(tree=tiny[3])
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(5, state)
    mgr.wait()
    assert mgr.latest_step() == 5
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))   # a crash mid-save
    assert mgr.latest_step() == 5
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state)


def test_checkpoint_async_write_error_surfaces_in_wait(tmp_path, tiny, monkeypatch):
    _, state = _port_state(tree=tiny[3])
    mgr = CheckpointManager(str(tmp_path))

    def no_space(*args, **kw):
        raise OSError("no space left on device")

    monkeypatch.setattr(np, "save", no_space)
    mgr.save_async(5, state)
    with pytest.raises(OSError, match="no space"):
        mgr.wait()
    mgr.wait()   # reported once
    assert mgr.latest_step() is None


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_restore(tmp_path, tiny, writer):
    """A checkpoint written by one package is restored by the other (leaf
    names, shapes and values), and one more step from it equals the
    reference's step from its own state."""
    jm, jcfg, jstep, jstate = tiny
    if writer == "reference":
        JCheckpointManager(str(tmp_path)).save(2, jstate)
        tm, state = _port_state()
        state, at = CheckpointManager(str(tmp_path)).restore(state)
        want = _named(jstate)
    else:
        _, src = _port_state(tree=jstate)
        CheckpointManager(str(tmp_path)).save(2, src)
        shapes = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jstate)
        restored, at = JCheckpointManager(str(tmp_path)).restore(shapes)
        want = _named(src)
        assert set(_named(restored)) == set(want)
        for k, v in _named(restored).items():
            np.testing.assert_array_equal(v, want[k])
        tm, state = _port_state(tree=restored)
    assert at == 2
    for k, v in _named(state).items():
        np.testing.assert_array_equal(v, want[k])
    batch = _batch(5)
    jnext, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnext, tm_ = make_train_step(tm, OptimizerConfig(**OPT))(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(tnext["step"]) == int(jnext["step"]) == 3
    assert abs(float(tm_["loss"]) - float(jm_["loss"])) <= 1e-5 * abs(float(jm_["loss"]))
    want, got = _named(jnext["params"]), _named(tnext["params"])
    assert max(float(np.abs(got[k] - want[k]).max()) for k in want) <= 1e-4


# ---------------------------------------------------------------------------
# Fault-tolerant runner
# ---------------------------------------------------------------------------

def test_fault_recovery_and_straggler(tmp_path):
    """The reference's test (``tests/test_train_and_fault.py``): a failure
    at step 7 restores step 5's checkpoint and resumes; a slow step 11 is
    flagged as a straggler.  The eager CPU step takes tens of ms (the
    reference's jitted one a few), so the injected delay is scaled to the
    steps measured before it."""
    opt_cfg = OptimizerConfig(**OPT)
    tm = Model(TC.get_reduced("smollm-135m"), device="cpu")
    step_raw = make_train_step(tm, opt_cfg)
    boom = {"armed": True}

    def step_fn(state, batch):
        s = int(state["step"])
        if s == 7 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected device failure")
        if s == 11:   # slower than 2.5x the window's median, whatever this machine's pace
            time.sleep(0.25 + 3 * max(runner.step_times[-8:]))
        return step_raw(state, batch)

    def batches():
        while True:
            yield {k: torch.from_numpy(v) for k, v in _batch(0, b=4).items()}

    runner = FaultTolerantRunner(
        step_fn, lambda _: (init_state(tm, opt_cfg), None), batches(),
        CheckpointManager(str(tmp_path)),
        RunnerConfig(checkpoint_every=5, async_checkpoint=False, straggler_factor=2.5,
                     straggler_window=8))
    out = runner.run(15)
    assert out["restarts"] == 1
    kinds = [e.kind for e in out["events"]]
    assert "failure" in kinds and "restore" in kinds
    assert [e.step for e in out["events"] if e.kind == "restore"] == [5]
    assert int(out["state"]["step"]) == 15
    assert any(e.kind == "straggler" for e in out["events"])


def test_runner_gives_up_after_max_restarts(tmp_path):
    tm = Model(TC.get_reduced("smollm-135m"), device="cpu")
    opt_cfg = OptimizerConfig(**OPT)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, init_state(tm, opt_cfg))

    def failing(state, batch):
        raise RuntimeError("kernel launch failed")

    runner = FaultTolerantRunner(failing, lambda _: (init_state(tm, opt_cfg), None),
                                 iter(lambda: {}, None), mgr, RunnerConfig(max_restarts=0))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        runner.run(3)
    assert [e.kind for e in runner.events] == ["restore", "failure"]


# ---------------------------------------------------------------------------
# Int8 compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4096, 1000, 3])
def test_int8_quantization_unbiased_with_the_references_scales(n):
    x_np = np.random.default_rng(0).normal(size=(n,)) * 0.01
    x = torch.tensor(x_np, dtype=torch.float32)
    _, jscale = jcompress.quantize_int8(jnp.asarray(x_np, jnp.float32), jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    deqs = []
    for i in range(64):
        q, scale = compress.quantize_int8(x, gen)
        assert q.dtype == torch.int8 and q.shape == (-(-n // compress.BLOCK), compress.BLOCK)
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
        deqs.append(compress.dequantize_int8(q, scale, x.shape, torch.float32).numpy())
    scale_mag = float(x.abs().max()) / 127
    np.testing.assert_allclose(np.mean(deqs, axis=0), x.numpy(), atol=scale_mag)   # unbiased
    assert np.abs(deqs[0] - x.numpy()).max() <= scale_mag + 1e-7                    # bounded
    jdeq = jcompress.dequantize_int8(jnp.asarray(q.numpy()), jnp.asarray(scale.numpy()),
                                     (n,), jnp.float32)
    np.testing.assert_array_equal(deqs[-1], np.asarray(jdeq))


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------

def test_train_cli_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--reduced",
         "--steps", "3", "--batch", "2", "--seq", "16", "--log-every", "1",
         "--ckpt-dir", str(tmp_path)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("step ")]
    assert [ln.split(":")[0] for ln in lines] == ["step 1", "step 2", "step 3"]
    assert all("loss=" in ln and "gnorm=" in ln and "lr=" in ln for ln in lines)
    assert "restarts=0" in out.stdout
    assert CheckpointManager(str(tmp_path)).latest_step() == 3


def test_train_main_needs_a_card_or_a_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="needs 4 ranks: run it under torchrun"):
        train_main(["--device", "cpu", "--mesh", "2x2", "--ckpt-dir", str(tmp_path)])
    # Under torchrun (RANK set) the sharded path needs a card too.
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(["--reduced", "--mesh", "1x1", "--steps", "1", "--ckpt-dir", str(tmp_path)])
