"""The port stands alone and never hides the device.

* It imports neither JAX nor the JAX package, at import time or while it
  joins, trains or serves (checked in a fresh interpreter, and in the
  sources), and neither do the twins of the examples (``scripts/*_torch.py``).
* Entry points run on the card unless the caller asks for the CPU: without a
  card and without ``device=``, they raise (the joins, the Bitmap Filter's
  words, the Monte-Carlo bound and every dedup entry point).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import engine, join
from repro_torch.core.collection import from_lists

ROOT = Path(__file__).resolve().parents[1]

_CHILD = r"""
import sys
import numpy as np
import torch
import repro_torch, repro_torch.core
from repro_torch.core import bitmap, bounds, engine, expected, join, plan, verify
from repro_torch.core import cpu_algos, filters
from repro_torch.data import collections, dedup
from repro_torch.index import candidates, postings
from repro_torch.kernels import _build, bitmap_build, bitmap_filter, compaction, ops, ref
from repro_torch.kernels import bitplane, postings as postings_kernels
from repro_torch.serve import JoinSession
from repro_torch.store import CorpusStore
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.kernels import flash_attention
from repro_torch.models import DecodeEngine, Model, convert, generate, moe, ssm
from repro_torch import train, distributed
from repro_torch.data import loader
from repro_torch.launch import train as launch_train
from repro_torch.launch import mesh as launch_mesh
from repro_torch.distributed import checkpoint, fault, sharded_index, sharding
from repro_torch.models import decode
from repro_torch.train import compress, optimizer, step as train_step
from repro_torch.launch import cost, dryrun, report, roofline
import importlib.util
for name in ("quickstart_torch", "train_lm_torch", "serve_lm_torch", "dedup_pipeline_torch"):
    spec = importlib.util.spec_from_file_location(name, f"scripts/{name}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
model = Model(configs.get_reduced("qwen3-8b"), device="cpu")
out = generate.greedy_generate(DecodeEngine(model), torch.arange(12).reshape(2, 6), 3)
assert out.tokens.shape == (2, 3)
hybrid = Model(configs.get_reduced("zamba2-7b"), device="cpu")
out = generate.greedy_generate(DecodeEngine(hybrid), torch.arange(16).reshape(2, 8), 3)
assert out.tokens.shape == (2, 3)
opt_cfg = train.OptimizerConfig()
state = train.init_state(model, opt_cfg)
batches = loader.SyntheticLMLoader(model.cfg, loader.LoaderConfig(batch_size=2, seq_len=8),
                                   device="cpu")
state, metrics = train.make_train_step(model, opt_cfg)(state, next(batches))
assert int(state["step"]) == 1 and bool(torch.isfinite(metrics["loss"]))
col = collections.with_duplicates(collections.uniform_collection(60, seed=1),
                                  n_clusters=5, seed=2)
for mode in ("host", "device"):
    got = join.blocked_bitmap_join(col, "jaccard", 0.6, b=64, block=32,
                                   compaction=mode, device="cpu")
    assert np.array_equal(got, join.naive_join(col, "jaccard", 0.6, device="cpu"))
eng = engine.JoinEngine(col, "jaccard", 0.6, device="cpu",
                        planner=plan.JoinPlanner(naive_cells=0, indexed_cells=0))
assert eng.plan.driver == "indexed"
assert np.array_equal(eng.self_join(), join.naive_join(col, "jaccard", 0.6, device="cpu"))
for name, algo in cpu_algos.ALGORITHMS.items():
    bf = filters.BitmapFilter.build(col.tokens, col.lengths, "jaccard", 0.6, device="cpu")
    assert np.array_equal(algo(col, "jaccard", 0.6, bitmap=bf),
                          join.naive_join(col, "jaccard", 0.6, device="cpu")), name
cpu_eng = engine.JoinEngine(col, "jaccard", 0.6, device="cpu",
                            plan=plan.JoinPlan(driver="groupjoin", sim="jaccard", tau=0.6))
assert np.array_equal(cpu_eng.self_join(), eng.self_join())
res = dedup.dedup_shards(col, [col], 0.6, device="cpu")
assert len(res[0].keep) == 0 and len(dedup.dedup_collection(col, 0.6, device="cpu").drop)
kept, _ = dedup.dedup_documents(["a b c d e f", "a b c d e f", "x y z"], 0.8, device="cpu")
assert kept == ["a b c d e f", "x y z"]
assert expected.monte_carlo_expected_bound("xor", 64, 8, trials=20, device="cpu") > 0
store = CorpusStore(col, "jaccard", 0.6, device="cpu")
sess = JoinSession(store, max_wait=0.0)
sess.append(col, compact=False)
assert len(sess.probe(col)[0]) >= col.num_sets
import tempfile
import torch.distributed as dist
with tempfile.TemporaryDirectory() as tmp:
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=0, world_size=1)
    mesh = launch_mesh.make_mesh((1,), ("data",), device_type="cpu")
    prep = engine.prepare(col, "cpu")
    assert np.array_equal(join.ring_join_prepared(prep, mesh=mesh, sim="jaccard", tau=0.6),
                          eng.self_join())
    assert np.array_equal(sharded_index.sharded_indexed_join_prepared(
        prep, mesh=mesh, sim="jaccard", tau=0.6), eng.self_join())
    mesh2 = launch_mesh.make_mesh((1, 1), ("data", "model"), device_type="cpu")
    step, sspecs, _ = train_step.sharded_train_step(model, opt_cfg, mesh2)
    sharded = train_step.sharded_state(model, opt_cfg, mesh2)
    sharded, metrics = step(sharded, next(batches))
    assert int(sharded["step"]) == 1 and bool(torch.isfinite(metrics["loss"]))
    mgr = checkpoint.CheckpointManager(tmp + "/ckpt")
    mgr.save(1, sharded, sharding.named(mesh2, sspecs))
    assert mgr.restore(sharded, sharding.named(mesh2, sspecs))[1] == 1
    pspecs = model.param_specs(mesh2)
    with torch.no_grad(), sharding.activation_sharding(mesh2):
        logits, cache = decode.sharded_prefill(model.cfg, sharded["params"], pspecs,
                                               {"tokens": torch.arange(12).reshape(2, 6)},
                                               max_len=8)
        logits, cache = decode.sharded_decode_step(model.cfg, sharded["params"], pspecs, cache,
                                                   {"tokens": torch.ones(2, 1, dtype=torch.int32)})
    assert logits.shape == (2, 1, model.cfg.vocab_size) and int(cache["cur"][0]) == 7
    hspecs = hybrid.param_specs(mesh2)
    with torch.no_grad(), sharding.activation_sharding(mesh2):
        logits, cache = decode.sharded_prefill(hybrid.cfg, hybrid.param_tree(), hspecs,
                                               {"tokens": torch.arange(16).reshape(2, 8)},
                                               max_len=10)
        logits, cache = decode.sharded_decode_step(hybrid.cfg, hybrid.param_tree(), hspecs,
                                                   cache,
                                                   {"tokens": torch.ones(2, 1, dtype=torch.int32)})
    assert logits.shape == (2, 1, hybrid.cfg.vocab_size) and int(cache["cur"][0]) == 9
    assert set(cache) == {"cur", "conv_x", "conv_b", "conv_c", "ssm", "shared"}
    dist.destroy_process_group()
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("BAD", bad)
"""


def test_port_never_imports_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_sources_name_no_jax_or_reference_import():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro[ .])", re.M)
    files = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "scripts").glob("*_torch.py")))
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_prepare_without_device_needs_a_card(monkeypatch):
    _no_card(monkeypatch)
    col = from_lists([[1, 2, 3], [2, 3, 4]])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.prepare(col)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        join.blocked_bitmap_join(col, "jaccard", 0.5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        join.naive_join(col, "jaccard", 0.5)
    assert engine.prepare(col, device="cpu").device == torch.device("cpu")


def test_filters_and_dedup_without_device_need_a_card(monkeypatch):
    from repro_torch.core import expected
    from repro_torch.core.filters import BitmapFilter
    from repro_torch.data import dedup

    _no_card(monkeypatch)
    col = from_lists([[1, 2, 3], [1, 2, 3, 4], [7, 8]])
    calls = [
        lambda **kw: BitmapFilter.build(col.tokens, col.lengths, "jaccard", 0.7, **kw),
        lambda **kw: BitmapFilter.build_rs(col.tokens, col.lengths, col.tokens, col.lengths,
                                           "jaccard", 0.7, **kw),
        lambda **kw: expected.monte_carlo_expected_bound("set", 64, 4, trials=5, **kw),
        lambda **kw: dedup.dedup_collection(col, 0.7, **kw),
        lambda **kw: dedup.dedup_documents(["abcdef", "abcdeg"], 0.7, **kw),
        lambda **kw: dedup.dedup_against(col, col, 0.7, **kw),
        lambda **kw: dedup.dedup_documents_against(["abcdef"], ["abcdef"], 0.7, **kw),
        lambda **kw: dedup.dedup_shards(col, [col], 0.7, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        call(device="cpu")
    # The CPU plans run on the host, but their words on the engine's device.
    cpu_plan = engine.JoinPlan(driver="ppjoin", sim="jaccard", tau=0.7)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.JoinEngine(col, "jaccard", 0.7, plan=cpu_plan)
    eng = engine.JoinEngine(col, "jaccard", 0.7, plan=cpu_plan, device="cpu")
    assert np.array_equal(eng.self_join(), np.array([[0, 1]]))
    prep = engine.prepare(col, device="cpu")
    bf = engine.prepared_bitmap_filter(prep, sim="jaccard", tau=0.7)
    assert bf.words.dtype == np.uint32 and prep.builds["bitmap"] == 1


def test_cpu_join_runs_without_a_card(monkeypatch):
    _no_card(monkeypatch)
    col = from_lists([[1, 2, 3], [1, 2, 3, 4], [7, 8]])
    got = join.blocked_bitmap_join(col, "jaccard", 0.7, b=32, device="cpu")
    assert np.array_equal(got, np.array([[0, 1]]))
