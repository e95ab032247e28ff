"""The port's launch tooling against the JAX package's: ``configs/shapes.py``
(``input_specs``, ``demo_batch``), the dry run (``launch/dryrun.py`` over
``launch/cost.py``), ``launch/roofline.py`` and ``launch/report.py``.

* ``input_specs`` equals the reference's ``ShapeDtypeStruct``s in shape and
  dtype for all 10 configs x 4 shapes; ``demo_batch`` draws the
  reference's values from the same seed.
* The twin of ``tests/test_multidevice.py::test_dryrun_cell_small_mesh``:
  reduced qwen3-8b on a (2, 2, 2) ("pod", "data", "model") mesh, train
  (8 x 64 tokens, AdamW), prefill (8 x 64, ``last_only``) and decode (8
  rows, a cache of 64).  The port runs one rank's program on meta tensors
  under a fake group of 8 ranks; the reference lowers and compiles the same
  cells in a subprocess on host devices (8 of the 512 that importing
  ``repro.launch.dryrun`` makes).  Per-rank argument bytes equal
  the reference's ``memory_analysis().argument_size_in_bytes`` exactly;
  per-rank flops are within ``FLOPS_RTOL`` of ``hlo_analysis``'s (measured
  on this CPU: equal in all three cells, 41,943,040 / 11,567,104 /
  212,992).  The reference test's own cell, reduced zamba2-7b's decode,
  with its train cell and reduced mamba2-2.7b's decode: argument bytes
  equal, flops the reference's plus the whole-N B / C projections.  Two
  more cells on the same mesh: reduced phi3.5-moe's train (argument bytes
  equal; flops not compared, the reference's one-hot dispatch against the
  port's gather form) and reduced qwen3-8b with 3 / 1 heads (the
  ``q_sequence`` attention split), train and prefill, argument bytes equal
  and flops within ``FLOPS_RTOL``.
* ``smollm-135m x train_4k`` at the real (16, 16) mesh of 256 ranks comes
  back ``ok``, its argument bytes the analytic state (float32 parameters
  and both AdamW moments, each leaf over the ranks its spec shards it
  across) plus the step and this rank's rows of the batch.
* ``compute_roofline`` and the report render on fixed costs.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import configs as JC
from repro.configs import shapes as jshapes
from repro_torch import configs as TC
from repro_torch.configs import shapes as tshapes
from repro_torch.launch import cost, report, roofline

ROOT = Path(__file__).resolve().parents[1]
FLOPS_RTOL = 1e-3
TIMEOUT = 240

_REF = r"""
import json
import os
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import configs
from repro.configs.shapes import ShapeSpec
from repro.distributed.sharding import activation_sharding
from repro.launch import hlo_analysis
from repro.launch.dryrun import _batch_specs, _sds
from repro.launch.mesh import make_mesh, named
from repro.models import DecodeEngine, Model
from repro.train import OptimizerConfig
from repro.train import step as step_lib

# repro.launch.dryrun sets 512 host devices at import; the mesh takes 8 of them.
assert jax.device_count() >= 8
B, S = 8, 64
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
fsdp = ("pod", "data")
out = {}
CELLS = [("", configs.get_reduced("qwen3-8b"), ("train", "prefill", "decode")),
         ("moe_", configs.get_reduced("phi3.5-moe-42b-a6.6b"), ("train",)),
         ("q_sequence_", configs.get_reduced("qwen3-8b", num_heads=3, num_kv_heads=1),
          ("train", "prefill")),
         ("hybrid_", configs.get_reduced("zamba2-7b"), ("train", "decode")),
         ("ssm_", configs.get_reduced("mamba2-2.7b"), ("decode",))]
# This process's share of the cells (three processes compile them at once).
SHARE = {"": "base", "moe_": "more", "q_sequence_": "more", "hybrid_": "ssm", "ssm_": "ssm"}
CELLS = [c for c in CELLS if SHARE[c[0]] == os.environ["TWIN_CELLS"]]
for tag, cfg, kind in ((t, c, k) for t, c, kinds in CELLS for k in kinds):
    model, engine = Model(cfg), DecodeEngine(Model(cfg))
    pspecs = model.param_specs(mesh, fsdp=fsdp)
    sp = ShapeSpec(kind, S, B, kind)
    bspecs = _batch_specs(cfg, mesh, sp, kind)
    seq = 1 if kind == "decode" else S
    b = {"tokens": jax.ShapeDtypeStruct((B, seq), jnp.int32)}
    if kind == "train":
        b["labels"] = jax.ShapeDtypeStruct((B, seq), jnp.int32)
    b = _sds(b, mesh, bspecs)
    logit_spec = P(bspecs["tokens"][0], None, "model")
    with mesh, activation_sharding(mesh, batch_axes=fsdp):
        if kind == "train":
            opt = OptimizerConfig(name="adamw")
            sspecs = step_lib.state_specs(model, opt, mesh, fsdp=fsdp)
            state = _sds(step_lib.state_shapes(model, opt), mesh, sspecs)
            c = jax.jit(step_lib.make_train_step(model, opt),
                        in_shardings=named(mesh, (sspecs, bspecs)),
                        out_shardings=named(mesh, (sspecs, None)),
                        donate_argnums=(0,)).lower(state, b).compile()
        elif kind == "prefill":
            cspecs = engine.cache_specs(mesh, B, fsdp=fsdp)
            pin = _sds(model.param_shapes(), mesh, pspecs)
            c = jax.jit(lambda p, x: engine.prefill(p, x, max_len=S, last_only=True),
                        in_shardings=named(mesh, (pspecs, bspecs)),
                        out_shardings=named(mesh, (logit_spec, cspecs))).lower(pin, b).compile()
        else:
            cspecs = engine.cache_specs(mesh, B, fsdp=fsdp)
            cin = _sds(engine.cache_shapes(B, S), mesh, cspecs)
            pin = _sds(model.param_shapes(), mesh, pspecs)
            c = jax.jit(engine.decode_step, in_shardings=named(mesh, (pspecs, cspecs, bspecs)),
                        out_shardings=named(mesh, (logit_spec, cspecs)),
                        donate_argnums=(1,)).lower(pin, cin, b).compile()
    out[tag + kind] = {"args": c.memory_analysis().argument_size_in_bytes,
                       "flops": hlo_analysis.analyze(c.as_text()).flops}
print("RESULT " + json.dumps(out))
"""

_PORT = r"""
import json
from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import cost, dryrun
from repro_torch.launch.mesh import make_mesh

cost.fake_world(8)
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
out = {}
CELLS = [("", configs.get_reduced("qwen3-8b"), ("train", "prefill", "decode")),
         ("moe_", configs.get_reduced("phi3.5-moe-42b-a6.6b"), ("train",)),
         ("q_sequence_", configs.get_reduced("qwen3-8b", num_heads=3, num_kv_heads=1),
          ("train", "prefill")),
         ("hybrid_", configs.get_reduced("zamba2-7b"), ("train", "decode")),
         ("ssm_", configs.get_reduced("mamba2-2.7b"), ("decode",))]
for tag, cfg, kind in ((t, c, k) for t, c, kinds in CELLS for k in kinds):
    m = dryrun.trace_cell(cfg, ShapeSpec(kind, 64, 8, kind), mesh)
    out[tag + kind] = {"args": m.memory["argument_size_in_bytes"], "flops": m.costs.flops,
                       "peak": m.memory["peak_bytes"],
                       "collectives": sum(c.count for c in m.costs.collectives)}
print("RESULT " + json.dumps(out))
"""


def _start(script: str, **env) -> subprocess.Popen:
    e = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1", **env)
    return subprocess.Popen([sys.executable, "-c", script], env=e, cwd=ROOT, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _result(p: subprocess.Popen) -> dict:
    out, err = p.communicate(timeout=TIMEOUT)
    assert p.returncode == 0, err[-3000:]
    line = [x for x in out.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    """The reference's compiled cells, the port's traced ones and the
    256-rank smollm cell, all three processes at once."""
    out = tmp_path_factory.mktemp("dryrun")
    refs = [_start(_REF, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   JAX_PLATFORMS="cpu", TWIN_CELLS=cells) for cells in ("base", "more", "ssm")]
    port = _start(_PORT)
    cell = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "smollm-135m",
         "--shape", "train_4k", "--mesh", "single", "--out", str(out)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1"), cwd=ROOT,
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        got = {"ref": {k: v for p in refs for k, v in _result(p).items()},
               "port": _result(port)}
        _, err = cell.communicate(timeout=TIMEOUT)
        assert cell.returncode == 0, err[-3000:]
    finally:
        for p in (*refs, port, cell):
            if p.poll() is None:
                p.kill()
    got["cell"] = json.loads((out / "smollm-135m__train_4k__single.json").read_text())
    return got


@pytest.mark.parametrize("arch", list(TC.ARCHS))
@pytest.mark.parametrize("shape", list(tshapes.SHAPES))
def test_input_specs_match_reference(arch, shape):
    want = jshapes.input_specs(JC.get(arch), shape)
    got = tshapes.input_specs(TC.get(arch), shape)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).replace("torch.", "") == str(w.dtype), k


@pytest.mark.parametrize("arch", ["qwen3-8b", "musicgen-medium", "llama-3.2-vision-11b"])
def test_demo_batch_matches_reference(arch):
    want = jshapes.demo_batch(JC.get_reduced(arch), 2, 6, np.random.default_rng(3))
    got = tshapes.demo_batch(TC.get_reduced(arch), 2, 6, np.random.default_rng(3), device="cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(w, np.float32), k)
        assert str(got[k].dtype).replace("torch.", "") == str(w.dtype), k


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dryrun_cell_small_mesh_matches_reference(twins, kind):
    ref, port = twins["ref"][kind], twins["port"][kind]
    assert port["args"] == ref["args"]
    np.testing.assert_allclose(port["flops"], ref["flops"], rtol=FLOPS_RTOL)
    assert port["peak"] >= port["args"] and port["collectives"] > 0


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_dryrun_q_sequence_cell_matches_reference(twins, kind):
    """Reduced qwen3-8b with 3 heads on 1 KV head over TP 2: attention
    splits the q sequence (each rank its rows against the whole K and V, k
    and v projected by columns and gathered), as the reference's XLA
    partitions it; per-rank flops within ``FLOPS_RTOL`` (measured on this
    CPU: equal, 36,962,304 train and 9,994,240 prefill)."""
    ref, port = twins["ref"]["q_sequence_" + kind], twins["port"]["q_sequence_" + kind]
    assert port["args"] == ref["args"]
    np.testing.assert_allclose(port["flops"], ref["flops"], rtol=FLOPS_RTOL)


def test_dryrun_moe_cell_matches_reference_bytes(twins):
    """Reduced phi3.5-moe's train cell: argument bytes equal the
    reference's exactly.  Flops are not compared: the reference counts its
    one-hot dispatch and combine einsums over every (token, expert, slot),
    the port's gather form runs each expert over its capacity's slots
    (measured on this CPU: 73,793,536 against 258,150,400, a ratio of
    0.286)."""
    ref, port = twins["ref"]["moe_train"], twins["port"]["moe_train"]
    assert port["args"] == ref["args"]
    assert 0 < port["flops"] < ref["flops"] and port["collectives"] > 0


def _whole_bc_flops(cfg, kind: str, rows: int = 2, seq: int = 64, tp: int = 2) -> float:
    """The products the port adds to the reference's in a Mamba2 layer: it
    gathers ``w_b`` and ``w_c`` (N sharded over TP by their spec) and
    projects every N on every TP rank, where the reference's partitioner
    projects each rank's N slice.  Per layer, two (rows·seq, D) x (D, N)
    products, (1 - 1/TP) of each beyond the reference's; a train step runs
    each three times (forward, and the backward's two products)."""
    seq = 1 if kind == "decode" else seq
    per_layer = 2 * 2 * rows * seq * cfg.d_model * cfg.ssm_state * (1 - 1 / tp)
    return per_layer * cfg.num_layers * (3 if kind == "train" else 1)


def test_dryrun_hybrid_cell_waits_for_item_11c(twins):
    """The twin of the reference's hybrid cell (``test_dryrun_cell_small_mesh``
    compiles reduced zamba2-7b's decode on (2, 2, 2)), which waited for
    ROADMAP Queue 1 item 11c until the ssm and hybrid families had a
    sharded path: reduced zamba2-7b's train and decode cells and reduced
    mamba2-2.7b's decode cell.  Per-rank argument bytes equal the
    reference's compiled cells exactly; per-rank flops are the reference's
    plus the whole-N ``w_b`` / ``w_c`` projections (:func:`_whole_bc_flops`),
    within ``FLOPS_RTOL`` (measured on this CPU: 108,298,240 against
    104,325,120 + 3,932,160 train, 525,312 = 504,832 + 20,480 and 157,696 =
    149,504 + 8,192 decode; the train cell's remaining 40,960, 4e-4, is the
    SSD's pairwise products against the reference's einsums)."""
    cells = {"hybrid_train": ("zamba2-7b", "train"), "hybrid_decode": ("zamba2-7b", "decode"),
             "ssm_decode": ("mamba2-2.7b", "decode")}
    for tag, (arch, kind) in cells.items():
        ref, port = twins["ref"][tag], twins["port"][tag]
        assert port["args"] == ref["args"], tag
        extra = _whole_bc_flops(TC.get_reduced(arch), kind)
        np.testing.assert_allclose(port["flops"], ref["flops"] + extra, rtol=FLOPS_RTOL,
                                   err_msg=tag)
        assert port["peak"] >= port["args"] and port["collectives"] > 0, tag


def test_dryrun_smollm_train_at_the_production_mesh(twins):
    from repro_torch.distributed.sharding import axes_size, entry_axes, mesh_sizes
    from repro_torch.models.model import param_layout, param_specs

    rec = twins["cell"]
    assert rec["ok"] and "skipped" not in rec and rec["n_devices"] == 256
    cfg = TC.get("smollm-135m")
    sizes = mesh_sizes({"data": 16, "model": 16})
    specs = dict(param_specs(cfg, sizes).items())
    state = 0
    for name, (shape, _) in param_layout(cfg).items():
        spec = specs
        for key in name.split("."):
            spec = spec[key]
        shards = np.prod([axes_size(sizes, entry_axes(e)) for e in tuple(spec)])
        state += 3 * 4 * int(np.prod(shape)) // int(shards)   # float32 param, mu, nu
    batch = 2 * (256 // 16) * 4096 * 4                        # tokens, labels: int32
    assert rec["memory"]["argument_size_in_bytes"] == state + 4 + batch
    rl = rec["roofline"]
    assert rl["peaks"] == "h100-sxm" and rl["bottleneck"] in ("compute", "memory", "collective")
    assert rl["t_collective"] > 0 and rec["hlo"]["flops_per_device"] > 0


def _fixed_costs():
    return cost.Costs(flops=989e12 * 0.002, hbm_bytes=3.35e12 * 0.001,
                      collective_traffic=2 * 50e9 * 0.001,
                      collectives=[cost.CollectiveInfo("all-reduce", 16, 50e9 * 0.001,
                                                       50e9 * 0.001, 1.0, "network"),
                                   cost.CollectiveInfo("all-gather", 8, 450e9 * 0.001,
                                                       450e9 * 0.001, 1.0, "nvlink")],
                      per_opcode_flops={"aten.mm": 989e12 * 0.002})


def test_roofline_terms_on_fixed_costs():
    rl = roofline.compute_roofline(arch="a", shape="s", mesh_name="single", n_devices=4,
                                   costs=_fixed_costs(), model_flops=989e12 * 0.004)
    assert rl.t_compute == pytest.approx(2e-3) and rl.t_memory == pytest.approx(1e-3)
    assert rl.t_collective == pytest.approx(2e-3)          # 1 ms on the network + 1 ms NVLink
    assert rl.bottleneck in ("compute", "collective") and rl.step_time_bound == pytest.approx(2e-3)
    assert rl.useful_ratio == pytest.approx(0.5) and rl.roofline_fraction == pytest.approx(1.0)
    pcie = roofline.compute_roofline(arch="a", shape="s", mesh_name="single", n_devices=4,
                                     costs=_fixed_costs(), model_flops=0.0,
                                     peaks_of="h100-pcie")
    assert pcie.t_compute == pytest.approx(2e-3 * 989 / 756)
    k = roofline.kernel_roofline("k", _fixed_costs(), us_measured=4000.0)
    assert k.bound_us == pytest.approx(2000.0) and k.gap == pytest.approx(2.0)
    assert "bottleneck=compute" in k.columns()
    assert roofline.fits(79e9) and not roofline.fits(81e9)
    with pytest.raises(KeyError):
        roofline.peaks("v5e")


def test_report_renders_fixed_records(tmp_path):
    rl = roofline.compute_roofline(arch="qwen3-8b", shape="train_4k", mesh_name="single",
                                   n_devices=256, costs=_fixed_costs(), model_flops=1e15)
    recs = [{"arch": "qwen3-8b", "shape": "train_4k", "mesh": "single", "ok": True,
             "trace_seconds": 3.0, "roofline": rl.as_dict(),
             "memory": {"argument_size_in_bytes": 2 * 2**30, "temp_size_in_bytes": 2**30,
                        "peak_bytes": 3 * 2**30}},
            {"arch": "zamba2-7b", "shape": "train_4k", "mesh": "single", "ok": True,
             "skipped": "waits for ROADMAP Queue 1 item 11c"},
            {"arch": "arctic-480b", "shape": "train_4k", "mesh": "multi", "ok": True,
             "trace_seconds": 9.0, "roofline": dict(rl.as_dict(), mesh="multi"),
             "memory": {"argument_size_in_bytes": 90e9, "temp_size_in_bytes": 1e9,
                        "peak_bytes": 91e9}}]
    for r in recs:
        (tmp_path / f"{r['arch']}__{r['shape']}__{r['mesh']}.json").write_text(json.dumps(r))
    loaded = report.load(tmp_path)
    assert len(loaded) == 3
    single = report.roofline_table(loaded, "single")
    assert "| qwen3-8b | train_4k |" in single and "SKIP zamba2-7b" in single
    mem = report.memory_table(loaded, "multi")
    assert "| arctic-480b | train_4k |" in mem and "| NO |" in mem
    assert "| yes |" in report.memory_table(loaded, "single")
    text = report.render(loaded)
    assert "single mesh" in text and "multi mesh" in text
