"""The port's partition specs against the JAX package's, with no process
group: ``param_specs``, ``opt_state_specs`` (AdamW and Adafactor),
``state_specs``, ``batch_specs`` and ``cache_specs`` for all ten
configurations, full and reduced (shapes only), on the meshes (2, 2, 2)
pod/data/model, (16, 16) data/model, (2, 16, 16) and (4,) data, and the
tiny-batch sequence-parallel fallback of ``cache_specs``.  The reference's
specs are ``PartitionSpec`` trees, compared as tuples; the meshes are
stubs with ``.shape`` and ``.axis_names`` (the reference reads nothing
else) on its side, plain ``{name: size}`` mappings on the port's.

Also the spec type, the local-shard arithmetic and DTensor placements,
``attn_partition``'s three cases and, on a one-rank gloo group in this
process, one sharded step of the moe, vlm, audio, ssm and hybrid families.
"""

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as JC
from repro.models import Model as JModel
from repro.models.decode import DecodeEngine as JDecodeEngine
from repro.train import step as jstep
from repro.train.optimizer import OptimizerConfig as JOptimizerConfig
from repro.train.optimizer import opt_state_specs as jopt_state_specs
from repro_torch import configs as TC
from repro_torch.distributed import sharding as S
from repro_torch.models import model as tmodel
from repro_torch.models.decode import cache_specs
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep
from repro_torch.train.tree import leaves_with_paths, tree_map

MESHES = {"pod2-data2-model2": {"pod": 2, "data": 2, "model": 2},
          "data16-model16": {"data": 16, "model": 16},
          "pod2-data16-model16": {"pod": 2, "data": 16, "model": 16},
          "data4": {"data": 4}}
CASES = [(arch, size, mesh) for arch in TC.ARCHS for size in ("full", "reduced")
         for mesh in MESHES]


class _StubMesh:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


def _configs(arch, size):
    if size == "full":
        return JC.get(arch), TC.get(arch)
    return JC.get_reduced(arch), TC.get_reduced(arch)


def _tuples(jtree):
    return jax.tree.map(tuple, jtree, is_leaf=lambda x: isinstance(x, JP))


def _port(tree):
    return tree_map(tuple, tree)


def _ids(case):
    return "-".join(case)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_param_specs_match_reference(case):
    arch, size, mesh = case
    jcfg, tcfg = _configs(arch, size)
    want = _tuples(JModel(jcfg).param_specs(_StubMesh(MESHES[mesh])))
    got = tmodel.param_specs(tcfg, MESHES[mesh])
    assert _port(got) == want
    assert all(isinstance(sp, S.PartitionSpec) for sp in (leaf for _, leaf in
                                                           leaves_with_paths(got)))
    # Every spec has one entry a dim of its leaf.
    shapes = dict(leaves_with_paths(tmodel.param_shapes(tcfg)))
    assert {p: len(sp) for p, sp in leaves_with_paths(got)} == {
        p: t.dim() for p, t in shapes.items()}


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_opt_state_and_batch_specs_match_reference(case):
    arch, size, mesh = case
    jcfg, tcfg = _configs(arch, size)
    stub, sizes = _StubMesh(MESHES[mesh]), MESHES[mesh]
    jmodel = JModel(jcfg)
    jpspecs = jmodel.param_specs(stub)
    tpspecs = tmodel.param_specs(tcfg, sizes)
    adamw, adafactor = topt.OptimizerConfig(), topt.OptimizerConfig(name="adafactor")
    assert _port(topt.opt_state_specs(adamw, tpspecs)) == _tuples(
        jopt_state_specs(JOptimizerConfig(), jpspecs))
    # Adafactor: vr drops the spec's last entry, vc its second-to-last.  A
    # one-dim leaf keeps {"v": spec}, the tree adafactor_init builds (the
    # reference gives it {"vr", "vc"}, which its own state does not have).
    jfac = _tuples(jopt_state_specs(JOptimizerConfig(name="adafactor"), jpspecs))["v"]
    tfac = _port(topt.opt_state_specs(adafactor, tpspecs))["v"]
    for path, spec in leaves_with_paths(_port(tpspecs)):
        node_t, node_j = tfac, jfac
        for key in path:
            node_t, node_j = node_t[key], node_j[key]
        if len(spec) < 2:
            assert node_t == {"v": spec}
        else:
            assert node_t == node_j == {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}
    for opt, jopt in ((adamw, JOptimizerConfig()), (adafactor, None)):
        got = _port(tstep.state_specs(tcfg, opt, sizes))
        assert got["step"] == ()
        assert got["params"] == _tuples(jpspecs)
        if jopt is not None:
            assert got == _tuples(jstep.state_specs(jmodel, jopt, stub))
    assert _port(tstep.batch_specs(tcfg, sizes)) == _tuples(jstep.batch_specs(jmodel, stub))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_cache_specs_match_reference(case):
    arch, size, mesh = case
    jcfg, tcfg = _configs(arch, size)
    jeng = JDecodeEngine(JModel(jcfg))
    for batch in (1, 3, 8, 128):   # 1 and 3: the tiny-batch (sequence-parallel) fallback
        want = _tuples(jeng.cache_specs(_StubMesh(MESHES[mesh]), batch))
        assert _port(cache_specs(tcfg, MESHES[mesh], batch)) == want, batch


def test_cache_specs_tiny_batch_fallback():
    """long_500k's batch of 1: the sequence dim over the non-pod FSDP axes."""
    cfg = TC.get("zamba2-7b")
    got = cache_specs(cfg, MESHES["pod2-data16-model16"], 1)
    assert tuple(got["shared"]["k"]) == (None, None, "data", "model", None)
    assert tuple(cache_specs(cfg, MESHES["pod2-data16-model16"], 32)["shared"]["k"]) == (
        None, ("pod", "data"), None, "model", None)
    # MHA fallback: 24 KV heads on 16-way TP shard the head dim instead.
    mg = cache_specs(TC.get("musicgen-medium"), MESHES["data16-model16"], 16)
    assert tuple(mg["k"]) == (None, "data", None, None, "model")


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_adafactor_specs_match_its_state(arch):
    """Adafactor's spec tree is the tree of its state, leaf for leaf."""
    cfg = TC.get_reduced(arch)
    opt = topt.OptimizerConfig(name="adafactor")
    specs = topt.opt_state_specs(opt, tmodel.param_specs(cfg, MESHES["pod2-data2-model2"]))
    state = topt.opt_init(opt, tmodel.param_shapes(cfg))
    got = dict(leaves_with_paths(specs))
    assert set(got) == {p for p, _ in leaves_with_paths(state)}
    for path, t in leaves_with_paths(state):
        assert len(got[path]) == t.dim(), path


def test_param_specs_unknown_leaf_raises(monkeypatch):
    layout = tmodel.param_layout(TC.get_reduced("qwen3-8b"))
    layout["blocks.attn.w_mystery"] = ((2, 4, 4), 4)
    monkeypatch.setattr(tmodel, "param_layout", lambda cfg: layout)
    with pytest.raises(ValueError, match="no spec rule"):
        tmodel.param_specs(TC.get_reduced("qwen3-8b"), MESHES["data4"])


def test_spec_type_and_mesh_forms():
    assert tuple(S.P(("data",), None, (), ("pod", "data"))) == (
        tuple(JP(("data",), None, (), ("pod", "data"))))
    assert tuple(S.P()) == () and S.P(("pod", "data"), "model").axes() == (
        "pod", "data", "model")
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert S.mesh_sizes(sizes) == S.mesh_sizes(_StubMesh(sizes)) == sizes
    assert list(S.mesh_sizes(_StubMesh(sizes))) == ["pod", "data", "model"]
    with pytest.raises(TypeError):
        S.mesh_sizes(object())


def test_local_slices_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    sizes = {"pod": 2, "data": 2, "model": 2}
    spec = S.P(("pod", "data"), "model")
    shape = (8, 6)
    seen = torch.zeros(shape, dtype=torch.int64)
    for pod in range(2):
        for data in range(2):
            for model in range(2):
                sl = S.local_slices(shape, spec, sizes,
                                    {"pod": pod, "data": data, "model": model})
                assert sl[0] == slice((pod * 2 + data) * 2, (pod * 2 + data + 1) * 2)
                assert sl[1] == slice(model * 3, model * 3 + 3)
                seen[sl] += 1
    assert bool((seen == 1).all())
    assert S.local_shape(shape, spec, sizes) == (2, 3)
    assert S.to_placements(spec, sizes) == (Shard(0), Shard(0), Shard(1))
    assert S.to_placements(S.P(None, "data"), sizes) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError):
        S.to_placements(S.P(("data", "pod")), sizes)      # not the mesh's order
    with pytest.raises(ValueError):
        S.local_slices((7, 6), spec, sizes, {"pod": 0, "data": 0, "model": 0})


def test_attn_partition_cases():
    assert S.attn_partition(9, 3) is None             # no context: no partition
    with S.activation_sharding({"data": 2, "model": 3}):
        assert S.attn_partition(9, 3) == S.AttnPartition("heads", (0, 3), (0, 1), tp=3)
        assert S.constrain((8, 16, 49152), ("batch", None, "tp")) == S.P("data", None, "model")
        assert S.constrain_residual((6, 16, 576)) == S.P("data", None, None)
    with S.activation_sharding({"data": 2, "model": 2}):
        assert S.attn_partition(9, 3).case == "q_sequence"     # smollm on TP 2
        assert S.attn_partition(9, 3).q_rows(16) == (0, 8)      # rank 0 of TP 2
        assert S.attn_partition(9, 3).q_rows(1) is None         # a decode step: replicated
        assert S.attn_partition(4, 1) == S.AttnPartition("q_heads", (0, 2), (0, 1), tp=2)
        assert S.constrain((7, 4), ("batch", "tp")) == S.P(None, "model")
    with S.activation_sharding({"pod": 2, "data": 2}, tp_axis="model"):
        assert S.attn_partition(4, 2) is None             # no TP axis
        assert S.constrain((8,), ("batch",)) == S.P(("pod", "data"))
    with S.activation_sharding({"data": 2, "model": 2}, seq_parallel=True) as ctx:
        assert ctx.seq_parallel
        assert S.constrain_residual((6, 16, 576)) == S.P("data", "model", None)
        assert S.constrain_residual((6, 1, 576)) == S.P("data", None, None)   # a decode step
    assert S.current_context() is None


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-2.7b"])
def test_sharded_step_of_other_families_raises(arch, one_rank_mesh):
    """The ssm and hybrid families' sharded step (it raised until they had
    a sharded path) builds, and one step on one rank runs (their equality
    with the single device over 4 ranks is tests/test_torch_mesh_ssm.py's)."""
    from repro_torch.configs.shapes import demo_batch
    from repro_torch.models import Model

    cfg = TC.get_reduced(arch)
    opt = topt.OptimizerConfig()
    step, sspecs, bspecs = tstep.sharded_train_step(cfg, opt, one_rank_mesh)
    assert set(bspecs) == {"tokens", "labels"}
    assert set(sspecs["params"]) >= {"blocks", "embed"}
    assert ("shared_attn" in sspecs["params"]) == (cfg.family == "hybrid")
    model = Model(cfg, device="cpu")
    state = tstep.sharded_state(model, opt, one_rank_mesh)
    state, metrics = step(state, demo_batch(cfg, 2, 16, device="cpu"))
    assert int(state["step"]) == 1 and bool(torch.isfinite(metrics["loss"]))


@pytest.fixture(scope="module")
def one_rank_mesh(tmp_path_factory):
    """A (1, 1) data x model mesh over a one-rank gloo group in this process."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    store = tmp_path_factory.mktemp("group") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    yield make_mesh((1, 1), ("data", "model"), device_type="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "llama-3.2-vision-11b",
                                  "musicgen-medium"])
def test_sharded_step_of_the_moe_vlm_and_audio_families_builds(arch, one_rank_mesh):
    """The moe, vlm and audio families' sharded step builds, and one step on
    one rank runs (their equality with the single device over 4 ranks is
    tests/test_torch_mesh_families.py's)."""
    from repro_torch.configs.shapes import demo_batch
    from repro_torch.models import Model

    cfg = TC.get_reduced(arch)
    opt = topt.OptimizerConfig()
    step, sspecs, bspecs = tstep.sharded_train_step(cfg, opt, one_rank_mesh)
    want = {"frame_embeds" if cfg.frame_inputs else "tokens", "labels"} | (
        {"image_embeds"} if cfg.family == "vlm" else set())
    assert set(bspecs) == want
    model = Model(cfg, device="cpu")
    state = tstep.sharded_state(model, opt, one_rank_mesh)
    batch = demo_batch(cfg, 2, 8, device="cpu")
    batch = {k: v.float() if v.is_floating_point() else v for k, v in batch.items()}
    state, metrics = step(state, batch)
    assert int(state["step"]) == 1 and bool(torch.isfinite(metrics["loss"]))
    assert ("moe_dropped" in metrics) == (cfg.family == "moe")
