"""The port's training math against the JAX package's, on the CPU: the
optimizers, the learning-rate schedule and clipping, ``Model.loss`` and its
gradients, and three train steps, from the same numpy inputs.

Tolerances: optimizer updates, schedule and clipping max abs 1e-6 (the same
float32 arithmetic); the loss relative 1e-5; each gradient leaf's largest
error within 1e-5 of its largest magnitude; after three steps the loss
relative 1e-5 and the parameters max abs 1e-5 under Adafactor.  Under AdamW
the parameters differ by up to 4.3e-5 after three steps: where a gradient
element is as small as ``eps`` (1e-8), float32 rounding of the gradient
(1.6e-6 of the largest) moves g / (|g| + eps), and with it the update, by
percents.  Given the same gradients the AdamW update agrees to 1e-6
(``test_optimizer_update_matches_reference``), so the three steps under
AdamW are held to 1e-4.

zamba2-7b's reduced config (five Mamba2 layers, the shared attention block
twice) holds its gradient leaves to 3e-5 of their largest magnitude: against
the same gradients in float64 (the reference run with ``jax_enable_x64``),
the JAX package's float32 gradients are off by up to 7.3e-6 and the port's
by 6.9e-6, so the two float32 results may differ by about their sum
(measured up to 1.03e-5).  mamba2-2.7b's are within 1.7e-6 of float64 and
keep 1e-5.  For the same reason zamba2-7b's parameters after three AdamW
steps are held to 3e-4: they differ by up to 1.35e-4 (2 of w_x's 40,960
elements above 1e-4, where the gradient's RMS is 1/137 of the leaf's
largest and the first moments differ by 5e-4 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import Model as JModel
from repro.train import OptimizerConfig as JOptimizerConfig
from repro.train import init_state as j_init_state
from repro.train import make_train_step as j_make_train_step
from repro.train import optimizer as jopt
from repro_torch import configs as TC
from repro_torch.models import Model
from repro_torch.models import model as model_lib
from repro_torch.models.convert import params_from_numpy, state_from_numpy
from repro_torch.train import OptimizerConfig, init_state, make_train_step
from repro_torch.train import optimizer as topt
from repro_torch.train.tree import leaves_with_paths

ARCHS = ["smollm-135m", "qwen3-8b", "mamba2-2.7b", "zamba2-7b"]
# Each gradient leaf's largest error, relative to its largest magnitude (see
# the module's docstring for zamba2-7b's).
GRAD_TOL = {"zamba2-7b": 3e-5}
OPT = dict(learning_rate=3e-3, warmup_steps=2, decay_steps=10)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _named(tree) -> dict:
    """``{"a/b": leaf}`` of a JAX tree or a port tree, as numpy arrays."""
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        return {"/".join(p): v.detach().numpy() for p, v in leaves_with_paths(tree)}
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(vocab, b=2, s=32, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        batch["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return batch


def _models(arch):
    """The reference's reduced model with its seeded parameters, and the
    port's model holding the same parameters."""
    jm = JModel(JC.get_reduced(arch))
    params = jm.init(jax.random.PRNGKey(0))
    tm = params_from_numpy(Model(TC.get_reduced(arch), device="cpu"), _np_tree(params))
    return jm, params, tm


# ---------------------------------------------------------------------------
# Optimizer, schedule, clipping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 5, 99, 100, 101, 5000, 10_000, 20_000])
def test_lr_schedule_matches_reference(step):
    for cfg in (OptimizerConfig(), OptimizerConfig(learning_rate=1.0, warmup_steps=10,
                                                   decay_steps=100)):
        jcfg = JOptimizerConfig(**dataclasses.asdict(cfg))
        want = float(jopt.lr_schedule(jcfg, jnp.int32(step)))
        got = topt.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6


def _opt_inputs(seed):
    """Parameters of 1, 2 and 3 dims (a norm scale, a matrix, a stacked
    layer leaf), gradients and a step."""
    rng = np.random.default_rng(seed)
    shapes = {"norm": (16,), "mat": (12, 20), "blocks": {"w": (3, 8, 12), "s": (3, 8)}}
    params = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    grads = jax.tree.map(lambda p: (rng.normal(size=p.shape) * 0.1).astype(np.float32), params)
    return params, grads


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("step", [0, 3, 250])
def test_optimizer_update_matches_reference(name, step):
    """Two updates from the same parameters, gradients and state."""
    cfg = OptimizerConfig(name=name, learning_rate=1e-2, warmup_steps=4, decay_steps=500)
    jcfg = JOptimizerConfig(**dataclasses.asdict(cfg))
    params, grads = _opt_inputs(step)
    jp, jstate = jax.tree.map(jnp.asarray, params), jopt.opt_init(jcfg, params)
    tp = _t_tree(params)
    tstate = topt.opt_init(cfg, tp)
    assert set(_named(tstate)) == set(_named(jstate))
    for i in range(2):
        jg = jax.tree.map(lambda g: jnp.asarray(g * (1 + i)), grads)
        tg = _t_tree(jax.tree.map(lambda g: g * (1 + i), grads))
        jp, jstate, jlr = jopt.opt_update(jcfg, jp, jg, jstate, jnp.int32(step + i))
        tp, tstate, tlr = topt.opt_update(cfg, tp, tg, tstate,
                                          torch.tensor(step + i, dtype=torch.int32))
        assert abs(float(tlr) - float(jlr)) <= 1e-6
        for tree_t, tree_j in ((tp, jp), (tstate, jstate)):
            want, got = _named(tree_j), _named(tree_t)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_by_global_norm_matches_reference(scale):
    params, grads = _opt_inputs(7)
    grads = jax.tree.map(lambda g: g * scale, grads)
    want, jnorm = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 1.0)
    got, tnorm = topt.clip_by_global_norm(_t_tree(grads), 1.0)
    assert abs(float(tnorm) - float(jnorm)) <= 1e-6 * max(1.0, float(jnorm))
    want, got = _named(want), _named(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# Model.loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + ["minitron-8b", "internlm2-20b"])
def test_param_shapes_and_counts_match_reference(arch):
    """Names, shapes and counts of the full config's parameters (no tensor
    is built) and of the reduced model's."""
    jm = JModel(JC.get(arch))
    want = {"/".join(str(k.key) for k in path): tuple(s.shape)
            for path, s in jax.tree_util.tree_flatten_with_path(jm.param_shapes())[0]}
    got = {"/".join(p): tuple(v.shape) for p, v in
           leaves_with_paths(model_lib.param_shapes(TC.get(arch)))}
    assert got == want
    assert model_lib.param_count(TC.get(arch)) == jm.num_active_params() == jm.num_params()
    tm = Model(TC.get_reduced(arch), device="cpu")
    assert tm.num_params() == tm.num_active_params() == JModel(JC.get_reduced(arch)).num_params()
    assert {"/".join(p): tuple(v.shape) for p, v in leaves_with_paths(tm.param_shapes())} == {
        "/".join(p): tuple(v.shape) for p, v in leaves_with_paths(tm.param_tree())}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("variant", ["plain", "loss_mask", "triangle"])
def test_loss_and_gradients_match_reference(arch, variant):
    """``Model.loss`` and every gradient leaf against ``jax.value_and_grad``
    of the reference's ``Model.loss``, on the reduced config (float32)."""
    jm, params, tm = _models(arch)
    batch = _batch(jm.cfg.vocab_size, mask=variant == "loss_mask")
    triangle = variant == "triangle"
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, triangle=triangle), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tree = tm.param_tree()
    names = [n for n, _ in leaves_with_paths(tree)]
    for p in tm.parameters():
        p.requires_grad_(True)
    loss, metrics = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                            triangle=triangle)
    assert set(metrics) == set(jmetrics) == {"nll", "loss"}
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = torch.autograd.grad(loss, [p for _, p in leaves_with_paths(tree)])
    want = _named(jgrads)
    assert set(want) == {"/".join(n) for n in names}
    for name, g in zip(names, grads):
        w = want["/".join(name)]
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_TOL.get(arch, 1e-5) * float(np.abs(w).max()), ("/".join(name), err)


def test_remat_gives_the_same_gradients():
    """``cfg.remat`` recomputes each layer under ``torch.utils.checkpoint``:
    the loss and gradients equal those without it."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(256).items()}
    out = []
    for remat in (False, True):
        tm = Model(TC.get_reduced("qwen3-8b", remat=remat), device="cpu")
        for p in tm.parameters():
            p.requires_grad_(True)
        loss, _ = tm.loss(batch)
        out.append((loss.detach(), torch.autograd.grad(loss, list(tm.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_train_steps_match_reference(arch, name):
    """Three ``make_train_step`` steps of both packages from the same train
    state (``state_from_numpy``) and batch: loss relative 1e-5 every step,
    then parameters and optimizer state (see the module's docstring)."""
    jm = JModel(JC.get_reduced(arch))
    jcfg = JOptimizerConfig(name=name, **OPT)
    jstate = j_init_state(jm, jcfg, jax.random.PRNGKey(0))
    tm = Model(TC.get_reduced(arch), device="cpu")
    cfg = OptimizerConfig(name=name, **OPT)
    tstate = state_from_numpy(tm, cfg, _np_tree(jstate))
    jstep, tstep = jax.jit(j_make_train_step(jm, jcfg)), make_train_step(tm, cfg)
    batch = _batch(jm.cfg.vocab_size, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(3):
        jstate, jm_ = jstep(jstate, jb)
        tstate, tm_ = tstep(tstate, tb)
        assert set(tm_) == set(jm_)
        assert abs(float(tm_["loss"]) - float(jm_["loss"])) <= 1e-5 * abs(float(jm_["loss"]))
        assert abs(float(tm_["grad_norm"]) - float(jm_["grad_norm"])) <= 1e-5 * float(
            jm_["grad_norm"])
        assert abs(float(tm_["lr"]) - float(jm_["lr"])) <= 1e-9
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    tol = (3e-4 if arch == "zamba2-7b" else 1e-4) if name == "adamw" else 1e-5
    want, got = _named(jstate["params"]), _named(tstate["params"])
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    assert worst <= tol, worst
    want, got = _named(jstate["opt"]), _named(tstate["opt"])
    assert set(want) == set(got)
    for k in want:   # moments: relative to each leaf's largest
        assert float(np.abs(got[k] - want[k]).max()) <= 1e-3 * float(np.abs(want[k]).max()), k


def test_microbatches_equal_one_batch():
    """``microbatches=2`` against one batch, at the reference's own test's
    tolerances (``tests/test_train_and_fault.py::test_grad_accum_equivalent``)."""
    cfg = OptimizerConfig(**OPT)
    batch = {k: torch.from_numpy(v) for k, v in _batch(256, b=4, s=16, seed=2).items()}
    out = []
    for mb in (1, 2):
        tm = Model(TC.get_reduced("smollm-135m"), device="cpu")
        state = init_state(tm, cfg)
        step = make_train_step(tm, cfg, microbatches=mb)
        state, metrics = step(state, batch)
        state, metrics = step(state, batch)
        out.append((metrics, _named(state["params"])))
    (m1, p1), (m2, p2) = out
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    for k in p1:
        np.testing.assert_allclose(p1[k], p2[k], rtol=2e-4, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_state_shapes_match_reference(name):
    """``state_shapes``: the train state's names, shapes and dtypes, as the
    reference's ``eval_shape`` of ``init_state`` gives them, on ``meta``."""
    from repro.train.step import state_shapes as j_state_shapes
    from repro_torch.train import state_shapes

    want = {"/".join(str(k.key) for k in path): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(j_state_shapes(
                JModel(JC.get_reduced("qwen3-8b")), JOptimizerConfig(name=name)))[0]}
    got = leaves_with_paths(state_shapes(Model(TC.get_reduced("qwen3-8b"), device="cpu"),
                                         OptimizerConfig(name=name)))
    assert {"/".join(p): (tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in got} == want
    assert all(x.device.type == "meta" for _, x in got)


def test_train_state_holds_the_models_own_parameters():
    tm = Model(TC.get_reduced("smollm-135m"), device="cpu")
    assert not any(p.requires_grad for p in tm.parameters())
    state = init_state(tm, OptimizerConfig())
    assert all(p.requires_grad for p in tm.parameters())
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    assert [p for _, p in leaves_with_paths(state["params"])] == \
        [p for _, p in leaves_with_paths(tm.param_tree())]
    other = Model(TC.get_reduced("smollm-135m"), device="cpu")
    with pytest.raises(ValueError, match="model's own"):
        make_train_step(other, OptimizerConfig())(state, {})
