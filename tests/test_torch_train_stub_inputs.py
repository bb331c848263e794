"""The port's training loop fed the stub frontends' outputs
(``launch/train.run(..., inputs=...)``) against the reference's functions:
paligemma-3b smoke with its 8 prefix embeddings and whisper-base smoke with
its 24 frames, the batches the JAX package's train step takes
(``harness.train_input_specs``: ``prefix_embeds``, ``frames``).

Three float32 int8 steps through ``train.run``, on the plain path and on
the kernel path (flash attention through ``kernels/_autograd.PlainGradient``
with its plain version handed to the forward, as the card hands it the
kernel), against ``jax.value_and_grad`` of the reference's loss,
``compress_grads`` and ``adamw.apply`` on the same batches with the
residual carried; tolerances as
``tests/test_torch_train_families.py::test_train_steps_match_reference``.
The weights are the reference's ``tree_init`` draw, carried across by value,
with every leaf it initialises to a constant (biases, norm scales) drawn
about it, so that a wrong bias or scale shows.  The inputs are drawn with
numpy from a seed, rounded to bf16 (their type in ``train_input_specs``).

40 steps at lr 1e-3, batch 8, seq 64, bf16 weights, int8, with inputs
drawn by ``train.drawn_inputs``: the reference's own 40 steps at that setup
(its ``tree_init`` at seeds 0, 1, 2, numpy-drawn inputs, the residual
carried) lower paligemma's loss by 2.72, 2.69 and 2.70 and whisper's by
0.416, 0.403 and 0.341, so the port's must fall by more than 2.0 and 0.3."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.data.pipeline as ref_pipeline
import repro.models.param as ref_param
from repro.models.api import ShapeCell as RefCell
from repro.models.layers import Runtime as RefRuntime
from repro.optim import adamw as RA, compression as RC
import repro_torch.configs as port_configs
from repro_torch.kernels import ops
from repro_torch.kernels._autograd import PlainGradient
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.launch import train
from repro_torch.models.api import ShapeCell
from repro_torch.models.layers import Runtime
from repro_torch.models.param import tree_leaves

from _torch_parity import carry, max_err, one_thread, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RRT = RefRuntime(rules=None)
ARCHS = ["paligemma-3b", "whisper-base"]
KEY = {"paligemma-3b": "prefix_embeds", "whisper-base": "frames"}
SEED, B, S, STEPS = 7, 2, 16, 3
# how far the reference's own 40 steps lower the loss, at least (docstring)
DROP = {"paligemma-3b": 2.0, "whisper-base": 0.3}


def harnesses(arch):
    return (ref_configs.load(arch, smoke=True).clone(dtype=jnp.float32),
            port_configs.load(arch, smoke=True).clone(dtype=torch.float32))


def _draw_constants(tree, rng):
    """Every leaf of a numpy tree that holds one value throughout (the
    reference's zero biases and unit scales) drawn about it, 0.1 randn."""
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            _draw_constants(leaf, rng)
        elif leaf.size > 1 and (leaf == leaf.flat[0]).all():
            tree[key] = (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def weights(arch):
    rh, _ = harnesses(arch)
    params = to_np(ref_param.tree_init(rh.param_specs(), jax.random.PRNGKey(SEED)))
    _draw_constants(params, np.random.default_rng(SEED))
    return params


def stub_shape(arch, batch):
    _, ph = harnesses(arch)
    return tuple(ph.train_input_specs(ShapeCell("t", "train", S, batch))[KEY[arch]].shape)


@functools.lru_cache(maxsize=None)
def stub(arch, step):
    """Step ``step``'s stub input, float32 numpy of bf16 values."""
    x = np.random.default_rng(100 + step).standard_normal(stub_shape(arch, B)).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float().numpy()


def batch(arch, step):
    rh, _ = harnesses(arch)
    cfg = ref_pipeline.DataConfig(global_batch=B, seq_len=S, vocab_size=rh.cfg.vocab_size, seed=0)
    raw = ref_pipeline.SyntheticSource(cfg).batch_at(step)
    return {"tokens": raw[:, :-1], "labels": raw[:, 1:], KEY[arch]: stub(arch, step)}


@functools.lru_cache(maxsize=None)
def reference_steps(arch, lr=1e-3):
    """The reference's functions in its train script's order, float32, int8
    with the residual carried, each step's batch holding its stub input."""
    rh, _ = harnesses(arch)
    comp = RC.CompressionConfig(mode="int8")
    opt_cfg = RA.OptConfig(lr=lr, warmup_steps=10, decay_steps=STEPS)
    params = jax.tree.map(jnp.asarray, weights(arch))
    state, residual, out = RA.init_opt_state(params), None, []
    grad_fn = jax.jit(jax.value_and_grad(rh.loss(RRT)))
    for step in range(STEPS):
        b = batch(arch, step)
        b = {k: jnp.asarray(v, jnp.bfloat16) if k == KEY[arch] else jnp.asarray(v) for k, v in b.items()}
        loss, grads = grad_fn(params, b)
        payload, residual = RC.compress_grads(comp, grads, residual)
        params, state, _ = RA.apply(opt_cfg, params, payload, state)
        out.append({"loss": float(loss), "grads": [to_np(g) for g in jax.tree.leaves(grads)],
                    "payload": [to_np(p) for p in jax.tree.leaves(payload)]})
    return out, [to_np(m) for m in jax.tree.leaves(state["master"])]


def flash_through_function():
    """``ops.flash_attention`` through ``PlainGradient`` (its plain version
    as the forward), as the card runs it under autograd; returns the
    restore and the list of calls made."""
    calls, saved = [], ops.flash_attention

    def through(q, k, v, **kw):
        calls.append(kw)
        return PlainGradient.apply("plain", lambda *t: flash_attention_plain(*t, **kw),
                                   lambda *t: flash_attention_plain(*t, **kw), q, k, v)

    ops.flash_attention = through
    return (lambda: setattr(ops, "flash_attention", saved)), calls


def leaf_names(arch) -> list[str]:
    rh, _ = harnesses(arch)
    return [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(
        rh.param_specs(), is_leaf=lambda x: hasattr(x, "logical"))[0]]


def args_for(arch, *extra):
    return train.build_parser().parse_args(["--arch", arch, "--device", "cpu", *extra])


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_with_stub_inputs_match_reference(arch, use_kernels):
    """Three float32 steps from the same weights and batches through
    ``train.run(..., inputs=...)`` (int8, residual carried) and the
    reference's functions: step 0's loss and gradients within 2e-5, every
    step's loss within 1e-4; the masters after the last step within 1e-6 of
    the reference's at every element whose int8 value was the same on both
    sides at every step, and within twice the learning rates summed
    everywhere (a gradient straddling a rounding boundary moves its int8
    value by one).  whisper's key biases are held only by the last: a key
    bias adds one constant to a query's every score, so its exact gradient
    is zero and both sides' are rounding noise, which the int8 compression
    scales to the whole range of the leaf.  On the kernel path every attention (paligemma: 2 layers;
    whisper: 2 encoder layers, 2 decoder layers' self- and cross-attention)
    goes through the ``autograd.Function`` twice a step, in the forward and
    in the ``"nothing"`` remat's recompute."""
    ref, ref_master = reference_steps(arch)
    _, ph = harnesses(arch)
    seen = []
    params = carry(weights(arch), torch.float32)
    args = args_for(arch, "--steps", str(STEPS), "--batch", str(B), "--seq", str(S), "--lr", "1e-3",
                    "--compression", "int8")
    restore, calls = flash_through_function() if use_kernels else ((lambda: None), [])
    try:
        res = train.run(args, harness=ph, params=params, rt=Runtime(use_kernels=use_kernels),
                        inputs=lambda step: {KEY[arch]: torch.from_numpy(stub(arch, step)).bfloat16()},
                        observe=lambda step, loss, grads, payload, wire: seen.append((grads, tree_leaves(payload))))
    finally:
        restore()
    per_step = {"paligemma-3b": 2, "whisper-base": 6}[arch] * ph.cfg.n_layers
    assert len(calls) == (per_step * STEPS if use_kernels else 0)
    assert abs(res["losses"][0] - ref[0]["loss"]) <= 2e-5
    for g, a in zip(tree_leaves(seen[0][0]), ref[0]["grads"], strict=True):
        assert max_err(g, a) <= 2e-5
    for s in range(STEPS):
        assert abs(res["losses"][s] - ref[s]["loss"]) <= 1e-4
    names = leaf_names(arch)
    for i, (a, b) in enumerate(zip(ref_master, tree_leaves(params), strict=True)):
        d = np.abs(to_np(b) - a)
        assert d.max() <= 2 * sum(res["lrs"])
        if names[i].endswith("['bk']"):
            continue
        moved_apart = np.zeros(d.shape, bool)
        for s in range(STEPS):
            r = ref[s]["payload"][i]
            moved_apart |= np.abs(to_np(seen[s][1][i]) - r) > 0.5 * np.abs(r).max() / 127
        assert moved_apart.sum() <= max(4, 1e-2 * d.size), names[i]
        assert (d[~moved_apart] <= 1e-6).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_stub_inputs_change_the_step(arch):
    """The stub input reaches the loss: the same weights and tokens with
    another prefix or other frames give another first loss, as the
    reference's loss does."""
    rh, ph = harnesses(arch)
    losses = []
    for shift in (0, 1):
        args = args_for(arch, "--steps", "1", "--batch", str(B), "--seq", str(S))
        res = train.run(args, harness=ph, params=carry(weights(arch), torch.float32),
                        inputs=lambda step: {KEY[arch]: torch.from_numpy(stub(arch, step + shift)).bfloat16()})
        losses.append(res["losses"][0])
    b = batch(arch, 0)
    b[KEY[arch]] = stub(arch, 1)
    ref = float(jax.jit(rh.loss(RRT))(jax.tree.map(jnp.asarray, weights(arch)), jax.tree.map(jnp.asarray, b)))
    assert losses[0] != losses[1] and abs(losses[1] - ref) <= 2e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_train_with_drawn_inputs_lowers_the_loss(arch):
    """40 steps of the smoke config with ``train.drawn_inputs``, lr 1e-3,
    batch 8, seq 64, bf16 weights, int8: the loss falls by more than the
    reference's own 40 steps do at that setup (module docstring)."""
    _, ph = harnesses(arch)
    args = args_for(arch, "--steps", "40", "--batch", "8", "--seq", "64", "--lr", "1e-3", "--compression", "int8")
    losses = train.run(args, inputs=train.drawn_inputs(ph, 8, 100, "cpu"))["losses"]
    assert len(losses) == 40 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - DROP[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_drawn_inputs(arch):
    """``train.drawn_inputs``: step s's input is ``serve.stub_inputs`` at the
    seed plus s, of ``train_input_specs``' shape and type; other steps draw
    other values, a second helper the same ones."""
    from repro_torch.launch import serve

    _, ph = harnesses(arch)
    spec = ph.train_input_specs(ShapeCell("t", "train", S, 4))[KEY[arch]]
    a, b = train.drawn_inputs(ph, 4, 9, "cpu"), train.drawn_inputs(ph, 4, 9, "cpu")
    x0, x1 = a(0)[KEY[arch]], a(1)[KEY[arch]]
    assert list(a(0)) == [KEY[arch]]
    assert tuple(x0.shape) == tuple(spec.shape) and x0.dtype == spec.dtype == torch.bfloat16
    assert torch.equal(x0, b(0)[KEY[arch]]) and not torch.equal(x0, x1)
    assert torch.equal(x1, serve.stub_inputs(ph, 4, 10, "cpu")[KEY[arch]])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_input_specs_match_reference(arch):
    rh, ph = harnesses(arch)
    r = rh.train_input_specs(RefCell("t", "train", S, B))
    p = ph.train_input_specs(ShapeCell("t", "train", S, B))
    assert sorted(p) == sorted(r) == sorted(["tokens", "labels", KEY[arch]])
    assert p[KEY[arch]].shape == r[KEY[arch]].shape == stub_shape(arch, B)


@pytest.mark.parametrize("arch,key,shape,match", [
    ("paligemma-3b", "frames", (B, 24, 128), "takes inputs"),
    ("whisper-base", "prefix_embeds", (B, 8, 64), "takes inputs"),
    ("paligemma-3b", "prefix_embeds", (B, 7, 128), "expected"),
    ("whisper-base", "frames", (B, 24, 32), "expected"),
])
def test_an_input_the_family_does_not_take_raises(arch, key, shape, match):
    """A key the family's ``train_input_specs`` does not hold, or a tensor of
    another shape, raises before any step runs."""
    args = args_for(arch, "--steps", "1", "--batch", str(B), "--seq", str(S))
    with pytest.raises(ValueError, match=match):
        train.run(args, inputs=lambda step: {key: torch.zeros(shape, dtype=torch.bfloat16)})


def test_a_dense_model_takes_no_prefix():
    """granite-8b's ``train_input_specs`` holds tokens and labels only."""
    args = args_for("granite-8b", "--steps", "1", "--batch", str(B), "--seq", str(S))
    with pytest.raises(ValueError, match="takes inputs"):
        train.run(args, inputs=lambda step: {"prefix_embeds": torch.zeros(B, 8, 128)})


def test_whisper_without_inputs_names_the_fault():
    """Without ``inputs`` the loop feeds tokens and labels only, as the
    reference's train script: the audio family raises naming ROADMAP C5."""
    with pytest.raises(ValueError, match="C5"):
        train.run(args_for("whisper-base", "--steps", "1", "--batch", str(B), "--seq", str(S)))
