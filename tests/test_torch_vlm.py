"""Port of the transformer's bidirectional prefix (paligemma-3b) against the
reference: ``forward``, ``loss_fn`` (and every gradient leaf) and
``prefill`` with ``prefix_embeds``, then decode steps at P + S + i; ``serve.run``
against the reference's serving loop with no prefix (its ``main``) and with
a drawn one; the training loop, text-only as the reference's trains it.

paligemma's smoke config: 2 layers, d_model 128, 4 heads on 1 KV head of 32
(MQA), GELU, the gemma embedding scale, a prefix of 8.  Its layer norms'
scales are drawn (1 + 0.1 randn) where the reference has ones.

Tolerances as tests/test_torch_transformer.py and
tests/test_torch_train_families.py: logits float32 2e-4, bfloat16 3e-2 of
the largest |logit|; loss and gradients float32 2e-5, bfloat16 2e-2 of each
leaf's largest |g| or twice the reference's own bf16 distance from float32
where that is larger."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.param as ref_param
from repro.models import transformer as RT
from repro.models.api import ShapeCell as RefCell
from repro.models.layers import Runtime as RefRuntime
import repro_torch.configs as port_configs
from repro_torch.launch import serve, train
from repro_torch.models import transformer as PT
from repro_torch.models.api import ShapeCell
from repro_torch.models.layers import Runtime
from repro_torch.models.param import tree_init, tree_leaves, value_and_grad

from _torch_parity import JDT, TDT, carry, max_err, one_thread, rand, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RRT = RefRuntime(rules=None)
ARCH = "paligemma-3b"
B, S, STEPS = 2, 12, 4
SEED = 7


def harnesses(dtype):
    return (ref_configs.load(ARCH, smoke=True).clone(dtype=JDT[dtype]),
            port_configs.load(ARCH, smoke=True).clone(dtype=TDT[dtype]))


@functools.lru_cache(maxsize=None)
def weights():
    h, _ = harnesses("float32")
    params = to_np(ref_param.tree_init(h.param_specs(), jax.random.PRNGKey(SEED)))
    rng = np.random.default_rng(SEED)
    for name in ("ln1", "ln2"):
        shape = params["blocks"][name].shape
        params["blocks"][name] = (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    return params


@functools.lru_cache(maxsize=None)
def inputs():
    """prefix (B, P, d_model) of order 1, tokens (B, S + STEPS), labels (B, S)"""
    h, _ = harnesses("float32")
    rng = np.random.default_rng(11)
    prefix = rand(rng, (B, 8, h.cfg.d_model), scale=1.0)
    tokens = rng.integers(0, h.cfg.vocab_size, (B, S + STEPS), dtype=np.int32)
    labels = rng.integers(0, h.cfg.vocab_size, (B, S), dtype=np.int32)
    return prefix, tokens, labels


def ref_params(dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]), weights())


def logit_tol(dtype, ref) -> float:
    return 2e-4 if dtype == "float32" else 3e-2 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_with_prefix_matches_reference(dtype, use_kernels):
    """logits of the tokens only, (B, S, vocab); the prefix changes them"""
    rh, ph = harnesses(dtype)
    prefix, tokens, _ = inputs()
    ref, _ = RT.forward(RRT, rh.cfg, ref_params(dtype), jnp.asarray(tokens[:, :S]), jnp.asarray(prefix))
    ref = to_np(ref)
    rt, params = Runtime(use_kernels=use_kernels), carry(weights(), TDT[dtype])
    with torch.no_grad():
        port, aux = PT.forward(rt, ph.cfg, params, torch.from_numpy(tokens[:, :S]), torch.from_numpy(prefix))
        bare, _ = PT.forward(rt, ph.cfg, params, torch.from_numpy(tokens[:, :S]))
    assert tuple(port.shape) == (B, S, ph.cfg.vocab_padded) and float(aux) == 0.0
    assert max_err(port, ref) <= logit_tol(dtype, ref)
    assert max_err(port, bare) > 10 * logit_tol(dtype, ref)


@functools.lru_cache(maxsize=None)
def reference_loss_and_grads(dtype, weights_as=None):
    rh, _ = harnesses(dtype)
    w = weights()
    if weights_as is not None:
        w = to_np(jax.tree.map(lambda a: jnp.asarray(a, JDT[weights_as]), w))
    params = jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]), w)
    prefix, tokens, labels = inputs()
    b = {"tokens": jnp.asarray(tokens[:, :S]), "labels": jnp.asarray(labels),
         "prefix_embeds": jnp.asarray(prefix, jnp.bfloat16)}
    loss, grads = jax.jit(jax.value_and_grad(rh.loss(RRT)))(params, b)
    return float(loss), [to_np(g) for g in jax.tree.leaves(grads)]


@pytest.mark.parametrize("path", ["kernels", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_with_prefix_match_reference(dtype, path):
    """the batch as ``train_input_specs`` gives it: bf16 prefix embeddings"""
    r_loss, r_grads = reference_loss_and_grads(dtype)
    _, ph = harnesses(dtype)
    prefix, tokens, labels = inputs()
    b = {"tokens": torch.from_numpy(tokens[:, :S]), "labels": torch.from_numpy(labels),
         "prefix_embeds": torch.from_numpy(prefix).bfloat16()}
    loss, grads = value_and_grad(ph.loss(Runtime(use_kernels=path == "kernels")))(carry(weights(), TDT[dtype]), b)
    grads = tree_leaves(grads)
    assert abs(float(loss) - r_loss) <= (2e-5 if dtype == "float32" else 2e-2 * abs(r_loss))
    if dtype == "float32":
        limits = [2e-5] * len(r_grads)
    else:
        _, r32 = reference_loss_and_grads("float32", weights_as="bfloat16")
        limits = [max(2e-2 * float(np.abs(a).max()), 2 * max_err(a, b)) for a, b in zip(r_grads, r32)]
    assert len(grads) == len(r_grads)
    for i, (g, a, limit) in enumerate(zip(grads, r_grads, limits)):
        assert g.dtype == TDT[dtype] and tuple(g.shape) == a.shape
        assert max_err(g, a) <= limit, (i, max_err(g, a), limit)


@functools.lru_cache(maxsize=None)
def reference_serving(dtype):
    """The reference's prefill with the prefix, then STEPS decode steps at
    P + S + i on fixed tokens."""
    rh, _ = harnesses(dtype)
    prefix, tokens, _ = inputs()
    P = prefix.shape[1]
    cache = ref_param.tree_init(rh.serve_state_specs(RefCell("t", "decode", S + STEPS + 4, B)),
                                jax.random.PRNGKey(0))
    prefill, decode = jax.jit(rh.prefill(RRT)), jax.jit(rh.decode(RRT))
    params = ref_params(dtype)
    logits, cache = prefill(params, cache, jnp.asarray(tokens[:, :S]), jnp.asarray(prefix, JDT[dtype]))
    out = {"prefill": to_np(logits), "decode": []}
    for i in range(STEPS):
        logits, cache = decode(params, cache, jnp.asarray(tokens[:, S + i:S + i + 1]),
                               jnp.asarray(P + S + i, jnp.int32))
        out["decode"].append(to_np(logits))
    out["cache"] = to_np(cache)
    return out


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_with_prefix_then_decode_matches_reference(dtype, use_kernels):
    """The cache holds the prefix's keys at [0, P) and the prompt's at
    [P, P + S); decode steps at P + S + i see both; the cache is
    ``serve_state_specs``' (seq_len + prefix_tokens rows)"""
    ref = reference_serving(dtype)
    _, ph = harnesses(dtype)
    prefix, tokens, _ = inputs()
    P = prefix.shape[1]
    rt = Runtime(use_kernels=use_kernels)
    params = carry(weights(), TDT[dtype])
    cache = tree_init(ph.serve_state_specs(ShapeCell("t", "decode", S + STEPS + 4, B)),
                      torch.Generator().manual_seed(0), device="cpu")
    assert cache["k"].shape[2] == S + STEPS + 4 + P
    tokens = torch.from_numpy(tokens)
    with torch.no_grad():
        logits, cache2 = ph.prefill(rt)(params, cache, tokens[:, :S], torch.from_numpy(prefix).to(TDT[dtype]))
        assert cache2 is cache
        got = [to_np(logits)]
        for i in range(STEPS):
            lg, cache = ph.decode(rt)(params, cache, tokens[:, S + i:S + i + 1], P + S + i)
            got.append(to_np(lg))
    want = [ref["prefill"], *ref["decode"]]
    tol = logit_tol(dtype, np.stack(want))
    for g, w in zip(got, want):
        assert max_err(g, w) <= tol
        if dtype == "float32":
            np.testing.assert_array_equal(g[:, -1].argmax(-1), w[:, -1].argmax(-1))
    for name in ("k", "v"):
        assert max_err(cache[name], ref["cache"][name]) <= tol
        assert not to_np(cache[name])[:, :, P + S + STEPS:].any()


def test_input_and_state_specs_match_reference():
    rh, ph = harnesses("bfloat16")
    for kind in ("train", "prefill", "decode"):
        rs = rh.train_input_specs(RefCell("t", kind, 16, 2)) if kind == "train" else \
            rh.serve_input_specs(RefCell("t", kind, 16, 2))
        ps = ph.train_input_specs(ShapeCell("t", kind, 16, 2)) if kind == "train" else \
            ph.serve_input_specs(ShapeCell("t", kind, 16, 2))
        assert list(rs) == list(ps)
        for n in rs:
            assert (rs[n].shape, rs[n].logical, rs[n].init) == (ps[n].shape, ps[n].logical, ps[n].init)
            assert jnp.dtype(rs[n].dtype).name == str(ps[n].dtype).split(".")[-1]
    assert "prefix_embeds" in ph.train_input_specs(ShapeCell("t", "train", 16, 2))
    assert ph.prefix_tokens == rh.prefix_tokens == 8
    assert ph.serve_state_specs(ShapeCell("t", "decode", 16, 2))["k"].shape == \
        rh.serve_state_specs(RefCell("t", "decode", 16, 2))["k"].shape == (2, 2, 24, 1, 32)


# ---------------------------------------------------------------------------
# the serving and training loops
# ---------------------------------------------------------------------------


SERVE_BATCH, PROMPT, GEN, SERVE_SEED = 2, 16, 5, 3


def serve_args():
    return serve.build_parser().parse_args(
        ["--arch", ARCH, "--batch", str(SERVE_BATCH), "--prompt-len", str(PROMPT), "--gen", str(GEN),
         "--seed", str(SERVE_SEED), "--device", "cpu"])


def reference_loop(dtype, prefix=None, feed=None):
    """The reference's ``main`` loop (no prefix) on the prompts ``serve.run``
    draws from the seed; with ``prefix``, its prefill takes it and the
    decode positions start at P + prompt length.  ``feed`` replaces the greedy
    ids fed back."""
    rh, _ = harnesses(dtype)
    cfg = rh.cfg
    prompts = np.random.default_rng(SERVE_SEED).integers(0, cfg.vocab_size, size=(SERVE_BATCH, PROMPT),
                                                         dtype=np.int32)
    cache = ref_param.tree_init(rh.serve_state_specs(RefCell("serve", "decode", PROMPT + GEN + 8, SERVE_BATCH)),
                                jax.random.PRNGKey(0))
    params = ref_params(dtype)
    prefill, decode = jax.jit(rh.prefill(RRT)), jax.jit(rh.decode(RRT))
    if prefix is None:
        logits, cache = prefill(params, cache, jnp.asarray(prompts))
        offset = 0
    else:
        logits, cache = prefill(params, cache, jnp.asarray(prompts), jnp.asarray(prefix, JDT[dtype]))
        offset = prefix.shape[1]
    ids, all_logits = [], []
    for i in range(GEN):
        lg = np.asarray(logits[:, -1, :cfg.vocab_size].astype(jnp.float32))
        all_logits.append(lg)
        tok = lg.argmax(-1).astype(np.int32)
        ids.append(tok)
        if feed is not None:
            tok = feed[:, i]
        if i < GEN - 1:
            logits, cache = decode(params, cache, jnp.asarray(tok)[:, None],
                                   jnp.asarray(offset + PROMPT + i, jnp.int32))
    return np.stack(ids, 1), np.stack(all_logits, 1)


@pytest.mark.parametrize("with_prefix", [False, True])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_serve_matches_reference_fp32(use_kernels, with_prefix):
    """``serve.run --arch paligemma-3b --device cpu``: no prefix, as the
    reference's ``main``; and ``inputs={"prefix_embeds": ...}``, decoding at
    P + prompt length + i.  Greedy ids equal, logits within 2e-4."""
    prefix = rand(np.random.default_rng(4), (SERVE_BATCH, 8, 128), 1.0) if with_prefix else None
    ref_ids, ref_logits = reference_loop("float32", prefix)
    _, ph = harnesses("float32")
    inputs_ = {"prefix_embeds": torch.from_numpy(prefix)} if with_prefix else None
    res = serve.run(serve_args(), harness=ph, params=carry(weights()), rt=Runtime(use_kernels=use_kernels),
                    inputs=inputs_)
    np.testing.assert_array_equal(res["tokens"], ref_ids)
    assert max_err(res["logits"], ref_logits) <= 2e-4
    assert not any(res["launches"].values())                  # CPU: plain versions


@pytest.mark.parametrize("use_kernels", [True, False])
def test_serve_with_prefix_bf16(use_kernels):
    _, ph = harnesses("bfloat16")
    prefix = rand(np.random.default_rng(4), (SERVE_BATCH, 8, 128), 1.0)
    res = serve.run(serve_args(), harness=ph, params=carry(weights(), torch.bfloat16),
                    rt=Runtime(use_kernels=use_kernels),
                    inputs={"prefix_embeds": torch.from_numpy(prefix).bfloat16()})
    _, ref_logits = reference_loop("bfloat16", prefix, feed=res["tokens"])
    assert max_err(res["logits"], ref_logits) <= 3e-2 * max(1.0, np.abs(ref_logits).max())


def test_train_loop_trains_text_only():
    """as the reference's train script: tokens and labels, no prefix; the loss falls"""
    args = train.build_parser().parse_args(["--arch", ARCH, "--steps", "12", "--batch", "4", "--seq", "32",
                                            "--lr", "1e-2", "--device", "cpu"])
    res = train.run(args)
    assert len(res["losses"]) == 12 and np.isfinite(res["losses"]).all()
    assert res["losses"][-1] < res["losses"][0]


def test_harness_config_matches_reference():
    rh, ph = ref_configs.load(ARCH), port_configs.load(ARCH)
    assert (ph.family, ph.prefix_tokens) == (rh.family, rh.prefix_tokens) == ("vlm", 256)
    assert [f.name for f in dataclasses.fields(ph.cfg)] == [f.name for f in dataclasses.fields(rh.cfg)]
    assert ph.cfg.head_dim == 256 and ph.cfg.n_kv_heads == 1 and ph.cfg.param_count == 2_432_055_296


def test_stub_inputs():
    """``serve.stub_inputs``: the stub frontends' outputs at the config's own
    sizes, reproducible from the seed, none for a family without a stub"""
    pali, whisper = port_configs.load(ARCH, smoke=True), port_configs.load("whisper-base", smoke=True)
    a = serve.stub_inputs(pali, 2, 5, "cpu")
    assert list(a) == ["prefix_embeds"] and a["prefix_embeds"].shape == (2, 8, 128)
    assert a["prefix_embeds"].dtype == torch.bfloat16
    assert torch.equal(a["prefix_embeds"], serve.stub_inputs(pali, 2, 5, "cpu")["prefix_embeds"])
    assert serve.stub_inputs(whisper, 2, 5, "cpu")["frames"].shape == (2, 24, 64)
    assert serve.stub_inputs(port_configs.load("granite-8b", smoke=True), 2, 5, "cpu") == {}
