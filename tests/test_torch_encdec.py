"""Port of models/encdec.py (whisper-base) against the reference: the
sinusoid, cross-attention (``attention(kv_override=...)``), the encoder, the teacher-forced forward, the loss and every gradient leaf,
prefill + decode steps on the kernel path and the plain path (on the CPU the
kernel path runs flash attention's plain version), and ``serve.run`` against
the reference's serving loop with zero frames (its ``main``) and with drawn
frames; and the reference's train script, which feeds no frames (ROADMAP
C5), beside the port's, which says so.

The reference initialises every bias and every layer norm's bias to zeros
and its scales to ones; the weights here draw them (``draw_affine``), or a
wrong bias or a norm applied to the wrong tensor could not show.

Tolerances, as the other parity tests: logits and layer outputs float32 2e-4
(2e-5 for one layer), bfloat16 3e-2 of the largest |value|; loss and
gradients float32 2e-5, bfloat16 2e-2 of each leaf's largest |g| or twice
the reference's own bf16 distance from float32 where that is larger
(tests/test_torch_train_families.py says why)."""

import functools
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.launch.train as ref_train
import repro.models.param as ref_param
from repro.models import encdec as RE, layers as RL
from repro.models.api import ShapeCell as RefCell
from repro.models.layers import Runtime as RefRuntime
import repro_torch.configs as port_configs
from repro_torch.launch import serve, train
from repro_torch.models import encdec as PE, layers as PL
from repro_torch.models.api import ShapeCell
from repro_torch.models.layers import Runtime
from repro_torch.models.param import tree_init, tree_leaves, value_and_grad

from _torch_parity import JDT, TDT, carry, max_err, one_thread, rand, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

RRT = RefRuntime(rules=None)
ARCH = "whisper-base"
B, S, STEPS, SMAX = 2, 12, 4, 20
SEED = 7


def harnesses(dtype):
    return (ref_configs.load(ARCH, smoke=True).clone(dtype=JDT[dtype]),
            port_configs.load(ARCH, smoke=True).clone(dtype=TDT[dtype]))


def draw_affine(tree, rng):
    """Every bias (``b*``, a norm's ``bias``) ~ 0.1 randn and every norm
    scale ~ 1 + 0.1 randn, in place, in a numpy tree."""
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            draw_affine(leaf, rng)
        elif key in ("bq", "bk", "bv", "bo", "b_in", "b_out", "bias"):
            tree[key] = (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        elif key == "scale":
            tree[key] = (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def weights():
    h, _ = harnesses("float32")
    params = to_np(ref_param.tree_init(h.param_specs(), jax.random.PRNGKey(SEED)))
    draw_affine(params, np.random.default_rng(SEED))
    return params


@functools.lru_cache(maxsize=None)
def inputs():
    """frames (B, n_frames, d_model), tokens (B, S + STEPS), labels (B, S)"""
    h, _ = harnesses("float32")
    rng = np.random.default_rng(11)
    frames = rand(rng, (B, h.cfg.n_frames, h.cfg.d_model), scale=1.0)
    tokens = rng.integers(0, h.cfg.vocab_size, (B, S + STEPS), dtype=np.int32)
    labels = rng.integers(0, h.cfg.vocab_size, (B, S), dtype=np.int32)
    return frames, tokens, labels


def ref_params(dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]), weights())


def logit_tol(dtype, ref) -> float:
    return 2e-4 if dtype == "float32" else 3e-2 * max(1.0, float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# sinusoid, cross-attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_len,dim", [(24, 64), (64, 64), (32, 512)])
def test_sinusoid_matches_reference(max_len, dim):
    """at the smoke width (its 24 frames, its prompts and decode steps) and
    the first 32 positions at whisper-base's width; the decode step's
    ``sinusoid_row`` is the table's row, bit for bit, and the reference's
    65536-row table's row within 1e-6"""
    ref = np.asarray(RE.sinusoid(max_len, dim))
    port = PE.sinusoid(max_len, dim)
    assert port.dtype == torch.float32 and tuple(port.shape) == ref.shape
    assert max_err(port, ref) <= 1e-6
    decode_table = np.asarray(RE.sinusoid(65536, dim))
    for pos in (0, 1, max_len // 2, max_len - 1):
        row = PE.sinusoid_row(pos, dim)
        assert tuple(row.shape) == (1, dim) and torch.equal(row[0], port[pos])
        assert max_err(row[0], decode_table[pos]) <= 1e-6


@pytest.mark.parametrize("max_len,dim", [(1536, 512), (65536, 512)])
def test_sinusoid_tables_differ_only_by_the_frameworks_exp(max_len, dim):
    """At whisper-base's 1536 frames and the decode step's 65536-row table
    the two tables differ by up to position x one ulp of the frequency: the
    reference's fp32 ``exp`` rounds some frequencies a last bit apart from
    PyTorch's (both within an ulp of the exact value).  Given the reference's
    frequencies, the port's table is the reference's within 1e-6."""
    arg = jnp.arange(0, dim, 2, dtype=jnp.float32) * (-math.log(10000.0) / dim)
    div_ref = np.array(jnp.exp(arg))
    div_port = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32) * (-math.log(10000.0) / dim)).numpy()
    ulps = np.abs(div_ref.view(np.int32) - div_port.view(np.int32))
    assert ulps.max() <= 1
    exact = np.exp(np.asarray(arg, np.float64))
    assert np.abs(div_port - exact).max() <= np.abs(div_ref - exact).max()
    pos = torch.arange(max_len, dtype=torch.float32)[:, None]
    given = torch.zeros((max_len, dim))
    given[:, 0::2] = torch.sin(pos * torch.from_numpy(div_ref))
    given[:, 1::2] = torch.cos(pos * torch.from_numpy(div_ref))
    assert max_err(given, RE.sinusoid(max_len, dim)) <= 1e-6
    # where the frequencies agree to the bit, so do the tables within 1e-6
    cols = np.flatnonzero(np.repeat(ulps == 0, 2))
    assert 0 < cols.size < dim
    port = PE.sinusoid(max_len, dim)
    assert max_err(port[:, cols], np.asarray(RE.sinusoid(max_len, dim))[:, cols]) <= 1e-6
    # the decode step's row is the port's table's, bit for bit, at every position
    for pos in (max_len // 3, max_len - 1):
        assert torch.equal(PE.sinusoid_row(pos, dim)[0], port[pos])


def attn_params(cfg, rng):
    return {n: rand(rng, s.shape, scale=0.2) for n, s in RL.attn_specs(cfg).items()}


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2])
def test_attention_kv_override_matches_reference(G, dtype, use_kernels):
    """Cross-attention: q from x (S = 12), k and v projected from the encoder
    states (T = 40, no rope), every key visible; GQA with G = 2 too."""
    rng = np.random.default_rng(3)
    cfg_args = dict(d_model=64, n_heads=4, n_kv_heads=4 // G, head_dim=32, causal=False,
                    rope_theta=None, qkv_bias=True)
    p = attn_params(RL.AttnConfig(**cfg_args), rng)
    x, enc = rand(rng, (B, S, 64), 1.0), rand(rng, (B, 40, 64), 1.0)
    positions = np.arange(S)
    ref, cache = RL.attention(RRT, jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]), p),
                              jnp.asarray(x, JDT[dtype]), RL.AttnConfig(**cfg_args), jnp.asarray(positions),
                              kv_override=jnp.asarray(enc, JDT[dtype]))
    port, pcache = PL.attention(Runtime(use_kernels=use_kernels), carry(p, TDT[dtype]),
                                torch.from_numpy(x).to(TDT[dtype]), PL.AttnConfig(**cfg_args),
                                torch.from_numpy(positions), kv_override=torch.from_numpy(enc).to(TDT[dtype]))
    assert cache is None and pcache is None and port.dtype == TDT[dtype]
    ref = to_np(ref)
    assert max_err(port, ref) <= (2e-5 if dtype == "float32" else 3e-2 * max(1.0, np.abs(ref).max()))


# ---------------------------------------------------------------------------
# the model functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_reference(dtype, use_kernels):
    rh, ph = harnesses(dtype)
    frames = inputs()[0]
    ref = to_np(RE.encode(RRT, rh.cfg, ref_params(dtype), jnp.asarray(frames)))
    with torch.no_grad():
        port = PE.encode(Runtime(use_kernels=use_kernels), ph.cfg, carry(weights(), TDT[dtype]),
                         torch.from_numpy(frames))
    assert port.dtype == TDT[dtype] and tuple(port.shape) == ref.shape
    assert max_err(port, ref) <= logit_tol(dtype, ref)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype, use_kernels):
    rh, ph = harnesses(dtype)
    frames, tokens, _ = inputs()
    ref = to_np(RE.forward(RRT, rh.cfg, ref_params(dtype), jnp.asarray(frames), jnp.asarray(tokens[:, :S])))
    with torch.no_grad():
        port = PE.forward(Runtime(use_kernels=use_kernels), ph.cfg, carry(weights(), TDT[dtype]),
                          torch.from_numpy(frames), torch.from_numpy(tokens[:, :S]))
    assert tuple(port.shape) == (B, S, ph.cfg.vocab_padded)
    assert max_err(port, ref) <= logit_tol(dtype, ref)


def batch():
    frames, tokens, labels = inputs()
    return {"frames": frames, "tokens": tokens[:, :S], "labels": labels}


@functools.lru_cache(maxsize=None)
def reference_loss_and_grads(dtype, weights_as=None):
    rh, _ = harnesses(dtype)
    w = weights()
    if weights_as is not None:
        w = to_np(jax.tree.map(lambda a: jnp.asarray(a, JDT[weights_as]), w))
    params = jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]), w)
    loss, grads = jax.jit(jax.value_and_grad(rh.loss(RRT)))(params, jax.tree.map(jnp.asarray, batch()))
    return float(loss), [to_np(g) for g in jax.tree.leaves(grads)]


@pytest.mark.parametrize("path", ["kernels", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(dtype, path):
    """``value_and_grad`` of the harness's loss against
    ``jax.value_and_grad`` of the reference's, every leaf (the decoder's
    gradient reaches the encoder through the cross-attention)."""
    r_loss, r_grads = reference_loss_and_grads(dtype)
    _, ph = harnesses(dtype)
    b = {k: torch.from_numpy(v) for k, v in batch().items()}
    loss, grads = value_and_grad(ph.loss(Runtime(use_kernels=path == "kernels")))(
        carry(weights(), TDT[dtype]), b)
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
        assert float(np.abs(a).max()) > 0, i                   # every leaf is reached
        assert max_err(g, a) <= limit, (i, max_err(g, a), limit)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["dots", "none"])
def test_remat_changes_nothing(policy, dtype):
    """Both stacks under ``cfg.remat_policy``: recomputing each block in the
    backward (``"nothing"``, the default and what the reference applies),
    keeping only its matrix products (``"dots"``) or keeping everything
    (``"none"``) give the same loss and gradients, bit for bit."""
    _, ph = harnesses(dtype)
    b = {k: torch.from_numpy(v) for k, v in batch().items()}
    base_loss, base = value_and_grad(ph.loss(Runtime(use_kernels=True)))(carry(weights(), TDT[dtype]), b)
    loss, grads = value_and_grad(ph.clone(remat_policy=policy).loss(Runtime(use_kernels=True)))(
        carry(weights(), TDT[dtype]), b)
    assert torch.equal(loss, base_loss)
    for a, g in zip(tree_leaves(base), tree_leaves(grads)):
        assert torch.equal(a, g)


def test_remat_policy_unknown_raises():
    _, ph = harnesses("float32")
    b = {k: torch.from_numpy(v) for k, v in batch().items()}
    with pytest.raises(ValueError, match="remat_policy"):
        value_and_grad(ph.clone(remat_policy="everything").loss(Runtime()))(carry(weights()), b)


@functools.lru_cache(maxsize=None)
def reference_serving(dtype):
    """The reference's prefill + STEPS decode steps on fixed tokens."""
    rh, _ = harnesses(dtype)
    frames, tokens, _ = inputs()
    cache = ref_param.tree_init(rh.serve_state_specs(RefCell("t", "decode", SMAX, B)), jax.random.PRNGKey(0))
    prefill, decode = jax.jit(rh.prefill(RRT)), jax.jit(rh.decode(RRT))
    params = ref_params(dtype)
    logits, cache = prefill(params, cache, jnp.asarray(frames), jnp.asarray(tokens[:, :S]))
    out = {"prefill": to_np(logits), "enc_out": to_np(cache["enc_out"]), "decode": []}
    for i in range(STEPS):
        logits, cache = decode(params, cache, jnp.asarray(tokens[:, S + i:S + i + 1]), jnp.asarray(S + i, jnp.int32))
        out["decode"].append(to_np(logits))
    out["cache"] = to_np(cache)
    return out


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype, use_kernels):
    """Prefill (the encoder, the decoder's cache for [0, S), enc_out in the
    cache) and STEPS decode steps at S + i, fed the same tokens: logits,
    their greedy ids (float32), the caches."""
    ref = reference_serving(dtype)
    _, ph = harnesses(dtype)
    frames, tokens, _ = inputs()
    rt = Runtime(use_kernels=use_kernels)
    params = carry(weights(), TDT[dtype])
    cache = tree_init(ph.serve_state_specs(ShapeCell("t", "decode", SMAX, B)),
                      torch.Generator().manual_seed(0), device="cpu")
    enc_leaf = cache["enc_out"]
    tokens = torch.from_numpy(tokens)
    with torch.no_grad():
        logits, cache2 = ph.prefill(rt)(params, cache, torch.from_numpy(frames), tokens[:, :S])
        got = [to_np(logits)]
        for i in range(STEPS):
            lg, cache = ph.decode(rt)(params, cache, tokens[:, S + i:S + i + 1], S + i)
            got.append(to_np(lg))
    assert cache2 is cache
    # bf16: the encoder's output goes into the bf16 cache leaf in place; the
    # float32 model's replaces it, as the reference's returned cache holds it
    assert (cache["enc_out"] is enc_leaf) == (dtype == "bfloat16")
    want = [ref["prefill"], *ref["decode"]]
    tol = logit_tol(dtype, np.stack(want))
    for g, w in zip(got, want):
        assert max_err(g, w) <= tol
        if dtype == "float32":
            np.testing.assert_array_equal(g[:, -1].argmax(-1), w[:, -1].argmax(-1))
    for name in ("k", "v", "enc_out"):
        assert max_err(cache[name], ref["cache"][name]) <= tol
    assert not to_np(cache["k"])[:, :, S + STEPS:].any()


def test_input_specs_match_reference():
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


# ---------------------------------------------------------------------------
# the serving and training loops
# ---------------------------------------------------------------------------


SERVE_BATCH, PROMPT, GEN, SERVE_SEED = 2, 16, 5, 3


def serve_args(**over):
    args = serve.build_parser().parse_args(
        ["--arch", ARCH, "--batch", str(SERVE_BATCH), "--prompt-len", str(PROMPT), "--gen", str(GEN),
         "--seed", str(SERVE_SEED), "--device", "cpu"])
    for k, v in over.items():
        setattr(args, k, v)
    return args


def reference_loop(dtype, frames=None, feed=None):
    """The reference's ``main`` loop on the prompts ``serve.run`` draws from
    the seed, prefilled with ``frames`` (zeros, as ``main`` feeds, if None);
    ``feed`` replaces the greedy ids fed back."""
    rh, _ = harnesses(dtype)
    cfg = rh.cfg
    prompts = np.random.default_rng(SERVE_SEED).integers(0, cfg.vocab_size, size=(SERVE_BATCH, PROMPT),
                                                         dtype=np.int32)
    if frames is None:
        frames = jnp.zeros((SERVE_BATCH, cfg.n_frames, cfg.d_model), jnp.bfloat16)
    cache = ref_param.tree_init(rh.serve_state_specs(RefCell("serve", "decode", PROMPT + GEN + 8, SERVE_BATCH)),
                                jax.random.PRNGKey(0))
    params = ref_params(dtype)
    prefill, decode = jax.jit(rh.prefill(RRT)), jax.jit(rh.decode(RRT))
    logits, cache = prefill(params, cache, jnp.asarray(frames), jnp.asarray(prompts))
    ids, all_logits = [], []
    for i in range(GEN):
        lg = np.asarray(logits[:, -1, :cfg.vocab_size].astype(jnp.float32))
        all_logits.append(lg)
        tok = lg.argmax(-1).astype(np.int32)
        ids.append(tok)
        if feed is not None:
            tok = feed[:, i]
        if i < GEN - 1:
            logits, cache = decode(params, cache, jnp.asarray(tok)[:, None], jnp.asarray(PROMPT + i, jnp.int32))
    return np.stack(ids, 1), np.stack(all_logits, 1)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_serve_matches_reference_main_fp32(use_kernels):
    """``serve.run --arch whisper-base --device cpu``: zero frames, as the
    reference's ``main``; greedy ids equal, logits within 2e-4"""
    ref_ids, ref_logits = reference_loop("float32")
    _, ph = harnesses("float32")
    res = serve.run(serve_args(), harness=ph, params=carry(weights()), rt=Runtime(use_kernels=use_kernels))
    np.testing.assert_array_equal(res["tokens"], ref_ids)
    assert max_err(res["logits"], ref_logits) <= 2e-4
    assert not any(res["launches"].values())                  # CPU: plain versions


@pytest.mark.parametrize("use_kernels", [True, False])
def test_serve_with_drawn_frames_bf16(use_kernels):
    """``inputs={"frames": ...}``: the reference fed the same frames and the
    port's ids, 3e-2 of the largest |logit|"""
    _, ph = harnesses("bfloat16")
    frames = torch.from_numpy(rand(np.random.default_rng(4), (SERVE_BATCH, ph.cfg.n_frames, ph.cfg.d_model), 1.0))
    res = serve.run(serve_args(), harness=ph, params=carry(weights(), torch.bfloat16),
                    rt=Runtime(use_kernels=use_kernels), inputs={"frames": frames.bfloat16()})
    _, ref_logits = reference_loop("bfloat16", frames=jnp.asarray(frames.numpy(), jnp.bfloat16),
                                   feed=res["tokens"])
    assert max_err(res["logits"], ref_logits) <= 3e-2 * max(1.0, np.abs(ref_logits).max())


def test_serve_draws_its_own_weights():
    res = serve.run(serve_args())
    assert res["tokens"].shape == (SERVE_BATCH, GEN) and np.isfinite(res["logits"]).all()
    with pytest.raises(ValueError, match="takes inputs"):
        serve.run(serve_args(), inputs={"prefix_embeds": torch.zeros(SERVE_BATCH, 4, 64)})


def test_reference_train_driver_feeds_no_frames(monkeypatch):
    """ROADMAP C5: the reference's train script feeds its step only tokens and
    labels (``repro/launch/train.py:120``), so whisper-base's loss, which
    reads ``batch["frames"]``, fails at the first step."""
    monkeypatch.setattr(sys, "argv", ["train", "--arch", ARCH, "--steps", "2", "--batch", "2", "--seq", "16"])
    with pytest.raises(KeyError, match="frames"):
        ref_train.main()


def test_port_train_loop_names_the_fault():
    args = train.build_parser().parse_args(["--arch", ARCH, "--steps", "2", "--batch", "2", "--seq", "16",
                                            "--device", "cpu"])
    with pytest.raises(ValueError, match="C5"):
        train.run(args)
