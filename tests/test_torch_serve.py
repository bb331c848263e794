"""The slices as a whole: ``repro_torch.launch.serve.run`` (prefill + greedy
KV-cache or recurrent decode) on the granite-8b, mixtral-8x22b, zamba2 and
rwkv6 smoke configs against the reference's prefill + decode loop, from the
same carried weights and the same prompts.

For zamba2 and rwkv6 the reference's loop does not use its
``HybridHarness.prefill`` / ``RWKVHarness.prefill``, which return the state
they were given (tests/test_torch_hybrid.py, tests/test_torch_rwkv_lm.py):
its prefill is the last logits of ``forward`` and the state its
``decode_step`` reaches fed the prompt one token at a time.  rwkv6's
zero-initialised ``mu``, ``w0`` and ``bonus_u`` are drawn non-zero."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.param as ref_param
from repro.models.api import ShapeCell as RefCell
from repro.models.layers import Runtime as RefRuntime
import repro_torch.configs as port_configs
from repro_torch.launch import serve
from repro_torch.models.layers import Runtime

from _torch_parity import JDT, carry, draw_time_mix, reference_rwkv_scan, reference_scan, to_np

BATCH, PROMPT, GEN, SEED = 2, 16, 5, 3


def args_for(**over):
    argv = ["--batch", str(BATCH), "--prompt-len", str(PROMPT), "--gen", str(GEN),
            "--seed", str(SEED), "--device", "cpu"]
    args = serve.build_parser().parse_args(argv)
    for k, v in over.items():
        setattr(args, k, v)
    return args


def reference_loop(dtype, feed=None, arch="granite-8b"):
    """The reference's serving loop (tests/test_e2e.py::TestServing shape) on
    the prompts ``serve.run`` draws from the seed.  ``feed`` (batch, gen)
    replaces the greedy ids that are fed back, for comparing logits."""
    h = ref_configs.load(arch, smoke=True).clone(dtype=JDT[dtype])
    params = ref_param.tree_init(h.param_specs(), jax.random.PRNGKey(1))
    if h.family == "ssm":
        params = to_np(params)
        draw_time_mix(params["blocks"]["tm"], params["blocks"]["cm"], np.random.default_rng(1))
        params = jax.tree.map(jnp.asarray, params)
    vocab = h.cfg.vocab_size
    prompts = np.random.default_rng(SEED).integers(0, vocab, size=(BATCH, PROMPT), dtype=np.int32)
    cell = RefCell("serve", "decode", PROMPT + GEN + 8, BATCH)
    cache = ref_param.tree_init(h.serve_state_specs(cell), jax.random.PRNGKey(0))
    rt = RefRuntime(rules=None)
    prefill, decode = jax.jit(h.prefill(rt)), jax.jit(h.decode(rt))
    if h.family in ("hybrid", "ssm"):
        for t in range(PROMPT):
            _, cache = decode(params, cache, jnp.asarray(prompts[:, t:t + 1]), jnp.asarray(t, jnp.int32))
        logits = h.prefill(rt)(params, cache, jnp.asarray(prompts))[0]   # forward's last logits
    else:
        logits, cache = prefill(params, cache, jnp.asarray(prompts))
    ids, all_logits = [], []
    for i in range(GEN):
        lg = logits[:, -1, :vocab].astype(jnp.float32)
        all_logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        ids.append(np.asarray(tok))
        if feed is not None:
            tok = jnp.asarray(feed[:, i])
        if i < GEN - 1:
            logits, cache = decode(params, cache, tok[:, None], jnp.asarray(PROMPT + i, jnp.int32))
    return to_np(params), np.stack(ids, 1), np.stack(all_logits, 1)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_greedy_ids_equal_reference_fp32(use_kernels):
    params, ref_ids, ref_logits = reference_loop("float32")
    h = port_configs.load("granite-8b", smoke=True).clone(dtype=torch.float32)
    res = serve.run(args_for(), harness=h, params=carry(params), rt=Runtime(use_kernels=use_kernels))
    assert res["tokens"].shape == (BATCH, GEN)
    np.testing.assert_array_equal(res["tokens"], ref_ids)
    # float32, the same arithmetic in another order of sums
    np.testing.assert_allclose(res["logits"], ref_logits, atol=2e-4, rtol=0)
    assert res["launches"] == {"flash_attention": 0, "moe_dispatch": 0, "ssd_scan": 0, "rwkv6_scan": 0,
                               "ccu_reduce": 0}   # CPU: plain versions
    assert res["prefill_s"] > 0 and res["decode_s_per_token"] > 0


@pytest.mark.parametrize("use_kernels", [True, False])
def test_mixtral_greedy_ids_equal_reference_fp32(use_kernels):
    """the MoE slice: every layer's attention and expert dispatch, prefill
    and decode (C = 1 a step), float32 as above"""
    params, ref_ids, ref_logits = reference_loop("float32", arch="mixtral-8x22b")
    h = port_configs.load("mixtral-8x22b", smoke=True).clone(dtype=torch.float32)
    res = serve.run(args_for(arch="mixtral-8x22b"), harness=h, params=carry(params),
                    rt=Runtime(use_kernels=use_kernels))
    np.testing.assert_array_equal(res["tokens"], ref_ids)
    np.testing.assert_allclose(res["logits"], ref_logits, atol=2e-4, rtol=0)
    assert res["launches"] == {"flash_attention": 0, "moe_dispatch": 0, "ssd_scan": 0, "rwkv6_scan": 0,
                               "ccu_reduce": 0}


@pytest.mark.parametrize("use_kernels", [True, False])
def test_zamba2_greedy_ids_equal_reference_fp32(use_kernels):
    """the hybrid slice: every Mamba2 layer's scan in prefill and its
    recurrence in decode, the shared block's cache, float32 as above"""
    params, ref_ids, ref_logits = reference_loop("float32", arch="zamba2-1.2b")
    h = port_configs.load("zamba2-1.2b", smoke=True).clone(dtype=torch.float32)
    res = serve.run(args_for(arch="zamba2-1.2b"), harness=h, params=carry(params),
                    rt=Runtime(use_kernels=use_kernels))
    np.testing.assert_array_equal(res["tokens"], ref_ids)
    np.testing.assert_allclose(res["logits"], ref_logits, atol=2e-4, rtol=0)
    assert res["launches"] == {"flash_attention": 0, "moe_dispatch": 0, "ssd_scan": 0, "rwkv6_scan": 0,
                               "ccu_reduce": 0}


@pytest.mark.parametrize("use_kernels", [True, False])
def test_zamba2_logits_close_to_reference_bf16(use_kernels):
    """bf16, the reference fed the port's ids, 3e-2 of the largest |logit|;
    the kernel path against the reference with its prefill scan through its
    own Pallas kernel (tests/test_torch_hybrid.py says why)"""
    h = port_configs.load("zamba2-1.2b", smoke=True)
    params, _, _ = reference_loop("bfloat16", arch="zamba2-1.2b")
    res = serve.run(args_for(arch="zamba2-1.2b"), harness=h, params=carry(params, torch.bfloat16),
                    rt=Runtime(use_kernels=use_kernels))
    with reference_scan(use_kernels):
        _, _, ref_logits = reference_loop("bfloat16", feed=res["tokens"], arch="zamba2-1.2b")
    tol = 3e-2 * max(1.0, np.abs(ref_logits).max())
    np.testing.assert_allclose(res["logits"], ref_logits, atol=tol, rtol=0)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_rwkv6_greedy_ids_equal_reference_fp32(use_kernels):
    """the RWKV-6 slice: every layer's scan in prefill and its recurrence in
    decode, float32 as above"""
    params, ref_ids, ref_logits = reference_loop("float32", arch="rwkv6-1.6b")
    h = port_configs.load("rwkv6-1.6b", smoke=True).clone(dtype=torch.float32)
    res = serve.run(args_for(arch="rwkv6-1.6b"), harness=h, params=carry(params),
                    rt=Runtime(use_kernels=use_kernels))
    np.testing.assert_array_equal(res["tokens"], ref_ids)
    np.testing.assert_allclose(res["logits"], ref_logits, atol=2e-4, rtol=0)
    assert res["launches"] == {"flash_attention": 0, "moe_dispatch": 0, "ssd_scan": 0, "rwkv6_scan": 0,
                               "ccu_reduce": 0}


@pytest.mark.parametrize("use_kernels", [True, False])
def test_rwkv6_logits_close_to_reference_bf16(use_kernels):
    """bf16, the reference fed the port's ids, 3e-2 of the largest |logit|;
    the kernel path against the reference with its prefill scan through its
    own Pallas kernel"""
    h = port_configs.load("rwkv6-1.6b", smoke=True)
    params, _, _ = reference_loop("bfloat16", arch="rwkv6-1.6b")
    res = serve.run(args_for(arch="rwkv6-1.6b"), harness=h, params=carry(params, torch.bfloat16),
                    rt=Runtime(use_kernels=use_kernels))
    with reference_rwkv_scan(use_kernels):
        _, _, ref_logits = reference_loop("bfloat16", feed=res["tokens"], arch="rwkv6-1.6b")
    tol = 3e-2 * max(1.0, np.abs(ref_logits).max())
    np.testing.assert_allclose(res["logits"], ref_logits, atol=tol, rtol=0)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_logits_close_to_reference_bf16(use_kernels):
    h = port_configs.load("granite-8b", smoke=True)
    assert h.cfg.dtype == torch.bfloat16
    params, _, _ = reference_loop("bfloat16")
    res = serve.run(args_for(), harness=h, params=carry(params, torch.bfloat16),
                    rt=Runtime(use_kernels=use_kernels))
    # feed the reference the port's ids, so every step's logits are comparable
    _, _, ref_logits = reference_loop("bfloat16", feed=res["tokens"])
    # 3e-2 of the largest |logit|: one or two bf16 ulps of the larger logits
    # (see tests/test_torch_transformer.py)
    tol = 3e-2 * max(1.0, np.abs(ref_logits).max())
    np.testing.assert_allclose(res["logits"], ref_logits, atol=tol, rtol=0)


def test_draws_its_own_weights_and_samples():
    """without carried weights: bf16 weights from the seeded generator; with a
    temperature the ids come from the sampling generator, reproducibly"""
    a = serve.run(args_for(temperature=0.8))
    b = serve.run(args_for(temperature=0.8))
    c = serve.run(args_for(temperature=0.8, seed=SEED + 1))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    vocab = port_configs.load("granite-8b", smoke=True).cfg.vocab_size
    assert a["tokens"].min() >= 0 and a["tokens"].max() < vocab
    assert a["logits"].shape == (BATCH, GEN, vocab) and np.isfinite(a["logits"]).all()


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "granite-3-2b", "starcoder2-7b",
                                  "zamba2-1.2b", "rwkv6-1.6b", "mixtral-8x22b", "dbrx-132b"])
def test_other_archs_serve(arch):
    res = serve.run(args_for(arch=arch))
    assert res["tokens"].shape == (BATCH, GEN) and np.isfinite(res["logits"]).all()


def test_parser_flags_match_reference():
    args = serve.build_parser().parse_args([])
    assert vars(args) == dict(arch="granite-8b", smoke=True, batch=4, prompt_len=32, gen=16,
                              temperature=0.0, seed=0, device="cuda")
    assert serve.build_parser().parse_args(["--no-smoke"]).smoke is False
