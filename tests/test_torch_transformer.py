"""Port of models/transformer.py against the reference: the four dense and
the two MoE smoke configs, same carried weights, prefill + 4 decode steps;
and the reference's three transformer invariants restated for the port, with
causality and prefill -> decode consistency also for mixtral.

Tolerances.  cfg.dtype float32: 2e-4 on logits (the same arithmetic, sums in
another order, through 2 layers).  cfg.dtype bfloat16: 3e-2 of the largest
|logit| (at least 3e-2).  A bf16 logit of magnitude 2..4 has an ulp of 0.0156
and the two frameworks sum in different orders, so differences of one or two
ulps of the larger logits (0.031 was observed at a logit of 2.2) are rounding,
not error; 3e-2 absolute holds only where the logits stay below 2.  On the
kernel path (use_kernels=True) scores and probabilities also stay float32
where the reference rounds them to bf16; measured, each path lies 0.03..0.05
from the float32 result at logits up to 4."""

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
from repro_torch.models import transformer as PT
from repro_torch.models.api import ShapeCell
from repro_torch.models.layers import Runtime
from repro_torch.models.param import tree_init

from _torch_parity import JDT, TDT, carry, routing_margins, to_np

ARCHS = ["granite_8b", "phi4_mini_3_8b", "granite_3_2b", "starcoder2_7b",
         "mixtral_8x22b", "dbrx_132b"]
B, S, SMAX, STEPS = 2, 12, 20, 4
MOE_SEED = 9
RRT = RefRuntime(rules=None)


def harnesses(arch, dtype):
    return (ref_configs.load(arch, smoke=True).clone(dtype=JDT[dtype]),
            port_configs.load(arch, smoke=True).clone(dtype=TDT[dtype]))


# The MoE archs' weights: the dense archs' seed (7) leaves a bf16 routing
# decision within 2.3 ulps of a tie; this one keeps every decision more than
# 4.3 ulps clear on both paths.
PARAM_SEED = {"mixtral_8x22b": MOE_SEED, "dbrx_132b": MOE_SEED}
MIN_MARGIN_ULPS = 4


@functools.lru_cache(maxsize=None)
def reference_run(arch, dtype):
    """The reference's prefill + STEPS decode steps on fixed tokens; returns
    the weights and every output as numpy."""
    rh, _ = harnesses(arch, dtype)
    params = ref_param.tree_init(rh.param_specs(), jax.random.PRNGKey(PARAM_SEED.get(arch, 7)))
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, rh.cfg.vocab_size, (B, S + STEPS), dtype=np.int32)
    cache = ref_param.tree_init(rh.serve_state_specs(RefCell("t", "decode", SMAX, B)), jax.random.PRNGKey(0))
    prefill, decode = jax.jit(rh.prefill(RRT)), jax.jit(rh.decode(RRT))
    logits, cache = prefill(params, cache, jnp.asarray(tokens[:, :S]))
    out = {"params": to_np(params), "tokens": tokens,
           "prefill_logits": to_np(logits), "prefill_cache": to_np(cache), "decode_logits": []}
    for i in range(STEPS):
        logits, cache = decode(params, cache, jnp.asarray(tokens[:, S + i:S + i + 1]), jnp.asarray(S + i, jnp.int32))
        out["decode_logits"].append(to_np(logits))
    out["final_cache"] = to_np(cache)
    return out


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype, use_kernels):
    ref = reference_run(arch, dtype)
    _, ph = harnesses(arch, dtype)
    rt = Runtime(use_kernels=use_kernels)
    params = carry(ref["params"])
    tokens = torch.from_numpy(ref["tokens"])
    cache = tree_init(ph.serve_state_specs(ShapeCell("t", "decode", SMAX, B)),
                      torch.Generator().manual_seed(0), device="cpu")
    scale = max(1.0, max(np.abs(l).max() for l in [ref["prefill_logits"], *ref["decode_logits"]]))
    tol = 2e-4 if dtype == "float32" else 3e-2 * scale

    with torch.no_grad(), routing_margins() as margins:
        logits, cache2 = ph.prefill(rt)(params, cache, tokens[:, :S])
        prefill_cache = {n: to_np(t).copy() for n, t in cache.items()}   # decode writes on
        decode_logits = []
        for i in range(STEPS):
            lg, cache = ph.decode(rt)(params, cache, tokens[:, S + i:S + i + 1], S + i)
            decode_logits.append(to_np(lg))
    if dtype == "bfloat16" and ph.cfg.moe is not None:
        # the port's router logits, which agree with the reference's to bf16 rounding
        assert min(margins) > MIN_MARGIN_ULPS, (
            f"a routing decision lies {min(margins):.2f} bf16 ulps from a tie at this seed: "
            "the two frameworks may route it apart")
    assert cache2 is cache                                     # written in place
    assert logits.shape == (B, 1, ph.cfg.vocab_padded) and logits.dtype == TDT[dtype]
    np.testing.assert_allclose(to_np(logits), ref["prefill_logits"], atol=tol, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(prefill_cache[name], ref["prefill_cache"][name], atol=tol, rtol=0)
        assert not prefill_cache[name][:, :, S:].any()         # only [0, S) written
    for i in range(STEPS):
        np.testing.assert_allclose(decode_logits[i], ref["decode_logits"][i], atol=tol, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(to_np(cache[name]), ref["final_cache"][name], atol=tol, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    rh, ph = harnesses(arch, "float32")
    ref = reference_run(arch, "float32")
    tokens = ref["tokens"]
    r, r_aux = RT.forward(RRT, rh.cfg, jax.tree.map(jnp.asarray, ref["params"]), jnp.asarray(tokens))
    with torch.no_grad():
        p, p_aux = PT.forward(Runtime(), ph.cfg, carry(ref["params"]), torch.from_numpy(tokens))
    np.testing.assert_allclose(to_np(p), to_np(r), atol=2e-4, rtol=0)
    np.testing.assert_allclose(to_np(p_aux), to_np(r_aux), atol=1e-6, rtol=0)   # the MoE layers' aux loss


# ---------------------------------------------------------------------------
# the reference's TestInvariants (tests/test_models.py), restated for the port
# ---------------------------------------------------------------------------


def port_params(arch, seed=42):
    h = port_configs.load(arch, smoke=True)
    return h, tree_init(h.param_specs(), torch.Generator().manual_seed(seed), device="cpu")


@pytest.mark.parametrize("use_kernels", [True, False])
def test_causality_dense(use_kernels):
    """perturbing a future token must not change earlier logits"""
    h, params = port_params("granite_8b")
    rt = Runtime(use_kernels=use_kernels)
    tok1 = torch.zeros((1, 16), dtype=torch.int32) + 5
    tok2 = tok1.clone()
    tok2[0, 12] = 9
    with torch.no_grad():
        lg1 = PT.forward(rt, h.cfg, params, tok1)[0].float()
        lg2 = PT.forward(rt, h.cfg, params, tok2)[0].float()
    np.testing.assert_allclose(lg1[:, :12].numpy(), lg2[:, :12].numpy(), atol=1e-5)
    assert not np.allclose(lg1[:, 12:].numpy(), lg2[:, 12:].numpy())


@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_decode_consistency(use_kernels):
    """prefill(S tokens) then decode == forward(S+1 tokens) logits"""
    h, params = port_params("granite_8b")
    rt = Runtime(use_kernels=use_kernels)
    n = 8
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (2, n + 1)).astype(np.int32))
    cache = tree_init(h.serve_state_specs(ShapeCell("t", "decode", n + 4, 2)),
                      torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        _, cache = PT.prefill(rt, h.cfg, params, tokens[:, :n], cache)
        lg_dec, _ = PT.decode_step(rt, h.cfg, params, tokens[:, n:], cache, n)
        lg_full, _ = PT.forward(rt, h.cfg, params, tokens)
    np.testing.assert_allclose(
        lg_dec[:, -1].float().numpy(), lg_full[:, -1].float().numpy(),
        atol=3e-2,  # bf16 cache
    )


def moe_params(seed=42):
    """mixtral smoke with room for every token in every expert: capacity
    factor E / K makes C = S, so no token is dropped"""
    h, params = port_params("mixtral_8x22b", seed)
    moe = h.cfg.moe
    return h.clone(moe=dataclasses.replace(moe, capacity_factor=moe.n_experts / moe.topk)), params


@pytest.mark.parametrize("use_kernels", [True, False])
def test_causality_moe(use_kernels):
    """perturbing a future token must not change earlier logits.  Only with
    no token dropped: the capacity positions are handed out k-major (the
    k-th choices of all tokens, then the next k), so with drops a later
    token's first choice can take an earlier token's second slot, in the
    reference as here"""
    h, params = moe_params()
    assert h.cfg.moe.capacity(16) == 16
    rt = Runtime(use_kernels=use_kernels)
    tok1 = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (1, 16)).astype(np.int32))
    tok2 = tok1.clone()
    tok2[0, 12] = (tok2[0, 12] + 9) % 512
    with torch.no_grad():
        lg1 = PT.forward(rt, h.cfg, params, tok1)[0].float()
        lg2 = PT.forward(rt, h.cfg, params, tok2)[0].float()
    np.testing.assert_allclose(lg1[:, :12].numpy(), lg2[:, :12].numpy(), atol=1e-5)
    assert not np.allclose(lg1[:, 12:].numpy(), lg2[:, 12:].numpy())


@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_decode_consistency_moe(use_kernels):
    """prefill(S tokens) then decode == forward(S+1 tokens) logits, with no
    token dropped in either (a decode step has C = 1 and its K choices go
    to K different experts)"""
    h, params = moe_params()
    rt = Runtime(use_kernels=use_kernels)
    n = 8
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, n + 1)).astype(np.int32))
    cache = tree_init(h.serve_state_specs(ShapeCell("t", "decode", n + 4, 2)),
                      torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        _, cache = PT.prefill(rt, h.cfg, params, tokens[:, :n], cache)
        lg_dec, _ = PT.decode_step(rt, h.cfg, params, tokens[:, n:], cache, n)
        lg_full, _ = PT.forward(rt, h.cfg, params, tokens)
    np.testing.assert_allclose(
        lg_dec[:, -1].float().numpy(), lg_full[:, -1].float().numpy(),
        atol=3e-2,  # bf16 cache
    )


@pytest.mark.parametrize("use_kernels", [True, False])
def test_sliding_window_limits_context(use_kernels):
    """starcoder2 SWA: tokens beyond the window have no influence"""
    h, params = port_params("starcoder2_7b")    # window=64 in smoke
    rt = Runtime(use_kernels=use_kernels)
    n = 128
    base = np.random.default_rng(3).integers(0, 64, (1, n))
    pert = base.copy()
    pert[0, 0] = (pert[0, 0] + 7) % 64
    with torch.no_grad():
        lg1, _ = PT.forward(rt, h.cfg, params, torch.from_numpy(base.astype(np.int32)))
        lg2, _ = PT.forward(rt, h.cfg, params, torch.from_numpy(pert.astype(np.int32)))
    # with 2 layers x window 64, influence dies beyond ~2*64 tokens
    np.testing.assert_allclose(lg1[:, -1].float().numpy(), lg2[:, -1].float().numpy(), atol=1e-5)
