"""Port of models/hybrid.py (zamba2 smoke) against the reference, same
carried weights: forward, and the serving state the port's ``prefill``
returns held against the reference's own recurrence.

The reference's ``HybridHarness.prefill`` returns the state it was given
(``test_reference_prefill_keeps_its_input_state`` pins that), so its decode
starts from zeros whatever the prompt.  The port's ``prefill`` returns the
state the prompt leaves; what that state must be is what the reference's
``decode_step`` reaches when fed the prompt one token at a time from the
zero state.

Tolerances.  float32: 2e-4 on logits, 1e-4 on the state (the same arithmetic
in another order: chunked scan against recurrence).  bfloat16: 3e-2 of the
largest |value| (see tests/test_torch_transformer.py).  The port's plain path
is held against the reference's model (its scan the twin ``ssd_chunked``),
the kernel path against the reference with its scan through its own Pallas
kernel (``_torch_parity.reference_scan``): each twin rounds alike.  The
limit tells a bf16 result from a float32 one: on these weights the float32
logits lie farther than 3e-2 of the largest from the reference's bf16 logits
(``test_reference_bf16_noise_exceeds_3e_2``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.param as ref_param
from repro.kernels import ops as ref_ops
from repro.models import hybrid as RH
from repro.models import layers as RL
from repro.models import mamba2 as RM
from repro.models.api import ShapeCell as RefCell
from repro.models.layers import Runtime as RefRuntime
import repro_torch.configs as port_configs
from repro_torch.models import hybrid as PH
from repro_torch.models.api import ShapeCell
from repro_torch.models.layers import Runtime
from repro_torch.models.param import tree_init

from _torch_parity import JDT, TDT, carry, max_err, reference_scan, reference_scan_inputs, to_np

B, S, STEPS = 2, 12, 4
RRT = RefRuntime(rules=None)


def harnesses(dtype):
    return (ref_configs.load("zamba2-1.2b", smoke=True).clone(dtype=JDT[dtype]),
            port_configs.load("zamba2-1.2b", smoke=True).clone(dtype=TDT[dtype]))


def tol(dtype, ref, f32=2e-4):
    """float32: ``f32``.  bfloat16: 3e-2 of the largest |ref|."""
    if dtype == "float32":
        return f32
    return 3e-2 * max(1.0, float(np.abs(to_np(ref)).max()))


@functools.lru_cache(maxsize=None)
def ref_weights(seed=7):
    """The reference's weights, with A_log and dt_bias drawn (zeros in the
    spec) so that every head of every layer decays at its own rate."""
    h, _ = harnesses("float32")
    params = to_np(ref_param.tree_init(h.param_specs(), jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    blocks = params["mamba_blocks"]["mamba"]
    for name in ("A_log", "dt_bias"):
        blocks[name] = (rng.standard_normal(blocks[name].shape) * 0.5).astype(np.float32)
    return params


def smax(n):
    return n + STEPS + 8


def prompt(n=S):
    """The first n of the n + STEPS tokens the reference's recurrence is fed."""
    return tokens(n + STEPS)[:, :n]


def tokens(n, seed=11):
    return np.random.default_rng(seed).integers(0, 512, (B, n), dtype=np.int32)


@functools.lru_cache(maxsize=None)
def reference_forward(dtype, kernel=False, n=S):
    """The reference's forward over the first n tokens (its scan through its
    Pallas kernel with ``kernel``)."""
    rh, _ = harnesses(dtype)
    with reference_scan(kernel):
        return to_np(RH.forward(RRT, rh.cfg, jax.tree.map(jnp.asarray, ref_weights()),
                                jnp.asarray(prompt(n))))


@functools.lru_cache(maxsize=None)
def reference_prompt_state(dtype, kernel=False, n=S):
    """What the reference's forward computes over the prompt and drops, from
    its own functions in its group loop: each Mamba2 layer's final scan state
    (its twin's, or its Pallas kernel's with ``kernel``) and conv tail, and
    each shared call's keys and values (its attention given the zero cache at
    position 0)."""
    rh, _ = harnesses(dtype)
    cfg = rh.cfg
    params = ref_param.cast_floats(jax.tree.map(jnp.asarray, ref_weights()), cfg.dtype)
    kv = ref_param.tree_init(rh.serve_state_specs(RefCell("t", "decode", smax(n), B)),
                             jax.random.PRNGKey(0))["kv"]
    x = RL.embed(RRT, params["embed"], jnp.asarray(prompt(n))).astype(cfg.dtype)
    positions = jnp.arange(n)
    h, conv, k, v = [], [], [], []
    for i in range(cfg.n_layers):
        lp = jax.tree.map(lambda t: t[i], params["mamba_blocks"])
        x_in = RL.rmsnorm(lp["norm"], x)
        conv_in, scan_in = reference_scan_inputs(lp["mamba"], x_in, cfg.mamba)
        scan = ref_ops.ssd_scan(*scan_in, chunk=cfg.mamba.chunk) if kernel else RM.ssd_chunked(
            *scan_in, cfg.mamba.chunk)
        h.append(scan[1])
        conv.append(RM._causal_conv(conv_in, lp["mamba"]["conv_w"], lp["mamba"]["conv_b"])[1])
        with reference_scan(kernel):
            x = (x + RM.mamba2_apply(RRT, lp["mamba"], x_in, cfg.mamba)[0]).astype(cfg.dtype)
        if (i + 1) % cfg.share_every == 0 and i + 1 < cfg.n_layers:
            c = len(k)
            x, (kc, vc) = RH._shared_block(RRT, cfg, params["shared"], x, positions,
                                           (kv["k"][c], kv["v"][c]), 0)
            k.append(kc)
            v.append(vc)
    return to_np({"ssm": {"h": jnp.stack(h), "conv": jnp.stack(conv)},
                  "kv": {"k": jnp.stack(k), "v": jnp.stack(v)}})


@functools.lru_cache(maxsize=None)
def reference_recurrence(dtype, n=S):
    """The reference's decode_step over prompt + STEPS tokens from the zero
    state: the state after the prompt, and the logits of every step."""
    rh, _ = harnesses(dtype)
    params = jax.tree.map(jnp.asarray, ref_weights())
    state = ref_param.tree_init(rh.serve_state_specs(RefCell("t", "decode", smax(n), B)), jax.random.PRNGKey(0))
    decode = jax.jit(rh.decode(RRT))
    toks = tokens(n + STEPS)
    logits = []
    for t in range(n + STEPS):
        lg, state = decode(params, state, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t, jnp.int32))
        logits.append(to_np(lg)[:, -1])
        if t == n - 1:
            prompt_state = to_np(state)
    return prompt_state, np.stack(logits, 1), to_np(state)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype, use_kernels):
    _, ph = harnesses(dtype)
    r = reference_forward(dtype, use_kernels)
    with torch.no_grad():
        p = PH.forward(Runtime(use_kernels=use_kernels), ph.cfg, carry(ref_weights(), TDT[dtype]),
                       torch.from_numpy(prompt()))
    assert p.shape == (B, S, ph.cfg.vocab_padded) and p.dtype == TDT[dtype]
    assert max_err(p, r) <= tol(dtype, r)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_state_matches_reference_recurrence(dtype, use_kernels):
    """the port's one-pass prefill leaves the state the reference's
    decode_step reaches token by token: SSM states, conv tails and the
    shared block's KV cache; and four decode steps on from it agree.

    In float32 the chunked prefill and the recurrence are the same
    arithmetic in another order.  In bfloat16 the plain path's twin rounds
    ``att`` and the carried state where the recurrence does not (the
    reference's own twin too: its bf16 forward's last logits lie 0.85 of the
    limit from its recurrence's), so there the state is held against what
    the reference's functions compute over the prompt on the same path
    (``reference_prompt_state``), and the decode steps against the
    recurrence."""
    prompt_state, ref_logits, final_state = reference_recurrence(dtype)
    if dtype == "bfloat16":
        prompt_state = reference_prompt_state(dtype, use_kernels)
    forward_last = reference_forward(dtype, use_kernels)[:, -1]
    _, ph = harnesses(dtype)
    rt = Runtime(use_kernels=use_kernels)
    params = carry(ref_weights(), TDT[dtype])
    toks = torch.from_numpy(tokens(S + STEPS))
    state = tree_init(ph.serve_state_specs(ShapeCell("t", "decode", smax(S), B)),
                      torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        logits, state = ph.prefill(rt)(params, state, toks[:, :S])
        got = jax.tree.map(np.copy, to_np(state))             # decode writes on
        decode_logits = []
        for i in range(STEPS):
            lg, state = ph.decode(rt)(params, state, toks[:, S + i:S + i + 1], S + i)
            decode_logits.append(to_np(lg)[:, -1])
    assert logits.shape == (B, 1, ph.cfg.vocab_padded)
    lim = tol(dtype, ref_logits)
    assert max_err(logits[:, 0], forward_last) <= tol(dtype, forward_last)
    ssm, ref_ssm = got["ssm"], prompt_state["ssm"]
    assert state["ssm"]["h"].dtype == torch.float32
    assert max_err(ssm["h"], ref_ssm["h"]) <= tol(dtype, ref_ssm["h"], f32=1e-4)
    # the conv tail is promoted as the reference's concatenation promotes it
    assert str(state["ssm"]["conv"].dtype).split(".")[-1] == jnp.dtype(JDT[dtype]).name
    assert max_err(ssm["conv"], ref_ssm["conv"]) <= tol(dtype, ref_ssm["conv"], f32=1e-4)
    for name in ("k", "v"):
        kv = prompt_state["kv"][name]
        assert max_err(got["kv"][name], kv) <= tol(dtype, kv)
        assert not got["kv"][name][:, :, S:].any()              # only [0, S) written
    for i in range(STEPS):
        assert max_err(decode_logits[i], ref_logits[:, S + i]) <= lim
    assert max_err(state["ssm"]["h"], final_state["ssm"]["h"]) <= tol(dtype, final_state["ssm"]["h"], f32=1e-4)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_across_a_chunk_boundary(use_kernels):
    """a prompt of 256 = two of the scan's chunks of 128: the state carried
    from the first chunk into the second, against the reference's
    recurrence (float32)"""
    n = 256
    prompt_state, _, _ = reference_recurrence("float32", n)
    forward_last = reference_forward("float32", False, n)[:, -1]
    _, ph = harnesses("float32")
    state = tree_init(ph.serve_state_specs(ShapeCell("t", "decode", smax(n), B)),
                      torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        logits, state = PH.prefill(Runtime(use_kernels=use_kernels), ph.cfg, carry(ref_weights()),
                                   torch.from_numpy(prompt(n)), state)
    assert max_err(logits[:, 0], forward_last) <= 2e-4
    assert max_err(state["ssm"]["h"], prompt_state["ssm"]["h"]) <= 1e-4


def test_reference_prefill_keeps_its_input_state():
    """the reference's fault that the port works around: its prefill returns
    the state it was given, bit for bit, so the first decode step's logits do
    not depend on the prompt.  If this fails the reference changed: revisit
    the workaround (hybrid.prefill) and ROADMAP's Queue C."""
    rh, _ = harnesses("float32")
    params = jax.tree.map(jnp.asarray, ref_weights())
    state = ref_param.tree_init(rh.serve_state_specs(RefCell("t", "decode", smax(S), B)), jax.random.PRNGKey(0))
    prefill, decode = rh.prefill(RRT), rh.decode(RRT)
    firsts = []
    for seed in (1, 2):
        _, out = prefill(params, state, jnp.asarray(tokens(S, seed)))
        for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(state)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        lg, _ = decode(params, out, jnp.asarray(tokens(1, 3)), jnp.asarray(S, jnp.int32))
        firsts.append(np.asarray(lg))
    np.testing.assert_array_equal(firsts[0], firsts[1])


@pytest.mark.parametrize("use_kernels", [True, False])
def test_reference_bf16_noise_exceeds_3e_2(use_kernels):
    """the control of the bf16 limits above: a model computed in float32,
    without the twin's roundings (the reference's and the port's, on either
    path), lies farther than 3e-2 of the largest |logit| from the bf16
    reference that path is held against, so the limit tells them apart"""
    r16 = reference_forward("bfloat16", use_kernels)
    _, ph = harnesses("float32")
    with torch.no_grad():
        p32 = PH.forward(Runtime(use_kernels=use_kernels), ph.cfg, carry(ref_weights(), torch.float32),
                         torch.from_numpy(prompt()))
    for f32 in (reference_forward("float32", use_kernels), p32):
        assert max_err(f32, r16) > tol("bfloat16", r16)


def port_params(seed=42):
    h = port_configs.load("zamba2-1.2b", smoke=True).clone(dtype=torch.float32)
    return h, tree_init(h.param_specs(), torch.Generator().manual_seed(seed), device="cpu")


@pytest.mark.parametrize("use_kernels", [True, False])
def test_causality(use_kernels):
    """perturbing a future token must not change earlier logits"""
    h, params = port_params()
    rt = Runtime(use_kernels=use_kernels)
    tok1 = torch.from_numpy(tokens(16))
    tok2 = tok1.clone()
    tok2[:, 12] = (tok2[:, 12] + 9) % 512
    with torch.no_grad():
        lg1 = PH.forward(rt, h.cfg, params, tok1)
        lg2 = PH.forward(rt, h.cfg, params, tok2)
    np.testing.assert_allclose(lg1[:, :12].numpy(), lg2[:, :12].numpy(), atol=1e-5)
    assert not np.allclose(lg1[:, 12:].numpy(), lg2[:, 12:].numpy())


@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_decode_consistency(use_kernels):
    """prefill(S tokens) then decode == forward(S+1 tokens) logits"""
    h, params = port_params()
    rt = Runtime(use_kernels=use_kernels)
    toks = torch.from_numpy(tokens(S + 1))
    state = tree_init(h.serve_state_specs(ShapeCell("t", "decode", S + 4, B)),
                      torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        _, state = PH.prefill(rt, h.cfg, params, toks[:, :S], state)
        lg_dec, _ = PH.decode_step(rt, h.cfg, params, toks[:, S:], state, S)
        lg_full = PH.forward(rt, h.cfg, params, toks)
    np.testing.assert_allclose(lg_dec[:, -1].numpy(), lg_full[:, -1].numpy(), atol=2e-4)


def test_group_loop_of_the_full_config(monkeypatch):
    """38 layers, share_every 6: the shared block after layers 6, 12, ...,
    36 (not after the last, 38), each call with its own cache"""
    h = port_configs.load("zamba2-1.2b")
    assert (h.cfg.n_layers, h.cfg.n_shared_calls) == (38, 6)
    order = []

    def mamba(rt, p, x, cfg, state=None, keep=True):
        order.append("m")
        return torch.zeros_like(x), {"h": torch.zeros(()), "conv": torch.zeros(())}

    def shared(rt, cfg, p, x, positions, cache=None, cache_pos=None):
        order.append(("s", cache[0].data_ptr()))
        return x, cache

    monkeypatch.setattr(PH, "mamba2_apply", mamba)
    monkeypatch.setattr(PH, "_shared_block", shared)
    cfg = h.cfg
    params = {"embed": {"tok": torch.zeros(8, 4), "unembed": torch.zeros(4, 8)},
              "mamba_blocks": {"norm": torch.ones(38, 4), "mamba": {}},
              "shared": {}, "final_norm": torch.ones(4)}
    kv = torch.zeros(6, 1, 2, 1, 1)
    state = {"ssm": {"h": torch.zeros(38), "conv": torch.zeros(38)}, "kv": {"k": kv, "v": kv.clone()}}
    PH.decode_step(Runtime(), cfg, params, torch.zeros((1, 1), dtype=torch.int32), state, 0)
    shared_at = [i for i, o in enumerate(order) if o != "m"]
    assert [order[:i].count("m") for i in shared_at] == [6, 12, 18, 24, 30, 36]
    assert order.count("m") == 38
    assert [order[i][1] for i in shared_at] == [kv[c].data_ptr() for c in range(6)]
