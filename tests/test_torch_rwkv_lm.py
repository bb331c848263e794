"""Port of models/rwkv_lm.py (rwkv6 smoke: 2 layers, d_model 128, head_dim
32, chunk 16, vocab 512) against the reference, same carried weights, with
the reference's zero-initialised ``mu``, ``w0`` and ``bonus_u`` drawn
non-zero: forward, and the serving state the port's ``prefill`` returns held
against the reference's own recurrence.

The reference's ``RWKVHarness.prefill`` returns the state it was given
(``test_reference_rwkv_prefill_keeps_its_input_state`` pins that), so its
decode starts from zeros whatever the prompt.  The port's ``prefill``
returns the state the prompt leaves; what that state must be is what the
reference's ``decode_step`` reaches when fed the prompt one token at a time
from the zero state.

Tolerances.  float32: 2e-4 on logits, 1e-4 on the state (the same
arithmetic in another order: chunked scan against recurrence).  bfloat16:
3e-2 of the largest |value| (see tests/test_torch_transformer.py).  The
port's plain path is held against the reference's model (its scan the twin
``rwkv6_chunked``), the kernel path against it and against the reference
with its scan through its own Pallas kernel
(``_torch_parity.reference_rwkv_scan``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.param as ref_param
import repro.models.rwkv6 as RW
from repro.kernels import ops as ref_ops
from repro.models import layers as RL
from repro.models import rwkv_lm as RLM
from repro.models.api import ShapeCell as RefCell
from repro.models.layers import Runtime as RefRuntime
import repro_torch.configs as port_configs
from repro_torch.models import rwkv_lm as PLM
from repro_torch.models.api import ShapeCell
from repro_torch.models.layers import Runtime
from repro_torch.models.param import tree_init

from _torch_parity import (JDT, TDT, carry, draw_time_mix, max_err, reference_rwkv_scan,
                           reference_rwkv_scan_inputs, to_np)

B, S, STEPS = 2, 12, 4
RRT = RefRuntime(rules=None)


def harnesses(dtype):
    return (ref_configs.load("rwkv6-1.6b", smoke=True).clone(dtype=JDT[dtype]),
            port_configs.load("rwkv6-1.6b", smoke=True).clone(dtype=TDT[dtype]))


def tol(dtype, ref, f32=2e-4):
    """float32: ``f32``.  bfloat16: 3e-2 of the largest |ref|."""
    if dtype == "float32":
        return f32
    return 3e-2 * max(1.0, float(np.abs(to_np(ref)).max()))


@functools.lru_cache(maxsize=None)
def ref_weights(seed=7):
    """The reference's weights, with mu, w0 and bonus_u drawn (zeros in the
    spec) so that the token shift, the decay's bias and the bonus act."""
    h, _ = harnesses("float32")
    params = to_np(ref_param.tree_init(h.param_specs(), jax.random.PRNGKey(seed)))
    blocks = params["blocks"]
    draw_time_mix(blocks["tm"], blocks["cm"], np.random.default_rng(seed))
    return params


def smax(n):
    return n + STEPS + 8


def tokens(n, seed=11):
    return np.random.default_rng(seed).integers(0, 512, (B, n), dtype=np.int32)


def prompt(n=S):
    """The first n of the n + STEPS tokens the reference's recurrence is fed."""
    return tokens(n + STEPS)[:, :n]


def jparams():
    return jax.tree.map(jnp.asarray, ref_weights())


@functools.lru_cache(maxsize=None)
def reference_forward(dtype, kernel=False, n=S):
    """The reference's forward over the first n tokens (its scan through its
    Pallas kernel with ``kernel``)."""
    rh, _ = harnesses(dtype)
    with reference_rwkv_scan(kernel):
        return to_np(RLM.forward(RRT, rh.cfg, jparams(), jnp.asarray(prompt(n))))


@functools.lru_cache(maxsize=None)
def reference_prompt_state(dtype, kernel=False, n=S):
    """What the reference's forward computes over the prompt and drops, from
    its own functions layer by layer: each layer's final scan state (its
    twin's, or its Pallas kernel's with ``kernel``) and the last inputs of
    its two token shifts."""
    rh, _ = harnesses(dtype)
    cfg = rh.cfg
    params = ref_param.cast_floats(jparams(), cfg.dtype)
    x = RL.embed(RRT, params["embed"], jnp.asarray(prompt(n)))
    x = RL.layernorm(params["ln_in"], x).astype(cfg.dtype)
    tm_s, tm_shift, cm_shift = [], [], []
    for i in range(cfg.n_layers):
        lp = jax.tree.map(lambda t: t[i], params["blocks"])
        x_tm = RL.layernorm(lp["ln1"], x)
        scan_in = reference_rwkv_scan_inputs(lp["tm"], x_tm, cfg.inner)
        scan = (ref_ops.rwkv6_scan(*scan_in, chunk=cfg.chunk) if kernel
                else RW.rwkv6_chunked(*scan_in, cfg.chunk))
        tm_s.append(scan[1])
        tm_shift.append(x_tm[:, -1:])
        with reference_rwkv_scan(kernel):
            x = x + RW.timemix_apply(RRT, lp["tm"], x_tm, cfg.inner)[0]
        x_cm = RL.layernorm(lp["ln2"], x)
        cm_shift.append(x_cm[:, -1:])
        x = x + RW.channelmix_apply(RRT, lp["cm"], x_cm)[0]
    return to_np({"tm_s": jnp.stack(tm_s), "tm_shift": jnp.stack(tm_shift), "cm_shift": jnp.stack(cm_shift)})


@functools.lru_cache(maxsize=None)
def reference_recurrence(dtype, n=S):
    """The reference's decode_step over prompt + STEPS tokens from the zero
    state: the state after the prompt, and the logits of every step."""
    rh, _ = harnesses(dtype)
    state = ref_param.tree_init(rh.serve_state_specs(RefCell("t", "decode", smax(n), B)), jax.random.PRNGKey(0))
    decode = jax.jit(rh.decode(RRT))
    toks = tokens(n + STEPS)
    logits = []
    for t in range(n + STEPS):
        lg, state = decode(jparams(), state, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t, jnp.int32))
        logits.append(to_np(lg)[:, -1])
        if t == n - 1:
            prompt_state = to_np(state)
    return prompt_state, np.stack(logits, 1), to_np(state), jax.tree.map(lambda a: a.dtype, state)


def port_state(ph, n):
    return tree_init(ph.serve_state_specs(ShapeCell("t", "decode", smax(n), B)),
                     torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype, use_kernels):
    """the plain path against the reference's model; the kernel path against
    it and against the reference with its scan through its Pallas kernel"""
    _, ph = harnesses(dtype)
    with torch.no_grad():
        p = PLM.forward(Runtime(use_kernels=use_kernels), ph.cfg, carry(ref_weights(), TDT[dtype]),
                        torch.from_numpy(prompt()))
    assert p.shape == (B, S, ph.cfg.vocab_padded) and p.dtype == TDT[dtype]
    for kernel in ((False, True) if use_kernels else (False,)):
        r = reference_forward(dtype, kernel)
        assert max_err(p, r) <= tol(dtype, r)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_state_matches_reference_recurrence(dtype, use_kernels):
    """the port's one-pass prefill leaves the state the reference's
    decode_step reaches token by token: each layer's scan state and token
    shifts; and four decode steps on from it agree.

    In float32 the chunked prefill and the recurrence are the same
    arithmetic in another order.  In bfloat16 the state is held against what
    the reference's functions compute over the prompt on the same path
    (``reference_prompt_state``), and the decode steps against the
    recurrence.  The shift buffers come back in the type the reference's
    decode gives them: float32 for a float32 model, whose bf16 buffers are
    promoted and never rounded into."""
    prompt_state, ref_logits, final_state, ref_types = reference_recurrence(dtype)
    if dtype == "bfloat16":
        prompt_state = reference_prompt_state(dtype, use_kernels)
    forward_last = reference_forward(dtype, use_kernels)[:, -1]
    _, ph = harnesses(dtype)
    rt = Runtime(use_kernels=use_kernels)
    params = carry(ref_weights(), TDT[dtype])
    toks = torch.from_numpy(tokens(S + STEPS))
    state = port_state(ph, S)
    with torch.no_grad():
        logits, state = ph.prefill(rt)(params, state, toks[:, :S])
        got = jax.tree.map(np.copy, to_np(state))             # decode writes on
        decode_logits = []
        for i in range(STEPS):
            lg, state = ph.decode(rt)(params, state, toks[:, S + i:S + i + 1], S + i)
            decode_logits.append(to_np(lg)[:, -1])
    assert logits.shape == (B, 1, ph.cfg.vocab_padded)
    assert max_err(logits[:, 0], forward_last) <= tol(dtype, forward_last)
    for name in ("tm_s", "tm_shift", "cm_shift"):
        assert str(state[name].dtype).split(".")[-1] == jnp.dtype(ref_types[name]).name, name
        assert max_err(got[name], prompt_state[name]) <= tol(dtype, prompt_state[name], f32=1e-4), name
    lim = tol(dtype, ref_logits)
    for i in range(STEPS):
        assert max_err(decode_logits[i], ref_logits[:, S + i]) <= lim
    assert max_err(state["tm_s"], final_state["tm_s"]) <= tol(dtype, final_state["tm_s"], f32=1e-4)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_across_chunk_boundaries(use_kernels):
    """a prompt of 80 = five of the scan's chunks of 16: the state carried
    from chunk to chunk, against the reference's recurrence (float32)"""
    n = 80
    prompt_state, _, _, _ = reference_recurrence("float32", n)
    forward_last = reference_forward("float32", False, n)[:, -1]
    _, ph = harnesses("float32")
    with torch.no_grad():
        logits, state = PLM.prefill(Runtime(use_kernels=use_kernels), ph.cfg, carry(ref_weights()),
                                    torch.from_numpy(prompt(n)), port_state(ph, n))
    assert max_err(logits[:, 0], forward_last) <= 2e-4
    for name in ("tm_s", "tm_shift", "cm_shift"):
        assert max_err(state[name], prompt_state[name]) <= 1e-4, name


@pytest.mark.parametrize("use_kernels", [True, False])
def test_decode_matches_forward(use_kernels):
    """tests/test_models.py::test_rwkv_decode_matches_forward restated: the
    bf16 smoke model fed 12 tokens one by one through decode_step from the
    zero state gives forward's logits within 5e-2"""
    h = port_configs.load("rwkv6-1.6b", smoke=True)
    rt = Runtime(use_kernels=use_kernels)
    params = carry(ref_weights())
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 64, (1, 12), dtype=np.int32))
    state = tree_init(h.serve_state_specs(ShapeCell("t", "decode", 12, 1)),
                      torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        lg_full = PLM.forward(rt, h.cfg, params, toks)
        outs = []
        for t in range(12):
            lg, state = PLM.decode_step(rt, h.cfg, params, toks[:, t:t + 1], state, t)
            outs.append(lg[:, 0])
    np.testing.assert_allclose(to_np(torch.stack(outs, dim=1)), to_np(lg_full), atol=5e-2)


def test_reference_rwkv_prefill_keeps_its_input_state():
    """the reference's fault that the port works around: its prefill returns
    the state it was given, bit for bit, so the first decode step's logits do
    not depend on the prompt.  If this fails the reference changed: revisit
    the workaround (rwkv_lm.prefill) and ROADMAP's Queue C."""
    rh, _ = harnesses("float32")
    state = ref_param.tree_init(rh.serve_state_specs(RefCell("t", "decode", smax(S), B)), jax.random.PRNGKey(0))
    prefill, decode = rh.prefill(RRT), rh.decode(RRT)
    firsts = []
    for seed in (1, 2):
        _, out = prefill(jparams(), state, jnp.asarray(tokens(S, seed)))
        for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(state)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        lg, _ = decode(jparams(), out, jnp.asarray(tokens(1, 3)), jnp.asarray(S, jnp.int32))
        firsts.append(np.asarray(lg))
    np.testing.assert_array_equal(firsts[0], firsts[1])


def port_params(seed=42):
    """The port's own draw in float32, with mu, w0 and bonus_u drawn too."""
    h = port_configs.load("rwkv6-1.6b", smoke=True).clone(dtype=torch.float32)
    params = tree_init(h.param_specs(), torch.Generator().manual_seed(seed), device="cpu")
    blocks = to_np(params["blocks"])
    draw_time_mix(blocks["tm"], blocks["cm"], np.random.default_rng(seed))
    params["blocks"] = carry(blocks)
    return h, params


@pytest.mark.parametrize("use_kernels", [True, False])
def test_causality(use_kernels):
    """perturbing a future token must not change earlier logits"""
    h, params = port_params()
    rt = Runtime(use_kernels=use_kernels)
    tok1 = torch.from_numpy(tokens(16))
    tok2 = tok1.clone()
    tok2[:, 12] = (tok2[:, 12] + 9) % 512
    with torch.no_grad():
        lg1 = PLM.forward(rt, h.cfg, params, tok1)
        lg2 = PLM.forward(rt, h.cfg, params, tok2)
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
        _, state = PLM.prefill(rt, h.cfg, params, toks[:, :S], state)
        lg_dec, _ = PLM.decode_step(rt, h.cfg, params, toks[:, S:], state, S)
        lg_full = PLM.forward(rt, h.cfg, params, toks)
    np.testing.assert_allclose(lg_dec[:, -1].numpy(), lg_full[:, -1].numpy(), atol=2e-4)
