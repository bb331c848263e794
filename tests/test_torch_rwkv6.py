"""Port of models/rwkv6.py against the reference, on the same weights and
inputs (numpy, carried to both), float32 and bfloat16, kernels on and off,
with the reference's zero-initialised ``mu``, ``w0`` and ``bonus_u`` drawn
non-zero (``_torch_parity.draw_time_mix``).

Tolerances.  float32: 5e-5 on the scan (the reference kernel test's), 2e-4
on a block's output and 1e-4 on its state (the same arithmetic, sums in
another order, through the projections).  bfloat16: 3e-2 of the largest
|value| (at least 3e-2), as for the port's logits: the two frameworks may
sum a product in another order, and a value one ulp apart carries through
the scan and the gates.  Where the point is how a bf16 value rounds (the
gates, the decay's low-rank product), bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.rwkv6 as RW
from repro.models.layers import Runtime as RefRuntime
from repro_torch.models import layers as PL
from repro_torch.models import mamba2 as PM
from repro_torch.models import rwkv6 as PW
from repro_torch.models.layers import Runtime

from _torch_parity import JDT, TDT, carry, draw_time_mix, max_err, rand, to_np

RRT = RefRuntime(rules=None)
# the rwkv6 smoke config's widths (4 heads of 32, decay LoRA rank 64); three
# chunks of 16 in a sequence of 48: the state crosses chunk boundaries
KW = dict(d_model=128, head_dim=32, d_ff=256, chunk=16)
B, S = 2, 48


def weights(seed=5):
    """The reference's spec trees of both blocks, every leaf drawn: the
    scaled ones as randn / sqrt(fan_in), the rmsnorm weight around 1, and
    mu, w0, bonus_u non-zero."""
    cfg = RW.RWKV6Config(**KW)
    rng = np.random.default_rng(seed)
    out = []
    for specs in (RW.timemix_specs(cfg), RW.channelmix_specs(cfg)):
        p = {}
        for name, s in specs.items():
            if s.init == "ones":
                p[name] = (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
            else:
                scale = 1 / np.sqrt(s.shape[-2]) if len(s.shape) >= 2 else 0.5
                p[name] = rand(rng, s.shape, scale)
        out.append(p)
    tm, cm = out
    draw_time_mix(tm, cm, rng)
    return tm, cm


def tol(dtype, ref, f32=2e-4):
    if dtype == "float32":
        return f32
    return 3e-2 * max(1.0, float(np.abs(to_np(ref)).max()))


def both_x(dtype, seed=9, n=S):
    x = np.random.default_rng(seed).standard_normal((B, n, KW["d_model"])).astype(np.float32)
    return jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def ref_params(p, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(JDT[dtype]), p)


def decode_state(dtype, seed=13, shift=True):
    """A state to continue from: a drawn fp32 scan state, and the token
    shift's last input in bf16, as the serving state holds it."""
    rng = np.random.default_rng(seed)
    H, N = KW["d_model"] // KW["head_dim"], KW["head_dim"]
    s = rand(rng, (B, H, N, N))
    sh = rng.standard_normal((B, 1, KW["d_model"])).astype(np.float32)
    ref = {"s": jnp.asarray(s), "shift": jnp.asarray(sh).astype(jnp.bfloat16)}
    port = {"s": torch.from_numpy(s), "shift": torch.from_numpy(sh).bfloat16()}
    return ref, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sigmoid_rounds_as_the_reference(dtype):
    """the channel mix's gate rounds as the reference's: the same bits in
    bf16, where a sigmoid rounded once (``torch.sigmoid``) lies an ulp away
    in many elements; in fp32 within the frameworks' exp (a few ulps)"""
    x = rand(np.random.default_rng(6), (65536,), 4.0)
    r = jax.nn.sigmoid(jnp.asarray(x).astype(JDT[dtype]))
    p = PL._sigmoid(torch.from_numpy(x).to(TDT[dtype]))
    assert p.dtype == TDT[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(to_np(p), to_np(r), rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(to_np(p), to_np(r))
        assert max_err(torch.sigmoid(torch.from_numpy(x).bfloat16()), r) > 0


def test_silu_moved_and_still_rounds_as_the_reference():
    """``_silu`` lives in layers now; mamba2 re-exports the same function,
    and it is still bit-equal to the reference's in bf16"""
    assert PM._silu is PL._silu
    x = rand(np.random.default_rng(7), (65536,), 3.0)
    r = jax.nn.silu(jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_array_equal(to_np(PL._silu(torch.from_numpy(x).bfloat16())), to_np(r))


def test_decay_lora_order_is_the_reference_order():
    """the three-operand einsum "bsd,dl,le->bse" is two products, each
    rounded to bf16: (x @ a) @ b gives the reference's bits, x @ (a @ b)
    does not.  The reference's einsum picks the order by its cost; with
    rank 64 and d_model >= 128 (every rwkv6 config, smoke and full) that is
    x @ a first"""
    tm, _ = weights()
    xj, xt = both_x("bfloat16")
    a, b = (jnp.asarray(tm[n]).astype(jnp.bfloat16) for n in ("w_lora_a", "w_lora_b"))
    r = jnp.einsum("bsd,dl,le->bse", xj, a, b)
    at, bt = (torch.from_numpy(tm[n]).bfloat16() for n in ("w_lora_a", "w_lora_b"))
    np.testing.assert_array_equal(to_np((xt @ at) @ bt), to_np(r))
    assert max_err(xt @ (at @ bt), r) > 0


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_chunked_matches_reference(dtype, with_s0):
    """the port's model twin against the reference's on the same inputs:
    float32 5e-5 on y and the state; bf16 y one ulp of each element plus
    5e-5 (both are fp32 inside and round once), the state 5e-5"""
    rng = np.random.default_rng(21)
    H, N = 4, 16
    r, k, v = (rand(rng, (B, S, H, N)) for _ in range(3))
    w = (0.98 / (1 + np.exp(-rng.standard_normal((B, S, H, N)))) + 0.01).astype(np.float32)
    u = rand(rng, (H, N), 0.3)
    s0 = rand(rng, (B, H, N, N)) if with_s0 else None
    J = [jnp.asarray(a).astype(JDT[dtype]) for a in (r, k, v)] + [jnp.asarray(w), jnp.asarray(u).astype(JDT[dtype])]
    T = [torch.from_numpy(a).to(TDT[dtype]) for a in (r, k, v)] + [torch.from_numpy(w), torch.from_numpy(u).to(TDT[dtype])]
    yr, sr = RW.rwkv6_chunked(*J, 16, None if s0 is None else jnp.asarray(s0))
    yp, sp = PW.rwkv6_chunked(*T, 16, None if s0 is None else torch.from_numpy(s0))
    assert yp.dtype == TDT[dtype] and sp.dtype == torch.float32
    if dtype == "float32":
        assert max_err(yp, yr) <= 5e-5
    else:
        o, q = to_np(yp).astype(np.float64), to_np(yr).astype(np.float64)
        assert np.max(np.abs(o - q) / (2.0 ** -7 * np.abs(q) + 5e-5)) <= 1.0
    assert max_err(sp, sr) <= 5e-5


def test_rwkv6_chunked_keeps_the_reference_assertion():
    z = torch.zeros(1, 24, 1, 4)
    with pytest.raises(AssertionError):
        PW.rwkv6_chunked(z, z, z, z, torch.zeros(1, 4), 16)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_timemix_apply_prefill(dtype, use_kernels):
    """without a state: the output against the reference's; the state the
    port returns (which the reference drops) against the reference's own
    recurrence from a zero state over the same input (float32: 1e-4)"""
    tm, _ = weights()
    xj, xt = both_x(dtype)
    cfg, pcfg = RW.RWKV6Config(**KW), PW.RWKV6Config(**KW)
    r_out, _ = RW.timemix_apply(RRT, ref_params(tm, dtype), xj, cfg)
    with torch.no_grad():
        p_out, p_state = PW.timemix_apply(Runtime(use_kernels=use_kernels), carry(tm, TDT[dtype]), xt, pcfg)
    assert p_out.dtype == TDT[dtype]
    assert max_err(p_out, r_out) <= tol(dtype, r_out)
    H, N = pcfg.n_heads, pcfg.head_dim
    zero = {"s": jnp.zeros((B, H, N, N), jnp.float32), "shift": jnp.zeros((B, 1, KW["d_model"]), JDT[dtype])}
    _, r_state = RW.timemix_apply(RRT, ref_params(tm, dtype), xj, cfg, zero)
    assert p_state["s"].dtype == torch.float32
    assert max_err(p_state["s"], r_state["s"]) <= tol(dtype, r_state["s"], f32=1e-4)
    assert torch.equal(p_state["shift"], xt[:, -1:])


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_timemix_apply_decode(dtype, use_kernels, n):
    """with a state (the recurrence, the same code on both paths): output,
    scan state and shift against the reference's; a bf16 shift buffer of a
    float32 model is promoted as the reference's concatenation promotes"""
    tm, _ = weights()
    xj, xt = both_x(dtype, seed=10, n=n)
    ref_state, port_state = decode_state(dtype)
    r_out, r_new = RW.timemix_apply(RRT, ref_params(tm, dtype), xj, RW.RWKV6Config(**KW), ref_state)
    with torch.no_grad():
        p_out, p_new = PW.timemix_apply(Runtime(use_kernels=use_kernels), carry(tm, TDT[dtype]), xt,
                                        PW.RWKV6Config(**KW), port_state)
    assert max_err(p_out, r_out) <= tol(dtype, r_out)
    assert max_err(p_new["s"], r_new["s"]) <= tol(dtype, r_new["s"], f32=1e-4)
    assert str(p_new["shift"].dtype).split(".")[-1] == jnp.dtype(r_new["shift"].dtype).name
    np.testing.assert_array_equal(to_np(p_new["shift"]), to_np(r_new["shift"]))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channelmix_apply(dtype, with_state):
    _, cm = weights()
    xj, xt = both_x(dtype, seed=11)
    ref_state, port_state = decode_state(dtype)
    r_out, r_new = RW.channelmix_apply(RRT, ref_params(cm, dtype), xj,
                                       {"shift": ref_state["shift"]} if with_state else None)
    with torch.no_grad():
        p_out, p_new = PW.channelmix_apply(Runtime(), carry(cm, TDT[dtype]), xt,
                                           {"shift": port_state["shift"]} if with_state else None)
    assert p_out.dtype == TDT[dtype]
    assert max_err(p_out, r_out) <= tol(dtype, r_out)
    assert torch.equal(p_new["shift"], xt[:, -1:])
    if with_state:
        np.testing.assert_array_equal(to_np(p_new["shift"]), to_np(r_new["shift"]))


def test_draws_are_non_zero():
    """the leaves the reference initialises to zeros are drawn here"""
    tm, cm = weights()
    for leaf in (tm["mu"], cm["mu"], tm["w0"], tm["bonus_u"]):
        assert np.all(leaf != 0)
    assert 0 < tm["mu"].min() and tm["mu"].max() < 1
