"""Port of models/layers.py against the reference, function by function.

The same numpy-made inputs and weights go through both.  float32: 1e-5 (the
same arithmetic, sums in another order).  bfloat16: 2e-2 absolute (each
function rounds its output once or a few times to bf16, whose ulp at
magnitude 1..2 is 0.0078; the outputs here stay below 2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.models import layers as PL

from _torch_parity import both, rand, to_np

DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
RRT, PRT = RL.Runtime(rules=None), PL.Runtime(rules=None)


def close(port, ref, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(to_np(port), to_np(ref), atol=tol, rtol=0)


def weights(rng, shapes: dict, dtype, scale=0.5):
    """{name: shape} -> (jax dict, torch dict) of the same values"""
    j, t = {}, {}
    for name, shape in shapes.items():
        j[name], t[name] = both(rand(rng, shape, scale), dtype)
    return j, t


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    (jw, tw), (jx, tx) = both(1 + rand(rng, (96,), 0.1), dtype), both(rand(rng, (2, 5, 96), 2.0), dtype)
    close(PL.rmsnorm(tw, tx), RL.rmsnorm(jw, jx), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm(dtype):
    rng = np.random.default_rng(1)
    jp, tp = weights(rng, {"scale": (96,), "bias": (96,)}, dtype)
    jx, tx = both(1.0 + rand(rng, (2, 5, 96), 2.0), dtype)
    close(PL.layernorm(tp, tx), RL.layernorm(jp, jx), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batched", [False, True])
def test_rope(dtype, batched):
    rng = np.random.default_rng(2)
    jx, tx = both(rand(rng, (2, 7, 3, 32)), dtype)
    pos = np.arange(40, 47) if not batched else np.stack([np.arange(7), np.arange(100, 107)])
    out = PL.rope(tx, torch.from_numpy(pos), 10000.0)
    close(out, RL.rope(jx, jnp.asarray(pos), 10000.0), dtype)
    assert out.dtype == tx.dtype


@pytest.mark.parametrize("causal,window,prefix_len", [
    (True, None, 0), (True, 8, 0), (True, None, 5), (False, None, 0), (True, 4, 3), (False, 6, 0),
])
def test_mask_bias(causal, window, prefix_len):
    q_pos, k_pos = np.arange(10, 22), np.arange(30)
    port = PL._mask_bias(torch.from_numpy(q_pos), torch.from_numpy(k_pos), causal, window, prefix_len)
    ref = RL._mask_bias(jnp.asarray(q_pos), jnp.asarray(k_pos), causal, window, prefix_len)
    assert port.dtype == torch.float32
    np.testing.assert_array_equal(to_np(port), to_np(ref))      # 0 / -1e9 exactly


@pytest.mark.parametrize("dtype", DTYPES)
def test_sdpa(dtype):
    rng = np.random.default_rng(3)
    B, Sq, Sk, K, G, D = 2, 6, 9, 2, 3, 32
    (jq, tq), (jk, tk), (jv, tv) = (
        both(rand(rng, s), dtype) for s in [(B, Sq, K, G, D), (B, Sk, K, D), (B, Sk, K, D)])
    jb = RL._mask_bias(jnp.arange(3, 3 + Sq), jnp.arange(Sk), True, None)
    tb = PL._mask_bias(torch.arange(3, 3 + Sq), torch.arange(Sk), True, None)
    close(PL.sdpa(tq, tk, tv, tb), RL.sdpa(jq, jk, jv, jb), dtype)
    close(PL.sdpa(tq, tk, tv, None), RL.sdpa(jq, jk, jv, None), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu(dtype):
    rng = np.random.default_rng(4)
    jp, tp = weights(rng, {"w_gate": (96, 192), "w_up": (96, 192), "w_down": (192, 96)}, dtype, 0.1)
    jx, tx = both(rand(rng, (2, 5, 96)), dtype)
    close(PL.swiglu(PRT, tp, tx), RL.swiglu(RRT, jp, jx), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bias", [True, False])
def test_gelu_mlp(dtype, bias):
    rng = np.random.default_rng(5)
    shapes = {"w_in": (96, 192), "w_out": (192, 96)}
    if bias:
        shapes |= {"b_in": (192,), "b_out": (96,)}
    jp, tp = weights(rng, shapes, dtype, 0.1)
    jx, tx = both(rand(rng, (2, 5, 96)), dtype)
    close(PL.gelu_mlp(PRT, tp, tx), RL.gelu_mlp(RRT, jp, jx), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_unembed(dtype):
    rng = np.random.default_rng(6)
    jp, tp = weights(rng, {"tok": (256, 96), "unembed": (96, 256)}, dtype, 0.1)
    tokens = rng.integers(0, 256, (2, 5), dtype=np.int32)
    np.testing.assert_array_equal(                      # a lookup: exact
        to_np(PL.embed(PRT, tp, torch.from_numpy(tokens))),
        to_np(RL.embed(RRT, jp, jnp.asarray(tokens))))
    jx, tx = both(rand(rng, (2, 5, 96)), dtype)
    close(PL.unembed(PRT, tp, tx), RL.unembed(RRT, jp, jx), dtype)


def test_specs_match():
    cfg = dict(d_model=96, n_heads=3, n_kv_heads=1, head_dim=32, qkv_bias=True)
    pairs = [
        (PL.attn_specs(PL.AttnConfig(**cfg)), RL.attn_specs(RL.AttnConfig(**cfg))),
        (PL.swiglu_specs(96, 192), RL.swiglu_specs(96, 192)),
        (PL.gelu_mlp_specs(96, 192), RL.gelu_mlp_specs(96, 192)),
        (PL.layernorm_specs(96), RL.layernorm_specs(96)),
        (PL.embed_specs(512, 96), RL.embed_specs(512, 96)),
        ({"w": PL.rmsnorm_spec(96)}, {"w": RL.rmsnorm_spec(96)}),
        (PL.init_kv_cache(PL.AttnConfig(**cfg), 2, 24, 3, torch.bfloat16),
         RL.init_kv_cache(RL.AttnConfig(**cfg), 2, 24, 3, jnp.bfloat16)),
    ]
    for p, r in pairs:
        assert sorted(p) == sorted(r)
        for k in p:
            assert (p[k].shape, p[k].logical, p[k].init, p[k].scale) == (
                r[k].shape, r[k].logical, r[k].init, r[k].scale), k


ATTN_CASES = {
    "gqa": dict(d_model=128, n_heads=4, n_kv_heads=2, head_dim=32),
    "mqa_window_bias": dict(d_model=96, n_heads=3, n_kv_heads=1, head_dim=32, window=6, qkv_bias=True),
    "prefix": dict(d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, prefix_len=3),
}


def attn_setup(case, dtype, seed):
    kw = ATTN_CASES[case]
    rcfg, pcfg = RL.AttnConfig(**kw), PL.AttnConfig(**kw)
    D, N, K, Dh = kw["d_model"], kw["n_heads"], kw["n_kv_heads"], kw["head_dim"]
    shapes = {"wq": (D, N * Dh), "wk": (D, K * Dh), "wv": (D, K * Dh), "wo": (N * Dh, D)}
    if kw.get("qkv_bias"):
        shapes |= {"bq": (N * Dh,), "bk": (K * Dh,), "bv": (K * Dh,), "bo": (D,)}
    rng = np.random.default_rng(seed)
    jp, tp = weights(rng, shapes, dtype, 0.1)
    return rng, rcfg, pcfg, jp, tp


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_three_uses(case, dtype, use_kernels):
    """no cache; prefill written at 0 into a longer cache; one token at
    cache_pos.  With use_kernels the port goes through the flash-attention
    wrapper (its plain version on the CPU), else through sdpa as the
    reference does: both are held against the reference."""
    rng, rcfg, pcfg, jp, tp = attn_setup(case, dtype, 7)
    rt = PL.Runtime(use_kernels=use_kernels)
    B, S, Smax, D, K, Dh = 2, 10, 16, rcfg.d_model, rcfg.n_kv_heads, rcfg.head_dim
    jx, tx = both(rand(rng, (B, S, D)), dtype)

    # 1. no cache
    ry, rc = RL.attention(RRT, jp, jx, rcfg, jnp.arange(S))
    py, pc = PL.attention(rt, tp, tx, pcfg, torch.arange(S))
    assert rc is None and pc is None
    close(py, ry, dtype)

    # 2. prefill: write at 0 into a longer cache
    jck, tck = both(np.zeros((B, Smax, K, Dh), np.float32), dtype)
    jcv, tcv = both(np.zeros((B, Smax, K, Dh), np.float32), dtype)
    ry, (rk, rv) = RL.attention(RRT, jp, jx, rcfg, jnp.arange(S), (jck, jcv), jnp.asarray(0))
    py, (pk, pv) = PL.attention(rt, tp, tx, pcfg, torch.arange(S), (tck, tcv), 0)
    assert pk is tck and pv is tcv                      # written in place
    close(py, ry, dtype)
    close(pk, rk, dtype)
    close(pv, rv, dtype)
    assert not pk[:, S:].any() and pk[:, :S].any()

    # 3. decode: one token at cache_pos, over the cache the prefill left
    jx1, tx1 = both(rand(rng, (B, 1, D)), dtype)
    ry, (rk, rv) = RL.attention(RRT, jp, jx1, rcfg, jnp.asarray([S]), (rk, rv), jnp.asarray(S))
    py, (pk, pv) = PL.attention(rt, tp, tx1, pcfg, torch.tensor([S]), (pk, pv), S)
    close(py, ry, dtype)
    close(pk, rk, dtype)
    close(pv, rv, dtype)


def test_runtime_takes_no_rules_yet():
    with pytest.raises(NotImplementedError):
        PL.Runtime(rules=object()).shard(torch.zeros(1), "batch")
    assert PL.Runtime().use_kernels is True             # honoured, and on by default
