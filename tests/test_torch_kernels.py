"""The port's kernels (their plain versions: no GPU here) against the
reference's Pallas kernels (interpret mode) and the reference's oracles.

Tolerances as tests/test_kernels.py: flash attention float32 2e-5 (sums in
another order), bfloat16 2e-2 (one rounding of the output, |out| < 1); SSD
and RWKV-6 scans 5e-5 on y and the final state (RWKV-6's extreme decay
5e-4); MoE dispatch 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st  # hypothesis or skip-shim
from repro.kernels import moe_dispatch as ref_moe, ops as ref_ops, ref as ref_ref
from repro.models import layers as ref_layers
from repro_torch.kernels import launch_counts, ops, ref, reset_launch_counts
from repro_torch.kernels._autograd import PlainGradient
from repro_torch.kernels.ccu_reduce import ccu_reduce, ccu_reduce_plain
from repro_torch.kernels.flash_attention import (
    _with_grad, decode_splits, flash_attention, flash_attention_bwd_plain, flash_attention_plain, kernel_gradient)
from repro_torch.kernels.moe_dispatch import moe_dispatch, moe_dispatch_plain, moe_gather_matmul
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_plain
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models import layers

from _torch_parity import (BF16_ULP, JDT, TDT, both, flash_bwd_emulated, flash_emulated, max_err,  # noqa: F401
                           moe_compacted, one_thread, rand, rwkv_emulated, ssd_emulated, to_np)

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def qkv(seed, B, K, G, Sq, Sk, D, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rand(rng, (B, K, G, Sq, D)), rand(rng, (B, K, Sk, D)), rand(rng, (B, K, Sk, D))]
    j, t = zip(*(both(a, dtype) for a in arrs))
    return j, t


@pytest.mark.parametrize("B,K,G,S,D", [
    (1, 1, 1, 128, 64),
    (2, 2, 3, 256, 64),
    (1, 4, 2, 256, 128),
    (2, 1, 8, 128, 32),     # MQA
    (1, 1, 8, 128, 256),    # MQA at paligemma-3b's head_dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shapes_dtypes(B, K, G, S, D, dtype):
    j, t = qkv(42, B, K, G, S, S, D, dtype)
    o = ops.flash_attention_bkgsd(*t, causal=True)
    assert o.dtype == t[0].dtype and o.shape == t[0].shape
    tol = TOL[dtype]
    assert max_err(o, ref_ops.flash_attention_bkgsd(*j, causal=True)) <= tol   # Pallas, interpret
    assert max_err(o, ref_ref.attention_ref(*j, causal=True)) <= tol
    assert max_err(o, ref.attention_ref(*t, causal=True)) <= tol               # the port's own oracle


@pytest.mark.parametrize("kwargs", [
    dict(causal=True, window=64),
    dict(causal=True, prefix_len=48),
    dict(causal=False),
    dict(causal=True, window=32, prefix_len=16),
])
def test_masks(kwargs):
    j, t = qkv(43, 2, 2, 2, 256, 256, 64, "float32")
    o = ops.flash_attention_bkgsd(*t, **kwargs)
    assert max_err(o, ref_ops.flash_attention_bkgsd(*j, **kwargs)) <= 2e-5
    assert max_err(o, ref_ref.attention_ref(*j, **kwargs)) <= 2e-5
    assert max_err(ref.attention_ref(*t, **kwargs), ref_ref.attention_ref(*j, **kwargs)) <= 2e-5


@pytest.mark.parametrize("Sq,Sk,q_start,window,prefix_len", [
    (100, 100, 0, None, 0),        # ragged, no multiple of any tile
    (77, 203, 126, None, 0),       # a continuation: rows 126..202 over 203 keys
    (45, 300, 255, 70, 0),         # sliding window at an offset
    (1, 200, 199, None, 0),        # a decode step over the cache
    (1, 131, 130, 64, 0),
    (1, 97, 96, 16, 8),
    (5, 60, 55, 16, 8),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_and_q_start_vs_sdpa(Sq, Sk, q_start, window, prefix_len, dtype):
    """what the reference has no kernel for: held against the port's sdpa with
    the mask bias at the rows' global positions"""
    B, K, G, D = 2, 2, 3, 32
    _, (q, k, v) = qkv(44, B, K, G, Sq, Sk, D, dtype)
    o = flash_attention(q, k, v, causal=True, window=window, prefix_len=prefix_len, q_start=q_start)
    bias = layers._mask_bias(
        q_start + torch.arange(Sq), torch.arange(Sk), True, window, prefix_len)
    r = layers.sdpa(q.permute(0, 3, 1, 2, 4), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), bias)
    assert max_err(o, r.permute(0, 2, 3, 1, 4)) <= TOL[dtype]


@pytest.mark.parametrize("Sq,Sk,q_start,causal,window,prefix_len", [
    (100, 100, 0, True, None, 0),
    (77, 203, 126, True, None, 0),
    (45, 300, 255, True, 70, 0),
    (1, 97, 96, True, 16, 8),
    (5, 60, 55, True, 16, 24),       # the prefix reaches into the window
    (33, 65, 0, False, 8, 0),        # a window without the causal limit
])
def test_oracle_is_independent_of_the_plain_version(Sq, Sk, q_start, causal, window, prefix_len):
    """attention_ref works out each row's keys as index ranges and takes the
    softmax over them alone in float64; the plain version masks with -1e30 in
    fp32.  They agree to fp32 rounding (2e-5), q_start and ragged lengths
    included, which the reference's oracle cannot be asked."""
    _, (q, k, v) = qkv(49, 2, 2, 3, Sq, Sk, 32, "float32")
    kw = dict(causal=causal, window=window, prefix_len=prefix_len, q_start=q_start)
    assert max_err(flash_attention_plain(q, k, v, **kw), ref.attention_ref(q, k, v, **kw)) <= 2e-5


def test_keys_past_the_rows_change_nothing():
    """prefill over a longer cache: the keys the causal mask hides have
    probability exactly 0, so cutting them off is the same function"""
    _, (q, k, v) = qkv(45, 1, 2, 2, 40, 64, 32, "float32")
    full = flash_attention(q, k, v, causal=True)
    cut = flash_attention(q, k[:, :, :40], v[:, :, :40], causal=True)
    assert torch.equal(full, cut)


def test_model_layout_wrapper():
    rng = np.random.default_rng(46)
    B, S, N, K, D = 2, 128, 8, 2, 64
    (jq, tq), (jk, tk), (jv, tv) = (
        both(rand(rng, s), "float32") for s in [(B, S, N, D), (B, S, K, D), (B, S, K, D)])
    o = ops.flash_attention_bsnd(tq, tk, tv, causal=True)
    bias = ref_layers._mask_bias(jnp.arange(S), jnp.arange(S), True, None)
    r = ref_layers.sdpa(jq.reshape(B, S, K, N // K, D), jk, jv, bias).reshape(B, S, N, D)
    assert max_err(o, r) <= 2e-5
    assert max_err(o, ref_ops.flash_attention_bsnd(jq, jk, jv, causal=True)) <= 2e-5
    # strided views in, as the model hands them over: a slice of a longer cache
    cache_k = torch.cat([tk, torch.zeros(B, 9, K, D)], dim=1)
    cache_v = torch.cat([tv, torch.zeros(B, 9, K, D)], dim=1)
    o2 = ops.flash_attention_bsnd(tq, cache_k[:, :S], cache_v[:, :S], causal=True)
    assert torch.equal(o, o2)


def test_finite_fill_keeps_masked_tiles_finite():
    """a sliding window masks whole stretches of keys: -1e30, not -inf"""
    _, (q, k, v) = qkv(47, 1, 1, 2, 256, 256, 32, "bfloat16")
    o = flash_attention(q, k, v, causal=True, window=8)
    assert torch.isfinite(o.float()).all()


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "mixed", "shape", "rank", "device"])
def test_wrapper_raises(bad):
    q, k, v = torch.zeros(1, 2, 2, 8, 32), torch.zeros(1, 2, 8, 32), torch.zeros(1, 2, 8, 32)
    if bad == "head_dim":
        q, k, v = (torch.zeros(*t.shape[:-1], 48) for t in (q, k, v))
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed":
        k = k.bfloat16()
    elif bad == "shape":
        k = torch.zeros(1, 3, 8, 32)
        v = k
    elif bad == "rank":
        q = q[0]
    elif bad == "device":
        # a tensor that is neither on the CPU nor on a CUDA device never
        # reaches the plain version
        q, k, v = (torch.empty(t.shape, device="meta") for t in (q, k, v))
    with pytest.raises(ValueError):
        flash_attention(q, k, v)


def test_launch_count_untouched_on_cpu():
    reset_launch_counts()
    _, (q, k, v) = qkv(48, 1, 1, 1, 8, 8, 32, "float32")
    flash_attention(q, k, v)
    assert launch_counts() == {"flash_attention": 0, "moe_dispatch": 0, "ssd_scan": 0, "rwkv6_scan": 0,
                               "ccu_reduce": 0, "flash_attention.bwd": 0}   # CPU tensors
    assert torch.equal(flash_attention(q, k, v), flash_attention_plain(q, k, v))


# ---------------------------------------------------------------------------
# the CUDA kernels' arithmetic, emulated on the CPU (the kernels themselves run
# only on the card: tests/test_torch_gpu.py)
# ---------------------------------------------------------------------------


def peaked_qkv(seed, B, K, G, Sq, Sk, D):
    """bf16 inputs as the card's tests draw them (q 2 randn, k 1.5 randn, v
    randn): each row's softmax rests on a few keys, outputs of order 1."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32) * sc).bfloat16()
                 for s, sc in [((B, K, G, Sq, D), 2.0), ((B, K, Sk, D), 1.5), ((B, K, Sk, D), 1.0)])


def one_ulp_excess(o, r) -> float:
    """Largest |o - r| over one bf16 ulp of the element plus 1e-5, the limit
    the kernel is held to on the card."""
    o, r = o.double(), r.double()
    return ((o - r).abs() / (BF16_ULP * r.abs() + 1e-5)).max().item()


@pytest.mark.parametrize("B,K,G,S,D", [(1, 1, 1, 128, 64), (2, 2, 3, 256, 64), (1, 4, 2, 256, 128), (2, 1, 8, 128, 32)])
def test_tensor_core_arithmetic_within_one_ulp(B, K, G, S, D):
    """The prefill kernel's arithmetic (64-key tiles, P = P_hi + P_lo, two
    bf16 products summed in fp32) on the reference test's shapes, causal:
    within one bf16 ulp of each element of the plain version."""
    q, k, v = peaked_qkv(60, B, K, G, S, S, D)
    o = flash_emulated(q, k, v, causal=True, p_parts=2)
    assert one_ulp_excess(o, flash_attention_plain(q, k, v, causal=True)) <= 1.0


@pytest.mark.parametrize("G,Sk,kw", [
    (4, 200, dict(q_start=199)),
    (9, 131, dict(window=64, q_start=130)),
    (1, 97, dict(window=16, prefix_len=8, q_start=96)),
    (4, 64, dict(q_start=63)),                     # one tile: one split
    (4, 300, dict(window=16, prefix_len=100, q_start=299)),   # the prefix crosses a split
    (4, 1000, dict(q_start=999)),                  # many splits
])
def test_decode_arithmetic_within_one_ulp(G, Sk, kw):
    """The decode kernels' arithmetic (fp32 P, the keys in splits of whole
    tiles as ``decode_splits`` cuts them, partials combined in split order)
    within one bf16 ulp of each element of the plain version."""
    q, k, v = peaked_qkv(61, 2, 2, G, 1, Sk, 64)
    splits = decode_splits(2 * 2, Sk, 132)
    o = flash_emulated(q, k, v, causal=True, p_parts=None, splits=splits, **kw)
    assert one_ulp_excess(o, flash_attention_plain(q, k, v, causal=True, **kw)) <= 1.0


@pytest.mark.parametrize("G,S,kw", [
    (8, 128, dict(causal=True)),
    (8, 96, dict(causal=True, prefix_len=40)),             # paligemma's bidirectional prefix
    (2, 100, dict(causal=True, window=30, prefix_len=9)),
    (1, 77, dict(causal=False)),
])
def test_tensor_core_arithmetic_at_head_dim_256(G, S, kw):
    """At head_dim 256 the tensor-core kernel's two warpgroups each take 128
    of the output's columns, each computing the same S and P: the split
    changes no bit of the result.  Within one bf16 ulp of the plain version
    and within the bf16 tolerance of the reference's Pallas kernel
    (interpret mode)."""
    q, k, v = peaked_qkv(63, 1, 1, G, S, S, 256)
    o = flash_emulated(q, k, v, p_parts=2, col_block=128, **kw)
    assert torch.equal(o, flash_emulated(q, k, v, p_parts=2, **kw))
    assert one_ulp_excess(o, flash_attention_plain(q, k, v, **kw)) <= 1.0
    if S % 32 == 0:                 # the reference's kernel takes whole blocks only
        ref = ref_ops.flash_attention_bkgsd(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
                                            block_q=32, block_k=32, **kw)
        assert max_err(o, ref) <= TOL["bfloat16"] * float(o.float().abs().max())


@pytest.mark.parametrize("Sk,kw", [
    (776, dict(q_start=775)),                                  # paligemma's decode: G = 8, Sk = P + S + i
    (300, dict(window=16, prefix_len=100, q_start=299)),
    (1536, dict(causal=False)),                                # whisper's cross-attention, at D = 256 here
])
def test_decode_arithmetic_at_head_dim_256(Sk, kw):
    """The decode kernels at head_dim 256 (8 columns a lane, partials over
    ``decode_splits`` of whole tiles): within one bf16 ulp of each element
    of the plain version."""
    kw = dict(causal=True) | kw
    q, k, v = peaked_qkv(64, 2, 1, 8, 1, Sk, 256)
    o = flash_emulated(q, k, v, p_parts=None, splits=decode_splits(2, Sk, 132), **kw)
    assert one_ulp_excess(o, flash_attention_plain(q, k, v, **kw)) <= 1.0


def test_single_bf16_p_breaks_one_ulp():
    """Why the tensor-core kernel takes two products: one bf16 P puts
    elements many ulps from the fp32-P result, the split P_hi + P_lo does not."""
    q, k, v = peaked_qkv(62, 2, 2, 3, 256, 256, 64)
    r = flash_attention_plain(q, k, v, causal=True)
    assert one_ulp_excess(flash_emulated(q, k, v, causal=True, p_parts=1), r) > 10.0
    assert one_ulp_excess(flash_emulated(q, k, v, causal=True, p_parts=2), r) <= 1.0


@pytest.mark.parametrize("bk,Sk,splits", [
    (32, 520, 9),      # granite-8b decode: 288 blocks
    (128, 527, 3),     # zamba2-1.2b decode
    (32, 1, 1), (32, 64, 1), (32, 65, 2), (4, 4096, 64), (1024, 4096, 1),
    (1, 16384, 128),   # at most MAX_SPLITS
])
def test_decode_splits(bk, Sk, splits):
    """About two blocks an SM of 132, at most 128 splits (the combine
    kernel's room), whole 64-key tiles, no split empty."""
    assert decode_splits(bk, Sk, 132) == splits
    tiles = -(-Sk // 64)
    per = -(-tiles // splits)
    assert (splits - 1) * per < tiles <= splits * per


# ---------------------------------------------------------------------------
# flash attention's autograd.Function: its plumbing on the CPU, through the
# plain version (on the card its forward is the kernel: tests/test_torch_gpu.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(causal=True, window=None, prefix_len=0, q_start=0),
    dict(causal=True, window=3, prefix_len=2, q_start=0),
    dict(causal=True, window=None, prefix_len=0, q_start=5),
    dict(causal=False, window=None, prefix_len=0, q_start=0),
])
def test_attention_function_gradcheck(kw):
    """The backward of flash attention under autograd (``PlainGradient``: the
    plain version's gradient at the saved inputs) against finite
    differences, in float64, GQA with G = 2."""
    rng = np.random.default_rng(3)
    Sk = 6 + kw["q_start"]
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in [(1, 2, 2, 6, 32), (1, 2, Sk, 32), (1, 2, Sk, 32)])
    kw = {**kw, "sm_scale": 1 / np.sqrt(32)}
    plain = functools.partial(flash_attention_plain, **kw)
    assert torch.autograd.gradcheck(lambda q, k, v: PlainGradient.apply("plain", plain, plain, q, k, v), (q, k, v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_function_matches_plain_autograd(dtype):
    """Forward and gradients of flash attention through ``PlainGradient`` are
    those of autograd through the plain version, bit for bit, in the model's
    layout (strided views)."""
    rng = np.random.default_rng(4)
    B, S, N, K, D = 2, 40, 4, 2, 32
    base = [torch.from_numpy(rand(rng, (B, S, h * D))).to(TDT[dtype]) for h in (N, K, K)]
    views = lambda q, k, v: (q.unflatten(2, (K, N // K, D)).permute(0, 2, 3, 1, 4),   # noqa: E731
                             k.unflatten(2, (K, D)).permute(0, 2, 1, 3), v.unflatten(2, (K, D)).permute(0, 2, 1, 3))
    kw = dict(causal=True, window=None, prefix_len=0, q_start=0, sm_scale=1 / np.sqrt(D))
    go = torch.from_numpy(rand(rng, (B, K, N // K, S, D))).to(TDT[dtype])
    outs = []
    plain = functools.partial(flash_attention_plain, **kw)
    for fn in (lambda *t: PlainGradient.apply("plain", plain, plain, *t), plain):
        leaves = [t.clone().requires_grad_() for t in base]
        o = fn(*views(*leaves))
        o.backward(go)
        outs.append([o.detach(), *(t.grad for t in leaves)])
    for a, b in zip(*outs):
        assert a.dtype == TDT[dtype] and torch.equal(a, b)


# flash attention's backward kernels: their arithmetic in plain PyTorch
# (``flash_attention_bwd_plain``) and the choice of backward (on the card the
# kernels themselves: tests/test_torch_gpu.py)

BWD_CASES = [   # (B, K, G, Sq, Sk, D, mask)
    (2, 2, 1, 70, 70, 64, dict(causal=True)),
    (1, 2, 4, 50, 50, 128, dict(causal=True, window=16)),
    (2, 1, 6, 40, 40, 64, dict(causal=True, prefix_len=9)),
    (1, 2, 4, 33, 70, 64, dict(causal=True, q_start=37)),
    (2, 2, 1, 20, 45, 128, dict(causal=False)),
    (1, 1, 6, 17, 60, 128, dict(causal=True, window=20, prefix_len=5, q_start=43)),
    (1, 2, 4, 65, 30, 64, dict(causal=False)),
]


def bwd_inputs(seed, B, K, G, Sq, Sk, D, dtype):
    """q, k, v and the output's gradient, peaked as the card's tests draw
    them (q 2 randn, k 1.5 randn, v and dO randn)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s) * sc).to(dtype)
                 for s, sc in [((B, K, G, Sq, D), 2.0), ((B, K, Sk, D), 1.5), ((B, K, Sk, D), 1.0),
                               ((B, K, G, Sq, D), 1.0)])


@pytest.mark.parametrize("B,K,G,Sq,Sk,D,kw", BWD_CASES)
def test_flash_bwd_plain_is_the_gradient(B, K, G, Sq, Sk, D, kw):
    """In float64 the plain backward (P from the saved log-sum-exp, delta,
    dS = P (dP - delta)) is autograd's gradient of ``flash_attention_plain``
    and of the float64 oracle ``attention_ref``, to rounding."""
    q, k, v, do = bwd_inputs(31, B, K, G, Sq, Sk, D, torch.float64)
    o, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert lse.dtype == torch.float64
    got = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for fn in (flash_attention_plain, ref.attention_ref):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(fn(*leaves, **kw), leaves, do)
        for a, b in zip(got, want):
            assert a.dtype == torch.float64 and a.shape == b.shape
            assert (a - b).abs().max() <= 1e-12 * b.abs().max()


@pytest.mark.parametrize("B,K,G,Sq,Sk,D,kw", BWD_CASES)
def test_flash_bwd_plain_in_fp32(B, K, G, Sq, Sk, D, kw):
    """In fp32 (the kernels' own sums) the plain backward lies within 1e-5
    of each gradient's largest |g| from autograd through the float64 oracle."""
    q, k, v, do = bwd_inputs(32, B, K, G, Sq, Sk, D, torch.float32)
    o, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    got = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention_ref(*leaves, **kw), leaves, do.double())
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert (a.double() - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize("B,K,G,Sq,Sk,D,kw", BWD_CASES)
def test_flash_bwd_arithmetic_within_one_ulp(B, K, G, Sq, Sk, D, kw):
    """The backward kernels' arithmetic (``flash_bwd_emulated``: P rounded
    to bf16 and dS cut into two bf16 parts as the products' operands, fp32
    sums, delta from the fp32 output) on bf16 inputs lies within one bf16
    ulp of each gradient's largest |g| from the float64 oracle's, the limit
    ``chip_smoke.py`` holds the kernels to."""
    q, k, v, do = bwd_inputs(33, B, K, G, Sq, Sk, D, torch.bfloat16)
    o, lse = flash_attention_plain(q.float(), k.float(), v.float(), return_lse=True, **kw)
    got = flash_bwd_emulated(q, k, v, o, lse, do, **kw)
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention_ref(*leaves, **kw), leaves, do.double())
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert (a.double() - b).abs().max() <= BF16_ULP * b.abs().max()


@pytest.mark.parametrize("B,K,G,Sq,Sk,D,kw", BWD_CASES)
def test_flash_bwd_plain_matches_jax_grad(B, K, G, Sq, Sk, D, kw):
    """The plain backward in float64, on the saved output and log-sum-exp,
    against the reference's gradient: ``jax.vjp`` of its oracle
    ``attention_ref`` (fp32 inside) on the same q, k, v and dO, within 1e-5
    of each gradient's largest |g|.  The reference's oracle has no
    ``q_start`` (its rows start at position 0), so q_start zero rows with a
    zero gradient go before q, and their dq is cut off again."""
    q, k, v, do = (t.numpy() for t in bwd_inputs(35, B, K, G, Sq, Sk, D, torch.float32))
    w = [torch.from_numpy(a).double() for a in (q, k, v, do)]
    o, lse = flash_attention_plain(*w[:3], return_lse=True, **kw)
    got = flash_attention_bwd_plain(*w[:3], o, lse, w[3], **kw)
    n = kw.get("q_start", 0)
    pad = lambda a: jnp.asarray(np.concatenate([np.zeros((B, K, G, n, D), np.float32), a], axis=3))  # noqa: E731
    _, vjp = jax.vjp(lambda *t: ref_ref.attention_ref(*t, **{a: b for a, b in kw.items() if a != "q_start"}),
                     pad(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g, np.float64) for g in vjp(pad(do))]
    want[0] = want[0][:, :, :, n:]
    for a, b in zip(got, want):
        assert a.dtype == torch.float64 and a.shape == b.shape
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


def _stub_launches(calls):
    """The forward and backward launches of ``_with_grad``, stubbed with the
    plain versions on CPU tensors; each call is appended to ``calls``."""

    def launch(*t, for_backward=False, **kw):
        calls.append("fwd+lse" if for_backward else "fwd")
        o, lse = flash_attention_plain(*t, return_lse=True, **kw)
        return (o, lse, o) if for_backward else o

    def launch_bwd(*t, **kw):
        calls.append("bwd")
        return flash_attention_bwd_plain(*t, **kw)

    return launch, launch_bwd


@pytest.mark.parametrize("dtype,D,kernel", [
    ("bfloat16", 64, True), ("bfloat16", 128, True), ("bfloat16", 32, False), ("bfloat16", 256, False),
    ("float32", 64, False), ("float32", 128, False),
])
def test_flash_gradient_chosen_by_dtype_and_head_dim(dtype, D, kernel):
    """Under autograd the wrapper takes the backward kernels (the forward
    asked for the log-sum-exp, then one backward call) for bf16 at head_dim
    64 and 128, and the plain version's gradient (``PlainGradient``: the
    forward alone) for fp32 and for head_dim 32 and 256: the launches are
    stubbed with the plain versions on CPU tensors.  Either way the
    gradients are autograd's through the plain version, to the kernels'
    rounding (two bf16 ulps of the largest |g|; fp32 bit for bit)."""
    calls = []
    launch, launch_bwd = _stub_launches(calls)
    q, k, v, do = bwd_inputs(34, 1, 2, 3, 40, 40, D, TDT[dtype])
    kw = dict(causal=True, window=None, prefix_len=0, q_start=0, sm_scale=1 / np.sqrt(D))
    assert kernel_gradient(q) == kernel
    runs = []
    for fn in (lambda *t: _with_grad(*t, kw, launch=launch, launch_bwd=launch_bwd),
               lambda *t: flash_attention_plain(*t, **kw)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*leaves)
        o.backward(do)
        runs.append((o, [t.grad for t in leaves]))
    (o, g), (op, gp) = runs
    assert type(o.grad_fn).__name__ == ("FlashGradientBackward" if kernel else "PlainGradientBackward")
    assert calls == (["fwd+lse", "bwd"] if kernel else ["fwd"])
    assert torch.equal(o.detach(), op.detach())
    for a, b in zip(g, gp):
        assert a.dtype == TDT[dtype]
        if kernel:
            assert (a.float() - b.float()).abs().max() <= 2 * BF16_ULP * b.float().abs().max()
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G,Sq,kernel", [(1, 16, False), (4, 4, False), (1, 17, True), (6, 3, True)])
def test_flash_gradient_plain_at_decode_rows(G, Sq, D, kernel):
    """bf16 at head_dim 64 and 128 over at most 16 folded rows (G * Sq): the
    forward is a decode kernel, which writes no unrounded output for the
    backward, so the plain version's gradient takes the call; over 16 rows
    the backward kernels do (launches stubbed on CPU tensors)."""
    calls = []
    launch, launch_bwd = _stub_launches(calls)
    q, k, v, do = bwd_inputs(36, 1, 2, G, Sq, 40, D, torch.bfloat16)
    kw = dict(causal=True, window=None, prefix_len=0, q_start=40 - Sq, sm_scale=1 / np.sqrt(D))
    assert kernel_gradient(q) == kernel
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = _with_grad(*leaves, kw, launch=launch, launch_bwd=launch_bwd)
    o.backward(do)
    assert type(o.grad_fn).__name__ == ("FlashGradientBackward" if kernel else "PlainGradientBackward")
    assert calls == (["fwd+lse", "bwd"] if kernel else ["fwd"])
    assert all(torch.isfinite(t.grad.float()).all() for t in leaves)


def test_attention_cpu_path_keeps_the_graph():
    """On CPU tensors the wrapper is the plain version, graph and all."""
    _, (q, k, v) = qkv(5, 1, 1, 2, 8, 8, 32, "float32")
    q.requires_grad_()
    o = flash_attention(q, k, v)
    assert o.grad_fn is not None
    o.sum().backward()
    assert q.grad is not None and q.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# SSD scan: the reference's TestSSDScan restated, and what the port adds
# ---------------------------------------------------------------------------


def ssd_inputs(seed, B, S, H, P, N, log_l=None):
    """As tests/test_kernels.py draws them: x, B, C of scale 0.5, and
    log_l = -softplus(randn) unless given."""
    rng = np.random.default_rng(seed)
    xh, Bm, Cm = rand(rng, (B, S, H, P)), rand(rng, (B, S, N)), rand(rng, (B, S, N))
    if log_l is None:
        log_l = -np.logaddexp(0.0, rng.standard_normal((B, S, H))).astype(np.float32)
    else:
        log_l = np.full((B, S, H), log_l, np.float32)
    return xh, log_l, Bm, Cm


def torch_of(arrays, dtype="float32"):
    """x, B, C in ``dtype``; log_l stays float32, as the model hands it over."""
    xh, ll, Bm, Cm = arrays
    return (torch.from_numpy(xh).to(TDT[dtype]), torch.from_numpy(ll),
            torch.from_numpy(Bm).to(TDT[dtype]), torch.from_numpy(Cm).to(TDT[dtype]))


def bf16_excess(o, r, fp32_diff=1e-5) -> float:
    """Largest |o - r| over its limit, one bf16 ulp of the element (2^-7 |r|)
    plus ``fp32_diff``, how far the fp32 results beneath may lie apart: both
    round one fp32 result once."""
    o, r = to_np(o).astype(np.float64), to_np(r).astype(np.float64)
    return float(np.max(np.abs(o - r) / (BF16_ULP * np.abs(r) + fp32_diff)))


class TestSSDScan:
    @pytest.mark.parametrize("B,S,H,P,N,chunk", [
        (1, 128, 2, 16, 16, 64),
        (2, 256, 4, 32, 16, 128),
        (1, 256, 1, 64, 64, 32),
    ])
    def test_matches_recurrence(self, B, S, H, P, N, chunk):
        arrays = ssd_inputs(50, B, S, H, P, N)
        y, h = ssd_scan_plain(*torch_of(arrays), chunk=chunk)
        assert y.shape == (B, S, H, P) and y.dtype == torch.float32
        assert h.shape == (B, H, P, N) and h.dtype == torch.float32
        j = [jnp.asarray(a) for a in arrays]
        yp, hp = ref_ops.ssd_scan(*j, chunk=chunk)                  # Pallas, interpret
        yr, hr = ref_ref.ssd_scan_ref(*j)
        for port, ref_ in ((y, yp), (h, hp), (y, yr), (h, hr)):
            assert max_err(port, ref_) <= 5e-5
        yo, ho = ref.ssd_scan_ref(*torch_of(arrays))                # the port's own oracle
        assert max_err(y, yo) <= 5e-5 and max_err(h, ho) <= 5e-5
        yw, hw = ops.ssd_scan(*torch_of(arrays), chunk=chunk)       # the wrapper, on the CPU
        assert torch.equal(yw, y) and torch.equal(hw, h)

    def test_strong_decay_is_stable(self):
        """the failure mode that NaN'd the factored form"""
        arrays = ssd_inputs(51, 1, 256, 2, 16, 16, log_l=-13.0)
        y, h = ssd_scan(*torch_of(arrays), chunk=128)
        assert torch.isfinite(y).all() and torch.isfinite(h).all()
        yr, hr = ref_ref.ssd_scan_ref(*(jnp.asarray(a) for a in arrays))
        assert max_err(y, yr) <= 5e-5 and max_err(h, hr) <= 5e-5

    @pytest.mark.parametrize("S", [1, 77, 200])
    @pytest.mark.parametrize("with_h0", [False, True])
    def test_ragged_and_initial_state(self, S, with_h0):
        """any S (a partial last chunk) and an initial state, where the
        reference's kernel asserts whole chunks and takes none: against the
        reference's token-level recurrence, which takes both"""
        B, H, P, N = 2, 3, 16, 16
        arrays = ssd_inputs(52 + S, B, S, H, P, N)
        h0 = rand(np.random.default_rng(S), (B, H, P, N)) if with_h0 else None
        y, h = ssd_scan(*torch_of(arrays), chunk=64,
                        h0=None if h0 is None else torch.from_numpy(h0))
        yr, hr = ref_ref.ssd_scan_ref(*(jnp.asarray(a) for a in arrays),
                                      h0=None if h0 is None else jnp.asarray(h0))
        assert max_err(y, yr) <= 5e-5 and max_err(h, hr) <= 5e-5

    @pytest.mark.parametrize("S,with_h0", [(128, False), (77, True)])
    def test_oracle_matches_reference_oracle(self, S, with_h0):
        arrays = ssd_inputs(53, 2, S, 2, 32, 16)
        h0 = rand(np.random.default_rng(1), (2, 2, 32, 16)) if with_h0 else None
        yo, ho = ref.ssd_scan_ref(*torch_of(arrays), h0=None if h0 is None else torch.from_numpy(h0))
        yr, hr = ref_ref.ssd_scan_ref(*(jnp.asarray(a) for a in arrays),
                                      h0=None if h0 is None else jnp.asarray(h0))
        assert max_err(yo, yr) <= 5e-5 and max_err(ho, hr) <= 5e-5

    def test_partial_chunk_is_zero_padding(self):
        """a partial last chunk computes what a chunk padded with x = 0,
        B = 0, log_l = 0 rows computes"""
        xh, ll, Bm, Cm = torch_of(ssd_inputs(54, 2, 100, 2, 16, 16))
        y, h = ssd_scan_plain(xh, ll, Bm, Cm, chunk=64)
        pad = [torch.cat([t, torch.zeros((2, 28, *t.shape[2:]))], dim=1) for t in (xh, ll, Bm, Cm)]
        yp, hp = ssd_scan_plain(*pad, chunk=64)
        assert max_err(y, yp[:, :100]) <= 1e-6 and max_err(h, hp) <= 1e-6

    def test_bfloat16(self):
        """x, B, C in bf16 (log_l float32, as the model's): y within one bf16
        ulp of the Pallas kernel's, which also works in fp32 inside; the
        float32 state within 5e-5"""
        arrays = ssd_inputs(55, 2, 256, 4, 32, 16)
        y, h = ssd_scan(*torch_of(arrays, "bfloat16"), chunk=128)
        assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
        j = [jnp.asarray(a) for a in arrays]
        j = [j[0].astype(jnp.bfloat16), j[1], j[2].astype(jnp.bfloat16), j[3].astype(jnp.bfloat16)]
        yp, hp = ref_ops.ssd_scan(*j, chunk=128)
        assert bf16_excess(y, yp) <= 1.0 and max_err(h, hp) <= 5e-5
        assert bf16_excess(y, ref.ssd_scan_ref(*torch_of(arrays, "bfloat16"))[0]) <= 1.0

    def test_plain_version_is_the_wrapper_on_cpu(self):
        reset_launch_counts()
        args = torch_of(ssd_inputs(56, 1, 40, 2, 16, 16))
        y, h = ssd_scan(*args, chunk=16)
        yp, hp = ssd_scan_plain(*args, chunk=16)
        assert torch.equal(y, yp) and torch.equal(h, hp)
        assert launch_counts() == {"flash_attention": 0, "moe_dispatch": 0, "ssd_scan": 0, "rwkv6_scan": 0,
                               "ccu_reduce": 0, "flash_attention.bwd": 0}

    def test_strided_inputs(self):
        """B and C as the model hands them over: slices of one conv output"""
        xh, ll, Bm, Cm = torch_of(ssd_inputs(57, 2, 64, 2, 16, 16))
        conv = torch.cat([torch.zeros(2, 64, 8), Bm, Cm], dim=-1)
        y, h = ops.ssd_scan(xh, ll, conv[..., 8:24], conv[..., 24:], chunk=32)
        y0, h0 = ops.ssd_scan(xh, ll, Bm, Cm, chunk=32)
        assert torch.equal(y, y0) and torch.equal(h, h0)

    @pytest.mark.parametrize("bad", ["rank", "seq", "heads", "dtype", "mixed", "log_dtype",
                                     "chunk", "width", "h0", "empty", "device"])
    def test_wrapper_raises(self, bad):
        xh, ll, Bm, Cm = torch.zeros(2, 8, 4, 16), torch.zeros(2, 8, 4), torch.zeros(2, 8, 16), torch.zeros(2, 8, 16)
        h0 = None
        if bad == "rank":
            xh = xh[0]
        elif bad == "seq":
            Bm = Cm = torch.zeros(2, 9, 16)
        elif bad == "heads":
            ll = torch.zeros(2, 8, 3)
        elif bad == "dtype":
            xh, Bm, Cm = xh.half(), Bm.half(), Cm.half()
        elif bad == "mixed":
            Bm = Bm.bfloat16()
        elif bad == "log_dtype":
            ll = ll.double()
        elif bad == "chunk":
            pass                               # chunk=256 below: more rows than the kernel holds
        elif bad == "width":
            xh = torch.zeros(2, 8, 4, 18)
        elif bad == "h0":
            h0 = torch.zeros(2, 4, 16, 15)
        elif bad == "empty":
            xh, ll, Bm, Cm = torch.zeros(2, 0, 4, 16), torch.zeros(2, 0, 4), torch.zeros(2, 0, 16), torch.zeros(2, 0, 16)
        elif bad == "device":
            xh, ll, Bm, Cm = (torch.empty(t.shape, device="meta") for t in (xh, ll, Bm, Cm))
        with pytest.raises(ValueError):
            ops.ssd_scan(xh, ll, Bm, Cm, chunk=256 if bad == "chunk" else 8, h0=h0)


# ---------------------------------------------------------------------------
# SSD scan: the bf16 kernel's arithmetic on the CPU (tensor-core products with
# the fp32 operand in two TF32 parts, scores shared by a block's heads), held
# against the JAX reference
# ---------------------------------------------------------------------------


def jax_bf16(arrays):
    """x, B, C as bf16 JAX arrays, log_l float32, as the model hands them over"""
    xh, ll, Bm, Cm = (jnp.asarray(a) for a in arrays)
    return xh.astype(jnp.bfloat16), ll, Bm.astype(jnp.bfloat16), Cm.astype(jnp.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk,with_h0", [
    (2, 256, 3, 16, 16, 64, False), (2, 200, 3, 16, 16, 64, True), (1, 77, 2, 8, 16, 128, True),
    (2, 40, 2, 8, 8, 16, False), (1, 1, 2, 8, 8, 16, True),
])
def test_ssd_scan_chunked_is_the_plain_function(B, S, H, P, N, chunk, with_h0, dtype):
    """``ssd_scan_chunked`` (what the kernel's backward differentiates) is
    ``ssd_scan_plain``'s function: y, the final state and every input's
    gradient agree to fp32 rounding (2e-6 of the largest), and in bf16 y and
    the gradients to one ulp of the largest, whole chunks, a ragged last one
    and an initial state alike."""
    from repro_torch.kernels.ssd_scan import ssd_scan_chunked

    gen = torch.Generator().manual_seed(S + H)
    xh, Bm, Cm = ((torch.randn(s, generator=gen) * 0.5).to(dtype) for s in [(B, S, H, P), (B, S, N), (B, S, N)])
    log_l = -torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen))
    h0 = torch.randn((B, H, P, N), generator=gen) * 0.5 if with_h0 else None
    gy = torch.randn((B, S, H, P), generator=gen).to(dtype)
    gh = torch.randn((B, H, P, N), generator=gen)
    runs = []
    for fn in (ssd_scan_plain, ssd_scan_chunked):
        xs = [t.detach().clone().requires_grad_() if t is not None else None for t in (xh, log_l, Bm, Cm, h0)]
        y, h = fn(*xs[:4], chunk=chunk, h0=xs[4])
        leaves = [t for t in xs if t is not None]
        runs.append((y, h, torch.autograd.grad((y, h), leaves, (gy, gh))))
    (y, h, g), (yc, hc, gc) = runs
    tol = 2e-6 if dtype == torch.float32 else 2.0 ** -7
    for a, r in [(yc, y), (hc, h), *zip(gc, g)]:
        assert (a.float() - r.float()).abs().max() <= tol * r.float().abs().max() + 1e-7


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 128, 2, 16, 16, 64),
    (2, 256, 4, 32, 16, 128),
    (1, 256, 1, 64, 64, 32),
])
def test_ssd_tensor_core_arithmetic_matches_reference(B, S, H, P, N, chunk):
    """At the reference test's shapes: y within one bf16 ulp of each element
    (plus 1e-5) of the reference's Pallas kernel (interpret mode) and of its
    token-level oracle, h within 5e-5 of both."""
    arrays = ssd_inputs(70, B, S, H, P, N)
    y, h = ssd_emulated(*torch_of(arrays, "bfloat16"), chunk=chunk)
    j = jax_bf16(arrays)
    yp, hp = ref_ops.ssd_scan(*j, chunk=chunk)
    yr, hr = ref_ref.ssd_scan_ref(*j)
    assert bf16_excess(y, yp) <= 1.0 and max_err(h, hp) <= 5e-5
    assert bf16_excess(y, yr) <= 1.0 and max_err(h, hr) <= 5e-5


def test_ssd_tensor_core_arithmetic_strong_decay():
    """log_l = -13: finite, and held to the reference's oracle as above"""
    arrays = ssd_inputs(71, 1, 256, 2, 16, 16, log_l=-13.0)
    y, h = ssd_emulated(*torch_of(arrays, "bfloat16"), chunk=128)
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all()
    yr, hr = ref_ref.ssd_scan_ref(*jax_bf16(arrays))
    assert bf16_excess(y, yr) <= 1.0 and max_err(h, hr) <= 5e-5


@pytest.mark.parametrize("S", [1, 77, 200])
def test_ssd_tensor_core_arithmetic_ragged_with_h0(S):
    """A ragged last chunk staged as zero rows, an initial state, and P = 48
    (the P columns taken 32 at a time, as a split of P would take them): against
    the reference's oracle, which takes both"""
    B, H, P, N = 2, 3, 48, 16
    arrays = ssd_inputs(72 + S, B, S, H, P, N)
    h0 = rand(np.random.default_rng(S), (B, H, P, N))
    y, h = ssd_emulated(*torch_of(arrays, "bfloat16"), chunk=64, h0=torch.from_numpy(h0), p_block=32)
    yr, hr = ref_ref.ssd_scan_ref(*jax_bf16(arrays), h0=jnp.asarray(h0))
    assert bf16_excess(y, yr) <= 1.0 and max_err(h, hr) <= 5e-5


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ssd_tensor_core_arithmetic_at_main_widths(seed):
    """zamba2's widths (P = N = 64, chunk 128, 512 rows) with an initial
    state: y within one bf16 ulp of each element of the plain version, h
    within 5e-5, as the kernel is held on the card."""
    xh, ll, Bm, Cm = torch_of(ssd_inputs(seed, 2, 512, 8, 64, 64), "bfloat16")
    h0 = torch.from_numpy(rand(np.random.default_rng(seed), (2, 8, 64, 64)))
    yp, hp = ssd_scan_plain(xh, ll, Bm, Cm, chunk=128, h0=h0)
    y, h = ssd_emulated(xh, ll, Bm, Cm, chunk=128, h0=h0)
    assert bf16_excess(y, yp) <= 1.0 and max_err(h, hp) <= 5e-5


def test_ssd_operand_parts_chosen():
    """Why the kernel cuts its fp32 operands into two TF32 parts: one bf16
    part puts y many ulps from the plain version, and two bf16 parts (a
    residual of 2^-16) still put some element of y past one ulp at the main
    widths, where two TF32 parts (2^-22) do not."""
    worst = {}
    for parts, kind in [(1, "bf16"), (2, "bf16"), (2, "tf32")]:
        worst[parts, kind] = 0.0
        for seed in range(4):
            xh, ll, Bm, Cm = torch_of(ssd_inputs(seed, 2, 512, 8, 64, 64), "bfloat16")
            h0 = torch.from_numpy(rand(np.random.default_rng(seed), (2, 8, 64, 64)))
            yp, _ = ssd_scan_plain(xh, ll, Bm, Cm, chunk=128, h0=h0)
            y, _ = ssd_emulated(xh, ll, Bm, Cm, chunk=128, h0=h0, parts=parts, kind=kind)
            worst[parts, kind] = max(worst[parts, kind], bf16_excess(y, yp))
    assert worst[1, "bf16"] > 10.0
    assert worst[2, "bf16"] > 1.0
    assert worst[2, "tf32"] <= 1.0


# ---------------------------------------------------------------------------
# RWKV-6 scan: the reference's TestRWKV6Scan restated, and what the port adds
# ---------------------------------------------------------------------------


def rwkv_inputs(seed, B, S, H, N, w=None, u_scale=0.3):
    """As tests/test_kernels.py draws them: r, k, v of scale 0.5, the decay
    w = 0.98 sigmoid(randn) + 0.01 unless given, the bonus u of scale 0.3."""
    rng = np.random.default_rng(seed)
    r, k, v = (rand(rng, (B, S, H, N)) for _ in range(3))
    if w is None:
        w = (0.98 / (1 + np.exp(-rng.standard_normal((B, S, H, N)))) + 0.01).astype(np.float32)
    else:
        w = np.full((B, S, H, N), w, np.float32)
    return r, k, v, w, rand(rng, (H, N), u_scale)


def rwkv_torch(arrays, dtype="float32"):
    """r, k, v and u in ``dtype``; w stays float32, as the model hands it over."""
    r, k, v, w, u = (torch.from_numpy(a) for a in arrays)
    return r.to(TDT[dtype]), k.to(TDT[dtype]), v.to(TDT[dtype]), w, u.to(TDT[dtype])


def rwkv_jax(arrays, dtype="float32"):
    r, k, v, w, u = (jnp.asarray(a) for a in arrays)
    return r.astype(JDT[dtype]), k.astype(JDT[dtype]), v.astype(JDT[dtype]), w, u.astype(JDT[dtype])


class TestRWKV6Scan:
    @pytest.mark.parametrize("B,S,H,N,chunk", [
        (1, 64, 1, 16, 32),
        (2, 128, 2, 32, 32),
        (1, 256, 4, 64, 128),
    ])
    def test_matches_recurrence(self, B, S, H, N, chunk):
        """the plain version against the reference's token recurrence and its
        Pallas kernel (interpret mode), 5e-5 on y and the state, on the
        reference test's own inputs (tests/test_kernels.py draws them from
        jax.random key 42): at (1, 256, 4, 64) the fp32 chunked form lies
        ~4e-5 from the recurrence, the reference's kernel too, so the limit is
        held on the data the reference holds its kernel to"""
        ks = jax.random.split(jax.random.PRNGKey(42), 5)
        draws = [jax.random.normal(ks[i], (B, S, H, N), jnp.float32) * 0.5 for i in range(3)]
        w = jax.nn.sigmoid(jax.random.normal(ks[3], (B, S, H, N))) * 0.98 + 0.01
        j = (*draws, w, jax.random.normal(ks[4], (H, N), jnp.float32) * 0.3)
        args = [torch.from_numpy(np.array(a)) for a in j]
        y, s = rwkv6_scan_plain(*args, chunk=chunk)
        assert y.shape == (B, S, H, N) and y.dtype == torch.float32
        assert s.shape == (B, H, N, N) and s.dtype == torch.float32
        yp, sp = ref_ops.rwkv6_scan(*j, chunk=chunk, tile=16)          # Pallas, interpret
        yr, sr = ref_ref.rwkv6_scan_ref(*j)
        for port, ref_ in ((y, yp), (s, sp), (y, yr), (s, sr)):
            assert max_err(port, ref_) <= 5e-5
        yo, so = ref.rwkv6_scan_ref(*args)                              # the port's own oracle
        assert max_err(y, yo) <= 5e-5 and max_err(s, so) <= 5e-5
        yw, sw = ops.rwkv6_scan(*args, chunk=chunk)                     # the wrapper, on the CPU
        assert torch.equal(yw, y) and torch.equal(sw, s)

    @pytest.mark.parametrize("chunk", [64, 128])
    def test_extreme_decay_stable(self, chunk):
        """w = 1e-6: the decays that overflow exp(-cum) in the factored form;
        finite, and within the reference test's 5e-4 of the recurrence"""
        arrays = rwkv_inputs(61, 1, 128, 1, 16, w=1e-6, u_scale=0.5)
        y, s = rwkv6_scan(*rwkv_torch(arrays), chunk=chunk)
        assert torch.isfinite(y).all() and torch.isfinite(s).all()
        yr, sr = ref_ref.rwkv6_scan_ref(*rwkv_jax(arrays))
        assert max_err(y, yr) <= 5e-4 and max_err(s, sr) <= 5e-4

    @pytest.mark.parametrize("S", [1, 77, 200])
    @pytest.mark.parametrize("with_s0", [False, True])
    def test_ragged_and_initial_state(self, S, with_s0):
        """any S (a partial last chunk) and an initial state, where the
        reference's kernel asserts whole chunks and takes none: against the
        reference's token-level recurrence, which takes both"""
        B, H, N = 2, 3, 16
        arrays = rwkv_inputs(62 + S, B, S, H, N)
        s0 = rand(np.random.default_rng(S), (B, H, N, N)) if with_s0 else None
        y, s = rwkv6_scan(*rwkv_torch(arrays), chunk=64,
                          s0=None if s0 is None else torch.from_numpy(s0))
        yr, sr = ref_ref.rwkv6_scan_ref(*rwkv_jax(arrays), s0=None if s0 is None else jnp.asarray(s0))
        assert max_err(y, yr) <= 5e-5 and max_err(s, sr) <= 5e-5

    @pytest.mark.parametrize("S,with_s0", [(128, False), (77, True)])
    def test_oracle_matches_reference_oracle(self, S, with_s0):
        arrays = rwkv_inputs(63, 2, S, 2, 32)
        s0 = rand(np.random.default_rng(2), (2, 2, 32, 32)) if with_s0 else None
        yo, so = ref.rwkv6_scan_ref(*rwkv_torch(arrays), s0=None if s0 is None else torch.from_numpy(s0))
        yr, sr = ref_ref.rwkv6_scan_ref(*rwkv_jax(arrays), s0=None if s0 is None else jnp.asarray(s0))
        assert max_err(yo, yr) <= 5e-5 and max_err(so, sr) <= 5e-5

    def test_partial_chunk_is_zero_padding(self):
        """a partial last chunk computes what a chunk padded with r = k = v = 0
        and w = 1 rows computes"""
        r, k, v, w, u = rwkv_torch(rwkv_inputs(64, 2, 100, 2, 16))
        y, s = rwkv6_scan_plain(r, k, v, w, u, chunk=64)
        pad = [torch.cat([t, torch.full((2, 28, 2, 16), fill)], dim=1)
               for t, fill in ((r, 0.0), (k, 0.0), (v, 0.0), (w, 1.0))]
        yp, sp = rwkv6_scan_plain(*pad, u, chunk=64)
        assert max_err(y, yp[:, :100]) <= 1e-6 and max_err(s, sp) <= 1e-6

    def test_bfloat16(self):
        """r, k, v and u in bf16 (w float32, as the model's): y within one
        bf16 ulp of the Pallas kernel's, which also works in fp32 inside, plus
        5e-5 (the fp32 tolerance: outputs reach 12 here, and an element near
        zero carries the fp32 sums' whole difference); the state within 5e-5"""
        arrays = rwkv_inputs(65, 2, 256, 4, 32)
        y, s = rwkv6_scan(*rwkv_torch(arrays, "bfloat16"), chunk=128)
        assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
        yp, sp = ref_ops.rwkv6_scan(*rwkv_jax(arrays, "bfloat16"), chunk=128, tile=16)
        assert bf16_excess(y, yp, 5e-5) <= 1.0 and max_err(s, sp) <= 5e-5
        yo, so = ref.rwkv6_scan_ref(*rwkv_torch(arrays, "bfloat16"))
        assert bf16_excess(y, yo, 5e-5) <= 1.0 and max_err(s, so) <= 5e-5

    def test_plain_version_is_the_wrapper_on_cpu(self):
        reset_launch_counts()
        args = rwkv_torch(rwkv_inputs(66, 1, 40, 2, 16))
        y, s = rwkv6_scan(*args, chunk=16)
        yp, sp = rwkv6_scan_plain(*args, chunk=16)
        assert torch.equal(y, yp) and torch.equal(s, sp)
        assert launch_counts() == {"flash_attention": 0, "moe_dispatch": 0, "ssd_scan": 0, "rwkv6_scan": 0,
                               "ccu_reduce": 0, "flash_attention.bwd": 0}

    def test_strided_inputs(self):
        """r, k, v as the model hands them over: (B, S, H, N) views of
        slices of one wider tensor"""
        r, k, v, w, u = rwkv_torch(rwkv_inputs(67, 2, 64, 2, 16))
        wide = torch.cat([r, k, v], dim=-1)                    # (B, S, H, 3N)
        y, s = ops.rwkv6_scan(wide[..., :16], wide[..., 16:32], wide[..., 32:], w, u, chunk=32)
        y0, s0 = ops.rwkv6_scan(r, k, v, w, u, chunk=32)
        assert torch.equal(y, y0) and torch.equal(s, s0)

    @pytest.mark.parametrize("bad", ["rank", "seq", "bonus", "dtype", "mixed", "w_dtype",
                                     "chunk", "width", "s0", "empty", "device"])
    def test_wrapper_raises(self, bad):
        r = k = v = w = torch.zeros(2, 8, 4, 16)
        u, s0 = torch.zeros(4, 16), None
        if bad == "rank":
            r = r[0]
        elif bad == "seq":
            k = torch.zeros(2, 9, 4, 16)
        elif bad == "bonus":
            u = torch.zeros(3, 16)
        elif bad == "dtype":
            r, k, v = r.half(), k.half(), v.half()
        elif bad == "mixed":
            k = k.bfloat16()
        elif bad == "w_dtype":
            w = w.double()
        elif bad == "chunk":
            pass                               # chunk=256 below: more rows than the kernel holds
        elif bad == "width":
            r = k = v = w = torch.zeros(2, 8, 4, 18)
            u = torch.zeros(4, 18)
        elif bad == "s0":
            s0 = torch.zeros(2, 4, 16, 15)
        elif bad == "empty":
            r = k = v = w = torch.zeros(2, 0, 4, 16)
        elif bad == "device":
            r, k, v, w, u = (torch.empty(t.shape, device="meta") for t in (r, k, v, w, u))
        with pytest.raises(ValueError):
            ops.rwkv6_scan(r, k, v, w, u, chunk=256 if bad == "chunk" else 8, s0=s0)


# ---------------------------------------------------------------------------
# RWKV-6 scan: the bf16 kernel's arithmetic on the CPU (decays factored at
# 16-row tile edges, the direct form on the diagonal tiles, tensor-core
# products with every fp32 operand in two TF32 parts), held against the JAX
# reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,H,N,chunk", [
    (1, 64, 1, 16, 32),
    (2, 128, 2, 32, 32),
    (1, 256, 4, 64, 128),
])
def test_rwkv_tensor_core_arithmetic_matches_reference(B, S, H, N, chunk):
    """At the reference test's shapes, bf16 r, k, v, u: y within one bf16 ulp
    of each element (plus 5e-5) of the reference's Pallas kernel (interpret
    mode) and of its token-level recurrence, the state within 5e-5 of both."""
    arrays = rwkv_inputs(80, B, S, H, N)
    y, s = rwkv_emulated(*rwkv_torch(arrays, "bfloat16"), chunk=chunk)
    j = rwkv_jax(arrays, "bfloat16")
    yp, sp = ref_ops.rwkv6_scan(*j, chunk=chunk, tile=16)
    yr, sr = ref_ref.rwkv6_scan_ref(*j)
    assert bf16_excess(y, yp, 5e-5) <= 1.0 and max_err(s, sp) <= 5e-5
    assert bf16_excess(y, yr, 5e-5) <= 1.0 and max_err(s, sr) <= 5e-5


@pytest.mark.parametrize("chunk", [64, 128])
def test_rwkv_tensor_core_arithmetic_extreme_decay(chunk):
    """w = 1e-6: 16 rows of decay reach -319 in base 2, where one factor
    2^(-cum_j) would overflow; every factor of the off-diagonal tiles is <= 1,
    so the result is finite, and within the reference test's 5e-4 of its
    recurrence (y: one bf16 ulp plus that)."""
    arrays = rwkv_inputs(81, 1, 128, 1, 16, w=1e-6, u_scale=0.5)
    y, s = rwkv_emulated(*rwkv_torch(arrays, "bfloat16"), chunk=chunk)
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    yr, sr = ref_ref.rwkv6_scan_ref(*rwkv_jax(arrays, "bfloat16"))
    assert bf16_excess(y, yr, 5e-4) <= 1.0 and max_err(s, sr) <= 5e-4


@pytest.mark.parametrize("N", [16, 32, 48, 64])
@pytest.mark.parametrize("S", [1, 77, 200])
def test_rwkv_tensor_core_arithmetic_ragged_with_s0(S, N):
    """A ragged last chunk staged as zero rows (a partial 16-row tile, or fewer
    than 16 rows), an initial state, N of 16 to 64: against the reference's
    recurrence, which takes both."""
    B, H = 2, 3
    arrays = rwkv_inputs(82 + S + N, B, S, H, N)
    s0 = rand(np.random.default_rng(S + N), (B, H, N, N))
    y, s = rwkv_emulated(*rwkv_torch(arrays, "bfloat16"), chunk=64, s0=torch.from_numpy(s0))
    yr, sr = ref_ref.rwkv6_scan_ref(*rwkv_jax(arrays, "bfloat16"), s0=jnp.asarray(s0))
    assert bf16_excess(y, yr, 5e-5) <= 1.0 and max_err(s, sr) <= 5e-5


def rwkv_main_widths(seed, H=4):
    """rwkv6-1.6b's widths (head_dim 64, chunk 128, 512 rows), bf16, with s0"""
    r, k, v, w, u = rwkv_torch(rwkv_inputs(seed, 2, 512, H, 64), "bfloat16")
    return r, k, v, w, u, torch.from_numpy(rand(np.random.default_rng(seed), (2, H, 64, 64)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rwkv_tensor_core_arithmetic_at_main_widths(seed):
    """y within one bf16 ulp of each element (plus 5e-5) of the plain version,
    the state within 5e-5, as the kernel is held on the card."""
    r, k, v, w, u, s0 = rwkv_main_widths(seed)
    yp, sp = rwkv6_scan_plain(r, k, v, w, u, chunk=128, s0=s0)
    y, s = rwkv_emulated(r, k, v, w, u, chunk=128, s0=s0)
    assert bf16_excess(y, yp, 5e-5) <= 1.0 and max_err(s, sp) <= 5e-5


def test_rwkv_operand_parts_chosen():
    """Why the kernel cuts each fp32 operand into two TF32 parts and keeps
    three products where both operands are fp32: dropping small x big as well
    puts y many one-ulp limits from the plain version, one TF32 part more still;
    two bf16 parts pass the one-ulp check but, before y is rounded, lie as far
    from the float64 recurrence as half the 5e-5 the check allows, where two
    TF32 parts lie within a fifth of it."""
    worst = {}
    for parts, kind, terms in [(2, "tf32", 3), (2, "tf32", 2), (1, "tf32", 1)]:
        worst[parts, kind, terms] = 0.0
        for seed in range(2):
            r, k, v, w, u, s0 = rwkv_main_widths(seed)
            yp, _ = rwkv6_scan_plain(r, k, v, w, u, chunk=128, s0=s0)
            y, _ = rwkv_emulated(r, k, v, w, u, chunk=128, s0=s0, parts=parts, kind=kind, terms=terms)
            worst[parts, kind, terms] = max(worst[parts, kind, terms], bf16_excess(y, yp, 5e-5))
    assert worst[2, "tf32", 3] <= 1.0
    assert worst[2, "tf32", 2] > 5.0
    assert worst[1, "tf32", 1] > 10.0
    # the same arithmetic on bf16-valued fp32 inputs, y left unrounded
    r, k, v, w, u, s0 = (t.float() for t in rwkv_main_widths(4))
    yo, _ = ref.rwkv6_scan_ref(*(t.double() for t in (r, k, v, w, u)), s0=s0.double())
    unrounded = {kind: max_err(rwkv_emulated(r, k, v, w, u, chunk=128, s0=s0, kind=kind)[0], yo)
                 for kind in ("tf32", "bf16")}
    assert unrounded["tf32"] <= 1e-5 < 2.5e-5 < unrounded["bf16"]


@pytest.mark.parametrize("w", [None, 1e-6])
def test_rwkv_emulated_exponents_are_non_positive(w):
    """Every exponent the kernel's arithmetic feeds to ex2 is <= 0: the row
    scales, the decays between tile edges, and on the diagonal tiles the
    direct form, masked to j < i before the exponential."""
    seen = []
    arrays = rwkv_inputs(83, 2, 200, 2, 32, w=w)
    y, s = rwkv_emulated(*rwkv_torch(arrays, "bfloat16"), chunk=128, seen=seen)
    assert seen and max(seen) <= 0.0
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()


# ---------------------------------------------------------------------------
# MoE dispatch: the reference's TestMoEDispatch restated, and what the port adds
# ---------------------------------------------------------------------------


def one_hot_disp(rng, T, E, C):
    """Random routing as tests/test_kernels.py draws it: each token to one
    expert, in arrival order, overflow beyond C dropped."""
    idx = rng.integers(0, E, T)
    disp = np.zeros((T, E, C), np.float32)
    cnt = np.zeros(E, int)
    for t in range(T):
        e = idx[t]
        if cnt[e] < C:
            disp[t, e, cnt[e]] = 1.0
            cnt[e] += 1
    return disp


class TestMoEDispatch:
    @given(st.integers(1, 4), st.integers(16, 64))
    @settings(max_examples=8, deadline=None)
    def test_property_random_routing(self, e_pow, c):
        E = 2 ** e_pow
        T, D = 128, 32
        rng = np.random.default_rng(E * 100 + c)
        disp = one_hot_disp(rng, T, E, c)
        x = rand(rng, (T, D))
        out = ops.moe_dispatch(torch.from_numpy(disp), torch.from_numpy(x))
        assert out.shape == (E, c, D) and out.dtype == torch.float32
        expect = np.einsum("tec,td->ecd", disp, x)
        np.testing.assert_allclose(out.numpy(), expect, atol=1e-5)
        pallas = ref_ops.moe_dispatch(jnp.asarray(disp), jnp.asarray(x), block_t=64)
        np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=1e-5)
        np.testing.assert_allclose(
            out.numpy(), ref.moe_dispatch_ref(torch.from_numpy(disp), torch.from_numpy(x)).numpy(),
            atol=1e-5)

    @pytest.mark.parametrize("T", [1, 77, 200])
    def test_ragged_tokens(self, T):
        """any T, where the reference asserts whole token blocks"""
        rng = np.random.default_rng(T)
        disp, x = one_hot_disp(rng, T, 8, 16), rand(rng, (T, 32))
        out = moe_dispatch(torch.from_numpy(disp), torch.from_numpy(x))
        np.testing.assert_allclose(out.numpy(), np.einsum("tec,td->ecd", disp, x), atol=1e-5)
        assert torch.equal(out, ref.moe_dispatch_ref(torch.from_numpy(disp), torch.from_numpy(x)))

    def test_batched_form_is_each_row(self):
        """disp (B,T,E,C), x (B,T,D) -> (E,B,C,D): row b is the 3-D form on
        row b's tokens"""
        rng = np.random.default_rng(5)
        B, T, E, C, D = 3, 40, 4, 12, 32
        disp = torch.from_numpy(np.stack([one_hot_disp(rng, T, E, C) for _ in range(B)]))
        x = torch.from_numpy(rand(rng, (B, T, D)))
        out = ops.moe_dispatch(disp, x)
        assert out.shape == (E, B, C, D)
        for b in range(B):
            assert torch.equal(out[:, b], ops.moe_dispatch(disp[b], x[b]))
        assert torch.equal(out, torch.einsum("bsec,bsd->ebcd", disp, x))   # the model's einsum
        assert torch.equal(out, ref.moe_dispatch_ref(disp, x))

    def test_dense_weights(self):
        """the general contract, not only one-hot: every weight counts"""
        rng = np.random.default_rng(6)
        T, E, C, D = 96, 4, 16, 32
        disp = torch.from_numpy(rand(rng, (2, T, E, C), scale=1 / np.sqrt(T)))
        x = torch.from_numpy(rand(rng, (2, T, D), scale=1.0))
        out = moe_dispatch(disp, x)
        assert max_err(out, ref.moe_dispatch_ref(disp, x)) <= 1e-5
        assert max_err(out[:, 0], ref_ops.moe_dispatch(jnp.asarray(disp[0].numpy()),
                                                        jnp.asarray(x[0].numpy()), block_t=32)) <= 1e-5

    def test_bfloat16_one_hot_is_exact(self):
        rng = np.random.default_rng(7)
        disp = one_hot_disp(rng, 64, 4, 20)
        (jd, td), (jx, tx) = both(disp, "bfloat16"), both(rand(rng, (64, 32)), "bfloat16")
        out = moe_dispatch(td, tx)
        assert out.dtype == torch.bfloat16
        assert torch.equal(out, ref.moe_dispatch_ref(td, tx))          # one term times 1.0
        np.testing.assert_array_equal(
            out.float().numpy(), np.asarray(ref_ops.moe_dispatch(jd, jx, block_t=64), np.float32))

    def test_gather_matmul_matches_reference(self):
        rng = np.random.default_rng(8)
        T, E, C, D, F = 64, 4, 20, 32, 48
        disp, x, w = one_hot_disp(rng, T, E, C), rand(rng, (T, D)), rand(rng, (E, D, F))
        out = moe_gather_matmul(*(torch.from_numpy(a) for a in (disp, x, w)))
        assert out.shape == (E, C, F)
        j = [jnp.asarray(a) for a in (disp, x, w)]
        assert max_err(out, ref_ref.moe_gather_matmul_ref(*j)) <= 1e-5
        assert max_err(out, ref_moe.moe_gather_matmul(*j)) <= 1e-5           # Pallas, interpret
        assert max_err(out, ref.moe_gather_matmul_ref(*(torch.from_numpy(a) for a in (disp, x, w)))) <= 1e-5

    def test_plain_version_is_the_wrapper_on_cpu(self):
        reset_launch_counts()
        rng = np.random.default_rng(9)
        disp, x = torch.from_numpy(one_hot_disp(rng, 16, 2, 8)), torch.from_numpy(rand(rng, (16, 32)))
        assert torch.equal(moe_dispatch(disp, x), moe_dispatch_plain(disp, x))
        assert launch_counts() == {"flash_attention": 0, "moe_dispatch": 0, "ssd_scan": 0, "rwkv6_scan": 0,
                               "ccu_reduce": 0, "flash_attention.bwd": 0}

    @pytest.mark.parametrize("bad", ["rank", "tokens", "batch", "dtype", "mixed", "empty", "device"])
    def test_wrapper_raises(self, bad):
        disp, x = torch.zeros(2, 8, 4, 3), torch.zeros(2, 8, 16)
        if bad == "rank":
            x = x[0]
        elif bad == "tokens":
            x = torch.zeros(2, 9, 16)
        elif bad == "batch":
            x = torch.zeros(3, 8, 16)
        elif bad == "dtype":
            disp, x = disp.half(), x.half()
        elif bad == "mixed":
            x = x.bfloat16()
        elif bad == "empty":
            disp, x = torch.zeros(2, 8, 4, 0), torch.zeros(2, 8, 16)
        elif bad == "device":
            disp, x = torch.empty(disp.shape, device="meta"), torch.empty(x.shape, device="meta")
        with pytest.raises(ValueError):
            ops.moe_dispatch(disp, x)


# ---------------------------------------------------------------------------
# MoE dispatch: the kernel's compacted arithmetic on the CPU (ascending lists
# of nonzero weights, token ranges when a list outgrows its buffer)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,buffer", [(128, 256), (200, 16), (77, 8)])
def test_compacted_dispatch_one_hot_is_bit_equal(T, buffer, dtype):
    """One-hot weights, slots left empty (C above what the tokens fill), lists
    within and beyond the buffer: bit-equal to the plain version"""
    rng = np.random.default_rng(T)
    B, E, C, D = 2, 4, 48, 32
    disp = torch.from_numpy(np.stack([one_hot_disp(rng, T, E, C) for _ in range(B)])).to(TDT[dtype])
    x = torch.from_numpy(rand(rng, (B, T, D), scale=1.0)).to(TDT[dtype])
    out = moe_compacted(disp, x, buffer=buffer)
    assert (disp.sum(1) == 0).any()                       # empty slots
    assert torch.equal(out, moe_dispatch_plain(disp, x))


@pytest.mark.parametrize("buffer", [256, 16])
def test_compacted_dispatch_dense(buffer):
    """Dense weights of size 1/sqrt(T), every slot holding T = 100 nonzeros:
    in one list, or in token ranges of 16: fp32 within 2e-5 of the plain
    version, bf16 within one bf16 ulp of each element plus 1e-5"""
    rng = np.random.default_rng(buffer)
    B, T, E, C, D = 2, 100, 2, 4, 32
    disp = torch.from_numpy(rand(rng, (B, T, E, C), scale=1 / np.sqrt(T)))
    x = torch.from_numpy(rand(rng, (B, T, D), scale=1.0))
    assert max_err(moe_compacted(disp, x, buffer=buffer), moe_dispatch_plain(disp, x)) <= 2e-5
    db, xb = disp.bfloat16(), x.bfloat16()
    assert bf16_excess(moe_compacted(db, xb, buffer=buffer), moe_dispatch_plain(db, xb)) <= 1.0


# ---------------------------------------------------------------------------
# CCU reduce: the reference's TestCCUReduce restated, and what the port adds
# ---------------------------------------------------------------------------


class TestCCUReduce:
    @pytest.mark.parametrize("P,N,block", [(2, 512, 512), (8, 2048, 512), (16, 1024, 256)])
    def test_matches_sum(self, P, N, block):
        """The reference test's shapes: against the reference's oracle at its
        1e-5, and bit-equal to the reference's Pallas kernel (interpret mode),
        which adds the same fp32 values in the same order."""
        bufs = rand(np.random.default_rng(P), (P, N))
        out = ops.ccu_reduce(torch.from_numpy(bufs))
        assert out.dtype == torch.float32 and out.shape == (N,)
        assert max_err(out, ref_ref.ccu_reduce_ref(jnp.asarray(bufs))) <= 1e-5
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref_ops.ccu_reduce(jnp.asarray(bufs), block_n=block)))
        assert max_err(out, ref.ccu_reduce_ref(torch.from_numpy(bufs))) <= 1e-5

    def test_int8_dequant_ingestion(self):
        """compressed-gradient ingestion: int8 peers + per-peer scales, as the
        reference's test draws them, at its tolerance against the sum and
        against its Pallas kernel.  Not bit-equal to that kernel: on the CPU
        the reference's compiler fuses ``x * scale`` and ``acc + x`` into one
        multiply-add (it equals a once-rounded sum on every element), where
        the reference's source, the port's plain version and its kernel round
        each; the port is bit-equal to that two-rounding sum."""
        rng = np.random.default_rng(0)
        P, N = 4, 1024
        q = rng.integers(-127, 128, (P, N), dtype=np.int8)
        scales = rng.uniform(0.5, 2.0, P).astype(np.float32)
        out = ops.ccu_reduce(torch.from_numpy(q), torch.from_numpy(scales))
        expect = (q.astype(np.float32) * scales[:, None]).sum(0)
        np.testing.assert_allclose(out.numpy(), expect, rtol=1e-5, atol=1e-3)
        pallas = np.asarray(ref_ops.ccu_reduce(jnp.asarray(q), jnp.asarray(scales), block_n=512))
        np.testing.assert_allclose(out.numpy(), pallas, rtol=1e-5, atol=1e-3)
        two_roundings = np.zeros(N, np.float32)
        for p in range(P):
            two_roundings = two_roundings + q[p].astype(np.float32) * scales[p]
        np.testing.assert_array_equal(out.numpy(), two_roundings)
        assert max_err(out, ref.ccu_reduce_ref(torch.from_numpy(q), torch.from_numpy(scales))) <= 1e-3

    def test_deterministic_order(self):
        """same peers, same order => bitwise identical (CCU determinism)"""
        bufs = torch.from_numpy(rand(np.random.default_rng(8), (8, 1024)))
        assert torch.equal(ops.ccu_reduce(bufs), ops.ccu_reduce(bufs))

    def test_order_is_p0_first(self):
        """The order is the contract: 1 + 2^-24 + 2^-24 in fp32 is 1 from peer 0
        on, but 1 + 2^-23 in the other order."""
        bufs = torch.tensor([[1.0], [2.0 ** -24], [2.0 ** -24]])
        assert ccu_reduce_plain(bufs).item() == 1.0
        assert ccu_reduce_plain(bufs.flip(0)).item() == 1.0 + 2.0 ** -23

    @pytest.mark.parametrize("N", [1, 15, 17, 1000, 4099])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int8"])
    def test_any_n_and_dtype(self, N, dtype):
        """Ragged N (the reference asserts whole blocks), every input type,
        with and without scales, against the float64 oracle: within the
        bound of P fp32 roundings, 1e-6 of the terms' absolute sum."""
        rng = np.random.default_rng(N)
        P = 3
        if dtype == "int8":
            bufs = torch.from_numpy(rng.integers(-127, 128, (P, N), dtype=np.int8))
        else:
            bufs = torch.from_numpy(rand(rng, (P, N), 2.0)).to(getattr(torch, dtype))
        scales = torch.from_numpy(rng.uniform(0.5, 2.0, P).astype(np.float32))
        for s in (None, scales):
            out = ops.ccu_reduce(bufs, s)
            assert out.dtype == torch.float32 and out.shape == (N,)
            r = ref.ccu_reduce_ref(bufs, s)
            size = ref.ccu_reduce_ref(bufs.abs(), None if s is None else s.abs())
            assert ((out - r).abs() <= 1e-6 * size + 1e-6).all()

    def test_ragged_n_matches_the_reference_oracle(self):
        bufs = rand(np.random.default_rng(11), (5, 777))
        out = ops.ccu_reduce(torch.from_numpy(bufs))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref_ref.ccu_reduce_ref(jnp.asarray(bufs))))

    def test_strided_rows(self):
        """A view of every other row of a larger buffer, and a column slice."""
        big = torch.from_numpy(rand(np.random.default_rng(12), (8, 300)))
        for view in (big[::2], big[:, 10:250]):
            assert torch.equal(ops.ccu_reduce(view), ccu_reduce_plain(view.contiguous()))

    def test_plain_version_is_the_wrapper_on_cpu(self):
        reset_launch_counts()
        bufs = torch.from_numpy(rand(np.random.default_rng(13), (4, 64)))
        assert torch.equal(ccu_reduce(bufs), ccu_reduce_plain(bufs))
        assert launch_counts()["ccu_reduce"] == 0

    @pytest.mark.parametrize("bad", ["rank", "empty", "dtype", "scales", "scale_device", "device"])
    def test_wrapper_raises(self, bad):
        bufs, scales = torch.zeros(3, 16), None
        if bad == "rank":
            bufs = torch.zeros(16)
        elif bad == "empty":
            bufs = torch.zeros(0, 16)
        elif bad == "dtype":
            bufs = torch.zeros(3, 16, dtype=torch.float64)
        elif bad == "scales":
            scales = torch.ones(4)
        elif bad == "scale_device":
            scales = torch.empty(3, device="meta")
        elif bad == "device":
            bufs = torch.empty(3, 16, device="meta")
        with pytest.raises(ValueError):
            ops.ccu_reduce(bufs, scales)
