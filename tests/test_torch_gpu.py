"""Tests of the port that need an NVIDIA GPU and nvcc: the CUDA kernels
themselves.  They skip on a machine without a card; run them on one with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports only torch and the port, so it runs where JAX is absent.
``chip_smoke.py`` makes the same comparison over more shapes."""

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel cannot run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False     # full-fp32 plain version
    return torch.device("cuda")


def _peaked_qkv(cuda, G, Sq, Sk, D, dtype, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(
        (torch.randn(s, generator=gen, device=cuda) * scale).to(dtype)
        for s, scale in [((2, 2, G, Sq, D), 2.0), ((2, 2, Sk, D), 1.5), ((2, 2, Sk, D), 1.0)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Sq,Sk,q_start,window,prefix_len", [
    (3, 256, 256, 0, None, 0), (3, 100, 100, 0, 32, 16), (3, 77, 203, 126, None, 0), (3, 1, 200, 199, None, 0),
    # folded rows (462) a multiple of neither 16 nor 64
    (6, 77, 77, 0, None, 0), (6, 77, 203, 126, 40, 0),
    # key counts about one tile, and a long cache with a wide and a narrow window
    (3, 1, 1, 0, None, 0), (3, 63, 63, 0, None, 0), (3, 64, 64, 0, None, 0), (3, 65, 65, 0, None, 0),
    (3, 1, 63, 62, None, 0), (3, 1, 65, 64, None, 0),
    (3, 4096, 4096, 0, 4096, 0), (3, 4096, 4096, 0, 16, 0),
    (3, 1, 4096, 4095, 4096, 0), (3, 1, 4096, 4095, 16, 0),
    # a prefix that crosses a key tile (prefill) and a key split (decode)
    (3, 200, 200, 0, 32, 100), (3, 1, 300, 299, 16, 100), (3, 5, 300, 295, 16, 100),
    # decode at 1, 2, 4, 16 and 64 key splits
    (3, 1, 64, 63, None, 0), (3, 1, 128, 127, None, 0), (3, 1, 256, 255, None, 0),
    (3, 1, 1000, 999, None, 0), (3, 1, 4096, 4095, None, 0),
])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_flash_attention_kernel_matches_plain(cuda, D, G, Sq, Sk, q_start, window, prefix_len, dtype):
    """Scores of standard deviation 3 and values of standard deviation 1: each
    row rests on a few keys chosen by q, and the outputs are of order 1.
    float32 within 2e-5 (sums in another order); bfloat16 within one bf16 ulp
    of each element (2^-7 |r|: both round the same fp32 result once) plus 1e-5.
    Folded rows G * Sq <= 16 take the decode kernels (keys split across
    blocks), more take the tensor-core kernel (bf16) or the fp32 one."""
    _assert_flash_matches_plain(cuda, D, G, Sq, Sk, q_start, window, prefix_len, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Sq,Sk,q_start,window,prefix_len", [
    (4, 256, 256, 0, None, 0), (4, 4096, 4096, 0, None, 0), (6, 77, 203, 126, 40, 0), (4, 200, 200, 0, 32, 100),
])
def test_flash_attention_kernel_at_a_softmax_scale(cuda, G, Sq, Sk, q_start, window, prefix_len, dtype):
    """granite-4.0-h's NoPE attention scales its scores by 1/128 at head_dim
    128, not by 1/sqrt(128): the kernels at that ``sm_scale``, causal, with
    G = 4 as the model has and at its training length, at the limits above."""
    _assert_flash_matches_plain(cuda, 128, G, Sq, Sk, q_start, window, prefix_len, dtype, sm_scale=2.0 ** -7)


def _assert_flash_matches_plain(cuda, D, G, Sq, Sk, q_start, window, prefix_len, dtype, sm_scale=None):
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    q, k, v = _peaked_qkv(cuda, G, Sq, Sk, D, dtype)
    kw = dict(causal=True, window=window, prefix_len=prefix_len, q_start=q_start, sm_scale=sm_scale)
    before = flash_attention.launches
    o = flash_attention(q, k, v, **kw).float()
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    r = flash_attention_plain(q, k, v, **kw).float()
    limit = torch.full_like(r, 2e-5) if dtype == torch.float32 else 2.0 ** -7 * r.abs() + 1e-5
    assert ((o - r).abs() <= limit).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Sq,Sk", [
    # whisper-base's cross-attention: a prompt over the encoder's frames, and
    # a decode step over them; its encoder: every frame sees every frame
    (1, 64, 1536), (1, 1, 1536), (1, 1536, 1536),
    # ragged both ways, more queries than keys, folded rows about 16 and 64
    (3, 77, 203), (3, 203, 77), (8, 2, 300), (8, 8, 65), (2, 33, 1),
])
@pytest.mark.parametrize("D", [64, 256])
def test_flash_attention_non_causal_kernel_matches_plain(cuda, D, G, Sq, Sk, dtype):
    """No mask (cross-attention, a bidirectional encoder) with Sq != Sk, at
    q_start 0 as ``layers.attention`` calls it; limits as above."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    q, k, v = _peaked_qkv(cuda, G, Sq, Sk, D, dtype, seed=4)
    o = flash_attention(q, k, v, causal=False).float()
    r = flash_attention_plain(q, k, v, causal=False).float()
    limit = torch.full_like(r, 2e-5) if dtype == torch.float32 else 2.0 ** -7 * r.abs() + 1e-5
    assert ((o - r).abs() <= limit).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sk,window", [(1000, None), (1000, 100), (527, None)])
@pytest.mark.parametrize("D", [128, 256])
def test_flash_decode_splits_of_many_tiles(cuda, D, Sk, window, dtype):
    """Many kv heads (B * K = 256) leave few key splits, each walking several
    64-key tiles through the decode kernel's two-stage ring (one stage in
    fp32 at D = 256); limits as above."""
    from repro_torch.kernels.flash_attention import decode_splits, flash_attention, flash_attention_plain

    assert (-(-Sk // 64)) > decode_splits(256, Sk, torch.cuda.get_device_properties(cuda).multi_processor_count)
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (
        (torch.randn(s, generator=gen, device=cuda) * scale).to(dtype)
        for s, scale in [((8, 32, 2, 1, D), 2.0), ((8, 32, Sk, D), 1.5), ((8, 32, Sk, D), 1.0)])
    kw = dict(causal=True, window=window, q_start=Sk - 1)
    o = flash_attention(q, k, v, **kw).float()
    r = flash_attention_plain(q, k, v, **kw).float()
    limit = torch.full_like(r, 2e-5) if dtype == torch.float32 else 2.0 ** -7 * r.abs() + 1e-5
    assert ((o - r).abs() <= limit).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Sq,Sk,q_start", [(4, 512, 512, 0), (4, 1, 520, 519), (4, 1, 4096, 4095)])
def test_flash_attention_kernel_is_deterministic(cuda, G, Sq, Sk, q_start, dtype):
    """Two calls on the same inputs give the same bits: the decode kernels
    combine their key splits in a fixed order, with no atomics."""
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = _peaked_qkv(cuda, G, Sq, Sk, 128, dtype, seed=2)
    kw = dict(causal=True, q_start=q_start)
    assert torch.equal(flash_attention(q, k, v, **kw), flash_attention(q, k, v, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk,with_h0", [
    (1, 128, 2, 16, 16, 64, False), (2, 256, 4, 32, 16, 128, False), (1, 256, 1, 64, 64, 32, False),
    (2, 200, 4, 64, 16, 128, True), (2, 1, 3, 32, 16, 128, True), (4, 512, 64, 64, 64, 128, False),
])
def test_ssd_scan_kernel_matches_plain(cuda, B, S, H, P, N, chunk, with_h0, dtype):
    """x, B, C of scale 0.5 and log_l = -softplus(randn), as the reference's
    test draws them.  y and h in float32 within 5e-5 (the reference test's
    tolerance); y in bfloat16 within one bf16 ulp of each element plus 1e-5
    (both are fp32 inside and round once); h of bf16 runs within 5e-5."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

    gen = torch.Generator(device=cuda).manual_seed(0)

    def draw(shape, scale=0.5):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    xh, Bm, Cm = (draw(s).to(dtype) for s in [(B, S, H, P), (B, S, N), (B, S, N)])
    log_l = -torch.nn.functional.softplus(draw((B, S, H), 1.0))
    h0 = draw((B, H, P, N)) if with_h0 else None
    before = ssd_scan.launches
    y, h = ssd_scan(xh, log_l, Bm, Cm, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    yr, hr = ssd_scan_plain(xh, log_l, Bm, Cm, chunk=chunk, h0=h0)
    y, yr = y.float(), yr.float()
    limit = torch.full_like(yr, 5e-5) if dtype == torch.float32 else 2.0 ** -7 * yr.abs() + 1e-5
    assert ((y - yr).abs() <= limit).all()
    assert ((h - hr).abs() <= 5e-5).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,E,C,D,dense", [
    (1, 128, 8, 16, 32, False), (4, 77, 8, 20, 128, False), (4, 1, 8, 1, 6144, False),
    (2, 200, 4, 24, 96, True),
])
def test_moe_dispatch_kernel_matches_plain(cuda, B, T, E, C, D, dense, dtype):
    """One-hot weights (the model's): bit-equal, one term times 1.0 and the
    zeros skipped.  Dense weights of size 1/sqrt(T), outputs of order 1:
    float32 within 2e-5 (sums in another order); bfloat16 within one bf16 ulp
    of each element plus 1e-5 (both round one fp32 sum once)."""
    from repro_torch.kernels.moe_dispatch import moe_dispatch, moe_dispatch_plain

    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((B, T, D), generator=gen, device=cuda).to(dtype)
    if dense:
        disp = (torch.randn((B, T, E, C), generator=gen, device=cuda) / T ** 0.5).to(dtype)
    else:
        # token t to expert t % E, slot t // E while there is room
        t = torch.arange(T, device=cuda)
        keep = t // E < C
        disp = torch.zeros((B, T, E, C), device=cuda, dtype=dtype)
        disp[:, t[keep], t[keep] % E, t[keep] // E] = 1
    before = moe_dispatch.launches
    o = moe_dispatch(disp, x)
    torch.cuda.synchronize()
    assert moe_dispatch.launches == before + 1
    r = moe_dispatch_plain(disp, x)
    if not dense:
        assert torch.equal(o, r)
        return
    o, r = o.float(), r.float()
    limit = torch.full_like(r, 2e-5) if dtype == torch.float32 else 2.0 ** -7 * r.abs() + 1e-5
    assert ((o - r).abs() <= limit).all()


@pytest.mark.parametrize("B,S,H,P,N,chunk,kind", [
    (2, 256, 7, 64, 64, 128, "randn"),      # H not a multiple of the head group (2): the last block one head
    (1, 128, 5, 48, 16, 64, "randn"),       # P = 48: the block's columns past P staged as zeros
    (2, 200, 3, 36, 20, 64, "h0"),          # P = 36, N = 20 (zero columns up to 64)
    (2, 1, 4, 64, 64, 128, "h0"),           # S = 1
    (2, 77, 4, 64, 64, 128, "randn"),       # one ragged chunk
    (1, 300, 4, 32, 64, 128, "h0"),         # two whole chunks and a ragged one
    (1, 256, 4, 16, 16, 128, "strong"),     # log_l = -13
    (2, 384, 8, 64, 64, 32, "h0"),          # many short chunks
    (4, 512, 64, 64, 64, 128, "conv"),      # zamba2's shape, B and C slices of the conv output
    (2, 256, 3, 64, 128, 128, "randn"),     # N = 128: one head a block
    (2, 200, 3, 36, 100, 64, "h0"),         # N = 100 (zero columns up to 128), ragged chunk
    (2, 1, 4, 64, 128, 128, "h0"),          # N = 128, S = 1
    (1, 256, 4, 16, 128, 128, "strong"),    # N = 128, log_l = -13
])
def test_ssd_scan_tensor_core_cases(cuda, B, S, H, P, N, chunk, kind):
    """The bf16 (tensor-core) kernel at its edges: y within one bf16 ulp of
    each element of the plain version plus 1e-5, h within 5e-5, outputs
    finite, and a second call on the same inputs giving the same bits."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

    gen = torch.Generator(device=cuda).manual_seed(S + H)

    def draw(shape, scale=0.5):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    xh = draw((B, S, H, P)).bfloat16()
    if kind == "conv":
        conv = draw((B, S, H * P + 2 * N)).bfloat16()
        Bm, Cm = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    else:
        Bm, Cm = draw((B, S, N)).bfloat16(), draw((B, S, N)).bfloat16()
    log_l = (torch.full((B, S, H), -13.0, device=cuda) if kind == "strong"
             else -torch.nn.functional.softplus(draw((B, S, H), 1.0)))
    h0 = draw((B, H, P, N)) if kind == "h0" else None
    before = ssd_scan.launches
    y, h = ssd_scan(xh, log_l, Bm, Cm, chunk=chunk, h0=h0)
    y2, h2 = ssd_scan(xh, log_l, Bm, Cm, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(h, h2)
    yr, hr = ssd_scan_plain(xh, log_l, Bm, Cm, chunk=chunk, h0=h0)
    y, yr = y.float(), yr.float()
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert ((y - yr).abs() <= 2.0 ** -7 * yr.abs() + 1e-5).all()
    assert ((h - hr).abs() <= 5e-5).all()


@pytest.mark.parametrize("seed", [32, 4224])
def test_ssd_scan_at_granite_hybrid_shape(cuda, seed):
    """At granite-4.0-h-small's training shape (xh (2, 4096, 128, 64), B/C
    (2, 4096, 128) slices of the conv output, chunk 128) the bf16 kernel's y
    lies within one bf16 ulp of each element plus 1e-5 of the float64
    recurrence's, rounded to bf16, and h within 5e-5: the limits the tests
    above hold it to against the plain version.  Against the plain version
    the absolute term is the fp32 limit, 5e-5, as ``chip_smoke.py``'s
    training row has it: at this shape the plain version's fp32 sums over
    128 columns of N lie up to 1.3 of the 1e-5 term from the oracle at
    elements near zero, where the kernel stays within it."""
    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

    B, S, H, P, N = 2, 4096, 128, 64, 128
    gen = torch.Generator(device=cuda).manual_seed(seed)
    xh = (torch.randn((B, S, H, P), generator=gen, device=cuda) * 0.5).bfloat16()
    conv = (torch.randn((B, S, H * P + 2 * N), generator=gen, device=cuda) * 0.5).bfloat16()
    Bm, Cm = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    log_l = -torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device=cuda))
    y, h = ssd_scan(xh, log_l, Bm, Cm, chunk=128)
    yo, ho = ssd_scan_ref(xh, log_l, Bm, Cm)
    yp, hp = ssd_scan_plain(xh, log_l, Bm, Cm, chunk=128)
    y, yo, yp = y.float(), yo.float(), yp.float()
    assert ((y - yo).abs() <= 2.0 ** -7 * yo.abs() + 1e-5).all()
    assert ((h - ho).abs() <= 5e-5).all()
    assert ((y - yp).abs() <= 2.0 ** -7 * yp.abs() + 5e-5).all()
    assert ((h - hp).abs() <= 5e-5).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,E,C,D,kind", [
    (2, 64, 8, 40, 256, "empty"),        # most slots empty: 64 tokens, 320 slots a row
    (1, 700, 2, 3, 200, "dense"),        # 700 nonzeros in every slot: past the 256-entry list
    (2, 300, 4, 10, 100, "dense"),       # two compaction tiles, ragged D
    (3, 77, 8, 12, 6144, "one_hot"),     # T a multiple of no tile
    (4, 512, 8, 160, 6144, "model"),     # mixtral's prefill, disp as the model makes it
    (4, 1, 8, 1, 6144, "model"),         # mixtral's decode
    (2, 1, 4, 20, 100, "dense"),         # one token: the decode kernel, slots in several tiles, ragged D
    (2, 20, 4, 12, 96, "one_hot"),       # a few tokens: one compaction pass, mostly idle
    (1, 30, 2, 3, 200, "dense"),         # a few tokens, every weight nonzero
    (2, 100, 4, 16, 96, "permuted"),     # disp with the slot axis not innermost
])
def test_moe_dispatch_kernel_edges(cuda, B, T, E, C, D, kind, dtype):
    """One-hot weights bit-equal to the plain version; dense ones within 2e-5
    (fp32) or one bf16 ulp of each element plus 1e-5; one launch a call."""
    from repro_torch.kernels.moe_dispatch import moe_dispatch, moe_dispatch_plain
    from repro_torch.models import moe

    gen = torch.Generator(device=cuda).manual_seed(T * E + C)
    x = torch.randn((B, T, D), generator=gen, device=cuda).to(dtype)
    if kind == "dense":
        disp = (torch.randn((B, T, E, C), generator=gen, device=cuda) / T ** 0.5).to(dtype)
    elif kind == "model":
        cfg = moe.MoEConfig(n_experts=E, topk=2, d_ff=64, strategy="expert_tp")
        router = (torch.randn((D, E), generator=gen, device=cuda) * D ** -0.5).to(dtype)
        disp, _ = moe.dispatch_tensors(moe.route(x, router, cfg), C, dtype)
    else:
        idx = torch.randint(0, E, (B, T), generator=gen, device=cuda)
        onehot = torch.nn.functional.one_hot(idx, E)
        slot = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(-1)
        disp = torch.zeros((B, T, E, C), device=cuda, dtype=dtype)
        b, t = torch.nonzero(slot < C, as_tuple=True)
        disp[b, t, idx[b, t], slot[b, t]] = 1
        if kind == "permuted":
            disp = disp.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
            assert disp.stride(3) != 1
    before = moe_dispatch.launches
    o = moe_dispatch(disp, x)
    torch.cuda.synchronize()
    assert moe_dispatch.launches == before + 1
    r = moe_dispatch_plain(disp, x)
    if kind != "dense":
        assert torch.equal(o, r)
        if kind == "empty":
            assert (disp.sum(1) == 0).any() and (o[disp.sum(1).permute(1, 0, 2) == 0] == 0).all()
        return
    o, r = o.float(), r.float()
    limit = torch.full_like(r, 2e-5) if dtype == torch.float32 else 2.0 ** -7 * r.abs() + 1e-5
    assert ((o - r).abs() <= limit).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,N,chunk,kind", [
    (1, 64, 1, 16, 32, "randn"), (2, 128, 2, 32, 32, "randn"), (1, 256, 4, 64, 128, "randn"),
    (1, 128, 1, 16, 128, "extreme"), (2, 77, 3, 32, 128, "s0"), (2, 1, 3, 32, 128, "s0"),
    (2, 256, 4, 32, 16, "randn"), (4, 512, 32, 64, 128, "randn"),
    # the tensor-core design's edges: partial 16-row tiles, chunks of fewer
    # than 16 rows, N of 16 to 64 (12: a row that is not a 16-byte multiple),
    # a chunk that is no multiple of 16, the extreme decay over whole chunks,
    # r, k, v as views of one wider tensor (aligned, and not)
    (2, 200, 3, 64, 128, "s0"), (1, 77, 2, 48, 64, "randn"), (2, 9, 2, 32, 128, "randn"),
    (1, 140, 2, 16, 128, "s0"), (2, 150, 2, 48, 64, "s0"), (1, 100, 2, 16, 100, "randn"),
    (1, 50, 2, 12, 32, "randn"), (2, 256, 2, 64, 128, "extreme"), (2, 300, 4, 64, 128, "view"),
    (2, 130, 3, 32, 128, "unaligned"),
])
def test_rwkv6_scan_kernel_matches_plain(cuda, B, S, H, N, chunk, kind, dtype):
    """r, k, v of scale 0.5, w = 0.98 sigmoid(randn) + 0.01 and u of scale
    0.3, as the reference's test draws them.  y and the state in float32
    within 5e-5 (the reference test's tolerance; 5e-4 for the extreme decay
    w = 1e-6, the reference test's for it); y in bfloat16 within one bf16 ulp
    of each element plus that limit (both are fp32 inside and round once);
    the state of bf16 runs within it.  bf16 runs the tensor-core kernel,
    float32 the first design."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_plain

    gen = torch.Generator(device=cuda).manual_seed(0)

    def draw(shape, scale=0.5):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    if kind == "view":                  # (B, S, H, N) views of (B, S, H, 3N)
        wide = draw((B, S, H, 3 * N)).to(dtype)
        r, k, v = wide[..., :N], wide[..., N:2 * N], wide[..., 2 * N:]
    elif kind == "unaligned":           # rows that start 4 elements into a wider row
        wide = draw((B, S, H, 3 * N + 4)).to(dtype)
        r, k, v = wide[..., 4:N + 4], wide[..., N + 4:2 * N + 4], wide[..., 2 * N + 4:]
    else:
        r, k, v = (draw((B, S, H, N)).to(dtype) for _ in range(3))
    if kind == "extreme":
        w = torch.full((B, S, H, N), 1e-6, device=cuda)
    else:
        w = torch.sigmoid(draw((B, S, H, N), 1.0)) * 0.98 + 0.01
    u = draw((H, N), 0.3).to(dtype)
    s0 = draw((B, H, N, N)) if kind == "s0" else None
    before = rwkv6_scan.launches
    y, s = rwkv6_scan(r, k, v, w, u, chunk=chunk, s0=s0)
    torch.cuda.synchronize()
    assert rwkv6_scan.launches == before + 1
    yr, sr = rwkv6_scan_plain(r, k, v, w, u, chunk=chunk, s0=s0)
    lim = 5e-4 if kind == "extreme" else 5e-5
    y, yr = y.float(), yr.float()
    limit = torch.full_like(yr, lim) if dtype == torch.float32 else 2.0 ** -7 * yr.abs() + lim
    assert torch.isfinite(y).all() and ((y - yr).abs() <= limit).all()
    assert ((s - sr).abs() <= lim).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_kernel_is_deterministic(cuda, dtype):
    """Two launches on the same inputs give the same bits: every sum is taken
    in a fixed order (no atomics), at rwkv6-1.6b's prefill shape with s0."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan

    gen = torch.Generator(device=cuda).manual_seed(1)
    r, k, v = (torch.randn((4, 512, 32, 64), generator=gen, device=cuda).mul(0.5).to(dtype) for _ in range(3))
    w = torch.sigmoid(torch.randn((4, 512, 32, 64), generator=gen, device=cuda)) * 0.98 + 0.01
    u = (torch.randn((32, 64), generator=gen, device=cuda) * 0.3).to(dtype)
    s0 = torch.randn((4, 32, 64, 64), generator=gen, device=cuda) * 0.5
    y1, s1 = rwkv6_scan(r, k, v, w, u, chunk=128, s0=s0)
    y2, s2 = rwkv6_scan(r, k, v, w, u, chunk=128, s0=s0)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int8])
@pytest.mark.parametrize("P,N,view", [
    (2, 512, None), (8, 2048, None), (16, 1024, None), (4, 1027, None), (1, 1, None),
    (3, 4096, "rows"), (3, 3001, "cols"),
])
def test_ccu_reduce_kernel_matches_plain(cuda, P, N, view, dtype, scaled):
    """Bit-equal to the plain version: the same products and sums, each
    rounded once, the peers in the same order; and two runs bit-equal."""
    from repro_torch.kernels.ccu_reduce import ccu_reduce, ccu_reduce_plain

    gen = torch.Generator(device=cuda).manual_seed(P * N)
    shape = (2 * P, N) if view == "rows" else (P, N + 13) if view == "cols" else (P, N)
    if dtype == torch.int8:
        bufs = torch.randint(-127, 128, shape, generator=gen, device=cuda, dtype=torch.int8)
    else:
        bufs = (torch.randn(shape, generator=gen, device=cuda) * 3).to(dtype)
    if view == "rows":
        bufs = bufs[::2]
    elif view == "cols":
        bufs = bufs[:, 5:5 + N]
    scales = torch.rand(P, generator=gen, device=cuda) * 1.5 + 0.5 if scaled else None
    before = ccu_reduce.launches
    o = ccu_reduce(bufs, scales)
    o2 = ccu_reduce(bufs, scales)
    torch.cuda.synchronize()
    assert ccu_reduce.launches == before + 2
    assert o.dtype == torch.float32 and o.shape == (N,)
    assert torch.equal(o, ccu_reduce_plain(bufs, scales)) and torch.equal(o, o2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gradients_match_plain(cuda, dtype):
    """Through the kernel with autograd recording: the output is the
    kernel's (held as above).  float32: its gradients those of the plain
    version at the same inputs, bit for bit (the backward recomputes the
    plain version); bfloat16 (head_dim 64: the backward kernels) within one
    bf16 ulp of each gradient's largest |g| from the plain version's, one
    backward launch."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    gen = torch.Generator(device=cuda).manual_seed(1)
    shapes = [((2, 2, 3, 100, 64), 2.0), ((2, 2, 100, 64), 1.5), ((2, 2, 100, 64), 1.0)]
    base = [(torch.randn(s, generator=gen, device=cuda) * sc).to(dtype) for s, sc in shapes]
    go = torch.randn((2, 2, 3, 100, 64), generator=gen, device=cuda).to(dtype)
    outs = []
    before = flash_attention.bwd_launches
    for fn in (flash_attention, flash_attention_plain):
        leaves = [t.clone().requires_grad_() for t in base]
        o = fn(*leaves, causal=True, window=48)
        assert o.grad_fn is not None
        o.backward(go)
        outs.append((o.detach().float(), [t.grad for t in leaves]))
    (o, g), (r, gr) = outs
    limit = torch.full_like(r, 2e-5) if dtype == torch.float32 else 2.0 ** -7 * r.abs() + 1e-5
    assert ((o - r).abs() <= limit).all()
    assert flash_attention.bwd_launches == before + (dtype == torch.bfloat16)
    for a, b in zip(g, gr):
        if dtype == torch.float32:
            assert torch.equal(a, b)
        else:
            assert (a.float() - b.float()).abs().max() <= 2.0 ** -7 * b.float().abs().max()


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G,Sq,Sk,q_start,causal,window,prefix_len", [
    (4, 256, 256, 0, True, None, 0), (1, 100, 100, 0, True, None, 0), (6, 77, 77, 0, True, None, 0),
    (4, 100, 100, 0, True, 32, 0), (6, 100, 100, 0, True, None, 40), (4, 64, 64, 0, True, 16, 70),
    (4, 77, 203, 126, True, None, 0), (1, 33, 300, 255, True, 70, 0), (6, 128, 256, 128, True, None, 0),
    (1, 64, 200, 0, False, None, 0), (4, 130, 40, 0, False, None, 0), (1, 17, 65, 48, True, None, 0),
    (6, 3, 70, 67, True, None, 0),
])
@pytest.mark.parametrize("sm_scale", [None, 2.0 ** -7])
def test_flash_attention_bwd_kernel_matches_oracle(cuda, D, G, Sq, Sk, q_start, causal, window, prefix_len, sm_scale):
    """The backward kernels (bf16 at head_dim 64 and 128) at the masks,
    ragged edges, q_start and G of the training paths: dq, dk, dv within one
    bf16 ulp of each gradient's largest |g| from autograd through the
    float64 oracle (P and dS enter the products in bf16, fp32 sums), within
    1e-2 of it from the plain backward on the same saved output and
    log-sum-exp, two launches bit for bit, one backward launch each.  At
    1/sqrt(D) and at granite-4.0-h's 1/128."""
    from repro_torch.kernels.flash_attention import _launch_bwd, flash_attention, flash_attention_bwd_plain
    from repro_torch.kernels.ref import attention_ref

    q, k, v = _peaked_qkv(cuda, G, Sq, Sk, D, torch.bfloat16, seed=3)
    go = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(4), device=cuda).bfloat16()
    kw = dict(causal=causal, window=window, prefix_len=prefix_len, q_start=q_start, sm_scale=sm_scale)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = flash_attention.bwd_launches
    o = flash_attention(*leaves, **kw)
    assert type(o.grad_fn).__name__ == "FlashGradientBackward"
    saved = [t.detach() for t in o.grad_fn.saved_tensors]       # q, k, v, o, lse
    o.backward(go)
    g = [t.grad for t in leaves]
    assert flash_attention.bwd_launches == before + 1
    again = _launch_bwd(*saved, go, **{**kw, "sm_scale": sm_scale or D ** -0.5})
    plain = flash_attention_bwd_plain(*saved, go, **kw)
    wide = [t.double().requires_grad_() for t in (q, k, v)]
    oracle = torch.autograd.grad(attention_ref(*wide, **kw), wide, go.double())
    of_ulp = [((a.double() - r).abs().max() / (2.0 ** -7 * r.abs().max())).item() for a, r in zip(g, oracle)]
    of_plain = [((a.float() - c.float()).abs().max() / c.float().abs().max()).item() for a, c in zip(g, plain)]
    assert all(a.dtype == torch.bfloat16 and torch.equal(a, b) for a, b in zip(g, again))
    assert max(of_ulp) <= 1.0 and max(of_plain) <= 1e-2, (of_ulp, of_plain)


def _autograd_case(cuda, kernel, kind, dtype):
    """(wrapper call, plain version, inputs, indices of the inputs that need
    a gradient) for one kernel at an edge: a ragged last chunk with an
    initial state (scans), the batched form with disp not needing a
    gradient (dispatch)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_dispatch import moe_dispatch_plain
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain
    from repro_torch.kernels.ssd_scan import ssd_scan_chunked

    gen = torch.Generator(device=cuda).manual_seed(3)

    def rnd(shape, scale=0.5, dt=dtype):
        return (torch.randn(shape, generator=gen, device=cuda) * scale).to(dt)

    if kernel == "rwkv6_scan":
        B, S, H, N = 2, 200, 2, 64
        w = torch.sigmoid(rnd((B, S, H, N), 1.0, torch.float32)) * 0.98 + 0.01
        inputs = [rnd((B, S, H, N)), rnd((B, S, H, N)), rnd((B, S, H, N)), w, rnd((H, N), 0.3),
                  rnd((B, H, N, N), 0.5, torch.float32) if kind == "state" else None]
        return (lambda *t: ops.rwkv6_scan(*t[:5], chunk=128, s0=t[5]),
                lambda *t: rwkv6_scan_plain(*t[:5], chunk=128, s0=t[5]), inputs,
                [0, 1, 2, 3, 4] + ([5] if kind == "state" else []))
    if kernel == "ssd_scan":
        B, S, H, P, N = 2, 200, 4, 64, 64
        log_l = -torch.nn.functional.softplus(rnd((B, S, H), 1.0, torch.float32))
        inputs = [rnd((B, S, H, P)), log_l, rnd((B, S, N)), rnd((B, S, N)),
                  rnd((B, H, P, N), 0.5, torch.float32) if kind == "state" else None]
        # the backward recomputes the plain version with its chunks batched
        # (``ssd_scan_chunked``, held to ``ssd_scan_plain`` on the CPU)
        return (lambda *t: ops.ssd_scan(*t[:4], chunk=128, h0=t[4]),
                lambda *t: ssd_scan_chunked(*t[:4], chunk=128, h0=t[4]), inputs,
                [0, 1, 2, 3] + ([4] if kind == "state" else []))
    B, T, E, C, D = 2, 77, 8, 24, 256
    idx = torch.randint(0, E, (B, T), generator=gen, device=cuda)
    disp = torch.nn.functional.one_hot(idx, E)[..., None] * (torch.arange(C, device=cuda) == 0)
    return (ops.moe_dispatch, moe_dispatch_plain, [disp.to(dtype), rnd((B, T, D))],
            [1] if kind == "plain" else [0, 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,kind", [("rwkv6_scan", "plain"), ("rwkv6_scan", "state"), ("ssd_scan", "plain"),
                                         ("ssd_scan", "state"), ("moe_dispatch", "plain"),
                                         ("moe_dispatch", "disp_grad")])
def test_kernel_gradients_match_plain(cuda, kernel, kind, dtype):
    """Under autograd the wrapper launches its kernel once (its output that
    of the call without autograd, bit for bit) and the gradients are those
    of the plain version at the same inputs, bit for bit (the backward
    recomputes it; for ``ssd_scan`` its chunk-batched form), for a
    non-contiguous incoming gradient, for y alone and, with an initial
    state, for the final state too."""
    from repro_torch import kernels

    call, plain, inputs, grad_of = _autograd_case(cuda, kernel, kind, dtype)
    with torch.no_grad():
        no_grad = call(*inputs)
    runs = []
    for fn in (call, plain):
        xs = [None if t is None else t.detach().requires_grad_(i in grad_of) for i, t in enumerate(inputs)]
        kernels.reset_launch_counts()
        outs = fn(*xs)
        launched = kernels.launch_counts()[kernel]
        outs = outs if isinstance(outs, tuple) else (outs,)
        used = outs if kind == "state" else outs[:1]
        gen = torch.Generator(device=cuda).manual_seed(4)
        gos = [torch.randn((*o.shape[:-1], 2 * o.shape[-1]), generator=gen, device=cuda).to(o.dtype)[..., ::2]
               for o in used]
        assert all(o.grad_fn is not None for o in used)
        runs.append((outs, torch.autograd.grad(used, [xs[i] for i in grad_of], gos), launched))
    (outs, g, launched), (_, gp, plain_launched) = runs
    assert launched == 1 and plain_launched == 0
    no_grad = no_grad if isinstance(no_grad, tuple) else (no_grad,)
    for a, b in zip(outs, no_grad):
        assert torch.equal(a.detach(), b)
    for a, b in zip(g, gp):
        assert torch.equal(a, b) and torch.isfinite(a.float()).all()


def test_train_kernel_path_matches_plain_path(cuda):
    """granite-8b smoke, float32, two steps through ``launch/train.run`` with
    int8 compression on each path from the same weights: the same losses
    within 1e-5, gradients within 2e-5, one ``ccu_reduce`` launch per leaf and
    step and two flash launches per layer and step (forward and recompute) on
    the kernel path, and no launch of either on the plain path."""
    from repro_torch.configs import load
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.models.layers import Runtime
    from repro_torch.models.param import tree_init, tree_leaves

    h = load("granite-8b", smoke=True).clone(dtype=torch.float32)
    args = train.build_parser().parse_args(["--steps", "2", "--batch", "4", "--seq", "64",
                                            "--lr", "1e-3", "--compression", "int8"])
    runs = []
    for rt in (Runtime(), Runtime(use_kernels=False)):
        params = tree_init(h.param_specs(), torch.Generator(device=cuda).manual_seed(1), torch.float32, cuda)
        grads = []
        reset_launch_counts()
        res = train.run(args, harness=h, params=params, rt=rt,
                        observe=lambda s, l, g, p, w: grads.append(g) if s == 0 else None)
        runs.append((res, grads[0], launch_counts()))
    (k, kg, kc), (p, pg, pc) = runs
    n_leaves = len(tree_leaves(kg))
    assert kc == {"flash_attention": 2 * 2 * h.cfg.n_layers, "moe_dispatch": 0, "ssd_scan": 0,
                  "rwkv6_scan": 0, "ccu_reduce": 2 * n_leaves, "flash_attention.bwd": 0}
    assert pc["flash_attention"] == 0 and pc["ccu_reduce"] == 0
    assert max(abs(a - b) for a, b in zip(k["losses"], p["losses"])) <= 1e-5
    for a, b in zip(tree_leaves(kg), tree_leaves(pg)):
        assert (a - b).abs().max() <= 2e-5


@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-base"])
def test_train_with_stub_inputs_kernel_path_matches_plain_path(cuda, arch):
    """paligemma-3b smoke with its 8 prefix embeddings and whisper-base smoke
    with its 24 frames (``train.drawn_inputs``), float32, one step through
    ``launch/train.run(..., inputs=...)`` with int8 compression on each path
    from the same weights and inputs: the same loss within 1e-5, gradients
    within 2e-5, one ``ccu_reduce`` launch per leaf and flash twice an
    attention (forward and recompute: paligemma one a layer, whisper three,
    the encoder's and the decoder's self- and cross-attention) on the
    kernel path, and no launch of either on the plain path."""
    from repro_torch.configs import load
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.models.layers import Runtime
    from repro_torch.models.param import tree_init, tree_leaves

    h = load(arch, smoke=True).clone(dtype=torch.float32)
    args = train.build_parser().parse_args(["--arch", arch, "--steps", "1", "--batch", "4", "--seq", "64",
                                            "--lr", "1e-3", "--compression", "int8"])
    inputs = train.drawn_inputs(h, 4, 100, cuda)
    runs = []
    for rt in (Runtime(), Runtime(use_kernels=False)):
        params = tree_init(h.param_specs(), torch.Generator(device=cuda).manual_seed(1), torch.float32, cuda)
        grads = []
        reset_launch_counts()
        res = train.run(args, harness=h, params=params, rt=rt, inputs=inputs,
                        observe=lambda s, l, g, p, w: grads.append(g))
        runs.append((res, grads[0], launch_counts()))
    (k, kg, kc), (p, pg, pc) = runs
    n_leaves = len(tree_leaves(kg))
    attentions = {"paligemma-3b": 1, "whisper-base": 3}[arch] * h.cfg.n_layers
    assert kc == {"flash_attention": 2 * attentions, "moe_dispatch": 0, "ssd_scan": 0,
                  "rwkv6_scan": 0, "ccu_reduce": n_leaves, "flash_attention.bwd": 0}
    assert pc["flash_attention"] == 0 and pc["ccu_reduce"] == 0
    assert abs(k["losses"][0] - p["losses"][0]) <= 1e-5
    for a, b in zip(tree_leaves(kg), tree_leaves(pg)):
        assert (a - b).abs().max() <= 2e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N", [2048, 4096, 4194304, 16777216, 58720256, 100663296])
def test_ccu_reduce_at_the_dist_rows(cuda, N, dtype):
    """The rows of ``chip_smoke.py``'s dist phase: P = 2 peers, N half of one
    of granite-8b's gradient leaves at 2 layers (bf16: the data axis's
    reduce-scatter of the gradients; fp32: the pod axis's all-reduce of the
    partial sums), bit-equal to the plain version and two runs bit-equal."""
    from repro_torch.kernels.ccu_reduce import ccu_reduce, ccu_reduce_plain

    gen = torch.Generator(device=cuda).manual_seed(N)
    bufs = (torch.randn((2, N), generator=gen, device=cuda) * 1e-3).to(dtype)
    before = ccu_reduce.launches
    o, o2 = ccu_reduce(bufs), ccu_reduce(bufs)
    torch.cuda.synchronize()
    assert ccu_reduce.launches == before + 2
    assert o.dtype == torch.float32 and o.shape == (N,)
    assert torch.equal(o, ccu_reduce_plain(bufs)) and torch.equal(o, o2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Sq,Sk,q_start", [
    # a model rank's rows against the keys gathered over "model" (the dense
    # family's sequence parallelism): granite-8b's train step on (data,
    # model) = (2, 2), both ranks; query tiles that start on a tile's edge,
    # and a last rank's rows far down a long sequence
    (4, 128, 256, 0), (4, 128, 256, 128), (4, 512, 2048, 1536), (4, 256, 4096, 3840), (4, 64, 8192, 4096),
])
def test_flash_attention_sequence_parallel_rows(cuda, G, Sq, Sk, q_start, dtype):
    """More than 16 folded rows at ``q_start > 0`` against every key of the
    sequence: the tile filter skips the tiles above the diagonal and keeps
    every tile a row needs.  Limits as ``test_flash_attention_kernel_matches_plain``."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    q, k, v = _peaked_qkv(cuda, G, Sq, Sk, 128, dtype, seed=q_start)
    kw = dict(causal=True, q_start=q_start)
    o = flash_attention(q, k, v, **kw).float()
    torch.cuda.synchronize()
    r = flash_attention_plain(q, k, v, **kw).float()
    limit = torch.full_like(r, 2e-5) if dtype == torch.float32 else 2.0 ** -7 * r.abs() + 1e-5
    assert ((o - r).abs() <= limit).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Sk,q_local,window,prefix_len,D", [
    # a model rank's block of the cache in decode: granite-8b (G = 4) at the
    # block's last key and partway through it; mixtral-8x22b (G = 6) under
    # its window; paligemma-3b (G = 8, head_dim 256) with its prefix in the block
    (4, 2048, 2047, None, 0, 128), (4, 2048, 700, None, 0, 128), (6, 512, 511, 4096, 0, 128),
    (6, 512, 300, 200, 0, 128), (8, 2064, 2063, None, 256, 256), (8, 600, 599, None, 0, 256),
])
def test_flash_decode_log_sum_exp_matches_plain(cuda, G, Sk, q_local, window, prefix_len, D, dtype):
    """The decode kernels' log-sum-exp output (written by the combine
    kernel) against the plain version's: fp32 within 1e-5 of max(1, |lse|)
    (the same fp32 scores, summed in another order); the output bit-equal
    to the same call without it"""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    q, k, v = _peaked_qkv(cuda, G, 1, Sk, D, dtype, seed=Sk)
    kw = dict(causal=True, window=window, prefix_len=prefix_len, q_start=q_local)
    before = flash_attention.launches
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert torch.equal(o, flash_attention(q, k, v, **kw))
    ro, rl = flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert lse.dtype == torch.float32 and lse.shape == rl.shape == (2, 2, G, 1)
    assert ((lse - rl).abs() <= 1e-5 * rl.abs().clamp(min=1.0)).all()
    limit = torch.full_like(ro.float(), 2e-5) if dtype == torch.float32 else 2.0 ** -7 * ro.float().abs() + 1e-5
    assert ((o.float() - ro.float()).abs() <= limit).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,ranks,E,K,D", [(2, 256, 2, 8, 2, 256), (2, 128, 16, 16, 4, 128), (4, 64, 4, 8, 2, 96)])
def test_moe_dispatch_at_a_ranks_token_share(cuda, B, T, ranks, E, K, D, dtype):
    """A model rank's ``T`` tokens of a sequence of ``ranks * T`` into the
    whole sequence's capacity ``C``, its slots offset by the earlier ranks'
    (the last rank's share, whose slots start past the others'):
    bit-equal to the plain version"""
    from repro_torch.kernels.moe_dispatch import moe_dispatch, moe_dispatch_plain
    from repro_torch.models.moe import MoEConfig

    C = MoEConfig(n_experts=E, topk=K, d_ff=1).capacity(ranks * T)
    gen = torch.Generator(device=cuda).manual_seed(T)
    x = torch.randn((B, T, D), generator=gen, device=cuda).to(dtype)
    idx = torch.randint(0, E, (B, T), generator=gen, device=cuda)
    onehot = torch.nn.functional.one_hot(idx, E)
    slot = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(-1) + (ranks - 1) * T * K // E
    disp = torch.zeros((B, T, E, C), device=cuda, dtype=dtype)
    b, t = torch.nonzero(slot < C, as_tuple=True)
    disp[b, t, idx[b, t], slot[b, t]] = 1
    o = moe_dispatch(disp, x)
    torch.cuda.synchronize()
    assert torch.equal(o, moe_dispatch_plain(disp, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,m", [(2, 512, 64, 64, 64, 2), (2, 2048, 64, 64, 64, 16), (2, 256, 4, 64, 16, 2)])
def test_ssd_scan_at_a_model_ranks_heads(cuda, B, S, H, P, N, m, dtype):
    """A Mamba2 layer's scan on a model rank (``mamba2._sequence_parallel_columns``):
    its H/m heads, x of its d_inner channels, and B/C whole, each a slice
    of the conv output ``(B, S, H·P/m + 2N)`` as the split leaves them (the
    innermost stride 1, rows H·P/m + 2N apart).  Limits as
    ``test_ssd_scan_kernel_matches_plain``'s"""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

    gen = torch.Generator(device=cuda).manual_seed(S + H)
    Hr = H // m
    conv = (torch.randn((B, S, Hr * P + 2 * N), generator=gen, device=cuda) * 0.5).to(dtype)
    xc, Bm, Cm = torch.split(conv, [Hr * P, N, N], dim=-1)
    dt = torch.nn.functional.softplus(torch.randn((B, S, Hr), generator=gen, device=cuda))
    log_l = -dt * 0.5
    xh = xc.reshape(B, S, Hr, P) * dt[..., None].to(dtype)
    before = ssd_scan.launches
    y, h = ssd_scan(xh, log_l, Bm, Cm, chunk=128)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    yr, hr = ssd_scan_plain(xh, log_l, Bm, Cm, chunk=128)
    y, yr = y.float(), yr.float()
    limit = torch.full_like(yr, 5e-5) if dtype == torch.float32 else 2.0 ** -7 * yr.abs() + 1e-5
    assert ((y - yr).abs() <= limit).all()
    assert ((h - hr).abs() <= 5e-5).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,N,m", [(2, 512, 32, 64, 2), (2, 2048, 32, 64, 16), (2, 256, 4, 32, 2)])
def test_rwkv6_scan_at_a_model_ranks_heads(cuda, B, S, H, N, m, dtype):
    """An RWKV-6 time mix's scan on a model rank (``rwkv6.timemix_apply``
    with ``rt.tp``): r/k/v of its H/m heads as the column-parallel products
    give them, the decay in fp32, ``bonus_u`` sliced to its channels.
    Limits as ``test_rwkv6_scan_kernel_matches_plain``'s"""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_plain

    gen = torch.Generator(device=cuda).manual_seed(S + H)
    Hr, r0 = H // m, (m - 1) * (H // m) * N                  # the last rank's heads
    x = torch.randn((B, S, 64), generator=gen, device=cuda).to(dtype)
    r, k, v = ((x @ (torch.randn((64, Hr * N), generator=gen, device=cuda) / 16).to(dtype)).reshape(B, S, Hr, N)
               for _ in range(3))
    w = torch.sigmoid(torch.randn((B, S, Hr, N), generator=gen, device=cuda)) * 0.98 + 0.01
    u = (torch.randn((H * N,), generator=gen, device=cuda) * 0.3).to(dtype)[r0:r0 + Hr * N].reshape(Hr, N)
    before = rwkv6_scan.launches
    y, s = rwkv6_scan(r, k, v, w, u, chunk=128)
    torch.cuda.synchronize()
    assert rwkv6_scan.launches == before + 1
    yr, sr = rwkv6_scan_plain(r, k, v, w, u, chunk=128)
    y, yr = y.float(), yr.float()
    limit = torch.full_like(yr, 5e-5) if dtype == torch.float32 else 2.0 ** -7 * yr.abs() + 5e-5
    assert torch.isfinite(y).all() and ((y - yr).abs() <= limit).all()
    assert ((s - sr).abs() <= 5e-5).all()
