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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,q_start,window,prefix_len", [
    (256, 256, 0, None, 0), (100, 100, 0, 32, 16), (77, 203, 126, None, 0), (1, 200, 199, None, 0),
])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_attention_kernel_matches_plain(cuda, D, Sq, Sk, q_start, window, prefix_len, dtype):
    """Scores of standard deviation 3 and values of standard deviation 1: each
    row rests on a few keys chosen by q, and the outputs are of order 1.
    float32 within 2e-5 (sums in another order); bfloat16 within one bf16 ulp
    of each element (2^-7 |r|: both round the same fp32 result once) plus 1e-5."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (
        (torch.randn(s, generator=gen, device=cuda) * scale).to(dtype)
        for s, scale in [((2, 2, 3, Sq, D), 2.0), ((2, 2, Sk, D), 1.5), ((2, 2, Sk, D), 1.0)])
    kw = dict(causal=True, window=window, prefix_len=prefix_len, q_start=q_start)
    before = flash_attention.launches
    o = flash_attention(q, k, v, **kw).float()
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    r = flash_attention_plain(q, k, v, **kw).float()
    limit = torch.full_like(r, 2e-5) if dtype == torch.float32 else 2.0 ** -7 * r.abs() + 1e-5
    assert ((o - r).abs() <= limit).all()


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,N,chunk,kind", [
    (1, 64, 1, 16, 32, "randn"), (2, 128, 2, 32, 32, "randn"), (1, 256, 4, 64, 128, "randn"),
    (1, 128, 1, 16, 128, "extreme"), (2, 77, 3, 32, 128, "s0"), (2, 1, 3, 32, 128, "s0"),
    (2, 256, 4, 32, 16, "randn"), (4, 512, 32, 64, 128, "randn"),
])
def test_rwkv6_scan_kernel_matches_plain(cuda, B, S, H, N, chunk, kind, dtype):
    """r, k, v of scale 0.5, w = 0.98 sigmoid(randn) + 0.01 and u of scale
    0.3, as the reference's test draws them.  y and the state in float32
    within 5e-5 (the reference test's tolerance; 5e-4 for the extreme decay
    w = 1e-6, the reference test's for it); y in bfloat16 within one bf16 ulp
    of each element plus that limit (both are fp32 inside and round once);
    the state of bf16 runs within it."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_plain

    gen = torch.Generator(device=cuda).manual_seed(0)

    def draw(shape, scale=0.5):
        return torch.randn(shape, generator=gen, device=cuda) * scale

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
