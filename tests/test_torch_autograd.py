"""The backward of ``rwkv6_scan``, ``ssd_scan`` and ``moe_dispatch``
(``kernels/_autograd.PlainGradient``: the kernel's launch forward, the plain
version's gradient backward), here with the plain version handed to the
forward, as the card hands it the kernel.  Against autograd through the plain
versions directly (bit for bit: the backward recomputes them), with y only,
the state only, both, an initial state, a ragged last chunk and a
non-contiguous incoming gradient; against ``jax.grad`` of the reference's jnp
twins (``rwkv6_chunked``, ``ssd_chunked``, the dispatch einsum) in float32,
within 2e-5 of each input's largest |g|; and finite at the decay extremes
(w = 1e-6, log_l = -13), the plain versions and the models' twins alike."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as ref_mamba2, rwkv6 as ref_rwkv6
from repro_torch.kernels._autograd import PlainGradient
from repro_torch.kernels.moe_dispatch import moe_dispatch_plain
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.models import mamba2 as port_mamba2, rwkv6 as port_rwkv6

from _torch_parity import one_thread, rand  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def rwkv_inputs(rng, B, S, H, N, *, extreme=False, s0=False):
    r, k, v = (rand(rng, (B, S, H, N)) for _ in range(3))
    w = (np.full((B, S, H, N), 1e-6, np.float32) if extreme
         else (1 / (1 + np.exp(-rng.standard_normal((B, S, H, N)))) * 0.98 + 0.01).astype(np.float32))
    u = rand(rng, (H, N), 0.3)
    return [r, k, v, w, u, rand(rng, (B, H, N, N)) if s0 else None]


def ssd_inputs(rng, B, S, H, P, N, *, strong=False, h0=False):
    xh = rand(rng, (B, S, H, P))
    log_l = (np.full((B, S, H), -13.0, np.float32) if strong
             else -np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32))
    return [xh, log_l, rand(rng, (B, S, N)), rand(rng, (B, S, N)), rand(rng, (B, H, P, N)) if h0 else None]


def moe_inputs(rng, B, T, E, C, D):
    idx = rng.integers(0, E, (B, T))
    disp = np.zeros((B, T, E, C), np.float32)
    for b in range(B):
        load = np.zeros(E, int)
        for t in range(T):
            e = idx[b, t]
            if load[e] < C:
                disp[b, t, e, load[e]] = 1.0
                load[e] += 1
    return [disp, rand(rng, (B, T, D))]


def rwkv_plain(chunk):
    return lambda *t: rwkv6_scan_plain(*t[:5], chunk=chunk, s0=t[5])


def ssd_plain(chunk):
    return lambda *t: ssd_scan_plain(*t[:4], chunk=chunk, h0=t[4])


def leaves(arrays, dtype, grad_of, fp32=()):
    """Torch leaves of the arrays in ``dtype``, those at ``fp32`` in float32
    (the models hand the scans their decays and states in float32)."""
    return [None if a is None else torch.from_numpy(a).to(torch.float32 if i in fp32 else dtype)
            .requires_grad_(i in grad_of) for i, a in enumerate(arrays)]


def grads_both_ways(plain, arrays, dtype, grad_of, used, seed=0, strided=False):
    """Gradients of a random projection of the ``used`` outputs, through
    ``PlainGradient`` and through ``plain`` directly: (outputs, grads) each."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for via in (True, False):
        xs = leaves(arrays, dtype, grad_of)
        outs = PlainGradient.apply("plain", plain, plain, *xs) if via else plain(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        gen.manual_seed(seed)
        picked, gos = [], []
        for i in used:
            o = outs[i]
            if strided:     # the incoming gradient as a view with a gap in every row
                go = torch.randn((*o.shape[:-1], 2 * o.shape[-1]), generator=gen).to(o.dtype)[..., ::2]
                assert not go.is_contiguous()
            else:
                go = torch.randn(o.shape, generator=gen).to(o.dtype)
            picked.append(o)
            gos.append(go)
        wanted = [xs[i] for i in grad_of]
        got = torch.autograd.grad(picked, wanted, gos, allow_unused=True)
        # an input the used outputs do not depend on (r for the state alone)
        out.append(([o.detach() for o in outs],
                     [torch.zeros_like(x) if g is None else g for x, g in zip(wanted, got)]))
    return out


CASES = [
    ("rwkv6", dict(B=2, S=40, H=2, N=16), 16, dict()),                     # ragged last chunk
    ("rwkv6", dict(B=1, S=32, H=2, N=16), 32, dict(s0=True)),
    ("ssd", dict(B=2, S=40, H=2, P=16, N=8), 16, dict()),
    ("ssd", dict(B=1, S=32, H=3, P=8, N=8), 32, dict(h0=True)),
]


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("used", [(0,), (1,), (0, 1)], ids=["y", "state", "both"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,shape,chunk,kw", CASES, ids=["rwkv6", "rwkv6-s0", "ssd", "ssd-h0"])
def test_scan_gradients_equal_plain(kernel, shape, chunk, kw, dtype, used, strided):
    rng = np.random.default_rng(0)
    if kernel == "rwkv6":
        arrays, plain = rwkv_inputs(rng, **shape, **kw), rwkv_plain(chunk)
        grad_of = [0, 1, 2, 3, 4] + ([5] if kw.get("s0") else [])
    else:
        arrays, plain = ssd_inputs(rng, **shape, **kw), ssd_plain(chunk)
        grad_of = [0, 1, 2, 3] + ([4] if kw.get("h0") else [])
    (outs, g), (outs_p, gp) = grads_both_ways(plain, arrays, dtype, grad_of, used, strided=strided)
    for a, b in zip(outs, outs_p):
        assert torch.equal(a, b)
    for a, b in zip(g, gp):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert torch.isfinite(a.float()).all()


@pytest.mark.parametrize("disp_grad", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_moe_dispatch_gradients_equal_plain(batched, disp_grad):
    """disp made of the routing's one-hots needs no gradient and gets none
    (its product is not formed); given one, it is the plain version's."""
    arrays = moe_inputs(np.random.default_rng(1), 2, 24, 4, 5, 16)
    if not batched:
        arrays = [a[0] for a in arrays]
    grad_of = [0, 1] if disp_grad else [1]
    (o, g), (op, gp) = grads_both_ways(moe_dispatch_plain, arrays, torch.float32, grad_of, (0,))
    assert torch.equal(o[0], op[0])
    for a, b in zip(g, gp):
        assert torch.equal(a, b)
    xs = leaves(arrays, torch.float32, grad_of)
    PlainGradient.apply("plain", moe_dispatch_plain, moe_dispatch_plain, *xs).sum().backward()
    assert (xs[0].grad is not None) == disp_grad and xs[1].grad is not None


def test_unused_input_gets_no_gradient():
    """An input that needs no gradient (w here) gets None, the others theirs."""
    arrays = rwkv_inputs(np.random.default_rng(2), 1, 16, 1, 8)
    xs = leaves(arrays, torch.float32, [0, 1, 2, 4])
    y, _ = PlainGradient.apply("plain", rwkv_plain(16), rwkv_plain(16), *xs)
    y.sum().backward()
    assert xs[3].grad is None and all(xs[i].grad is not None for i in (0, 1, 2, 4))


# ---------------------------------------------------------------------------
# against the reference's twins, and at the extremes
# ---------------------------------------------------------------------------


def jax_grads(fn, arrays, argnums):
    return jax.grad(fn, argnums=argnums)(*[None if a is None else jnp.asarray(a) for a in arrays])


def port_grads(fn, arrays, grad_of):
    xs = leaves(arrays, torch.float32, grad_of)
    fn(*xs).backward()
    return [xs[i].grad for i in grad_of]


def assert_close_of_largest(port, ref, rel=2e-5, floor=0.0):
    """Within ``rel`` of each gradient's largest |g|, or of ``floor`` where
    that is larger."""
    for p, r in zip(port, ref):
        r = np.asarray(r)
        assert np.isfinite(p.numpy()).all()
        assert np.abs(p.numpy() - r).max() <= rel * max(np.abs(r).max(), floor)


@pytest.mark.parametrize("extreme", [False, True])
def test_rwkv6_gradients_match_reference_twin(extreme):
    """``jax.grad`` of the reference's ``rwkv6_chunked`` against the port's
    plain version (the kernel's backward) and its twin, float32; at
    w = 2e-6 (every decay near the clip) too.  The decay's gradient is held
    as ``w * dL/dw``, the gradient of log w, which the model's
    ``w = exp(-exp(wlog))`` passes on: dL/dw itself carries the float32
    rounding of dL/dlog w times 1/w (5e5 here).  Near the clip that gradient
    is small (1.3e-5) beside the sums of order-1 terms it comes from, so it
    is held within 2e-5 of 1 there, the float32 rounding of those sums."""
    arrays = rwkv_inputs(np.random.default_rng(3), 2, 32, 2, 16, extreme=extreme, s0=True)
    # just above the clip: at w = 1e-6 exactly JAX's clip splits the gradient
    # between its two branches at the tie (0.5 each) where torch's clamp
    # passes it whole
    arrays[3] = arrays[3] * 2 if extreme else arrays[3]
    proj = np.random.default_rng(4).standard_normal((2, 32, 2, 16)).astype(np.float32)
    ref = jax_grads(lambda r, k, v, w, u, s0: jnp.sum(
        ref_rwkv6.rwkv6_chunked(r, k, v, w, u, 16, s0)[0] * proj), arrays, (0, 1, 2, 3, 4, 5))
    pt = torch.from_numpy(proj)
    ref = list(ref)
    ref[3] = ref[3] * arrays[3]
    for fn in (lambda *t: (rwkv_plain(16)(*t)[0] * pt).sum(),
               lambda *t: (port_rwkv6.rwkv6_chunked(*t[:5], 16, t[5])[0] * pt).sum()):
        got = port_grads(fn, arrays, range(6))
        got[3] = got[3] * torch.from_numpy(arrays[3])
        assert_close_of_largest(got[:3] + got[4:], ref[:3] + ref[4:])
        assert_close_of_largest(got[3:4], ref[3:4], floor=1.0 if extreme else 0.0)


@pytest.mark.parametrize("strong", [False, True])
def test_ssd_gradients_match_reference_twin(strong):
    """``jax.grad`` of the reference's ``ssd_chunked`` against the port's
    plain version (the kernel's backward) and its twin, float32; at
    log_l = -13 too."""
    arrays = ssd_inputs(np.random.default_rng(5), 2, 32, 2, 8, 8, strong=strong, h0=True)
    proj = np.random.default_rng(6).standard_normal((2, 32, 2, 8)).astype(np.float32)
    ref = jax_grads(lambda xh, ll, b, c, h0: jnp.sum(
        ref_mamba2.ssd_chunked(xh, ll, b, c, 16, h0)[0] * proj), arrays, (0, 1, 2, 3, 4))
    pt = torch.from_numpy(proj)
    for fn in (lambda *t: (ssd_plain(16)(*t)[0] * pt).sum(),
               lambda *t: (port_mamba2.ssd_chunked(*t[:4], 16, t[4])[0] * pt).sum()):
        assert_close_of_largest(port_grads(fn, arrays, range(5)), ref)


def test_moe_dispatch_gradients_match_reference_einsum():
    arrays = moe_inputs(np.random.default_rng(7), 2, 24, 4, 5, 16)
    proj = np.random.default_rng(8).standard_normal((4, 2, 5, 16)).astype(np.float32)
    ref = jax_grads(lambda d, x: jnp.sum(jnp.einsum("bsec,bsd->ebcd", d, x) * proj), arrays, (0, 1))
    pt = torch.from_numpy(proj)
    assert_close_of_largest(port_grads(lambda d, x: (moe_dispatch_plain(d, x) * pt).sum(), arrays, [0, 1]), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradients_finite_at_the_decay_extremes(dtype):
    """w = 1e-6 through a whole chunk of 128 (cum reaches -1768) and
    log_l = -13: the masks stand before the exponentials, so no masked
    inf meets a zero in the backward."""
    rng = np.random.default_rng(9)
    rwkv_fp32, ssd_fp32 = (3, 5), (1, 4)
    for plain, arrays, n, fp32 in (
            (rwkv_plain(128), rwkv_inputs(rng, 1, 128, 1, 16, extreme=True, s0=True), 6, rwkv_fp32),
            (lambda *t: port_rwkv6.rwkv6_chunked(*t[:5], 128, t[5]), rwkv_inputs(rng, 1, 128, 1, 16, extreme=True), 5,
             rwkv_fp32),
            (ssd_plain(64), ssd_inputs(rng, 1, 128, 2, 16, 16, strong=True, h0=True), 5, ssd_fp32),
            (lambda *t: port_mamba2.ssd_chunked(*t[:4], 64, t[4]), ssd_inputs(rng, 1, 128, 2, 16, 16, strong=True), 4,
             ssd_fp32)):
        xs = leaves(arrays, dtype, list(range(n)), fp32)
        y, state = PlainGradient.apply("plain", plain, plain, *xs)
        (y.float().sum() + state.sum()).backward()
        for t in xs[:n]:
            assert torch.isfinite(t.grad.float()).all()
