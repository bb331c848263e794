"""Port of models/mamba2.py against the reference, on the same weights and
inputs (numpy, carried to both), float32 and bfloat16, kernels on and off.

Tolerances.  float32: 5e-5 on the scan (the reference kernel test's), 2e-4
on a block's output (the same arithmetic, sums in another order, through
the projections).  bfloat16: 3e-2 of the largest |value| (at least 3e-2),
as for the port's logits: the two frameworks may sum in another order, and
on the kernel path the scan keeps ``att`` and the carried state in fp32
where the reference's twin rounds both to bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mamba2 as RM
import repro.models.param as ref_param
from repro.models.layers import Runtime as RefRuntime
from repro_torch.models import mamba2 as PM
from repro_torch.models.layers import Runtime

from _torch_parity import JDT, TDT, carry, max_err, rand, to_np
from _torch_parity import reference_scan_inputs as ref_scan_inputs

RRT = RefRuntime(rules=None)
# two chunks of 16 in a sequence of 32: the state crosses a chunk boundary
KW = dict(d_model=64, d_inner=128, d_state=16, head_dim=32, chunk=16)
B, S = 2, 32


def weights(seed=3):
    """The reference's spec tree, every leaf drawn (the zero- and one-inited
    A_log, dt_bias, conv_b and D too, so that each head decays at its own
    rate)."""
    specs = RM.mamba2_specs(RM.Mamba2Config(**KW))
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in specs.items():
        scale = 1 / np.sqrt(s.shape[-2]) if len(s.shape) >= 2 else 0.5
        out[name] = rand(rng, s.shape, scale)
    out["out_norm"] = 1 + out["out_norm"]
    return out


def tol(dtype, ref, f32=2e-4):
    return f32 if dtype == "float32" else 3e-2 * max(1.0, float(np.abs(to_np(ref)).max()))


def both_params(w, dtype):
    return ref_param.cast_floats(jax.tree.map(jnp.asarray, w), JDT[dtype]), carry(w, TDT[dtype])


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv(dtype, with_state):
    rng = np.random.default_rng(1)
    x, w, b = rand(rng, (B, S, 48)), rand(rng, (4, 48)), rand(rng, (48,))
    st = rand(rng, (B, 3, 48)) if with_state else None
    j = [jnp.asarray(a).astype(JDT[dtype]) for a in (x, w, b)]
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in (x, w, b)]
    # the state is bf16, as mamba2_state_specs makes it: promoted with x
    js = None if st is None else jnp.asarray(st).astype(jnp.bfloat16)
    ts = None if st is None else torch.from_numpy(st).bfloat16()
    ry, rs = RM._causal_conv(*j, js)
    py, ps = PM._causal_conv(*t, ts)
    assert py.dtype == TDT[dtype] and ps.dtype == TDT[dtype]
    assert max_err(py, ry) <= tol(dtype, ry, 1e-6)
    assert max_err(ps, rs) == 0.0                          # the last rows of [state | x]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_rounds_as_the_reference(dtype):
    """the block's SiLU rounds as the reference's: the same bits in bf16,
    where a SiLU rounded once (``F.silu``) lies an ulp away in many
    elements; in fp32 within the frameworks' exp (a few ulps)"""
    x = rand(np.random.default_rng(6), (4096,), 3.0)
    r = jax.nn.silu(jnp.asarray(x).astype(JDT[dtype]))
    p = PM._silu(torch.from_numpy(x).to(TDT[dtype]))
    assert p.dtype == TDT[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(to_np(p), to_np(r), rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(to_np(p), to_np(r))
        assert max_err(torch.nn.functional.silu(torch.from_numpy(x).bfloat16()), r) > 0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_reference(dtype, with_h0):
    """the model's plain twin, its bf16 casts of att and of the carried
    state included"""
    rng = np.random.default_rng(2)
    H, P, N = 4, 32, 16
    xh, Bm, Cm = rand(rng, (B, S, H, P)), rand(rng, (B, S, N)), rand(rng, (B, S, N))
    log_l = -np.logaddexp(0.0, rng.standard_normal((B, S, H))).astype(np.float32)
    h0 = rand(rng, (B, H, P, N)) if with_h0 else None
    j = [jnp.asarray(xh).astype(JDT[dtype]), jnp.asarray(log_l),
         jnp.asarray(Bm).astype(JDT[dtype]), jnp.asarray(Cm).astype(JDT[dtype])]
    t = [torch.from_numpy(xh).to(TDT[dtype]), torch.from_numpy(log_l),
         torch.from_numpy(Bm).to(TDT[dtype]), torch.from_numpy(Cm).to(TDT[dtype])]
    ry, rh = RM.ssd_chunked(*j, 16, h0=None if h0 is None else jnp.asarray(h0))
    py, ph = PM.ssd_chunked(*t, 16, h0=None if h0 is None else torch.from_numpy(h0))
    assert py.dtype == TDT[dtype] and ph.dtype == torch.float32
    assert max_err(py, ry) <= tol(dtype, ry, 5e-5)
    assert max_err(ph, rh) <= tol(dtype, rh, 5e-5)


def test_ssd_chunked_keeps_the_reference_assertion():
    t = torch.zeros(1, 24, 2, 8), torch.zeros(1, 24, 2), torch.zeros(1, 24, 4), torch.zeros(1, 24, 4)
    with pytest.raises(AssertionError, match="divisible"):
        PM.ssd_chunked(*t, 16)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_apply_prefill(dtype, use_kernels):
    """y against the reference's; the state returned against the reference's
    own ``ssd_chunked(...)[1]`` and ``_causal_conv(...)[1]`` on the same
    inputs, which its ``mamba2_apply`` computes and drops"""
    cfg_r, cfg_p = RM.Mamba2Config(**KW), PM.Mamba2Config(**KW)
    rp, pp = both_params(weights(), dtype)
    x = rand(np.random.default_rng(4), (B, S, KW["d_model"]))
    jx, tx = jnp.asarray(x).astype(JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])
    ry, rstate = RM.mamba2_apply(RRT, rp, jx, cfg_r)
    assert rstate is None                                  # the reference drops it
    with torch.no_grad():
        py, pstate = PM.mamba2_apply(Runtime(use_kernels=use_kernels), pp, tx, cfg_p)
    assert py.dtype == TDT[dtype]
    assert max_err(py, ry) <= tol(dtype, ry)
    conv_in, scan_in = ref_scan_inputs(rp, jx, cfg_r)
    rh = RM.ssd_chunked(*scan_in, cfg_r.chunk)[1]
    rconv = RM._causal_conv(conv_in, rp["conv_w"], rp["conv_b"])[1]
    assert pstate["h"].dtype == torch.float32 and pstate["h"].shape == (B, 4, 32, 16)
    assert max_err(pstate["h"], rh) <= tol(dtype, rh, 5e-5)
    assert pstate["conv"].dtype == TDT[dtype]
    assert max_err(pstate["conv"], rconv) <= tol(dtype, rconv, 1e-5)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_apply_decode(dtype, use_kernels, steps):
    """the token-by-token recurrence from the same state, plain on both paths"""
    cfg_r, cfg_p = RM.Mamba2Config(**KW), PM.Mamba2Config(**KW)
    rp, pp = both_params(weights(), dtype)
    rng = np.random.default_rng(5)
    x = rand(rng, (B, steps, KW["d_model"]))
    h, conv = rand(rng, (B, 4, 32, 16)), rand(rng, (B, 3, KW["d_inner"] + 2 * KW["d_state"]))
    jstate = {"h": jnp.asarray(h), "conv": jnp.asarray(conv).astype(jnp.bfloat16)}
    tstate = {"h": torch.from_numpy(h), "conv": torch.from_numpy(conv).bfloat16()}
    ry, rnew = RM.mamba2_apply(RRT, rp, jnp.asarray(x).astype(JDT[dtype]), cfg_r, state=jstate)
    with torch.no_grad():
        py, pnew = PM.mamba2_apply(Runtime(use_kernels=use_kernels), pp,
                                   torch.from_numpy(x).to(TDT[dtype]), cfg_p, state=tstate)
    assert max_err(py, ry) <= tol(dtype, ry)
    assert max_err(pnew["h"], rnew["h"]) <= tol(dtype, rnew["h"], 5e-5)
    # the bf16 state promoted with the activations, as the reference's concatenation does
    assert str(pnew["conv"].dtype).split(".")[-1] == jnp.dtype(rnew["conv"].dtype).name
    assert max_err(pnew["conv"], rnew["conv"]) <= tol(dtype, rnew["conv"], 1e-5)

