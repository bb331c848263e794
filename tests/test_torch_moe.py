"""Port of models/moe.py against the reference: ``moe_apply`` on carried
weights and one numpy input, and the routing decisions on their own.

Tolerances.  aux: 1e-6 (fp32 in both, from the same probabilities).  y:
float32 2e-5 (the same arithmetic, sums in another order); with
``dispatch_dtype="bf16"`` or a bfloat16 model, 3e-2 of the largest |y| (a
few bf16 ulps of it: both round the expert outputs to bf16 after sums taken
in different orders).  In bfloat16 the router logits are rounded to bf16
before the softmax, so two frameworks can route a near-tie apart, and one
token routed differently moves its output by O(1): the bf16 cases first
assert that every routing decision at their seed has a margin of more than
a few bf16 ulps of the logits, so that a failure of that kind names itself.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.param as ref_param
from repro.models import moe as RM
from repro.models.layers import Runtime as RefRuntime
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import moe as PM
from repro_torch.models.layers import Runtime

from _torch_parity import JDT, TDT, both, carry, routing_margin_ulps, to_np

B, D, E, FF = 2, 32, 4, 64
PREFILL_S = 16          # C = 10 (top-2) / 5 (top-1) against a mean load of 8 / 4
SEED = 12               # drops tokens in prefill; smallest bf16 routing margin 7.5 ulps
MIN_MARGIN_ULPS = 4


def configs(**kw):
    kw = dict(n_experts=E, d_ff=FF) | kw
    return RM.MoEConfig(**kw), PM.MoEConfig(**kw)


def ref_route(x, router, cfg):
    """The reference's routing, moe.py:73-88, line for line: moe_apply does
    not return it."""
    B_, S, _ = x.shape
    C = max(1, int(S * cfg.topk * cfg.capacity_factor / cfg.n_experts))
    logits = jnp.einsum("bsd,de->bse", x, router).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, cfg.topk)
    onehot = jax.nn.one_hot(gate_idx, cfg.n_experts, dtype=jnp.float32)
    flat = onehot.transpose(0, 2, 1, 3).reshape(B_, cfg.topk * S, cfg.n_experts)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(B_, cfg.topk, S, cfg.n_experts)
    pos = jnp.sum(pos.transpose(0, 2, 1, 3) * onehot, axis=-1)
    return np.asarray(logits), np.asarray(gate_idx), np.asarray(pos < C)


@functools.lru_cache(maxsize=None)
def reference(dtype, strategy, dispatch_dtype, topk, S, seed=SEED):
    rc, _ = configs(topk=topk, strategy=strategy, dispatch_dtype=dispatch_dtype)
    params = ref_param.tree_init(RM.moe_specs(D, rc), jax.random.PRNGKey(seed))
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)
    jx, _ = both(x, dtype)
    jp = ref_param.cast_floats(params, JDT[dtype])
    y, aux = RM.moe_apply(RefRuntime(rules=None), jp, jx, rc)
    logits, gate_idx, keep = ref_route(jx, jp["router"], rc)
    return dict(params=to_np(params), x=x, y=to_np(y), aux=float(aux),
                logits=logits, gate_idx=gate_idx, keep=keep)


@pytest.mark.parametrize("S", [1, PREFILL_S], ids=["decode", "prefill"])
@pytest.mark.parametrize("topk", [1, 2])
@pytest.mark.parametrize("dispatch_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("strategy", ["expert_tp", "expert_parallel"])
@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_reference(dtype, use_kernels, strategy, dispatch_dtype, topk, S):
    ref = reference(dtype, strategy, dispatch_dtype, topk, S)
    _, pc = configs(topk=topk, strategy=strategy, dispatch_dtype=dispatch_dtype)
    if dtype == "bfloat16":
        m = routing_margin_ulps(ref["logits"], topk)
        assert m > MIN_MARGIN_ULPS, (
            f"the reference's routing has a near-tie at this seed ({m:.2f} bf16 ulps "
            "between neighbouring choices): the two frameworks may route it apart")
    p = carry(ref["params"], TDT[dtype])
    x = torch.from_numpy(ref["x"]).to(TDT[dtype])

    r = PM.route(x, p["router"], pc)
    np.testing.assert_array_equal(r.gate_idx.numpy(), ref["gate_idx"], err_msg="routing differs")
    np.testing.assert_array_equal(r.keep.numpy(), ref["keep"], err_msg="capacity drops differ")
    if S == PREFILL_S:
        assert not r.keep.all(), "this prefill was meant to overflow an expert's capacity"
    else:
        assert pc.capacity(S) == 1 and r.keep.all()     # a decode step: C = 1, nothing dropped

    reset_launch_counts()
    with torch.no_grad():
        y, aux = PM.moe_apply(Runtime(use_kernels=use_kernels), p, x, pc)
    assert launch_counts()["moe_dispatch"] == 0          # CPU tensors: the plain version
    assert y.dtype == x.dtype and y.shape == x.shape and aux.dtype == torch.float32
    exact = dtype == "float32" and dispatch_dtype == "f32"
    tol = 2e-5 if exact else 3e-2 * max(1.0, float(np.abs(ref["y"]).max()))
    np.testing.assert_allclose(to_np(y), ref["y"], atol=tol, rtol=0)
    np.testing.assert_allclose(aux.item(), ref["aux"], atol=1e-6, rtol=0)


def test_kernel_and_plain_paths_agree_bitwise():
    """the dispatch is one-hot: the wrapper's plain version and the einsum
    of the plain path give the same bits, and so does the whole layer"""
    ref = reference("bfloat16", "expert_tp", "f32", 2, PREFILL_S)
    _, pc = configs(topk=2, strategy="expert_tp")
    p = carry(ref["params"], torch.bfloat16)
    x = torch.from_numpy(ref["x"]).bfloat16()
    with torch.no_grad():
        a, _ = PM.moe_apply(Runtime(use_kernels=True), p, x, pc)
        b, _ = PM.moe_apply(Runtime(use_kernels=False), p, x, pc)
    assert torch.equal(a, b)


def test_topk_ties_take_the_lower_index_first():
    """jax.lax.top_k's order among equal values, which torch.topk does not
    promise: equal router logits (a zero router) route to experts 0..K-1"""
    _, pc = configs(topk=2)
    x = torch.randn(1, 5, D)
    r = PM.route(x, torch.zeros(D, E), pc)
    assert r.gate_idx.tolist() == [[[0, 1]] * 5]
    rc, _ = configs(topk=2)
    _, gate_idx, _ = ref_route(jnp.asarray(x.numpy()), jnp.zeros((D, E)), rc)
    np.testing.assert_array_equal(r.gate_idx.numpy(), gate_idx)


def test_capacity_positions_are_k_major():
    """every token picks experts (0, 1): the k = 0 choices of all tokens take
    expert 0's slots first, then the k = 1 choices take expert 1's; with
    C = 3 the fourth token's choices are dropped and its gate values zeroed
    after the normalisation"""
    _, pc = configs(topk=2, capacity_factor=0.75 * E / 2)        # S = 4: C = 3
    router = torch.zeros(D, E)
    router[0] = torch.tensor([2.0, 1.0, 0.0, 0.0])
    x = torch.zeros(1, 4, D)
    x[..., 0] = 1.0
    r = PM.route(x, router, pc)
    assert pc.capacity(4) == 3
    assert r.pos[0].tolist() == [[0, 0], [1, 1], [2, 2], [3, 3]]
    assert r.keep[0].tolist() == [[True, True]] * 3 + [[False, False]]
    assert (r.gate_vals[0, 3] == 0).all() and torch.allclose(r.gate_vals[0, :3].sum(-1), torch.ones(3))


def test_config_and_specs_match_reference():
    for kw in [dict(n_experts=16, topk=4, d_ff=10752, strategy="expert_parallel"),
               dict(n_experts=8, topk=2, d_ff=16384, strategy="expert_tp")]:
        rc, pc = RM.MoEConfig(**kw), PM.MoEConfig(**kw)
        port = dataclasses.asdict(pc)
        # the port's own fields (an expert share, a shared expert) at the defaults that are the reference's layer
        assert {k: port.pop(k) for k in ("held", "shared_d_ff")} == {"held": None, "shared_d_ff": 0}
        assert dataclasses.asdict(rc) == port
        rs, ps = RM.moe_specs(6144, rc), PM.moe_specs(6144, pc)
        assert rs.keys() == ps.keys()
        for k in rs:
            assert (rs[k].shape, rs[k].logical, rs[k].init) == (ps[k].shape, ps[k].logical, ps[k].init)


def test_route_takes_imposed_choices():
    """route(gate_idx=...) keeps every step after the top-k: its own choices
    give back the same routing, other choices their own gate values and
    capacity positions"""
    _, pc = configs(topk=2)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 16, D)).astype(np.float32))
    router = torch.from_numpy(rng.standard_normal((D, E)).astype(np.float32))
    own = PM.route(x, router, pc)
    again = PM.route(x, router, pc, gate_idx=own.gate_idx)
    for a, b in zip(own, again):
        assert torch.equal(a, b)
    flipped = own.gate_idx.flip(-1)                              # second choice first
    r = PM.route(x, router, pc, gate_idx=flipped)
    assert torch.equal(r.gate_idx, flipped)
    kept = r.keep.float()
    np.testing.assert_allclose((r.gate_vals.sum(-1) * kept.prod(-1)).numpy(), kept.prod(-1).numpy(), atol=1e-6)
    assert not torch.equal(r.pos, own.pos)                       # k-major slots follow the order
