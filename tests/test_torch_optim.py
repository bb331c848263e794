"""Port of optim/ (``adamw``, ``compression``) against the reference, on the
same numpy-made inputs: the int8 quantiser and ``compress_grads`` in every
mode with the residual carried over three steps (q and scale bit-equal, the
payload and the residual within 1e-7), the learning-rate schedule, the
global norm, and ``adamw.apply`` over 1 and 10 steps leaf by leaf (fp32
state within 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.param as ref_param
from repro.optim import adamw as RA, compression as RC
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models.param import tree_leaves
from repro_torch.optim import adamw as PA, compression as PC

from _torch_parity import carry, max_err, rand, to_np


def grad_tree(rng, like, scale):
    """A tree of random gradients shaped as ``like`` (a numpy tree)."""
    return jax.tree.map(lambda a: rand(rng, a.shape, scale), like)


def smoke_params():
    h = ref_configs.load("granite-8b", smoke=True)
    return ref_param.tree_init(h.param_specs(), jax.random.PRNGKey(3), dtype=jnp.bfloat16)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1e-3, 0.5, 40.0])
def test_quantize_int8_bit_equal(scale):
    """q and scale bit for bit: the same max, the same division, rounding
    half to even on both sides (values placed exactly on .5 steps too)."""
    rng = np.random.default_rng(0)
    x = rand(rng, (4096,), scale)
    x[:8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5], np.float32) * (np.abs(x).max() / 127)
    rq, rs = RC.quantize_int8(jnp.asarray(x))
    pq, ps = PC.quantize_int8(torch.from_numpy(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    assert ps.item() == float(rs)
    np.testing.assert_array_equal(PC.dequantize_int8(pq, ps).numpy(), np.asarray(RC.dequantize_int8(rq, rs)))


def test_quantize_int8_all_zero():
    rq, rs = RC.quantize_int8(jnp.zeros((16,), jnp.float32))
    pq, ps = PC.quantize_int8(torch.zeros(16))
    assert ps.item() == float(rs) and not pq.any() and not np.asarray(rq).any()


@pytest.mark.parametrize("ef", [True, False])
@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_compress_grads_three_steps(mode, ef):
    """The residual carried over three steps on both sides, bf16 gradients
    (what a bf16 model's backward gives): payload and residual within 1e-7."""
    rng = np.random.default_rng(1)
    like = to_np(smoke_params())
    cfg_r, cfg_p = RC.CompressionConfig(mode=mode, ef=ef), PC.CompressionConfig(mode=mode, ef=ef)
    res_r = res_p = None
    reset_launch_counts()
    for _ in range(3):
        g = grad_tree(rng, like, 0.05)
        pay_r, res_r = RC.compress_grads(cfg_r, jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g), res_r)
        pay_p, res_p = PC.compress_grads(cfg_p, carry(g, torch.bfloat16), res_p)
        for a, b in zip(jax.tree.leaves(pay_r), tree_leaves(pay_p)):
            assert str(b.dtype).split(".")[-1] == str(a.dtype)
            assert max_err(b, a) <= 1e-7
        if mode == "int8":
            for a, b in zip(jax.tree.leaves(res_r), tree_leaves(res_p)):
                assert max_err(b, a) <= 1e-7
        else:
            assert res_r is None and res_p is None
    assert launch_counts()["ccu_reduce"] == 0      # CPU tensors: the plain version


def test_int8_payload_is_the_ccu_reduce_of_q():
    """The int8 payload of a leaf is ccu_reduce over one peer, q with its
    scale, which is dequantize_int8 bit for bit."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(2)
    g = torch.from_numpy(rand(rng, (64, 33), 0.3))
    pay = PC.compress_grads(PC.CompressionConfig(mode="int8"), {"w": g})[0]["w"]
    q, s = PC.quantize_int8(g)
    assert torch.equal(pay, PC.dequantize_int8(q, s))
    assert torch.equal(pay.reshape(-1), ops.ccu_reduce(q.reshape(1, -1), s.reshape(1)))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_compress_grads_wire_values(use_kernels):
    """``wire`` receives each leaf's int8 values and scale, the quantiser's
    bit for bit, in leaf order; the payload is the same on both paths (the
    plain path reduces through ``ccu_reduce_plain``, never the kernel)."""
    rng = np.random.default_rng(3)
    grads = {"a": torch.from_numpy(rand(rng, (64, 33), 0.3)), "b": torch.from_numpy(rand(rng, (5,), 2.0))}
    wire = []
    reset_launch_counts()
    pay = PC.compress_grads(PC.CompressionConfig(mode="int8"), grads, use_kernels=use_kernels, wire=wire)[0]
    assert launch_counts()["ccu_reduce"] == 0
    assert len(wire) == 2
    for (q, s), g, p in zip(wire, tree_leaves(grads), tree_leaves(pay)):
        rq, rs = PC.quantize_int8(g)
        assert torch.equal(q, rq) and torch.equal(s, rs)
        assert torch.equal(p, PC.dequantize_int8(q, s))


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_wire_bytes_factor(mode):
    assert PC.wire_bytes_factor(PC.CompressionConfig(mode=mode)) == RC.wire_bytes_factor(
        RC.CompressionConfig(mode=mode))


# ---------------------------------------------------------------------------
# adamw
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup,decay", [(100, 10_000), (2, 40), (10, 4), (0, 0)])
def test_schedule(warmup, decay):
    """Step by step, as ``apply`` calls it, over the warm-up, the decay and
    past its end (every 7th step of the long one)."""
    r_cfg = RA.OptConfig(lr=1e-3, warmup_steps=warmup, decay_steps=decay)
    p_cfg = PA.OptConfig(lr=1e-3, warmup_steps=warmup, decay_steps=decay)
    r_fn = jax.jit(lambda s: RA.schedule(r_cfg, s))
    last = max(decay, 12) + 5
    for step in [*range(0, last, 7 if last > 1000 else 1), last - 1]:
        r = float(r_fn(jnp.asarray(step, jnp.int32)))
        p = PA.schedule(p_cfg, torch.tensor(step, dtype=torch.int32))
        assert p.dtype == torch.float32
        assert abs(p.item() - r) <= 1e-6 * r, step


def global_norm64(tree) -> float:
    return float(np.sqrt(sum(np.sum(np.square(to_np(x).astype(np.float64))) for x in tree_leaves(tree))))


def test_global_norm():
    """The reference sums 430k squares in fp32 one after the other and lies
    1.5e-6 (relative) from the float64 norm on this draw; the port's sum lies
    within 1e-6 of it, and so within 1e-5 of the reference's."""
    rng = np.random.default_rng(4)
    g = grad_tree(rng, to_np(smoke_params()), 0.1)
    r = float(RA.global_norm(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g)))
    pg = carry(g, torch.bfloat16)
    p = float(PA.global_norm(pg))
    assert abs(p - r) <= 1e-5 * r
    assert abs(p - global_norm64(pg)) <= 1e-6 * p


def test_opt_state_specs_match_reference():
    h = ref_configs.load("granite-8b", smoke=True)
    import repro_torch.configs as port_configs

    r = RA.opt_state_specs(h.param_specs())
    p = PA.opt_state_specs(port_configs.load("granite-8b", smoke=True).param_specs())
    is_spec = lambda x: hasattr(x, "logical")   # noqa: E731
    r_leaves = jax.tree.leaves(r, is_leaf=is_spec)
    p_leaves = [p["m"], p["master"], p["step"], p["v"]]
    p_leaves = [leaf for t in p_leaves for leaf in tree_leaves(t)]
    assert [(s.shape, s.init) for s in p_leaves] == [(s.shape, s.init) for s in r_leaves]
    assert {str(s.dtype) for s in p_leaves} == {"torch.float32", "torch.int32"}


def test_init_opt_state_matches_reference():
    params = smoke_params()
    r = RA.init_opt_state(params)
    p = PA.init_opt_state(carry(params, torch.bfloat16))
    for name in ("master", "m", "v"):
        for a, b in zip(jax.tree.leaves(r[name]), tree_leaves(p[name])):
            assert b.dtype == torch.float32 and max_err(b, a) == 0.0
    assert int(p["step"]) == int(r["step"]) == 0


@pytest.mark.parametrize("grad_scale", [0.01, 0.2])       # below and above the clip norm
def test_apply_one_and_ten_steps(grad_scale):
    """bf16 params, fp32 master/m/v: after step 1 and step 10 every leaf of the
    fp32 state within 1e-6 of the reference's, the params within one bf16 ulp
    of its (a master 1e-7 apart may round to the neighbouring bf16), the lr
    within 1e-9 and the grad norm within 1e-5 (see ``test_global_norm``)."""
    rng = np.random.default_rng(5)
    r_cfg = RA.OptConfig(lr=1e-3, warmup_steps=2, decay_steps=10)
    p_cfg = PA.OptConfig(lr=1e-3, warmup_steps=2, decay_steps=10)
    r_params = smoke_params()
    p_params = carry(r_params, torch.bfloat16)
    r_state, p_state = RA.init_opt_state(r_params), PA.init_opt_state(p_params)
    r_apply = jax.jit(lambda p, g, s: RA.apply(r_cfg, p, g, s))
    like = to_np(r_params)
    for step in range(1, 11):
        g = grad_tree(rng, like, grad_scale)
        r_params, r_state, r_m = r_apply(r_params, jax.tree.map(jnp.asarray, g), r_state)
        p_params, p_state, p_m = PA.apply(p_cfg, p_params, carry(g), p_state)
        assert abs(float(p_m["grad_norm"]) - float(r_m["grad_norm"])) <= 1e-5 * float(r_m["grad_norm"])
        assert abs(float(p_m["lr"]) - float(r_m["lr"])) <= 1e-9
        if step in (1, 10):
            for name in ("master", "m", "v"):
                for a, b in zip(jax.tree.leaves(r_state[name]), tree_leaves(p_state[name])):
                    assert max_err(b, a) <= 1e-6, (name, step)
            for a, b in zip(jax.tree.leaves(r_params), tree_leaves(p_params)):
                assert b.dtype == torch.bfloat16
                ra, pb = to_np(a), to_np(b)
                assert (np.abs(pb - ra) <= 2.0 ** -7 * np.abs(ra) + 1e-30).all(), step
            assert int(p_state["step"]) == int(r_state["step"]) == step
