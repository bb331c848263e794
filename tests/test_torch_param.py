"""Port of models/param.py and configs/ against the reference."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.models.param as ref_param
import repro_torch.configs as port_configs
from repro_torch.models import param as P

from _torch_parity import carry, to_np

ARCHS = ["granite_8b", "phi4_mini_3_8b", "granite_3_2b", "starcoder2_7b",
         "zamba2_1_2b", "rwkv6_1_6b", "mixtral_8x22b", "dbrx_132b",
         "whisper_base", "paligemma_3b"]


def test_registry():
    """the reference's ten, in its order; an unknown id raises"""
    assert port_configs.ARCH_IDS == ARCHS == ref_configs.ARCH_IDS
    assert port_configs.CANONICAL == ref_configs.CANONICAL == {a.replace("_", "-"): a for a in ARCHS}
    with pytest.raises(ValueError, match="unknown arch"):
        port_configs.load("whisper-large")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_full_config(arch):
    """counted from the spec trees (the reference's HybridConfig has no
    param_count property; its LMConfig's counts the same tree)"""
    ref = ref_param.param_count(ref_configs.load(arch).param_specs())
    port = port_configs.load(arch)
    assert P.param_count(port.param_specs()) == ref
    if hasattr(port.cfg, "param_count"):
        assert port.cfg.param_count == ref == ref_configs.load(arch).cfg.param_count
    assert P.param_bytes(port.param_specs()) == 2 * ref
    if arch == "zamba2_1_2b":
        assert ref == 1_170_473_856
    if arch == "rwkv6_1_6b":
        assert ref == 1_584_046_080
    if arch == "whisper_base":
        assert ref == 97_355_776
    if arch == "paligemma_3b":
        assert ref == 2_432_055_296


def _port_only(fields: dict, **defaults) -> dict:
    """``fields`` without the port's own fields, each asserted to hold the
    default that keeps the reference's function."""
    assert {k: fields.pop(k) for k in defaults} == defaults
    return fields


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields(arch, smoke):
    rh, ph = ref_configs.load(arch, smoke=smoke), port_configs.load(arch, smoke=smoke)
    assert (ph.arch_id, ph.family, ph.long_context_ok, ph.moe_strategy) == (
        rh.arch_id, rh.family, rh.long_context_ok, rh.moe_strategy)
    names = [f.name for f in dataclasses.fields(rh.cfg)]
    assert names == [f.name for f in dataclasses.fields(ph.cfg)]
    for n in names:
        r, p = getattr(rh.cfg, n), getattr(ph.cfg, n)
        if n == "dtype":
            r, p = jnp.dtype(r).name, str(p).split(".")[-1]
        if n == "moe" and r is not None:        # two MoEConfig classes: field by field
            r, p = dataclasses.asdict(r), _port_only(dataclasses.asdict(p), held=None, shared_d_ff=0)
        assert r == p, (n, r, p)
    assert ph.cfg.vocab_padded == rh.cfg.vocab_padded
    if rh.family == "hybrid":                   # the derived Mamba2 config and the shared calls
        assert _port_only(dataclasses.asdict(ph.cfg.mamba), norm_before_gate=True, norm_eps=1e-6) == \
            dataclasses.asdict(rh.cfg.mamba)
        assert ph.cfg.mamba.n_heads == rh.cfg.mamba.n_heads
        assert ph.cfg.n_shared_calls == rh.cfg.n_shared_calls
        ra, pa = dataclasses.asdict(rh.cfg.attn), dataclasses.asdict(ph.cfg.attn)
        assert all(pa[k] == v for k, v in ra.items()), (ra, pa)
    if rh.family == "ssm":                      # the derived time-mix config
        assert dataclasses.asdict(ph.cfg.inner) == dataclasses.asdict(rh.cfg.inner)
        assert ph.cfg.inner.n_heads == rh.cfg.inner.n_heads
    assert ph.skip_reason("long_500k") == rh.skip_reason("long_500k")


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_match(arch):
    """same keys, shapes, logical axes, inits — params and serve state"""
    from repro.models.api import ShapeCell as RefCell
    from repro_torch.models.api import ShapeCell

    rh, ph = ref_configs.load(arch, smoke=True), port_configs.load(arch, smoke=True)
    pairs = [
        (rh.param_specs(), ph.param_specs()),
        (rh.serve_state_specs(RefCell("t", "decode", 24, 2)),
         ph.serve_state_specs(ShapeCell("t", "decode", 24, 2))),
        (rh.serve_input_specs(RefCell("t", "decode", 24, 2)),
         ph.serve_input_specs(ShapeCell("t", "decode", 24, 2))),
    ]
    for rs, ps in pairs:
        flat_r = jax.tree_util.tree_flatten_with_path(rs, is_leaf=ref_param.is_spec)[0]
        leaves_p = P.tree_leaves(ps)
        assert len(flat_r) == len(leaves_p)
        for (path, r), p in zip(flat_r, leaves_p):
            assert P.is_spec(p)
            assert (r.shape, r.logical, r.init, r.scale) == (p.shape, p.logical, p.init, p.scale), path
            assert jnp.dtype(r.dtype).name == str(p.dtype).split(".")[-1], path


def test_from_reference_roundtrip():
    h = ref_configs.load("starcoder2_7b", smoke=True)
    ref = ref_param.tree_init(h.param_specs(), jax.random.PRNGKey(0))
    ref["ids"] = jnp.arange(5, dtype=jnp.int32)
    port = carry(ref)
    flat_r = jax.tree.leaves(ref)
    flat_p = P.tree_leaves(port)
    assert len(flat_r) == len(flat_p)
    for r, p in zip(flat_r, flat_p):
        assert tuple(r.shape) == tuple(p.shape)
        np.testing.assert_array_equal(np.asarray(r), p.numpy())      # exact: by value
    assert port["ids"].dtype == torch.int32
    assert port["blocks"]["attn"]["wq"].dtype == torch.float32
    # bf16: the same rounding the reference applies
    port16 = carry(ref, torch.bfloat16)
    ref16 = ref_param.cast_floats(ref, jnp.bfloat16)
    for r, p in zip(jax.tree.leaves(ref16), P.tree_leaves(port16)):
        np.testing.assert_array_equal(to_np(r), to_np(p))
    assert port16["ids"].dtype == torch.int32


@pytest.mark.parametrize("init,mean,std", [
    ("zeros", 0.0, 0.0),
    ("ones", 1.0, 0.0),
    ("normal", 0.0, 0.02),
    ("scaled", 0.0, 1.0 / math.sqrt(64)),
])
def test_init_statistics(init, mean, std):
    gen = torch.Generator(device="cpu").manual_seed(0)
    spec = {"w": P.ParamSpec((3, 64, 512), ("layers", "a", "b"), init=init)}
    x = P.tree_init(spec, gen, device="cpu")["w"]
    assert x.shape == (3, 64, 512) and x.dtype == torch.float32
    # 98k samples: the mean is within 5 sigma / sqrt(n), the std within 2 %
    assert abs(x.mean().item() - mean) <= 5 * std / math.sqrt(x.numel()) + 1e-12
    assert abs(x.std().item() - std) <= 0.02 * std + 1e-12
    if std:
        assert not torch.equal(x[0], x[1])      # layers are drawn independently
        again = P.tree_init(spec, torch.Generator(device="cpu").manual_seed(0), device="cpu")["w"]
        assert torch.equal(x, again)            # and reproducibly from the seed


def test_tree_init_dtypes():
    gen = torch.Generator(device="cpu").manual_seed(0)
    specs = {
        "w": P.ParamSpec((4, 8), (None, None), init="scaled"),
        "tok": P.ParamSpec((2, 3), (None, None), init="zeros", dtype=torch.int32),
    }
    out = P.tree_init(specs, gen, torch.bfloat16, "cpu")
    assert out["w"].dtype == torch.bfloat16 and out["tok"].dtype == torch.int32


def test_helpers_match_reference():
    for x, m in [(1, 256), (256, 256), (257, 256), (49155, 256), (7, 3)]:
        assert P.round_up(x, m) == ref_param.round_up(x, m)
    spec = {"a": P.ParamSpec((2, 3), ("x", None), init="ones", scale=0.5)}
    st = P.stack_specs(spec, 4)["a"]
    rst = ref_param.stack_specs(
        {"a": ref_param.ParamSpec((2, 3), ("x", None), init="ones", scale=0.5)}, 4)["a"]
    assert (st.shape, st.logical, st.init, st.scale) == (rst.shape, rst.logical, rst.init, rst.scale)
    assert P.param_count(P.stack_specs(spec, 4)) == 24
    tree = {"f": torch.ones(2), "i": torch.ones(2, dtype=torch.int32)}
    cast = P.cast_floats(tree, torch.bfloat16)
    assert cast["f"].dtype == torch.bfloat16 and cast["i"].dtype == torch.int32
    assert P.cast_floats(tree, torch.float32)["f"] is tree["f"]      # no copy
    assert P.tree_map(lambda a, b: a + b, {"x": 1, "y": {"z": 2}}, {"x": 10, "y": {"z": 20}}) == {
        "x": 11, "y": {"z": 22}}
