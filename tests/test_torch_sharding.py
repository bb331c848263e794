"""Port of the sharding half of models/param.py and of parallel/sharding.py
against the reference: partition specs (the reference's ``PartitionSpec``
as a tuple), ZeRO-1 specs, placements, abstract trees.  No process group is
needed: this is index arithmetic."""

import jax
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from jax.sharding import PartitionSpec as JP

import repro.configs as ref_configs
import repro.models.param as ref_param
import repro.parallel.sharding as ref_sharding
from repro.models.api import SHAPES as REF_SHAPES
from repro_torch import configs as port_configs
from repro_torch.models import param as P
from repro_torch.launch import mesh as M
from repro_torch.models.api import SHAPES
from repro_torch.parallel import sharding as S
from repro_torch.parallel.sharding import make_rules, zero1_pspec

ARCHS = port_configs.ARCH_IDS


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict of specs (either package's)."""
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree) for k2, v2 in _flat(tree[k], f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _as_tuples(tree):
    return {k: tuple(v) for k, v in _flat(tree).items()}


def _spec_trees(harness, cell):
    trees = {"params": harness.param_specs()}
    if harness.skip_reason(cell.name) is None:
        if cell.kind == "train":
            trees["inputs"] = harness.train_input_specs(cell)
        else:
            trees["inputs"] = harness.serve_input_specs(cell)
            trees["state"] = harness.serve_state_specs(cell)
    return trees


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_pspecs_match_reference(arch, shape, multi_pod):
    """rules_for_cell, tree_pspecs (params, inputs, serving state) and
    tree_zero1_pspecs at the production DP size: equal to the reference's,
    leaf by leaf, as tuples"""
    ref_h, port_h = ref_configs.load(arch), port_configs.load(arch)
    ref_rules = ref_sharding.rules_for_cell(ref_h, REF_SHAPES[shape], multi_pod=multi_pod)
    rules = S.rules_for_cell(port_h, SHAPES[shape], multi_pod=multi_pod)
    assert rules.rules == ref_rules.rules
    ref_trees, trees = _spec_trees(ref_h, REF_SHAPES[shape]), _spec_trees(port_h, SHAPES[shape])
    assert sorted(trees) == sorted(ref_trees)
    for name in trees:
        got = _as_tuples(P.tree_pspecs(trees[name], rules))
        assert got == _as_tuples(ref_param.tree_pspecs(ref_trees[name], ref_rules)), name
    dp = 32 if multi_pod else 16
    got = _as_tuples(S.tree_zero1_pspecs(trees["params"], rules, dp))
    assert got == _as_tuples(ref_sharding.tree_zero1_pspecs(ref_trees["params"], ref_rules, dp))
    assert any(any(e is not None for e in ps) for ps in got.values())


# ---------------------------------------------------------------------------
# tests/test_distribution.py::TestShardingRules, restated against the port
# ---------------------------------------------------------------------------


def test_train_rules_seq_shard_wins_over_ff():
    rules = make_rules(multi_pod=False, sp=True)
    # activation (batch, sp, ff_act): sp takes "model", ff dropped
    assert rules.pspec(("batch", "sp", "ff_act")) == ("data", "model")


def test_decode_rules_ff_gets_model():
    rules = make_rules(multi_pod=False, sp=False)
    assert rules.pspec(("batch", "sp", "ff_act")) == ("data", None, "model")


def test_multipod_batch_spans_pod_and_data():
    rules = make_rules(multi_pod=True, sp=True)
    assert rules.pspec(("batch", "sp", None)) == (("pod", "data"), "model")


def test_zero1_adds_dp_axis_on_free_dim():
    rules = make_rules(multi_pod=False, sp=True)
    s = P.ParamSpec((4096, 1024), ("embed_in", "ff"))
    assert zero1_pspec(s, rules, dp_size=16) == ("data", "model")


def test_zero1_skips_layer_dim():
    rules = make_rules(multi_pod=False, sp=True)
    s = P.ParamSpec((36, 4096, 1024), ("layers", "embed_in", "ff"))
    assert zero1_pspec(s, rules, dp_size=16) == (None, "data", "model")


@given(st.integers(1, 4), st.integers(1, 4))
@settings(max_examples=20, deadline=None)
def test_pspec_never_reuses_axis(a, b):
    rules = make_rules(multi_pod=True, sp=True)
    logical = ("batch", "sp", "ff_act", "vocab")[: a + b]
    spec = rules.pspec(tuple(logical))
    used = []
    for entry in spec:
        if entry is None:
            continue
        used.extend([entry] if isinstance(entry, str) else list(entry))
    assert len(used) == len(set(used))
    assert spec == tuple(ref_sharding.make_rules(multi_pod=True, sp=True).pspec(tuple(logical)))


# ---------------------------------------------------------------------------
# placements, local blocks, abstract trees, virtual kv heads
# ---------------------------------------------------------------------------


def test_placements_follow_the_mesh_order():
    """one placement a mesh dim; a dim cut by (pod, data) is Shard on both,
    and DTensor cuts it pod-major, as the spec's tuple reads; an order the
    mesh cannot express, or an axis it lacks, raises"""
    from torch.distributed.tensor import Replicate, Shard

    names = ("pod", "data", "model")
    assert P.placements((None, ("pod", "data"), "model"), names) == [Shard(1), Shard(1), Shard(2)]
    assert P.placements((), names) == [Replicate()] * 3
    assert P.placements(("model",), names) == [Replicate(), Replicate(), Shard(0)]
    with pytest.raises(ValueError, match="order"):
        P.placements((("data", "pod"),), names)
    with pytest.raises(ValueError, match="not in the mesh"):
        P.placements(("pod",), ("data", "model"))


def test_local_slices_cut_major_to_minor():
    """the block of every device under a few specs: each sharded dim in
    equal parts, indexed row-major over the entry's axes (the first the
    major one); ``tests/test_torch_collectives.py`` holds the same blocks
    against ``NamedSharding.devices_indices_map`` on eight devices"""
    sizes = {"pod": 2, "data": 4, "model": 2}
    shape = (8, 16, 4)
    for ps in [(), (("pod", "data"), "model"), (None, ("pod", "data")), ("model", None, "pod"), ("data",)]:
        for coord in np.ndindex(*sizes.values()):
            c = dict(zip(sizes, coord))
            got = S.local_slices(ps, shape, sizes, c)
            # the reference's rule: an entry's axes major to minor, row-major index
            want = []
            for dim, n in enumerate(shape):
                e = ps[dim] if dim < len(ps) else None
                names = () if e is None else (e,) if isinstance(e, str) else e
                parts = int(np.prod([sizes[a] for a in names])) if names else 1
                idx = int(np.ravel_multi_index([c[a] for a in names], [sizes[a] for a in names])) if names else 0
                want.append(slice(idx * n // parts, (idx + 1) * n // parts))
            assert got == tuple(want), (ps, c)
    with pytest.raises(ValueError, match="divide"):
        S.local_slices(("data",), (6,), sizes, {"pod": 0, "data": 0, "model": 0})


@pytest.mark.parametrize("arch", ["granite_8b", "whisper_base"])
def test_tree_abstract_matches_reference(arch):
    """meta tensors of the reference's ShapeDtypeStruct shapes and types"""
    ref = _flat(ref_param.tree_abstract(ref_configs.load(arch).param_specs(), dtype=jax.numpy.bfloat16))
    got = _flat(P.tree_abstract(port_configs.load(arch).param_specs(), dtype=torch.bfloat16))
    assert sorted(got) == sorted(ref)
    for k, t in got.items():
        assert t.device.type == "meta" and tuple(t.shape) == ref[k].shape and t.dtype == torch.bfloat16
    specs = port_configs.load(arch).train_input_specs(SHAPES["train_4k"])
    for t, s in zip(P.tree_leaves(P.tree_abstract(specs)), P.tree_leaves(specs)):
        assert t.dtype == s.dtype and tuple(t.shape) == s.shape


@pytest.mark.parametrize("n_kv", [1, 2, 4, 8, 12, 16, 20, 32, 48])
def test_virtual_kv_heads_matches_reference(n_kv):
    for tp in (8, 16):
        assert P.virtual_kv_heads(n_kv, tp) == ref_param.virtual_kv_heads(n_kv, tp)


def test_pspec_tuple_equals_partition_spec():
    """the port's spec is the reference's PartitionSpec read as a tuple"""
    rules, ref_rules = make_rules(multi_pod=True), ref_sharding.make_rules(multi_pod=True)
    for logical in [("batch", "sp", "ff_act"), ("layers", "embed_in", "ff"), ("vocab", "embed"), ()]:
        assert rules.pspec(logical) == tuple(ref_rules.pspec(logical))
        assert JP(*rules.pspec(logical)) == ref_rules.pspec(logical)


@pytest.mark.parametrize("build,shape,names", [
    (lambda: M.make_production_mesh(device_type="cpu"), (16, 16), ("data", "model")),
    (lambda: M.make_production_mesh(multi_pod=True, device_type="cpu"), (2, 16, 16), ("pod", "data", "model")),
    (lambda: M.make_smoke_mesh(2, 4, device_type="cpu"), (2, 4), ("data", "model")),
])
def test_meshes_have_the_reference_shapes(build, shape, names):
    """the reference's axis names and shapes, built over a fake process
    group of that many ranks (no processes); this rank is rank 0"""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=int(np.prod(shape)))
    try:
        mesh = build()
        assert mesh.mesh_dim_names == names and tuple(mesh.mesh.shape) == shape
        assert mesh.device_type == "cpu" and list(mesh.get_coordinate()) == [0] * len(shape)
    finally:
        dist.destroy_process_group()
