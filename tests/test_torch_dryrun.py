"""The port's dry-run (``repro_torch.launch.{dryrun,hlo_stats,mesh}``,
``train_step.lower_bundle``) on the CPU.

The reference's three importable ``TestDryRunMachinery`` tests restated
against the port's copies (the ring conventions on the same triples,
``Roofline`` given the reference's TPU constants, the mesh shapes); the
analytic model FLOPs against the reference's for every arch and shape (the
reference's ``dryrun`` sets ``XLA_FLAGS`` when imported, so it runs in a
subprocess); the granite-8b smoke cell traced on a fake (data, model) =
(2, 2) group against the closed form of the scheme's collectives and
against what four gloo ranks' transports record for the same step;
probe-extrapolated counts against the full-depth trace; and granite-8b
``train_4k`` on both production meshes, its argument bytes a rank against
the closed form from the placements.  The reference's own dry-run fails on
this tree (``test_one_dryrun_cell_subprocess``), so no count is held against
its output."""

import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch

import _torch_dist
import _torch_model_axis_ranks as ranks
from repro_torch.configs import ARCH_IDS, load
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_stats import Roofline, collective_stats
from repro_torch.launch.mesh import fake_mesh, production_shape
from repro_torch.models.api import SHAPES, ShapeCell
from repro_torch.models.param import param_count, tree_leaves, tree_map, tree_pspecs
from repro_torch.optim.compression import CompressionConfig
from repro_torch.parallel import collectives
from repro_torch.parallel.collectives import hierarchical_allreduce, operand_bytes_by_axis, recording
from repro_torch.parallel.sharding import make_rules, rules_for_cell, tree_zero1_pspecs
from repro_torch.train.train_step import build_train_step, lower_bundle

from _torch_parity import one_thread  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

SMOKE = dict(arch="granite-8b", B=8, S=64, shape=(2, 2), axes=("data", "model"))


def test_collective_stats_ring_conventions():
    """the reference parser test's two collectives, as records: an fp32
    (1024, 256) all-reduce over 16 and a bf16 (512,) all-gather over 4"""
    st = collective_stats([("all-reduce", 1024 * 256 * 4, 16, ("data",)), ("all-gather", 512 * 2, 4, ("model",)),
                           ("reduce-scatter", 64, 4, ("model",)), ("collective-permute", 32, 2, ("data",))])
    assert abs(st.by_kind["all-reduce"] - 2 * 15 / 16 * 1024 * 256 * 4) < 1
    assert abs(st.by_kind["all-gather"] - 3 / 4 * 512 * 2) < 1
    assert st.by_kind["reduce-scatter"] == 3 * 64 and st.by_kind["collective-permute"] == 32
    assert st.count == 4
    assert st.by_axis["model"] == st.by_kind["all-gather"] + 3 * 64


def test_operand_bytes_from_records():
    """an all-gather's operand is its result over the group, a
    reduce-scatter's its result times the group, an all-to-all's and a
    send's its result; a group of two axes counts under both"""
    got = operand_bytes_by_axis([("all-gather", 512, 4, ("model",)), ("reduce-scatter", 64, 4, ("model",)),
                                 ("all-to-all", 96, 2, ("data",)), ("collective-permute", 32, 4, ("pod", "data"))])
    assert got == {"model": 128 + 256, "data": 96 + 32, "pod": 32}


def test_recording_only_inside_a_block():
    """a transport keeps no record outside ``recording``; inside, its
    records give back the operand bytes its counter took"""
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        fn = hierarchical_allreduce(mesh, "model", ("data",), reduce=lambda rows: rows.float().sum(0))
        x = torch.empty(10, dtype=torch.bfloat16, device="meta")
        fn(x)
        assert collectives._RECORDING == []
        wire0 = dict(fn.wire_bytes)
        with recording() as records:
            fn(x)
        assert collectives._RECORDING == []
    assert [r[0] for r in records] == ["reduce-scatter", "all-gather", "all-gather"]
    assert operand_bytes_by_axis(records) == {a: n - wire0[a] for a, n in fn.wire_bytes.items()}


def test_roofline_terms():
    """the reference's numbers given its TPU constants; an H100 SXM5's peaks
    by default"""
    r = Roofline(flops=1.97e14, hbm_bytes=8.19e11, wire_bytes=5e10, model_flops=1e14,
                 peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)
    assert abs(r.compute_s - 1.0) < 1e-6
    assert abs(r.memory_s - 1.0) < 1e-6
    assert r.collective_s == 1.0
    assert r.useful_flops_ratio == pytest.approx(0.5077, abs=1e-3)
    h = Roofline(flops=989e12, hbm_bytes=3.35e12, wire_bytes=0.0)
    assert h.compute_s == 1.0 and h.memory_s == 1.0 and h.bottleneck in ("compute", "memory")


def test_mesh_constructor_shapes():
    assert production_shape(False) == ((16, 16), ("data", "model"))
    assert production_shape(True) == ((2, 16, 16), ("pod", "data", "model"))
    for multi_pod, world in ((False, 256), (True, 512)):
        with fake_mesh(*production_shape(multi_pod)) as mesh:
            assert torch.distributed.get_world_size() == world
            assert tuple(mesh.mesh_dim_names) == production_shape(multi_pod)[1]
            assert list(mesh.get_coordinate()) == [0] * len(mesh.mesh_dim_names)


def test_analytic_model_flops_match_reference():
    code = ("import json, repro.launch.dryrun as d; from repro.configs import ARCH_IDS, load; "
            "from repro.models.api import SHAPES; "
            "print(json.dumps({f'{a}/{s}': d.analytic_model_flops(load(a), c) "
            "for a in ARCH_IDS for s, c in SHAPES.items()}))")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(want) == len(ARCH_IDS) * len(SHAPES) == 40
    for key, value in want.items():
        arch, shape = key.split("/")
        assert dryrun.analytic_model_flops(load(arch), SHAPES[shape]) == value, key


def _smoke_bundle(mesh, harness=None):
    harness = harness or load(SMOKE["arch"], smoke=True)
    return build_train_step(harness, ShapeCell("smoke", "train", SMOKE["S"], SMOKE["B"]), mesh,
                            opt_cfg=ranks.opt_cfg(), compression=CompressionConfig(mode="int8"),
                            rules=make_rules(), use_kernels=False)


@pytest.fixture(scope="module")
def smoke_trace():
    with fake_mesh(SMOKE["shape"], SMOKE["axes"]) as mesh:
        return lower_bundle(_smoke_bundle(mesh), mesh)


@pytest.fixture(scope="module")
def gloo_records(tmp_path_factory):
    return _torch_dist.spawn(ranks.records, 4, tmp_path_factory.mktemp("records"), SMOKE["shape"], SMOKE["axes"],
                             SMOKE["arch"], SMOKE["B"], SMOKE["S"], 2)


def _parts(n: int, ps: tuple, sizes: dict) -> int:
    """Elements of a rank's block: n over the sizes of the axes ``ps`` names."""
    axes = [a for e in ps if e is not None for a in ((e,) if isinstance(e, str) else e)]
    return n // math.prod(sizes[a] for a in axes)


def closed_form(harness, B: int, S: int, sizes: dict) -> dict:
    """The operand bytes one rank hands the process group in one int8 step
    of the dense family, by axis, from the shapes and the placements: on
    "model", each block's sharded weights and its K and V gathered in the
    forward and again in the recompute, the token table and the unembedding
    once, each of them reduce-scattered whole in the backward (bf16), the
    losses and the replicated leaves' gradients summed (fp32), each leaf's
    max and sum of squares gathered (fp32); on "data", each leaf's model
    shard reduce-scattered (bf16) and its fp32 sum gathered back, and each
    ZeRO-1 block gathered in the params' type."""
    cfg = harness.cfg
    rules = make_rules()
    m, d = sizes["model"], sizes["data"]
    specs = harness.param_specs()
    leaves = tree_leaves(tree_map(lambda s, ps, zs: (s, ps, zs), specs, tree_pspecs(specs, rules),
                                  tree_zero1_pspecs(specs, rules, 16)))
    kv = B // d * S * cfg.n_kv_heads * cfg.head_dim * 2          # a rank's K (or V) gathered whole, bf16
    model = data = 0
    replicated = 0
    for s, ps, zs in leaves:
        n = math.prod(s.shape)
        if any(e == "model" for e in ps):
            times = 2 if s.logical[0] == "layers" else 1           # block weights are gathered twice
            model += times * n // m * 2 + n * 2                    # the gathers, then the reduce-scatter
        else:
            replicated += n
        local = _parts(n, ps, sizes)
        chunk = -(-local // d)
        data += chunk * d * 2 + chunk * 4 + _parts(n, zs, sizes) * 2
    model += cfg.n_layers * 2 * (2 * kv // m + kv)                 # K and V: fwd + recompute, then backward
    model += (1 + replicated) * 4 + 2 * len(leaves) * 4
    return {"model": model, "data": data}


def test_smoke_cell_counts(smoke_trace, gloo_records):
    """the smoke cell's operand bytes by axis equal the closed form, and the
    trace's collectives are the gloo ranks' (kind, bytes, group, axes), one
    for one and in order; every one reached the process group through the
    transport"""
    harness = load(SMOKE["arch"], smoke=True)
    want = closed_form(harness, SMOKE["B"], SMOKE["S"], dict(zip(SMOKE["axes"], SMOKE["shape"])))
    assert smoke_trace["operand_bytes_by_axis"] == want
    assert smoke_trace["c10d_ops"] == len(smoke_trace["records"])
    for r in gloo_records:
        assert r["wire"] == want
        assert r["records"] == smoke_trace["records"]
    # its argument bytes: each leaf's block under its placement
    mem = smoke_trace["memory"]
    assert mem["argument_bytes"] == argument_bytes(harness, ShapeCell("s", "train", SMOKE["S"], SMOKE["B"]),
                                                   make_rules(), dict(zip(SMOKE["axes"], SMOKE["shape"])), 16)
    assert mem["peak_bytes"] >= mem["argument_bytes"] and mem["alias_bytes"] > 0


def test_extrapolation_is_exact():
    """f1 + (L - 1)(f2 - f1) from 1- and 2-layer probes equals the trace
    at the full depth: every layer counts alike in the eager trace"""
    harness = load(SMOKE["arch"], smoke=True).clone(n_layers=5)
    cell = ShapeCell("smoke", "train", SMOKE["S"], SMOKE["B"])
    with fake_mesh(SMOKE["shape"], SMOKE["axes"]) as mesh:
        ext = dryrun.extrapolated_metrics(harness, cell, mesh, False)
        full = dryrun._probe_metrics(harness, cell, mesh, False)
    for k in ("flops", "hbm", "wire"):
        assert ext[k] == full[k] > 0, k
    assert ext["operand_bytes_by_axis"] == full["operand_bytes_by_axis"]
    assert ext["by_kind"] == full["by_kind"]


def argument_bytes(harness, cell, rules, sizes: dict, dp_size: int) -> int:
    """A rank's params (bf16), ZeRO-1 optimizer state (fp32 master, m, v
    and the int32 step) and inputs, each leaf divided over its placement."""
    specs = harness.param_specs()
    n = sum(_parts(math.prod(s.shape), ps, sizes) * 2
            for s, ps in zip(tree_leaves(specs), tree_leaves(tree_pspecs(specs, rules))))
    zero = tree_leaves(tree_zero1_pspecs(specs, rules, dp_size))
    n += 3 * sum(_parts(math.prod(s.shape), ps, sizes) * 4 for s, ps in zip(tree_leaves(specs), zero)) + 4
    inputs = harness.train_input_specs(cell)
    n += sum(_parts(math.prod(s.shape), ps, sizes) * s.dtype.itemsize
             for s, ps in zip(tree_leaves(inputs), tree_leaves(tree_pspecs(inputs, rules))))
    return n


@pytest.mark.parametrize("multi_pod", [False, True])
def test_granite_train_4k_on_the_production_mesh(multi_pod):
    """one full-depth trace a mesh (no probes: ``test_extrapolation_is_exact``
    holds them): "ok", the reference's record keys and the port's, the
    argument bytes a rank from the placements"""
    rec = dryrun.run_cell("granite-8b", "train_4k", multi_pod, probes=False)
    assert rec["status"] == "ok" and rec["path"] == "plain"
    for key in ("memory", "cost", "collectives", "roofline", "params"):
        assert key in rec
    assert {"by_kind", "by_axis", "operand_bytes_by_axis"} <= set(rec["collectives"])
    shape, axes = production_shape(multi_pod)
    harness = load("granite-8b")
    rules = rules_for_cell(harness, SHAPES["train_4k"], multi_pod=multi_pod)
    want = argument_bytes(harness, SHAPES["train_4k"], rules, dict(zip(axes, shape)), 32 if multi_pod else 16)
    assert rec["memory"]["argument_bytes"] == want
    assert rec["params"] == param_count(harness.param_specs())
    # the model axis carries the weights' gathers: tens of GB a step; the data axis the DP sync
    by_axis = rec["collectives"]["operand_bytes_by_axis"]
    assert by_axis["model"] > 10 * by_axis["data"] > 0
    assert rec["collectives"]["c10d_ops"] == rec["collectives"]["count"]


def test_cells_not_ported_are_skipped():
    """only the reference's own reason skips a cell: the 14 ``long_500k``
    cells of full-attention archs on both meshes, with its ``skip_reason``;
    the dry-run has no reason of its own any more, so every other cell of
    the 80 (66, the SSM, hybrid and audio families' 22 among them) is
    built (``tests/test_torch_dryrun_families.py`` traces them at smoke
    size)"""
    assert not hasattr(dryrun, "not_ported") and not hasattr(dryrun, "NOT_PORTED")
    skipped = 0
    for arch in ARCH_IDS:
        for shape in SHAPES:
            reason = load(arch).skip_reason(shape)
            if reason is None:
                continue
            for multi_pod in (False, True):
                rec = dryrun.run_cell(arch, shape, multi_pod)
                assert rec["status"] == "skipped" and rec["reason"] == reason
                skipped += 1
    assert skipped == 14 and len(ARCH_IDS) * len(SHAPES) * 2 - skipped == 66


# ---------------------------------------------------------------------------
# the dense family's decode, and the MoE and VLM families, on the model axis
# ---------------------------------------------------------------------------

DECODE = dict(arch="granite-8b", B=8, L=64)


def _serve_bundle(mesh, harness, cell):
    from repro_torch.train.train_step import build_serve_step

    rules = make_rules(sp=cell.kind != "decode", moe_strategy=harness.moe_strategy)
    return build_serve_step(harness, cell, mesh, rules=rules, use_kernels=False)


@pytest.mark.parametrize("arch", ["granite-8b", "starcoder2-7b", "paligemma-3b"])
def test_decode_cell_counts(arch):
    """a decode cell on a fake (data, model) = (2, 2) group: its operand
    bytes on "model" equal the closed form of the tensor-parallel step
    (``tests/test_torch_model_axis_decode.decode_model_bytes``, bf16
    activations): each layer's gathered q/k/v columns and log-sum-exps, its
    reduce-scatter of the partial outputs and its two sums, the
    embedding's columns and the logits; nothing on "data"; the trace
    writes the cell's last position"""
    from test_torch_model_axis_decode import decode_model_bytes

    from repro_torch.train.train_step import decode_position

    harness = load(arch, smoke=True)
    cell = ShapeCell("d", "decode", DECODE["L"], DECODE["B"])
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        low = lower_bundle(_serve_bundle(mesh, harness, cell), mesh)
    assert low["operand_bytes_by_axis"] == {"model": decode_model_bytes(harness.cfg, DECODE["B"] // 2, 2, 2)}
    assert low["c10d_ops"] == len(low["records"]) == 5 * harness.cfg.n_layers + 2
    assert decode_position(harness, cell) == DECODE["L"] - 1


def test_moe_and_vlm_cells_trace():
    """the MoE family's train cell on a fake (2, 2) group records the same
    collectives, one for one and in order, as four gloo ranks' transports
    record in a warm step (``expert_tp``: the buffer and the expert
    outputs summed over "model", the experts' d_model dim gathered over
    "data"); the VLM family's train, prefill and decode cells trace"""
    harness = load("mixtral-8x22b", smoke=True)
    with fake_mesh(SMOKE["shape"], SMOKE["axes"]) as mesh:
        bundle = build_train_step(harness, ShapeCell("smoke", "train", SMOKE["S"], SMOKE["B"]), mesh,
                                  opt_cfg=ranks.opt_cfg(), compression=CompressionConfig(mode="int8"),
                                  rules=make_rules(moe_strategy="expert_tp"), use_kernels=False)
        low = lower_bundle(bundle, mesh)
        vlm = load("paligemma-3b", smoke=True)
        for cell in (ShapeCell("t", "train", 24, 8), ShapeCell("p", "prefill", 24, 8),
                     ShapeCell("d", "decode", 24, 8)):
            b = (build_train_step(vlm, cell, mesh, opt_cfg=ranks.opt_cfg(), rules=make_rules(), use_kernels=False)
                 if cell.kind == "train" else _serve_bundle(mesh, vlm, cell))
            assert lower_bundle(b, mesh)["operand_bytes_by_axis"]["model"] > 0
    assert low["c10d_ops"] == len(low["records"])
    assert {r[0] for r in low["records"]} >= {"all-gather", "reduce-scatter"}
    recs = _torch_dist.spawn(ranks.records, 4, _spawn_dir("moe_records"), SMOKE["shape"], SMOKE["axes"],
                             "mixtral-8x22b", SMOKE["B"], SMOKE["S"], 2)
    for r in recs:
        assert r["records"] == low["records"]
        assert r["wire"] == low["operand_bytes_by_axis"]


def _spawn_dir(name):
    import tempfile

    return tempfile.mkdtemp(prefix=f"dryrun_{name}_")


@pytest.mark.parametrize("arch, shape", [("granite-8b", "decode_32k"), ("dbrx-132b", "decode_32k"),
                                         ("paligemma-3b", "train_4k")])
def test_extrapolation_is_exact_on_the_new_cells(arch, shape):
    """the probes at 1 and 2 layers extrapolate exactly to 4 layers for a
    decode cell, an MoE cell and a VLM cell on a fake (2, 2) group"""
    harness = load(arch, smoke=True).clone(n_layers=4)
    cell = dataclasses.replace(SHAPES[shape], seq_len=64, global_batch=8)
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        ext = dryrun.extrapolated_metrics(harness, cell, mesh, False)
        full = dryrun._probe_metrics(harness, cell, mesh, False)
    for k in ("flops", "hbm", "wire"):
        assert ext[k] == full[k] > 0, k
    assert ext["operand_bytes_by_axis"] == full["operand_bytes_by_axis"]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_granite_decode_32k_on_the_production_mesh(multi_pod):
    """granite-8b decode_32k on both production meshes: "ok", its
    model-axis operand bytes a step the closed form (36 layers of about
    0.2 MB: activations only), below a hundredth of the rank's parameter
    bytes"""
    from test_torch_model_axis_decode import decode_model_bytes

    rec = dryrun.run_cell("granite-8b", "decode_32k", multi_pod, probes=False)
    assert rec["status"] == "ok"
    harness = load("granite-8b")
    dp = 32 if multi_pod else 16
    by_axis = rec["collectives"]["operand_bytes_by_axis"]
    assert by_axis["model"] == decode_model_bytes(harness.cfg, 128 // dp, 16, 2)
    rules = rules_for_cell(harness, SHAPES["decode_32k"], multi_pod=multi_pod)
    specs = harness.param_specs()
    shape, axes = production_shape(multi_pod)
    params = sum(_parts(math.prod(s.shape), ps, dict(zip(axes, shape))) * 2
                 for s, ps in zip(tree_leaves(specs), tree_leaves(tree_pspecs(specs, rules))))
    assert by_axis["model"] < params / 100
