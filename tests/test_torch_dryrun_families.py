"""The dry-run (``launch/dryrun.py``, ``train_step.lower_bundle``) of the
SSM, hybrid and audio families on the "model" axis, at smoke size on fake
process groups.

A decode step's operand bytes on "model" against the closed form of each
family's tensor-parallel scheme, from the shapes alone (activations only:
no term is a weight): rwkv6's two sums a layer (``wo``'s partial output and
``ln_out``'s sums of squares) and the channel mix's reduce-scatter of
``vv`` and gather of the product; zamba2's gathered ``in_proj`` product, its
two sums a layer and the shared block's dense terms; whisper's dense self-
attention terms, the cross-attention's ``wo`` sum and, where a head's
columns lie on two ranks, its partial scores summed over the pair; the
same closed forms equal each family's decode_32k cell on (16, 16).
zamba2's train cell traced on a fake (2, 2) group records the same
collectives, one for one, as four gloo ranks' transports record in a warm
step.  And the SSM and hybrid families' probe fits
(``extrapolated_metrics``) against the full trace: exact for the SSM
family, within a relative 1e-12 for the hybrid family's ``numpy.polyfit``."""

import dataclasses
import tempfile

import pytest

import _torch_dist
import _torch_model_axis_ranks as ranks
from repro_torch.configs import load
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models.api import SHAPES, ShapeCell
from repro_torch.optim.compression import CompressionConfig
from repro_torch.parallel.sharding import make_rules
from repro_torch.train.train_step import build_serve_step, build_train_step, lower_bundle

from _torch_parity import one_thread  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

B, L = 8, 64          # a decode cell's global batch and cache


def _all_reduce(n: int, m: int, itemsize: int) -> int:
    """Operand bytes of ``AxisGroup.all_reduce`` of n elements: the
    reduce-scatter's exchange of the zero-padded (m, ceil(n/m)) rows, then
    the all-gather of one row."""
    c = -(-n // m)
    return (m * c + c) * itemsize


def _dense_layer(cfg, b: int, m: int, s: int) -> int:
    """A dense decode layer's attention and MLP on the model axis
    (``tests/test_torch_model_axis_decode.decode_model_bytes``'s layer)."""
    N, K, Dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    return b * ((N + 2 * K) * Dh // m * s + N * 4 + N * Dh * s + 2 * D * s)


def decode_model_bytes(harness, b: int, m: int, s: int = 2) -> int:
    """The operand bytes a rank hands "model" in one decode step of the
    SSM, hybrid or audio family, ``b`` sequences a rank, ``m`` model ranks,
    activations of ``s`` bytes."""
    cfg = harness.cfg
    D, V = cfg.d_model, cfg.vocab_padded
    ends = b * (D + V) // m * s                     # the embedding's columns, the logits' vocabulary shard
    if harness.family == "ssm":
        layer = _all_reduce(b, m, 4) + _all_reduce(b * D, m, s) + b * D * s + b * D // m * s
        return cfg.n_layers * layer + ends
    if harness.family == "hybrid":
        mc = cfg.mamba
        W = 2 * mc.d_inner + 2 * mc.d_state + mc.n_heads
        mamba = b * W // m * s + _all_reduce(b, m, 4) + _all_reduce(b * D, m, s)
        return cfg.n_layers * mamba + cfg.n_shared_calls * _dense_layer(cfg, b, m, s) + ends
    N, K, Dh, T = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_frames
    self_attn = b * ((N + 2 * K) * Dh // m * s + N * 4 + N * Dh * s + D * s)
    cross = b * D * s + (0 if K % m == 0 else b * T * 4)          # wo's sum; split heads: the pair's scores
    return cfg.n_layers * (self_attn + cross + b * D * s) + ends


def _decode_low(arch: str, shape: tuple):
    harness = load(arch, smoke=True)
    cell = ShapeCell("d", "decode", L, B)
    with fake_mesh(shape, ("data", "model")) as mesh:
        return harness, lower_bundle(build_serve_step(harness, cell, mesh, rules=make_rules(sp=False),
                                                      use_kernels=False), mesh)


@pytest.mark.parametrize("arch, shape", [("rwkv6-1.6b", (2, 2)), ("zamba2-1.2b", (2, 2)), ("whisper-base", (2, 2)),
                                         ("whisper-base", (1, 4))])
def test_decode_cell_counts(arch, shape):
    """a decode cell's operand bytes on "model" equal the closed form
    (bf16 activations), nothing on "data", every collective through the
    transports; on (1, 4) whisper's cross-attention sums its scores over
    pairs of ranks (groups of 2)"""
    harness, low = _decode_low(arch, shape)
    data, m = shape
    assert low["operand_bytes_by_axis"] == {"model": decode_model_bytes(harness, B // data, m)}
    assert low["c10d_ops"] == len(low["records"])
    assert ({r[2] for r in low["records"]} == {2, 4}) == (shape == (1, 4))


def test_zamba2_train_cell_matches_gloo_ranks():
    """zamba2's train cell on a fake (2, 2) group records the same
    collectives, one for one and in order, as four gloo ranks' transports
    record in a warm step; ``in_proj`` is gathered whole over "model" (its
    column blocks do not line up with the heads) and the sums of squares of
    ``out_norm`` are summed there"""
    harness = load("zamba2-1.2b", smoke=True)
    Bt, S = 8, 64
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        bundle = build_train_step(harness, ShapeCell("smoke", "train", S, Bt), mesh, opt_cfg=ranks.opt_cfg(),
                                  compression=CompressionConfig(mode="int8"), rules=make_rules(), use_kernels=False)
        low = lower_bundle(bundle, mesh)
    W = 2 * harness.cfg.mamba.d_inner + 2 * harness.cfg.mamba.d_state + harness.cfg.mamba.n_heads
    in_proj = harness.cfg.d_model * W // 2 * 2                    # a rank's block, bf16
    gathers = [r for r in low["records"] if r[0] == "all-gather" and r[1] == 2 * in_proj]
    assert len(gathers) == 2 * harness.cfg.n_layers                # forward and the remat's recompute
    recs = _torch_dist.spawn(ranks.records, 4, tempfile.mkdtemp(prefix="dryrun_zamba2_"), (2, 2),
                             ("data", "model"), "zamba2-1.2b", Bt, S, 2)
    for r in recs:
        assert r["records"] == low["records"]
        assert r["wire"] == low["operand_bytes_by_axis"]


@pytest.mark.parametrize("arch, shape, layers, seq", [("rwkv6-1.6b", "prefill_32k", 3, 1024),
                                                      ("zamba2-1.2b", "prefill_32k", 13, 2048)])
def test_probe_fits_against_the_full_trace(arch, shape, layers, seq):
    """the SSM family's probes at L in {1, 2} and S in {256, 512}
    extrapolate exactly to (3, 1024); the hybrid family's at L in {6, 7, 8}
    and S in {256, 512, 1024} (the shared block's quadratic fit) to (13,
    2048, two shared calls) within a relative 1e-12 (``numpy.polyfit``'s
    rounding), the bytes by axis too"""
    harness = load(arch, smoke=True).clone(n_layers=layers)
    if arch == "zamba2-1.2b":
        harness = harness.clone(share_every=6)
    cell = dataclasses.replace(SHAPES[shape], seq_len=seq, global_batch=4)
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        ext = dryrun.extrapolated_metrics(harness, cell, mesh, False)
        full = dryrun._probe_metrics(harness, cell, mesh, False)
    tol = 0.0 if arch == "rwkv6-1.6b" else 1e-12
    for k in ("flops", "hbm", "wire"):
        assert full[k] > 0 and abs(ext[k] - full[k]) <= tol * full[k], k
    for a, n in full["operand_bytes_by_axis"].items():
        assert abs(ext["operand_bytes_by_axis"][a] - n) <= tol * n, a


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b", "whisper-base"])
def test_decode_32k_on_the_production_mesh(arch):
    """decode_32k on (16, 16): "ok", its model-axis operand bytes a step
    the closed form of its layout (8 sequences a rank; whisper's 8 heads on
    16 ranks, each head's scores summed over a pair), no weight gathered
    over "model": the largest collective is an activation's"""
    rec = dryrun.run_cell(arch, "decode_32k", False, probes=False)
    assert rec["status"] == "ok"
    harness = load(arch)
    assert rec["collectives"]["operand_bytes_by_axis"] == {"model": decode_model_bytes(harness, 128 // 16, 16)}
