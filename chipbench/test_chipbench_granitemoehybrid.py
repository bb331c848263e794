"""The granitemoehybrid family in the harness: its layout is the program's,
its FLOPs and the scan's work are counted as by hand, and its training
cell's check, driven through a whole run on the CPU at a tiny size (the
harness's look for a card skipped), reads a sound run as correct and each
fault, and the float8 control, as not correct against the cell's limits."""

import json
import math
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chipbench import compare, program, registry, run, scan_work, weights, work  # noqa: E402

WORKLOAD = "granite-4.0-h-small.train_4k"
FILE = json.loads((ROOT / "chipbench" / "configs" / "granite-4.0-h-small-10l.json").read_text())
# the cell's file at a tiny width: every key the family reads, the same guarantees
TINY = dict(FILE, name="tiny-granite-hybrid", hidden_size=64, layer_types=["mamba", "attention", "mamba"],
            num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2, head_dim=32, vocab_size=512,
            mamba_n_heads=8, mamba_d_head=16, mamba_d_state=16, mamba_chunk_size=32, intermediate_size=32,
            shared_intermediate_size=48, router_experts=8, num_local_experts=3, first_local_expert=2,
            num_experts_per_tok=2)
TRAIN = {"kind": "train", "batch": 2, "seq": 64, "check_steps": 3}
SEED = 3000000011


def _cell():
    limits = json.loads((ROOT / "chipbench" / "checks" / f"{WORKLOAD}.json").read_text())
    return run.Cell(WORKLOAD, 1, TINY, TRAIN, limits, [{"name": "setup_s", "unit": "s"}], [])


def _run():
    return run.run_cell(_cell(), SEED, 0.3, False, "cpu", t0=time.perf_counter())


@pytest.mark.parametrize("cfg", [FILE, TINY], ids=["cell", "tiny"])
def test_the_layout_is_the_programs(cfg):
    h = program.harness({**cfg, "name": "granite-hybrid"})       # raises where the trees differ
    assert h.cfg.moe.held == (cfg["first_local_expert"], cfg["num_local_experts"])
    assert h.cfg.moe.n_experts == cfg["router_experts"]


def test_the_cell_holds_its_published_size():
    """2.415 B parameters on the card: 10 layers, 9 of 72 experts each."""
    n = sum(math.prod(s[1]) for s in weights.leaf_specs(FILE))
    assert n == 2_414_692_992


def test_the_scan_work_by_hand():
    # B 2, S 5 in chunks of 4 (4 + 1 rows): causal pairs 10 + 1; H 3, P 2, N 4
    flops, nbytes = scan_work.ssd_scan_work(2, 5, 3, 2, 4, 4)
    assert flops == 2 * 2 * 11 * 4 + 2 * 2 * 11 * 3 * 2 + 4 * 2 * 5 * 3 * 2 * 4
    assert nbytes == 2 * (2 * 5 * 3 * 2 * 2) + 2 * 5 * 3 * 4 + 2 * (2 * 5 * 4 * 2) + 2 * 3 * 2 * 4 * 4


def test_the_step_flops_by_hand():
    """6 T N for the matrix parameters a token multiplies and three scans'
    and attention's forwards, at the tiny file's sizes."""
    D, V, B, S = 64, 512, 2, 64
    mamba = D * (2 * 128 + 2 * 16 + 8) + 128 * D
    attn = 2 * D * 128 + 2 * D * 64
    ffn = D * 8 + 2 * 3 / 8 * 3 * D * 32 + 3 * D * 48
    params = 2 * mamba + attn + 3 * ffn + D * V
    scan = scan_work.ssd_scan_work(B, S, 8, 16, 16, 32)[0]
    flash = work.flash_work(B, S, S, 4, 2, 32)[0]
    want = 6 * params * B * S + 3 * (2 * scan + flash)
    assert registry.family(TINY).train_step_flops(TINY, B, S) == pytest.approx(want, rel=1e-12)


def test_a_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]


def _state_unchanged(mp):
    from repro_torch.optim import adamw

    zero = torch.zeros(())
    mp.setattr(adamw, "apply", lambda cfg, params, grads, state: (params, state, {"grad_norm": zero, "lr": zero}))


def _half_batch(mp):
    from repro_torch.models.api import GraniteHybridHarness

    loss = GraniteHybridHarness.loss

    def halved(self, rt):
        fn = loss(self, rt)
        return lambda params, batch: fn(params, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

    mp.setattr(GraniteHybridHarness, "loss", halved)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch], ids=["state-unchanged", "half-batch"])
def test_a_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = _run()
    assert not out["correct"], out["checks"]


def test_the_control_fails_the_limits():
    """The reference in float8 put in the program's place."""
    cell = _cell()
    ok, checks = compare.judge(registry.kind(cell.mix).control(cell, SEED, "cpu"), cell.limits)
    assert not ok, checks
