"""The check that decides ``correct``, driven through a whole run on the CPU
at a tiny size (the harness's look for a card skipped), with the timed path
broken underneath: each fault a cell can have comes out not correct, and the
sound run and the control read as they should against the cells' limits.
An update that moves the other way keeps every norm of a sound step and is
seen by the change's elementwise distance alone."""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chipbench import compare, registry, run  # noqa: E402

OPT = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "warmup_steps": 10,
       "min_lr_ratio": 0.1, "clip_norm": 1.0, "grad_dtype": "bfloat16"}
DENSE = dict(name="tiny-dense", family="decoder", attention_bias=True, hidden_size=128, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             head_dim=32, intermediate_size=256, vocab_size=512, rms_norm_eps=1e-6, rope_theta=10000.0,
             sliding_window=None, remat_policy="nothing", training={"compression": "int8", "optimizer": OPT})
MOE = dict(DENSE, name="tiny-moe", attention_bias=False, num_local_experts=4, num_experts_per_tok=2,
           capacity_factor=1.25, router_aux_loss_coef=0.001, sliding_window=32, training={"compression": "none", "optimizer": OPT})
TRAIN = {"kind": "train", "batch": 2, "seq": 64, "check_steps": 3}
PREFILL = {"kind": "prefill", "batch": 2, "lengths": [16, 32], "gen": 1, "max_batches": 100000,
           "check_batches": {"16": 2, "32": 1}}
SEED = 3000000007


def _limits(workload):
    return json.loads((ROOT / "chipbench" / "checks" / f"{workload}.json").read_text())


def _cell(cfg, mix, workload):
    return run.Cell(workload, 1, cfg, mix, _limits(workload), [{"name": "setup_s", "unit": "s"}], [])


def _run(cell):
    return run.run_cell(cell, SEED, 0.3, False, "cpu", t0=time.perf_counter())


CELLS = {"dense": (DENSE, TRAIN, "granite-8b.train_4k"), "moe": (MOE, TRAIN, "mixtral-8x22b.train_4k"),
         "prefill": (DENSE, PREFILL, "granite-8b.prefill")}


@pytest.mark.parametrize("which", sorted(CELLS))
def test_a_sound_run_is_correct(which):
    out = _run(_cell(*CELLS[which]))
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


def _state_unchanged(mp):
    from repro_torch.optim import adamw

    zero = torch.zeros(())
    mp.setattr(adamw, "apply", lambda cfg, params, grads, state: (params, state, {"grad_norm": zero, "lr": zero}))


def _half_batch(mp):
    from repro_torch.models.api import TransformerHarness

    loss = TransformerHarness.loss

    def halved(self, rt):
        fn = loss(self, rt)
        return lambda params, batch: fn(params, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

    mp.setattr(TransformerHarness, "loss", halved)


def _update_flipped(mp):
    """Every update moves the other way: the norms of the gradients and of
    the change are those of a sound step."""
    from repro_torch.optim import adamw

    apply = adamw.apply
    mp.setattr(adamw, "apply", lambda cfg, params, grads, state: apply(
        cfg, params, {k: _neg(v) for k, v in grads.items()}, state))


def _neg(tree):
    return {k: _neg(v) for k, v in tree.items()} if isinstance(tree, dict) else -tree


def _token_altered(mp):
    from repro_torch.models.api import TransformerHarness

    prefill = TransformerHarness.prefill

    def altered(self, rt):
        fn = prefill(self, rt)

        def g(*args, **kw):
            logits, cache = fn(*args, **kw)
            logits = logits.clone()
            logits[:, -1, 7] += 100.0        # every prompt's first token becomes 7
            return logits, cache

        return g

    mp.setattr(TransformerHarness, "prefill", altered)


@pytest.mark.parametrize("which, fault", [
    ("dense", _state_unchanged), ("dense", _half_batch), ("dense", _update_flipped),
    ("moe", _state_unchanged), ("moe", _half_batch), ("moe", _update_flipped),
    ("prefill", _token_altered),
], ids=["dense-state-unchanged", "dense-half-batch", "dense-update-flipped", "moe-state-unchanged",
        "moe-half-batch", "moe-update-flipped", "prefill-token-altered"])
def test_a_fault_is_not_correct(which, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(_cell(*CELLS[which]))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("which", sorted(CELLS))
def test_the_control_fails_the_limits(which):
    """The reference in float8 put in the program's place."""
    cell = _cell(*CELLS[which])
    ok, checks = compare.judge(registry.kind(cell.mix).control(cell, SEED, "cpu"), cell.limits)
    assert not ok, checks
