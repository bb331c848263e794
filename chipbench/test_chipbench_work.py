"""The yardstick's arithmetic against counts made by hand at small shapes."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chipbench import work  # noqa: E402

TINY = dict(hidden_size=8, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=2,
            intermediate_size=16, vocab_size=10)


@pytest.mark.parametrize("kw, pairs, keys", [
    (dict(sq=4, sk=4), 1 + 2 + 3 + 4, 4),
    (dict(sq=4, sk=4, window=2), 1 + 2 + 2 + 2, 4),
    (dict(sq=3, sk=5, causal=False), 15, 5),
    (dict(sq=1, sk=10, q_start=9), 10, 10),
    (dict(sq=1, sk=10, q_start=9, window=3), 3, 3),
    (dict(sq=2, sk=6, q_start=2), 3 + 4, 4),
])
def test_visible_pairs(kw, pairs, keys):
    sq, sk = kw.pop("sq"), kw.pop("sk")
    assert work.visible_pairs(sq, sk, **kw) == (pairs, keys)


def test_flash_work_by_hand():
    # B 2, 3 query rows causal over 3 keys: 6 pairs; N 4 heads of 8, K 2
    flops, nbytes = work.flash_work(2, 3, 3, 4, 2, 8)
    assert flops == 4 * 8 * 6 * 2 * 4
    q = 2 * 3 * 4 * 8 * 2
    assert nbytes == 2 * q + 2 * (2 * 3 * 2 * 8 * 2)


def test_moe_dispatch_and_ccu_work_by_hand():
    flops, nbytes = work.moe_dispatch_work(1, 4, 2, 3, 5, 2)
    assert flops == 2 * 4 * 2 * 5
    assert nbytes == (1 * 4 * 2 * 3 + 4 * 5 + 2 * 3 * 5) * 2
    assert work.ccu_reduce_work(100) == (200.0, 100 + 4 + 400)
    assert work.ccu_reduce_work(10, peers=2) == (40.0, 20 + 8 + 40)


def test_least_seconds_takes_the_binding_side():
    assert work.least_seconds(989e12, 0.0) == pytest.approx(1.0)
    assert work.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert work.least_seconds(989e9, 3.35e12) == pytest.approx(1.0)


def test_model_flops_by_hand():
    # a layer: q, o 8 x 8 each, k, v 8 x 4 each, the MLP 3 x 8 x 16
    per_layer = 64 + 64 + 32 + 32 + 3 * 128
    assert work.layer_matmul_params(TINY) == per_layer
    n = 2 * per_layer + 8 * 10
    attn = 4 * 2 * (1 + 2 + 3) * 1 * 4 * 2          # head_dim 2, 6 pairs, batch 1, 4 heads, 2 layers
    assert work.attention_forward_flops(TINY, 1, 3) == attn
    assert work.train_step_flops(TINY, 1, 3) == 6 * n * 3 + 3 * attn
    assert work.prefill_flops(TINY, 1, 3) == 2 * 2 * per_layer * 3 + 2 * 8 * 10 + attn


def test_moe_flops_and_capacity_by_hand():
    cfg = dict(TINY, num_local_experts=4, num_experts_per_tok=2, capacity_factor=1.25)
    assert work.layer_matmul_params(cfg) == 64 + 64 + 32 + 32 + 8 * 4 + 2 * 3 * 128
    assert work.moe_capacity(cfg, 4096) == int(4096 * 2 * 1.25 / 4)
    assert work.moe_capacity(cfg, 1) == 1
