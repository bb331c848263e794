"""The reader of ``flash_attention_bwd_roofline.train`` on the made-up traces
of ``test_chipbench_spans.py``: the least time of every layer's backward
(twice the forward's operations and bytes) over the device time a step in
the ``flash_attention.bwd`` span."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chipbench import readers, run, spans  # noqa: E402
from chipbench.test_chipbench_spans import CFG, _ctx, _ms  # noqa: E402

NAME = "flash_attention_bwd_roofline.train"


@pytest.mark.parametrize("source", ["host", "innermost_only", "every_enclosing"])
def test_bwd_roofline_reads_the_backward_span_against_twice_the_forward(source):
    ctx = _ctx(source=source)
    least = CFG["num_hidden_layers"] * 2 * readers.flash_least_seconds(CFG, 2, 64)
    assert run.reader("metrics", NAME)(ctx) == pytest.approx(100 * least / (_ms("flash_attention.bwd") / 1e3))
    deeper = _ctx(source=source, cfg=dict(CFG, num_hidden_layers=3))
    assert run.reader("metrics", NAME)(deeper) == pytest.approx(3 * run.reader("metrics", NAME)(ctx))


def test_bwd_roofline_reads_nothing_outside_training_or_without_spans():
    assert run.reader("metrics", NAME)(_ctx("prefill")) is None
    loop_only = _ctx()
    loop_only["host_ops"] = [h for h in loop_only["host_ops"] if not spans.is_span(h[0]) or
                             h[0] in ("train.grad", "train.compress", "train.adamw")]
    assert run.reader("metrics", NAME)(loop_only) is None
