"""The readers of the program's spans and counters (``spans.py`` and its
metrics) on made-up traces whose sums are worked out by hand, placed from
the host's launches and from device-side ranges alike."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chipbench import run, spans, trace  # noqa: E402

CFG = dict(hidden_size=128, num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2, head_dim=32,
           intermediate_size=256, vocab_size=512, sliding_window=None, num_local_experts=4,
           num_experts_per_tok=2, capacity_factor=1.25)
STEPS = 2
# the program's ranges on the host (ns); the backward's ranges lie inside train.grad, as autograd's thread
# runs them while the main thread waits in it
RANGES = [("train.data", 0, 10), ("train.grad", 10, 1000),
          ("model.embed", 12, 20), ("model.norm", 20, 30), ("model.attention", 30, 60), ("model.rope", 35, 40),
          ("model.moe", 60, 90), ("model.moe.route", 61, 70), ("model.unembed", 90, 95), ("model.loss", 95, 100),
          ("model.loss.bwd", 200, 210), ("model.unembed.bwd", 210, 220), ("model.moe.bwd", 220, 300),
          ("model.norm.recompute", 221, 225), ("model.attention.recompute", 225, 229),
          ("model.rope.recompute", 227, 228), ("moe_dispatch.bwd", 230, 260), ("model.moe.route.bwd", 280, 290),
          ("model.attention.bwd", 300, 400), ("flash_attention.bwd", 310, 350),
          ("train.compress", 1000, 1100), ("train.adamw", 1100, 1200)]
# each launch on the host: (call, time, the kernel's device time in ns, its innermost span)
LAUNCHES = [("cudaMemcpyAsync", 5, 3, "train.data"), ("cudaLaunchKernel", 13, 5, "model.embed"),
            ("cudaLaunchKernel", 21, 7, "model.norm"), ("cuLaunchKernel", 31, 11, "model.attention"),
            ("cudaLaunchKernel", 36, 13, "model.rope"), ("cudaLaunchKernelExC", 50, 17, "model.attention"),
            ("cudaLaunchKernel", 62, 19, "model.moe.route"), ("cudaLaunchKernel", 75, 23, "model.moe"),
            ("cudaLaunchKernel", 91, 29, "model.unembed"), ("cudaLaunchKernel", 96, 31, "model.loss"),
            ("cudaLaunchKernel", 201, 37, "model.loss.bwd"), ("cudaMemsetAsync", 211, 41, "model.unembed.bwd"),
            ("cudaLaunchKernel", 222, 43, "model.norm.recompute"),
            ("cudaLaunchKernel", 226, 47, "model.attention.recompute"),
            ("cudaLaunchKernel", 227, 53, "model.rope.recompute"), ("cudaLaunchKernel", 231, 59, "moe_dispatch.bwd"),
            ("cudaLaunchKernel", 270, 61, "model.moe.bwd"), ("cudaLaunchKernel", 281, 67, "model.moe.route.bwd"),
            ("cudaLaunchKernel", 311, 71, "flash_attention.bwd"), ("cuLaunchKernelEx", 320, 73, "flash_attention.bwd"),
            ("cudaLaunchKernel", 360, 79, "model.attention.bwd"), ("cudaLaunchKernel", 450, 83, "train.grad"),
            ("cudaLaunchKernel", 1001, 89, "train.compress"), ("cudaLaunchKernel", 1101, 97, "train.adamw")]
NOISE = [("aten::mm", 30, 55), ("autograd::engine::evaluate_function: MmBackward0", 300, 390),
         ("cudaStreamSynchronize", 990, 999), ("cudaFuncGetAttributes", 40, 41)]


def _kernels():
    """The launches' operations on the device: later than their launches,
    in their order, each after the last."""
    out, t = [], 10_000
    for i, (call, _, d, _) in enumerate(LAUNCHES):
        name = "Memcpy HtoD (Pageable -> Device)" if "Memcpy" in call else "Memset (Device)" if "Memset" in call \
            else f"kernel_{i}"
        out.append((name, t, t + d))
        t += d + 5
    return out


def _device_ranges(every_enclosing: bool):
    """The device-side range of each host range: from the first to the last
    kernel launched inside it, counting the kernels of the ranges inside it
    or its own alone."""
    out = []
    for name, s, e in RANGES:
        mine = [k for k, (_, t, _, inner) in zip(_kernels(), LAUNCHES)
                if s <= t <= e and (every_enclosing or inner == name)]
        if mine:
            out.append((name, min(k[1] for k in mine), max(k[2] for k in mine)))
    return out


def _ctx(kind="train", source="host", cfg=CFG, launches=LAUNCHES):
    ctx = {"kernels": _kernels(), "device_spans": {}, "host_spans": {}, "cfg": cfg, "kind": kind,
           "mix": {"batch": 2, "seq": 64}, "steps": STEPS, "window_s": 1.0,
           "host_ops": [(n, t, t + 2) for n, t, _, _ in launches] + RANGES + NOISE}
    if kind == "prefill":
        ctx["batches"] = [("bench.batch.0", 4, 64), ("bench.batch.1", 4, 128)]
    if source != "host":
        ctx["program_spans"] = _device_ranges(source == "every_enclosing")
    return ctx


def _ms(*names):
    return sum(d for _, _, d, inner in LAUNCHES if inner in names) / 1e6 / STEPS


@pytest.mark.parametrize("source", ["host", "innermost_only", "every_enclosing"])
def test_span_readers_sum_each_kernel_in_its_innermost_span(source):
    ctx = _ctx(source=source)
    by = spans.by_span(ctx)
    assert by == pytest.approx({inner: sum(d for _, _, d, i in LAUNCHES if i == inner) / 1e9
                                for _, _, _, inner in LAUNCHES})
    read = lambda m: run.reader("metrics", m)(ctx)   # noqa: E731
    assert read("flash_attention_bwd_ms.train") == pytest.approx(_ms("flash_attention.bwd"))
    assert read("recompute_ms.train") == pytest.approx(
        _ms("model.norm.recompute", "model.attention.recompute", "model.rope.recompute"))
    assert read("loss_ms.train") == pytest.approx(
        _ms("model.unembed", "model.loss", "model.unembed.bwd", "model.loss.bwd"))
    assert read("moe_ms.train") == pytest.approx(
        _ms("model.moe", "model.moe.route", "model.moe.bwd", "model.moe.route.bwd", "moe_dispatch.bwd"))
    assert read("data_wait_ms.train") == pytest.approx(10 / 1e6 / STEPS)
    # a prefill's forward: device µs a prompt token
    pre = _ctx("prefill", source)
    tokens = 4 * 64 + 4 * 128
    assert run.reader("metrics", "norm_us_per_token.prefill")(pre) == pytest.approx(7e-3 / tokens)
    assert run.reader("metrics", "rope_us_per_token.prefill")(pre) == pytest.approx(13e-3 / tokens)


def test_span_readers_read_nothing_outside_their_cells_or_without_spans():
    names = ["flash_attention_bwd_ms.train", "recompute_ms.train", "loss_ms.train", "moe_ms.train",
             "data_wait_ms.train", "moe_slot_fill.train", "moe_dropped.train"]
    pre = _ctx("prefill")
    for m in names:
        assert run.reader("metrics", m)(pre) is None, m
    train = _ctx()
    for m in ("norm_us_per_token.prefill", "rope_us_per_token.prefill"):
        assert run.reader("metrics", m)(train) is None, m
    dense = _ctx(cfg={k: v for k, v in CFG.items() if k != "num_local_experts"})
    for m in ("moe_ms.train", "moe_slot_fill.train", "moe_dropped.train"):
        assert run.reader("metrics", m)(dense) is None, m
    # a program that marks only its loop, as before the spans: nothing to read, nothing raised
    loop_only = _ctx()
    loop_only["host_ops"] = [h for h in loop_only["host_ops"] if not spans.is_span(h[0]) or
                             h[0] in ("train.grad", "train.compress", "train.adamw")]
    for m in names[:4]:
        assert run.reader("metrics", m)(loop_only) is None, m
    assert run.reader("metrics", "data_wait_ms.train")(loop_only) is None
    # a kernel whose launch the trace lost: the kernels cannot be placed
    lost = _ctx(launches=LAUNCHES[:3] + LAUNCHES[4:])
    assert spans.by_span(lost) is None
    assert run.reader("metrics", "recompute_ms.train")(lost) is None


def test_each_kind_of_operation_pairs_with_its_calls_from_the_end():
    """A fill that the device starts before the kernel launched ahead of it
    still pairs with its own call, and calls left over at the window's
    start (operations the profiler dropped there) change nothing after
    them."""
    ctx = _ctx()
    ks = ctx["kernels"]
    fill = next(i for i, k in enumerate(ks) if k[0].startswith("Memset"))
    ks[fill - 1], ks[fill] = ks[fill], ks[fill - 1]
    ctx["host_ops"] += [("cudaLaunchKernel", 1, 2), ("cudaMemsetAsync", 2, 3), ("cudaLaunchKernel", 3, 4)]
    assert spans.by_span(ctx) == pytest.approx(spans.by_span(_ctx()))


def test_counter_readers(monkeypatch):
    from repro_torch import spans as program

    program.reset_counts()
    ctx = _ctx()
    assert run.reader("metrics", "moe_slot_fill.train")(ctx) is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            program.count("moe.assigned", 6)
            program.count("moe.kept", torch.tensor([True, True, False, True, True, True]))
            program.count("moe.slots", 8)
    program.count("moe.kept", torch.tensor([True]))          # no profiler: not counted
    assert spans.counts() == {"moe.assigned": 12, "moe.kept": 10, "moe.slots": 16}
    assert run.reader("metrics", "moe_slot_fill.train")(ctx) == pytest.approx(100 * 10 / 16)
    assert run.reader("metrics", "moe_dropped.train")(ctx) == pytest.approx(100 * 2 / 12)
    program.reset_counts()


def test_trace_context_holds_the_host_spans_the_readers_read():
    """``Trace.context`` of a short CPU profile: its keys as they were, and
    the program's spans and marks among ``host_ops``."""
    from repro_torch import spans as program

    tr = trace.Trace()
    tr.start()
    with program.mark("train.data"):
        x = torch.ones(4, 4, requires_grad=True)
    with torch.enable_grad():
        y = program.call("model.norm", lambda t: t * 2, x)
        y.sum().backward()
    tr.stop()
    ctx = tr.context()
    assert set(ctx) == {"kernels", "device_spans", "host_spans", "host_ops", "busy_s"}
    names = {h[0] for h in ctx["host_ops"]}
    assert {"train.data", "model.norm", "model.norm.bwd"} <= names
