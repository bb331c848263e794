"""Device time by the program's spans, for the metric readers.

The program marks its layers for ``torch.profiler`` (``repro_torch/spans.py``):
``model.*`` ranges in the forward, their ``.recompute`` form in the remat's
recompute and ``.bwd`` form in the backward, ``<kernel>.bwd`` around a
kernel's backward, and the host loop's ``train.*`` marks.  A kernel belongs
to its innermost span: the shortest of those ranges that holds it.

``by_span(ctx)`` sums the device seconds of the trace's kernels by
innermost span name (``""`` for a kernel in none).  Where the context has
``program_spans``, every device-side range as ``(name, start_ns, end_ns)``,
a kernel is placed by its start among them.  ``trace.Trace.context`` keeps
only the device-side ranges of ``trace.PARTS``, so otherwise each kernel is
placed by its launch on the host (``launch_times``): the program runs every
operation on one stream in launch order, and the window ends at a
synchronised point, so the window's kernels, copies and fills pair off in
order with the calls of the runtime that launch their kind (``LAUNCH``),
counted back from the window's end; the span is the shortest host range of
the program (``is_span``) that holds the call.  Where they do not pair off, or the program marks no span (a
program without ``repro_torch.spans``), it returns None and so does every
reader of it.

``is_span`` and ``innermost`` are frozen copies of ``repro_torch/spans.py``'s.
"""

from __future__ import annotations

import re

_NAME = re.compile(r"[a-z][a-z0-9_]*(\.[a-z0-9_]+)+")
# the runtime and driver calls that put one operation on the device: kernels, copies, fills
LAUNCH = re.compile(r"cu(da)?(Launch(Cooperative)?Kernel|Memcpy|Memset)")


def _op(name: str, launch: bool) -> str:
    """What a launch call, or an operation on the device, is: a kernel, a
    copy or a fill."""
    if launch:
        return "copy" if "Memcpy" in name else "fill" if "Memset" in name else "kernel"
    return "copy" if name.startswith("Memcpy") else "fill" if name.startswith("Memset") else "kernel"


def is_span(name: str) -> bool:
    return _NAME.fullmatch(name) is not None


def innermost(kernels: list, ranges: list) -> list:
    """For each ``(name, start, end)`` of ``kernels``, the name of the
    shortest of ``ranges`` (``(name, start, end)``, one clock with the
    kernels) that holds the kernel's start, or None."""
    ranges = sorted(ranges, key=lambda r: r[1])
    out, open_, j = [None] * len(kernels), [], 0
    for i in sorted(range(len(kernels)), key=lambda i: kernels[i][1]):
        t = kernels[i][1]
        while j < len(ranges) and ranges[j][1] <= t:
            open_.append(ranges[j])
            j += 1
        open_ = [r for r in open_ if r[2] >= t]
        if open_:
            out[i] = min(open_, key=lambda r: r[2] - r[1])[0]
    return out


def launch_times(ctx: dict) -> list | None:
    """The host time of each operation's launch, in ``ctx["kernels"]``'s
    order: the kernels, the copies and the fills each paired off with the
    calls that launch their kind, the last operation with the last call
    (the device may start a fill a little before the kernel launched ahead
    of it, so the kinds are paired apart).  Calls left over lie at the
    window's start: the profiler drops the first operations of a window
    (on an H100 under torch 2.11, 0 to 8 of them in its first 2 ms), whose
    device times it places before the window opened.  None where the
    operations outnumber the calls."""
    calls: dict[str, list] = {}
    for name, t, _ in ctx["host_ops"]:
        if LAUNCH.match(name):
            calls.setdefault(_op(name, True), []).append(t)
    ops: dict[str, list] = {}
    for i, (name, _, _) in enumerate(ctx["kernels"]):
        ops.setdefault(_op(name, False), []).append(i)
    out = [0] * len(ctx["kernels"])
    for op, at in ops.items():
        ts = sorted(calls.get(op, ()))
        if len(ts) < len(at):
            return None
        for i, t in zip(at, ts[len(ts) - len(at):]):
            out[i] = t
    return out


def _placed(ctx: dict) -> list | None:
    """Each kernel's innermost span name (None where none holds it), in
    ``ctx["kernels"]``'s order; None where the trace cannot say."""
    kernels = ctx["kernels"]
    if "program_spans" in ctx:
        ranges = [r for r in ctx["program_spans"] if is_span(r[0])]
        at = kernels
    else:
        ranges = [h for h in ctx["host_ops"] if is_span(h[0])]
        launches = launch_times(ctx)
        if launches is None:
            return None
        at = [(k[0], t, t) for k, t in zip(kernels, launches)]
    if all(r[0].startswith("train.") for r in ranges):     # the loop's marks alone: no span of the model
        return None
    return innermost(at, ranges)


def by_span(ctx: dict) -> dict[str, float] | None:
    """Device seconds by innermost span name; None where the trace cannot
    place the kernels or the program marks no span of its model."""
    if "_by_span" not in ctx:
        names = _placed(ctx)
        out = None
        if names is not None:
            out = {}
            for (_, s, e), n in zip(ctx["kernels"], names):
                out[n or ""] = out.get(n or "", 0.0) + (e - s) / 1e9
        ctx["_by_span"] = out
    return ctx["_by_span"]


def ms_per_step(ctx: dict, keep) -> float | None:
    """Device ms a training step of the kernels whose innermost span name
    ``keep(name)`` accepts; None outside a training trace, or where the
    spans cannot be read."""
    if ctx["kind"] != "train" or not ctx["steps"]:
        return None
    spans = by_span(ctx)
    if spans is None:
        return None
    return 1e3 * sum(v for n, v in spans.items() if keep(n)) / ctx["steps"]


def us_per_prompt_token(ctx: dict, names: tuple[str, ...]) -> float | None:
    """Device µs a prompt token of the window's prefill in the spans
    ``names``; None outside a prefill trace, or where the spans cannot be
    read."""
    if ctx["kind"] != "prefill" or not ctx["batches"]:
        return None
    spans = by_span(ctx)
    if spans is None:
        return None
    tokens = sum(b * length for _, b, length in ctx["batches"])
    return 1e6 * sum(spans.get(n, 0.0) for n in names) / tokens


def counts() -> dict[str, int]:
    """The program's counters over the traced window (``repro_torch.spans``
    counts only while a profiler records); empty for a program without
    them."""
    try:
        from repro_torch import spans
    except ImportError:
        return {}
    return spans.counts()
