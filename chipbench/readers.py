"""What the per-layer metrics of ``metrics/`` share: the kernels of a
metric's list of names, and the shapes each launch ran at.

A metric reader is a file ``metrics/<metric name>.py`` with ``read(ctx) ->
float | None``.  ``ctx`` holds the trace (``trace.Trace.context``) and the
run: ``cfg`` (the configuration file), ``mix`` (the traffic file),
``kind`` (the mix's kind), ``window_s``, and what the kind's
``trace_context`` adds (``kinds/<kind>.py``):

- ``train``: ``steps`` (whole steps in the traced window) and
  ``leaf_numels`` (each gradient leaf's size, in the order the program
  compresses them);
- ``prefill``: ``batches``, ``(span name, batch, prompt length)`` of every
  batch in the window, ``host_spans`` holding each span.

A reader that finds nothing to read returns None, and the metric is left
out of the result.
"""

from __future__ import annotations

import bisect

from . import work


def kernels_named(ctx: dict, names: tuple[str, ...]) -> list:
    return [k for k in ctx["kernels"] if any(n in k[0] for n in names)]


def batch_of(ctx: dict):
    """A function from a device time (ns) to the ``(batch, length)`` of the
    prefill batch whose host span holds it (a batch ends in a synchronise,
    so each of its kernels runs inside its span)."""
    spans = sorted((ctx["host_spans"][name][0], b, length) for name, b, length in ctx["batches"])
    starts = [s[0][0] for s in spans]

    def find(t: int):
        j = bisect.bisect_right(starts, t) - 1
        if j < 0 or t > spans[j][0][1]:
            raise RuntimeError("a kernel outside every batch of the window")
        return spans[j][1], spans[j][2]

    return find


def flash_least_seconds(cfg: dict, batch: int, seq: int) -> float:
    flops, nbytes = work.flash_work(batch, seq, seq, cfg["num_attention_heads"], cfg["num_key_value_heads"],
                                    cfg["head_dim"], causal=True, window=cfg.get("sliding_window"))
    return work.least_seconds(flops, nbytes)


def roofline_percent(least_s: float, kernels: list) -> float | None:
    spent = sum(e - s for _, s, e in kernels) / 1e9
    return None if not kernels or spent <= 0 else 100.0 * least_s / spent
