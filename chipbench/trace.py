"""The traced run: ``torch.profiler`` over the measured window, and what the
metric readers get from it.

``Trace`` starts the profiler where the window starts and stops it where
the window ends (both at a synchronised point, so every kernel recorded
ran inside the window).  ``context`` turns the profiler's events into what
``metrics/*.py`` read:

- ``kernels``: every operation that ran on the device, ``(name, start_ns,
  end_ns)``, kernels, copies and fills alike;
- ``device_spans``: the device-side ranges of the program's
  ``train.compress`` and ``train.adamw`` marks (``launch/train.run``);
- ``host_spans``: the benchmark's own marks on the host (``bench.batch.<i>``
  around each prefill batch);
- ``busy_s``: the union of the kernels' intervals.

``by_part`` is a frozen copy of ``_by_part`` of
``repro_torch/launch/profile_train.py``, and ``KINDS`` / ``kind`` of its
``KINDS`` / ``_kind``; ``by_kind`` sums device time by kind and
``breakdown`` gives the result line's ``breakdown``.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

# kinds of kernels, by a piece of their names (first match wins)
KINDS = [
    ("flash_attention", ("flash_fwd", "flash_decode", "flash_combine")),
    ("moe_dispatch", ("moe_dispatch",)),
    ("ssd_scan", ("ssd_scan",)),
    ("rwkv6_scan", ("rwkv6_scan",)),
    ("ccu_reduce", ("ccu_kernel",)),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
    ("reduction", ("reduce", "norm", "softmax", "logsumexp")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copy", ("copy", "memcpy", "memset", "fill", "cat")),
]
PARTS = ("train.compress", "train.adamw")


def kind(name: str) -> str:
    low = name.lower()
    for k, parts in KINDS:
        if any(p in low for p in parts):
            return k
    return "other"


class Trace:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()

    def context(self) -> dict:
        cuda = torch.autograd.DeviceType.CUDA
        kernels, device_spans, host_spans, host_ops = [], defaultdict(list), defaultdict(list), []
        for e in self.prof.profiler.kineto_results.events():
            name, start, dur = e.name(), e.start_ns(), e.duration_ns()
            if e.device_type() == cuda:
                if e.is_user_annotation():
                    if name in PARTS:
                        device_spans[name].append((start, start + dur))
                else:
                    kernels.append((name, start, start + dur))
            elif name.startswith("bench."):
                host_spans[name].append((start, start + dur))
            else:
                host_ops.append((name, start, start + dur))
        kernels.sort(key=lambda k: k[1])
        return {"kernels": kernels, "device_spans": dict(device_spans), "host_spans": dict(host_spans),
                "host_ops": host_ops, "busy_s": union_ns(kernels) / 1e9}


def union_ns(kernels: list) -> int:
    """The length of the union of sorted ``(name, start, end)`` intervals."""
    total, cur_s, cur_e = 0, None, None
    for _, s, e in kernels:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0)


def by_part(ctx: dict) -> dict[str, float]:
    """Device seconds of the kernels that start inside the device-side spans
    of ``train.compress`` and ``train.adamw``; every other kernel is the
    loss and its gradients (``train.grad``: the backward runs on autograd's
    own thread, outside the range as marked)."""
    spans = {name: sorted(ctx["device_spans"].get(name, [])) for name in PARTS}
    starts = {name: [a for a, _ in ss] for name, ss in spans.items()}
    parts = {"train.grad": 0.0, **{name: 0.0 for name in PARTS}}
    for _, start, end in ctx["kernels"]:
        part = "train.grad"
        for name, ss in spans.items():
            j = bisect.bisect_right(starts[name], start) - 1
            if j >= 0 and start <= ss[j][1]:
                part = name
                break
        parts[part] += (end - start) / 1e9
    return parts


def breakdown(ctx: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    between them by the innermost host operation running where each gap
    starts."""
    by_name: dict[str, float] = defaultdict(float)
    for name, s, e in ctx["kernels"]:
        by_name[name[:160]] += (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], None
    for _, s, e in ctx["kernels"]:
        if end is not None and s > end:
            gaps.append((s - end, end))
        end = e if end is None else max(end, e)
    gaps.sort(reverse=True)
    hosts = sorted((h for h in ctx["host_ops"] if not h[0].startswith("cuda")), key=lambda h: h[1])
    starts = [h[1] for h in hosts]
    by_host: dict[str, float] = defaultdict(float)
    for length, at in gaps[:200]:
        label = "no host operation"
        for j in range(bisect.bisect_right(starts, at) - 1, max(-1, bisect.bisect_right(starts, at) - 5000), -1):
            if hosts[j][2] >= at:       # the latest-starting operation that still runs: the innermost
                label = hosts[j][0]
                break
        by_host[label[:160]] += length / 1e9
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in idle]}


def by_kind(ctx: dict) -> dict[str, float]:
    """Device seconds by kind of kernel (``KINDS``)."""
    out: dict[str, float] = defaultdict(float)
    for name, s, e in ctx["kernels"]:
        out[kind(name)] += (e - s) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
