"""Where a training step spends its time on the GPU: runs
``repro_torch.launch.train.run`` once unprofiled and once under
``torch.profiler``, and prints the device time by part of the step (the
loss and its gradients, the compression, AdamW: the ``train.*`` ranges that
``train.run`` marks), by kind of kernel, by kernel name and by the
program's innermost span (``spans.py``: ``model.attention``,
``model.attention.recompute``, ``flash_attention.bwd``, ...), and the
device's idle share over a few warm steps, as one JSON object::

    PYTHONPATH=src python -m repro_torch.launch.profile_train --no-smoke \\
        --n-layers 8 --compression int8
    PYTHONPATH=src python -m repro_torch.launch.profile_train --arch rwkv6-1.6b \\
        --no-smoke --compression int8
    PYTHONPATH=src python -m repro_torch.launch.profile_train --arch paligemma-3b \\
        --no-smoke --compression int8

Takes the flags of ``repro_torch.launch.train`` (``--arch``, default
granite-8b, any family the port trains: paligemma-3b and whisper-base with
their stub inputs, 256 prefix embeddings or 1536 frames a sequence, drawn
each step by ``train.drawn_inputs`` from ``--seed`` + 100, as
``chip_smoke.py`` draws them; ``--steps`` is set from
``--warm`` and ``--active``) plus ``--top`` (kernels listed), ``--warm``
(steps run before the profiled ones: the first builds the kernels and warms
the allocator) and ``--active`` (steps profiled).  The idle share is given
over the profiled window's wall time, which the profiler's own host cost
lengthens, and over the fastest unprofiled warm step.  The profiled window runs
from the middle of one step to the middle of another (the profiler steps at
``train.run``'s ``observe`` hook, after the compression), so it covers
``--active`` steps' worth of work; its wall time is the host clock over it
ended by a synchronise, the profiler's own cost on the host included, and the
unprofiled run's step times are printed beside it.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile, schedule

from .. import spans
from ..configs import load
from . import train

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


def _kind(name: str) -> str:
    low = name.lower()
    for kind, parts in KINDS:
        if any(p in low for p in parts):
            return kind
    return "other"


def _is_mark(name: str) -> bool:
    return name.startswith("ProfilerStep") or spans.is_span(name)


def _by_part(events) -> tuple[dict[str, float], dict[str, float]]:
    """Device time (ms, summed over the window) by each kernel's innermost
    device-side range of the program (``spans.innermost``: ``model.*``,
    their ``.recompute`` and ``.bwd`` forms, ``<kernel>.bwd``, ``train.*``;
    "" where none holds it), and by part of the step: the kernels in
    ``train.compress`` and ``train.adamw`` (no span opens inside them), and
    every other kernel, the loss and its gradients (``train.grad``: the
    backward runs on autograd's own thread, outside the range as marked)."""
    cuda = torch.autograd.DeviceType.CUDA
    ranges, kernels = [], []
    for e in events:
        if e.device_type != cuda:
            continue
        if spans.is_span(e.name):
            ranges.append((e.name, e.time_range.start, e.time_range.end))
        elif not _is_mark(e.name):
            kernels.append((e.name, e.time_range.start, e.time_range.end))
    by_span: dict[str, float] = {}
    for (_, start, end), inner in zip(kernels, spans.innermost(kernels, ranges)):
        by_span[inner or ""] = by_span.get(inner or "", 0.0) + (end - start) / 1e3
    steps = ("train.compress", "train.adamw")
    parts = {"train.grad": sum(v for n, v in by_span.items() if n not in steps),
             **{n: by_span.get(n, 0.0) for n in steps}}
    return parts, by_span


def main(argv: list[str] | None = None) -> None:
    ap = train.build_parser()
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--warm", type=int, default=2, help="steps before the profiled ones (at least 1)")
    ap.add_argument("--active", type=int, default=2, help="steps profiled")
    args = ap.parse_args(argv)
    if torch.device(args.device).type != "cuda":
        raise SystemExit("profile_train measures the GPU: run it with --device cuda")
    args.warm = max(args.warm, 1)
    args.steps = args.warm + args.active + 1

    harness = load(args.arch, smoke=args.smoke)
    inputs = (train.drawn_inputs(harness, args.batch, args.seed + 100, args.device)
              if harness.family in ("vlm", "audio") else None)
    plain = train.run(args, inputs=inputs)
    marks = []
    sched = schedule(wait=0, warmup=args.warm, active=args.active, repeat=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], schedule=sched) as prof:
        def observe(step, loss, grads, payload, wire):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            prof.step()

        traced = train.run(args, observe=observe, inputs=inputs)

    # device-side events only: a host operator's row repeats its kernels' time,
    # and the marks (the profiler's steps, the train.* ranges) span kernels
    rows = [
        (e.self_device_time_total, e.count, e.key)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        and not _is_mark(e.key)
    ]
    if not rows:
        raise SystemExit("the profiler recorded no device time")
    parts, by_span = _by_part(prof.events())
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    wall_ms = (marks[args.warm + args.active - 1] - marks[args.warm - 1]) * 1e3
    kinds: dict[str, list] = {}
    for us, count, name in rows:
        k = kinds.setdefault(_kind(name), [0.0, 0])
        k[0] += us / 1e3 / args.active
        k[1] += count / args.active
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({
        "card": smi,
        "arch": args.arch, "smoke": args.smoke, "n_layers": args.n_layers, "batch": args.batch,
        "seq": args.seq, "compression": args.compression, "params": plain["params"],
        "unprofiled": {"step_ms": plain["step_ms"], "tokens_per_s": plain["tokens_per_s"],
                       "peak_memory_gb": plain["peak_memory_gb"], "losses": plain["losses"]},
        "profiled": {"steps": args.active, "wall_ms_per_step": wall_ms / args.active,
                     "device_busy_ms_per_step": device_ms / args.active,
                     "device_idle_share": 1 - device_ms / wall_ms, "step_ms": traced["step_ms"],
                     "device_idle_share_of_unprofiled_step":
                         1 - device_ms / args.active / min(plain["step_ms"][args.warm:])},
        "launches_per_step": {k: v / args.steps for k, v in traced["launches"].items()},
        "by_part_device_ms_per_step": {k: v / args.active for k, v in parts.items()},
        "by_span_device_ms_per_step": {k: v / args.active
                                       for k, v in sorted(by_span.items(), key=lambda kv: -kv[1])},
        "by_kind_ms_per_step": {k: {"ms": v[0], "launches": v[1], "share": v[0] * args.active / device_ms}
                                for k, v in sorted(kinds.items(), key=lambda kv: -kv[1][0])},
        "kernels_by_device_time": [
            {"name": name[:90], "calls_per_step": count / args.active, "ms_per_step": us / 1e3 / args.active,
             "share": us / 1e3 / device_ms}
            for us, count, name in rows[:args.top]
        ],
    }, indent=1))


if __name__ == "__main__":
    main()
