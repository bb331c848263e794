"""The port's benchmark: runs one cell of ``BENCHMARK.json`` once on the card
and prints one JSON line of results::

    python3 chipbench/run.py --workload granite-8b.train_4k --seed 7 --seconds 30 --trace 0

Everything a cell is made of is found by name (``registry.py``): the
workload in ``BENCHMARK.json``; its configuration in the file the entry
names, whose ``family`` picks ``models/<family>.py`` (the weight layout and
the plain reference) and ``programs/<family>.py`` (the program's model);
its traffic in ``mixes/<traffic>.json``, whose ``kind`` picks
``kinds/<kind>.py`` (how the traffic drives the program and how its output
is checked); the limits of its check in ``checks/<workload>.json``; each
end-to-end metric's reading in ``end_to_end/<name>.py`` and each per-layer
metric's in ``metrics/<name>.py``.  This file only loads and calls them.

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` runs the
same window under ``torch.profiler`` and reports its per-layer metrics, the
device's busy seconds and a breakdown.  Both check what the timed path
produced against the plain reference (``compare.py``) once the window has
closed and print each number beside its limit, as the last lines of
standard error and as the last key of the result.

Without a CUDA card, or with fewer than the cell asks for, it exits with 2
and prints no result; it never runs on the CPU.  If ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` is loaded once the window has closed,
it exits with 3 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = {**json.loads((root / conf["file"]).read_text()), "name": conf["name"]}
    mix = json.loads((root / "chipbench" / "mixes" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "chipbench" / "checks" / f"{name}.json").read_text())

    def ours(metric: dict, reported: set[str] | None = None) -> bool:
        if "workloads" in metric:
            return name in metric["workloads"]
        return reported is None or metric["moves"] in reported

    e2e = [m for m in bench["end_to_end"] if ours(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if ours(m, reported)]
    return Cell(name, w["chips"], cfg, mix, limits, e2e, layer)


def reader(kind: str, metric: str):
    from chipbench import registry

    return registry.module(kind, metric).read


@dataclass
class Run:
    kind: str
    mix: dict
    res: object
    setup_s: float


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float = T0) -> dict:
    """One run of a cell on ``device``: the window, the memory peak, the
    check against the reference, and the metrics.  Returns the result line
    as a dict (``checks`` last)."""
    import torch

    from chipbench import compare, registry
    from chipbench import trace as tracing

    kind = registry.kind(cell.mix)
    tr = tracing.Trace() if trace else None
    res = kind.window(cell, seed, seconds, device, tr)
    setup_s = res.t_start - t0
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    ctx = None
    if tr is not None:
        ctx = tr.context()
        tr = None
        ctx.update(cfg=cell.cfg, mix=cell.mix, kind=cell.mix["kind"], window_s=res.window_s,
                   **kind.trace_context(cell, res))
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    # the check, after the window and with the program's state gone
    numbers, readings = kind.check(cell, res, seed, device)
    correct, checks = compare.judge(numbers, cell.limits)

    out = {"correct": correct, "attempted": res.attempted, "failed": res.failed}
    if ctx is None:
        run = Run(cell.mix["kind"], cell.mix, res, setup_s)
        values = {m["name"]: (reader("end_to_end", m["name"])(run), m["unit"]) for m in cell.end_to_end}
    else:
        values = {m["name"]: (reader("metrics", m["name"])(ctx), m["unit"]) for m in cell.per_layer}
    out["metrics"] = {k: {"value": v, "unit": u} for k, (v, u) in values.items() if v is not None}
    out["device"] = device_info(device, cell.chips, peak)
    if ctx is not None:
        out["device"].update(busy_s=ctx["busy_s"], window_s=res.window_s)
        out["breakdown"] = tracing.breakdown(ctx)
        out["device_s_by_kind"] = tracing.by_kind(ctx)
    # every number, those the limits leave out too, before the ones compared
    out["readings"] = {"numbers": numbers, **readings}
    out["checks"] = checks
    return out


def device_info(device, chips: int, peak: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    try:
        power = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                               capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        power = "not read"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak), "power_limit": power}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    cell = load_cell(args.workload)
    os.environ["USE_FLAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"chipbench: {args.workload} needs {cell.chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}: no run on the CPU",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"chipbench: the process loaded {loaded}: the port's benchmark runs without JAX", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
