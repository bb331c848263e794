"""The readings that a cell's limits are set from, made on the card at the
cell's own size, in one process::

    python3 chipbench/control.py --workload granite-8b.train_4k --seeds 11,12,13 \\
        --control-seeds 21,22,23 --fault-seeds 31,32,33 --seconds 3

For each of ``--seeds``: one run of the program as the benchmark makes it
(``run.run_cell``, a short window), its numbers compared with the
reference's.  For each of ``--control-seeds``: the control, the reference
computed in float8 (``precision="fp8"``: the precision below the bf16 that
the configurations state) put in the program's place and compared by the
same numbers (the cell's kind's ``control``).  For each of
``--fault-seeds``: each of the kind's ``FAULTS`` planted in the float32
reference put in the program's place.  Prints one JSON line a reading.  The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="", help="each of the kind's FAULTS at these seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from chipbench import registry, run

    if not torch.cuda.is_available():
        print("chipbench.control measures on the card: no CUDA device", file=sys.stderr)
        return 2
    cell = run.load_cell(args.workload)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    faults = [int(s) for s in args.fault_seeds.split(",") if s]
    for seed in seeds:
        t = time.perf_counter()
        out = run.run_cell(cell, seed, args.seconds, False, device, t0=t)
        print(json.dumps({"workload": cell.name, "side": "program", "seed": seed, "correct": out["correct"],
                          "readings": out["readings"],
                          "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                          "memory_peak_bytes": out["device"]["memory_peak_bytes"],
                          "seconds": time.perf_counter() - t}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    kind = registry.kind(cell.mix)
    for side, fault, todo in [("control", None, controls)] + [(f, f, faults) for f in kind.FAULTS]:
        for seed in todo:
            t = time.perf_counter()
            numbers = kind.control(cell, seed, device, fault)
            print(json.dumps({"workload": cell.name, "side": side, "seed": seed, "numbers": numbers,
                              "seconds": time.perf_counter() - t}), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
