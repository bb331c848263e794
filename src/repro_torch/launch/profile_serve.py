"""Where a served batch spends its time on the GPU: runs
``repro_torch.launch.serve.run`` once to warm up and once under
``torch.profiler``, and prints the device time by kernel name beside the
wall times, as one JSON object::

    PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch granite-8b \\
        --no-smoke --batch 4 --prompt-len 512 --gen 16

Takes the flags of ``repro_torch.launch.serve`` plus ``--top`` (kernels
listed) and ``--n-layers``, which serves the config at that depth with its
widths unchanged, for an arch whose full depth does not fit one card::

    PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch mixtral-8x22b \\
        --no-smoke --n-layers 8 --batch 4 --prompt-len 512 --gen 16

Paligemma is served with its ``prefix_tokens`` prefix embeddings and
whisper with its ``n_frames`` frames drawn from the seed (standard normal,
bf16, ``serve.stub_inputs``), as ``chip_smoke.py`` serves them.

The device's idle share is 1 - (summed kernel time / wall time) of
the profiled run's prefill and decode; the profiler's own cost on the host is
inside that wall time, so the unprofiled run's times are printed beside it.
"""

from __future__ import annotations

import json
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import load
from ..models.param import tree_init
from . import serve


def main(argv: list[str] | None = None) -> None:
    ap = serve.build_parser()
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--n-layers", type=int, default=None,
                    help="serve at this depth, widths unchanged (default: the config's)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type != "cuda":
        raise SystemExit("profile_serve measures the GPU: run it with --device cuda")

    # one set of weights for all three runs, drawn outside the profiled one
    harness = load(args.arch, smoke=args.smoke)
    if args.n_layers is not None:
        harness = harness.clone(n_layers=args.n_layers)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = tree_init(harness.param_specs(), gen, torch.bfloat16, args.device)
    inputs = serve.stub_inputs(harness, args.batch, args.seed + 2, args.device)
    serve.run(args, harness=harness, params=params, inputs=inputs)   # warm-up: builds, library set-up
    plain = serve.run(args, harness=harness, params=params, inputs=inputs)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = serve.run(args, harness=harness, params=params, inputs=inputs)

    # device-side events only: a host operator's row repeats its kernels' time
    rows = [
        (e.self_device_time_total, e.count, e.key)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    wall_ms = (traced["prefill_s"] + traced["decode_s_per_token"] * max(args.gen - 1, 1)) * 1e3
    if not rows:
        raise SystemExit("the profiler recorded no device time")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({
        "card": smi,
        "arch": args.arch, "smoke": args.smoke, "n_layers": harness.cfg.n_layers, "batch": args.batch,
        "prompt_len": args.prompt_len, "gen": args.gen,
        "inputs": {k: list(t.shape) for k, t in inputs.items()},
        "unprofiled": {"prefill_ms": plain["prefill_s"] * 1e3,
                       "decode_ms_per_token": plain["decode_s_per_token"] * 1e3},
        "profiled": {"prefill_ms": traced["prefill_s"] * 1e3,
                     "decode_ms_per_token": traced["decode_s_per_token"] * 1e3,
                     "wall_ms": wall_ms, "device_busy_ms": device_ms,
                     "device_idle_share": 1 - device_ms / wall_ms},
        "launches": traced["launches"],
        "kernels_by_device_time": [
            {"name": name[:90], "calls": count, "ms": us / 1e3, "share": us / 1e3 / device_ms}
            for us, count, name in rows[:args.top]
        ],
    }, indent=1))


if __name__ == "__main__":
    main()
