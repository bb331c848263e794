"""Traffic of the kind ``prefill``: a prefill pool, a closed loop with one
batch of a mix's ``batch`` prompts in flight, sent to the program's
``launch/serve.run`` one batch a call.  Each batch's prompt length comes
from whole rounds of the mix's ``lengths``, each round in an order drawn
from the seed (``data.prefill_schedule``), so every seed does the same work.

``window`` warms every length once, then sends batches until ``seconds``
have passed.  ``check`` runs the plain reference after the window over
whole batches of it drawn from the seed, ``check_batches[length]`` of each
length, every row of each (``compare.sample_batches``).
"""

from __future__ import annotations

import argparse
import time
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from chipbench import compare, data, program, reference, weights

FAULTS = ()


@dataclass
class Result:
    lengths: list = field(default_factory=list)       # a batch's prompt length, in the window's order
    seeds: list = field(default_factory=list)         # a batch's prompt seed
    ttft_s: list = field(default_factory=list)        # a batch's submission to its first token
    tokens: list = field(default_factory=list)        # (B,) the served token of each prompt
    logits: list = field(default_factory=list)        # (B, vocab) what each was chosen from
    batch: int = 0
    t_start: float = 0.0
    window_s: float = 0.0
    failed: int = 0

    @property
    def attempted(self) -> int:
        return self.batch * len(self.lengths)


def _serve_args(cfg: dict, mix: dict, length: int, seed: int, device) -> argparse.Namespace:
    return argparse.Namespace(arch=cfg["name"], smoke=False, batch=mix["batch"], prompt_len=length,
                              gen=mix["gen"], temperature=0.0, seed=seed, device=str(device))


def window(cell, seed: int, seconds: float, device, trace=None, rt=None) -> Result:
    from torch.profiler import record_function

    from repro_torch.launch import serve

    cfg, mix = cell.cfg, cell.mix
    h = program.harness(cfg)
    params = weights.draw(cfg, seed, device)
    lengths = mix["lengths"]
    for length, s in zip(sorted(lengths), data.batch_seeds(seed, len(lengths), stream=1)):
        serve.run(_serve_args(cfg, mix, length, s, device), harness=h, params=params, rt=rt)
    schedule = data.prefill_schedule(seed, lengths, mix["max_batches"])
    seeds = data.batch_seeds(seed, mix["max_batches"], stream=2)
    res = Result(batch=mix["batch"])
    if trace is not None:
        trace.start()
    res.t_start = time.perf_counter()
    for i, (length, s) in enumerate(zip(schedule, seeds)):
        with (record_function(f"bench.batch.{i}") if trace is not None else nullcontext()):
            t0 = time.perf_counter()
            out = serve.run(_serve_args(cfg, mix, length, s, device), harness=h, params=params, rt=rt)
            t1 = time.perf_counter()
        res.lengths.append(length)
        res.seeds.append(s)
        res.ttft_s.append(t1 - t0)
        res.tokens.append(out["tokens"][:, 0].copy())
        res.logits.append(out["logits"][:, 0, :cfg["vocab_size"]].copy())
        if t1 - res.t_start >= seconds:
            res.window_s = t1 - res.t_start
            break
    else:
        raise RuntimeError(f"the window outlasted the mix's {mix['max_batches']} batches")
    if trace is not None:
        trace.stop()
    return res


def trace_context(cell, res: Result) -> dict:
    """Every batch of the window: ``(span name, batch, prompt length)``."""
    return {"batches": [(f"bench.batch.{i}", res.batch, n) for i, n in enumerate(res.lengths)]}


def _reference_logits(model, tree: dict, cell, seed: int, length: int, device) -> np.ndarray:
    prompts = data.prompts(seed, cell.mix["batch"], length, cell.cfg["vocab_size"])
    return model.last_logits(tree, torch.from_numpy(prompts).to(device)).double().cpu().numpy()


def check(cell, res: Result, seed: int, device) -> tuple[dict, dict]:
    picks = compare.sample_batches(seed, res.lengths, cell.mix["check_batches"])
    tree = weights.draw(cell.cfg, seed, device)
    model = reference.model(cell.cfg)
    served, prog_lg, ref_lg = [], [], []
    for i in picks:
        lg = _reference_logits(model, tree, cell, res.seeds[i], res.lengths[i], device)
        for r in range(res.batch):
            ref_lg.append(lg[r])
            prog_lg.append(res.logits[i][r].astype(np.float64))
            served.append(int(res.tokens[i][r]))
    return (compare.prefill_numbers(served, prog_lg, ref_lg),
            {"batches": [res.lengths[i] for i in picks], "requests": len(served)})


def control(cell, seed: int, device, fault: str | None = None) -> dict:
    """The control's numbers at ``seed``: the float8 reference's
    last-position logits and first token of the batches a window would
    sample, against the float32 reference's."""
    if fault is not None:
        raise ValueError(f"prefill has no fault {fault!r}")
    mix = cell.mix
    n = max(mix["check_batches"].values()) * len(mix["lengths"])
    lengths = data.prefill_schedule(seed, mix["lengths"], n)
    seeds = data.batch_seeds(seed, n, stream=2)
    picks = compare.sample_batches(seed, lengths, mix["check_batches"])
    tree = weights.draw(cell.cfg, seed, device)
    ref, low = reference.model(cell.cfg), reference.model(cell.cfg, "fp8")
    served, low_lg, ref_lg = [], [], []
    for i in picks:
        lo = _reference_logits(low, tree, cell, seeds[i], lengths[i], device)
        hi = _reference_logits(ref, tree, cell, seeds[i], lengths[i], device)
        for r in range(mix["batch"]):
            low_lg.append(lo[r])
            ref_lg.append(hi[r])
            served.append(int(lo[r].argmax()))
    return compare.prefill_numbers(served, low_lg, ref_lg)
