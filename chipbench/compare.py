"""The numbers that decide ``correct``: the program's readings of the timed
path against the plain reference's.  A cell's file ``checks/<workload>.json``
names the numbers it compares, each with its limit; the others are printed
under ``readings``.

Training (the checked steps, which ran through the window's own call).  A
leaf whose raw first gradient in the reference is under a thousandth of the
median leaf's moves by rounding alone and is left out of every number but
``grad_norm_gap``:

- ``loss_gap``: the largest of the checked steps' |program - reference| /
  |reference| loss;
- ``grad_norm_gap``: the worst leaf's gap between the program's and the
  reference's norm of the first gradient as AdamW gets it, over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
- ``update_norm_gap``: the same of the norm of the parameters' change after
  the checked steps;
- ``grad_dist_worst``, ``grad_dist_median``: each leaf's distance between
  the program's and the reference's raw first gradient, element by element
  over a sample of the leaf drawn from the seed (``weights.sample_index``),
  over the larger of the reference's norm of the sample and the median
  leaf's; the worst leaf, or the median.  A gap of norms barely moves under
  rounding that is independent from element to element, which a precision
  lower than the configuration's adds; a distance does;
- ``update_dist_worst``, ``update_dist_median``: the same of the parameters'
  change after the checked steps, on the same elements.  Under Adam a
  leaf's change has about the same norm whatever the signs of its
  gradient, so only a distance sees an update that moved the wrong way or
  the wrong elements.

Prefill (whole batches of the window drawn from the seed, every length in
them):

- ``logit_gap``: the worst request's |program - reference| over the
  reference's norm of its last position's logits (the whole vocabulary);
- ``served_gap``: the widest gap by which a served token's logit lies below
  the reference's best at that position.
"""

from __future__ import annotations

import statistics

import numpy as np


def _leaf_gap(program: list[float], reference: list[float], keep: list[bool]) -> float:
    floor = statistics.median(reference)
    gaps = [abs(p - r) / max(r, floor) for p, r, k in zip(program, reference, keep) if k]
    return max(gaps) if gaps else 0.0


def moving(ref: dict) -> list[bool]:
    """The leaves the rule keeps: the reference's raw first gradient at least
    a thousandth of the median leaf's."""
    floor = statistics.median(ref["grad_norms"])
    return [g >= 1e-3 * floor for g in ref["grad_norms"]]


def leaf_dists(program: list, reference: list, keep: list[bool]) -> list[float | None]:
    """Each leaf's distance of two sides' sampled elements over the larger of
    the reference sample's norm and the median leaf's (None for a leaf the
    rule leaves out)."""
    norms = [float(np.linalg.norm(np.asarray(r, np.float64))) for r in reference]
    floor = statistics.median(norms)
    return [float(np.linalg.norm(np.asarray(p, np.float64) - np.asarray(r, np.float64))) / max(n, floor)
            if k else None
            for p, r, n, k in zip(program, reference, norms, keep)]


def train_numbers(prog, ref: dict) -> dict[str, float]:
    keep = moving(ref)
    grad = [d for d in leaf_dists(prog.grad_samples, ref["grad_samples"], keep) if d is not None]
    change = [d for d in leaf_dists(prog.change_samples, ref["change_samples"], keep) if d is not None]
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog.losses, ref["losses"])),
        "grad_norm_gap": _leaf_gap(prog.payload_norms, ref["payload_norms"], [True] * len(keep)),
        "update_norm_gap": _leaf_gap(prog.change_norms, ref["change_norms"], keep),
        "grad_dist_worst": max(grad),
        "grad_dist_median": statistics.median(grad),
        "update_dist_worst": max(change),
        "update_dist_median": statistics.median(change),
    }


def train_leaf_readings(prog, ref: dict) -> dict:
    """Each leaf's two distances, by path."""
    keep = moving(ref)
    return {"leaf_grad_dist": dict(zip(ref["paths"], leaf_dists(prog.grad_samples, ref["grad_samples"], keep))),
            "leaf_update_dist": dict(zip(ref["paths"],
                                         leaf_dists(prog.change_samples, ref["change_samples"], keep)))}


def sample_batches(seed: int, lengths: list[int], counts: dict) -> list[int]:
    """Indices of whole batches of the window drawn from the seed:
    ``counts[str(length)]`` batches of each length (all there are where the
    window holds fewer)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 11]))
    pick: list[int] = []
    for length, n in sorted(counts.items(), key=lambda kv: int(kv[0])):
        have = [i for i, x in enumerate(lengths) if x == int(length)]
        pick += [have[j] for j in sorted(rng.choice(len(have), size=min(n, len(have)), replace=False))]
    return sorted(pick)


def prefill_numbers(served: list[int], program_logits: list[np.ndarray], reference_logits: list[np.ndarray]) -> dict:
    logit, gap = 0.0, 0.0
    for tok, lp, lr in zip(served, program_logits, reference_logits):
        logit = max(logit, float(np.linalg.norm(lp - lr) / np.linalg.norm(lr)))
        gap = max(gap, float(lr.max() - lr[tok]))
    return {"logit_gap": logit, "served_gap": gap}


def judge(numbers: dict[str, float], checks: dict) -> tuple[bool, dict]:
    """``correct`` and each number beside its limit; a number that is not
    finite fails."""
    out, ok = {}, True
    for name, limit in checks["limits"].items():
        value = numbers[name]
        out[name] = {"value": value, "limit": limit}
        ok = ok and bool(np.isfinite(value)) and value <= limit
    return ok, out
