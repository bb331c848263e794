"""Traffic of the kind ``train``: pretraining steps of a mix's ``batch``
sequences of ``seq`` tokens through the program's ``launch/train.run``, the
program's own synthetic data stream.

``window`` makes one call of ``train.run`` that holds the checked steps,
whose readings the reference checks, and the measured window: the same
model and optimizer state go on from one to the other.  The program's
per-step hook ``observe`` (called after the gradients' compression, at a
synchronised point) reads the first ``check_steps`` steps, starts the
window at step ``check_steps`` and ends the run at the first step after
``seconds`` by raising.  ``check`` runs the plain reference over the
checked steps after the window (``compare.train_numbers``).
"""

from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass, field

import torch

from chipbench import compare, program, reference, weights

FAULTS = ("half_batch",)


class WindowClosed(Exception):
    """Raised from ``train.run``'s per-step hook to end the run once the
    window has closed."""


def _check_optimizer(cfg: dict) -> None:
    """The optimizer settings the file states are the program's."""
    from repro_torch.optim.adamw import OptConfig

    want = cfg["training"]["optimizer"]
    have = OptConfig(lr=want["lr"], warmup_steps=want["warmup_steps"])
    for key in ("b1", "b2", "eps", "weight_decay", "min_lr_ratio", "clip_norm"):
        if getattr(have, key) != want[key]:
            raise RuntimeError(f"the program's AdamW has {key}={getattr(have, key)}, the file {want[key]}")
    if have.grad_dtype != getattr(torch, want["grad_dtype"]):
        raise RuntimeError(f"the program's AdamW rounds gradients to {have.grad_dtype}")


@dataclass
class Result:
    losses: list = field(default_factory=list)        # the checked steps' losses
    payload_norms: list | None = None                 # step 0's gradient as AdamW gets it, a norm a leaf
    grad_samples: list | None = None                  # step 0's raw gradient, each leaf's sampled elements
    change_norms: list | None = None                  # the params' change after the checked steps
    change_samples: list | None = None                # ... each leaf's sampled elements
    steps: int = 0                                    # steps in the window
    tokens: int = 0
    t_start: float = 0.0                              # perf_counter at the window's start
    window_s: float = 0.0
    failed: int = 0                                   # window steps whose loss is not finite

    @property
    def attempted(self) -> int:
        return self.steps


def window(cell, seed: int, seconds: float, device, trace=None, rt=None) -> Result:
    from repro_torch.launch import train

    cfg, mix = cell.cfg, cell.mix
    _check_optimizer(cfg)
    h = program.harness(cfg)
    params = weights.draw(cfg, seed, device)
    n_check = mix["check_steps"]
    opt = cfg["training"]["optimizer"]
    args = argparse.Namespace(
        arch=cfg["name"], smoke=False, n_layers=None, auto_parallel=False, lr=opt["lr"],
        steps=10**6, batch=mix["batch"], seq=mix["seq"], compression=cfg["training"]["compression"],
        ckpt_dir=None, ckpt_every=10**9, log_every=10**9, seed=seed, device=str(device))
    res = Result()

    def observe(step, loss, grads, payload, wire):
        if step < n_check:
            res.losses.append(float(loss))
            if step == 0:
                res.payload_norms = [float(torch.linalg.vector_norm(g.float())) for _, g in weights.flatten(payload)]
                res.grad_samples = weights.samples(cfg, seed, grads)
            return
        if step == n_check:
            res.change_norms, res.change_samples = [], []
            with torch.no_grad():
                for i, (_, p) in enumerate(weights.flatten(params)):
                    c = p.float() - weights.draw_leaf(cfg, seed, i, device).float()
                    res.change_norms.append(float(torch.linalg.vector_norm(c)))
                    res.change_samples.append(weights.sample(cfg, seed, i, c))
                    del c
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            if trace is not None:
                trace.start()
            res.t_start = time.perf_counter()
            return
        now = time.perf_counter()
        res.failed += not bool(torch.isfinite(loss))
        if now - res.t_start >= seconds:
            res.window_s = now - res.t_start
            res.steps = step - n_check
            res.tokens = res.steps * mix["batch"] * mix["seq"]
            if trace is not None:
                trace.stop()
            raise WindowClosed

    try:
        train.run(args, harness=h, params=params, observe=observe, rt=rt)
    except WindowClosed:
        return res
    raise RuntimeError("train.run ended before the window closed")


def trace_context(cell, res: Result) -> dict:
    """What the training metrics read beside the trace: whole steps in the
    window and each gradient leaf's size, in the order the program
    compresses them."""
    return {"steps": res.steps, "leaf_numels": [math.prod(s[1]) for s in weights.leaf_specs(cell.cfg)]}


def check(cell, res: Result, seed: int, device) -> tuple[dict, dict]:
    ref = reference.train_readings(cell.cfg, cell.mix, seed, device, steps=cell.mix["check_steps"])
    return compare.train_numbers(res, ref), compare.train_leaf_readings(res, ref)


def control(cell, seed: int, device, fault: str | None = None) -> dict:
    """The control's numbers at ``seed``: the float8 reference's checked
    steps against the float32 reference's; with ``fault="half_batch"`` the
    float32 reference with half of its batch left out in the program's
    place instead."""
    steps = cell.mix["check_steps"]
    ref = reference.train_readings(cell.cfg, cell.mix, seed, device, steps=steps)
    low = reference.train_readings(cell.cfg, cell.mix, seed, device, steps=steps,
                                   precision="fp32" if fault else "fp8", half_batch=fault == "half_batch")
    as_program = argparse.Namespace(**{k: low[k] for k in ("losses", "payload_norms", "change_norms",
                                                            "grad_samples", "change_samples")})
    return {**compare.train_numbers(as_program, ref), **compare.train_leaf_readings(as_program, ref)}
