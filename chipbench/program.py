"""The system under test: the program's model of a configuration, built by
its family's file ``programs/<family>.py``.  The traffic kinds
(``kinds/<kind>.py``) drive it through the program's own entry points.
Nothing on the reference side imports this file or the program."""

from __future__ import annotations

from . import registry, weights


def harness(cfg: dict):
    """The program's model of ``cfg``; its parameter tree has to be the
    benchmark's layout (``weights.leaf_specs``), which both sides draw."""
    h = registry.module("programs", cfg["family"]).harness(cfg)
    ours = [(".".join(p), tuple(shape)) for p, shape, _, _ in weights.leaf_specs(cfg)]
    theirs = [(".".join(p), tuple(s.shape)) for p, s in weights.flatten(h.param_specs())]
    if ours != theirs:
        raise RuntimeError(f"the program's parameter tree differs from the benchmark's layout:\n"
                           f"{theirs}\n{ours}")
    return h
