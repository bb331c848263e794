"""Pipeline parallelism — port of ``repro/parallel/pipeline.py``
(``pipelined_forward``, ``stage_split``): a GPipe microbatch pipeline.

The paper maps PP onto the inter-rack axis (P2P boundary transfers, < 0.2 %
of traffic, Table 1).  The reference runs the schedule as a ``shard_map``
over a "stage" mesh axis with ``ppermute`` boundary transfers; here each
rank of the stage axis runs its own stage and sends its activation to the
next stage's rank (``isend`` / ``irecv`` through
``collectives.Transport``).

GPipe schedule: ``n_micro + n_stages - 1`` ticks; at tick t stage s works on
microbatch t - s.  The reference has every stage compute at every tick and
keeps only the valid results; here a stage computes, sends and receives only
at the ticks that carry a microbatch, which gives the same valid results
with no compute or traffic on the empty ones.  The last stage collects.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.param import tree_map
from .collectives import Transport


def pipelined_forward(mesh, stage_axis: str, stage_fn: Callable, n_microbatches: int):
    """Build a pipelined forward over the ``stage_axis`` of ``mesh``.

    Returns fn(stage_params, x): ``stage_params`` this rank's stage of the
    ``stage_split`` tree (its leading dim ``L / n_stages``), ``x`` the
    ``(n_micro, mb, ...)`` microbatches (read on stage 0 only).  Every rank
    returns a ``(n_micro, mb, ...)`` buffer: the last stage's holds y, the
    others' zeros (as the reference's per-stage outputs are)."""
    wire: dict[str, int] = {}
    t = Transport(mesh, (stage_axis,), wire)
    n_stages, stage = t.size, t.rank

    def fn(stage_params, x: torch.Tensor) -> torch.Tensor:
        outputs = torch.zeros_like(x)
        for tick in range(n_microbatches + n_stages - 1):
            mb = tick - stage                 # the microbatch at this stage now
            if not 0 <= mb < n_microbatches:
                continue
            h = x[mb] if stage == 0 else t.irecv(x[0], stage - 1)()
            y = stage_fn(stage_params, h)
            if stage == n_stages - 1:
                outputs[mb] = y
            else:
                t.isend(y, stage + 1)()       # boundary transfer: stage i -> i + 1
        return outputs

    fn.wire_bytes = wire
    return fn


def stage_split(tree, n_stages: int):
    """Split a stacked-layer param tree (L, ...) into (n_stages, L/st, ...)."""

    def f(x):
        L = x.shape[0]
        assert L % n_stages == 0
        return x.reshape(n_stages, L // n_stages, *x.shape[1:])

    return tree_map(f, tree)
