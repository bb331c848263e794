"""Gradient compression with error feedback — port of
``repro/optim/compression.py``.

Two modes around the data-parallel reduction:

* ``bf16`` — the payload cast to bf16.  No error feedback.
* ``int8`` — symmetric per-tensor quantisation of gradient plus residual,
  ``q = clip(round(acc / scale), -127, 127)`` with ``scale = max|acc| / 127``
  (rounding half to even, as the reference's), and the error
  ``acc - q * scale`` carried to the next step as the residual.

The reference's docstring names the wire format "int8 quantize -> fp32
reduce of the dequantized value", realised on real hardware by the CCU-style
reduce kernel; its train step, though, compresses the gradient that its
framework has already reduced over the data-parallel ranks
(``repro/train/train_step.py:81-83``), so what it computes is Q and deQ of
the global gradient, and no int8 crosses a link.  The port does the same:
each leaf's int8 payload goes through ``ops.ccu_reduce`` with its scale as
the one peer's dequant scale, ``0 + q * scale`` in fp32, which is
``dequantize_int8(q, scale)`` bit for bit.  A multi-rank step
(``train/train_step.py``) first sums the ranks' gradients with
``parallel.collectives.hierarchical_allreduce`` (``ccu_reduce`` over the
peers' rows, P > 1) and then compresses the full synchronised gradient here,
at P = 1.  Quantising per rank and summing the peers' int8 rows would be a
different result, and a feature the JAX package lacks.

``compress_grads`` returns the new residual, as the reference's does; the
reference's own train step drops it, the port's carries it (``launch/train.py``).
With ``use_kernels=False`` (the plain path, ``Runtime.use_kernels``) the
payload goes through ``ccu_reduce_plain`` instead, and the kernel never runs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels import ops
from ..kernels.ccu_reduce import ccu_reduce_plain
from ..models.param import tree_leaves, tree_map


@dataclass(frozen=True)
class CompressionConfig:
    mode: str = "none"          # none | bf16 | int8
    ef: bool = True             # error feedback (int8 mode)


def quantize_int8(x: torch.Tensor, amax: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``amax``, if given, stands for ``max|x|`` (of a whole tensor whose
    shard ``x`` is)."""
    scale = torch.clamp(x.abs().amax() if amax is None else amax, min=1e-12) / 127.0
    q = (x / scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compress_grads(cfg: CompressionConfig, grads, residual=None, *, use_kernels: bool = True,
                   wire: list | None = None, amax: list | None = None):
    """Returns (payload_grads, new_residual).

    int8: g' = Q(g + residual); residual' = (g + residual) - deQ(g'), the
    dequantised payload reduced by ``ccu_reduce`` (``ccu_reduce_plain`` when
    ``use_kernels`` is off).  Leaf by leaf, so the fp32 temporaries of one
    leaf are the peak; a residual passed in is updated in place and returned.
    A ``wire`` list, if given, receives each leaf's int8 values and scale
    ``(q, scale)``, in leaf order.  ``amax``, if given, holds each leaf's
    ``max|g + residual|`` in leaf order, for a caller whose leaves are
    shards of the whole gradient (the model axis of ``train/train_step.py``
    takes the max over its ranks): each scale is then the whole leaf's.
    """
    if cfg.mode == "none":
        return grads, residual
    if cfg.mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads), residual
    if cfg.mode != "int8":
        raise ValueError(cfg.mode)

    if residual is None:
        residual = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)

    reduce = ops.ccu_reduce if use_kernels else ccu_reduce_plain
    payload = {}
    leaves = zip(tree_leaves(grads), tree_leaves(residual))
    for i, (g, r) in enumerate(leaves):
        acc = g.to(torch.float32) + r if cfg.ef else g.to(torch.float32)
        q, scale = quantize_int8(acc, None if amax is None else amax[i])
        deq = reduce(q.reshape(1, -1), scale.reshape(1)).reshape(q.shape)
        if wire is not None:
            wire.append((q, scale))
        if cfg.ef:
            torch.sub(acc, deq, out=r)
        else:
            r.zero_()
        payload[id(g)] = deq
    return tree_map(lambda g: payload[id(g)], grads), residual


def wire_bytes_factor(cfg: CompressionConfig) -> float:
    """Payload-size multiplier vs fp32 — feeds the comm cost model."""
    return {"none": 1.0, "bf16": 0.5, "int8": 0.25}[cfg.mode]
