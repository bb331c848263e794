"""The first cut of a backward for the port's kernels under autograd
(``flash_attention``, ``moe_dispatch``, ``ssd_scan``, ``rwkv6_scan``): the
kernel's launch in the forward, the gradient of its plain version in the
backward.  The reference's Pallas kernels have no backward (no
``custom_vjp``), so none has a hand-written backward kernel yet."""

from __future__ import annotations

import torch

from .. import spans


class PlainGradient(torch.autograd.Function):
    """``PlainGradient.apply(name, run, plain, *inputs)`` returns
    ``run(*inputs)`` (on the card the launch of the kernel ``name``; the
    tests hand it ``plain``).  The backward, inside the span ``name +
    ".bwd"`` (``spans.mark``), recomputes ``plain(*inputs)`` at the saved
    inputs (the plain versions widen to float32 inside) and returns
    ``torch.autograd.grad`` of it, for the inputs that need a gradient; the
    others (``None`` inputs, such as an initial state not given, and the
    routing's dispatch weights) get ``None``, and their part of the product
    is not formed.  An output
    whose gradient is ``None`` (the final state of a scan whose caller uses
    only ``y``) adds nothing, as a zero gradient would."""

    @staticmethod
    def forward(ctx, name, run, plain, *inputs):
        ctx.set_materialize_grads(False)
        ctx.name, ctx.plain = name, plain
        ctx.save_for_backward(*inputs)
        return run(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[3:]
        with spans.mark(ctx.name + ".bwd"):
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(n) if t is not None else None
                          for t, n in zip(ctx.saved_tensors, need)]
                outs = ctx.plain(*leaves)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
            wanted = [t for t, n in zip(leaves, need) if n]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                           allow_unused=True) if pairs else [None] * len(wanted))
            return (None, None, None, *(next(got) if n else None for n in need))
