"""Device time a training step of the kernels whose innermost span is the
MoE layer's, forward or backward: ``model.moe``, ``model.moe.route``, their
``.bwd`` and ``moe_dispatch.bwd``; the recompute is not included
(``spans.by_span``)."""

from chipbench import spans

NAMES = ("model.moe", "model.moe.route", "model.moe.bwd", "model.moe.route.bwd", "moe_dispatch.bwd")


def read(ctx):
    if not ctx["cfg"].get("num_local_experts"):
        return None
    return spans.ms_per_step(ctx, lambda n: n in NAMES)
