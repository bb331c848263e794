"""Device time a training step of the kernels whose innermost span is the
unembedding or the loss, forward or backward (``model.unembed``,
``model.loss`` and their ``.bwd``; ``spans.by_span``)."""

from chipbench import spans

NAMES = ("model.unembed", "model.loss", "model.unembed.bwd", "model.loss.bwd")


def read(ctx):
    return spans.ms_per_step(ctx, lambda n: n in NAMES)
