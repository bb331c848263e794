"""Device time a training step of the kernels whose innermost span is a
``*.recompute`` span: the remat's recompute of the layers in the backward
(``spans.by_span``)."""

from chipbench import spans


def read(ctx):
    return spans.ms_per_step(ctx, lambda n: n.endswith(".recompute"))
