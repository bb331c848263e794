"""Device time a training step of the kernels whose innermost span is
``flash_attention.bwd``: flash attention's backward (today the plain
version's gradient, recomputed; ``spans.by_span``)."""

from chipbench import spans


def read(ctx):
    return spans.ms_per_step(ctx, lambda n: n == "flash_attention.bwd")
