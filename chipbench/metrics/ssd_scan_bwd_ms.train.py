"""Device time a training step of the kernels whose innermost span is
``ssd_scan.bwd``: the Mamba2 scan's backward (today the plain version's
gradient, recomputed; ``spans.by_span``)."""

from chipbench import spans


def read(ctx):
    if "mamba" not in ctx["cfg"].get("layer_types", ()):
        return None
    return spans.ms_per_step(ctx, lambda n: n == "ssd_scan.bwd")
