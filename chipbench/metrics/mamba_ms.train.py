"""Device time a training step of the kernels whose innermost span is a
Mamba2 mixer's, forward or backward: ``model.mamba``, ``model.mamba.bwd``
and the scan's backward ``ssd_scan.bwd``; the recompute is not included
(``spans.by_span``)."""

from chipbench import spans

NAMES = ("model.mamba", "model.mamba.bwd", "ssd_scan.bwd")


def read(ctx):
    if "mamba" not in ctx["cfg"].get("layer_types", ()):
        return None
    return spans.ms_per_step(ctx, lambda n: n in NAMES)
