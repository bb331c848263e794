"""Device time a step of the kernels inside the program's ``train.compress``
and ``train.adamw`` marks (``trace.by_part``)."""

from chipbench import trace


def read(ctx):
    if ctx["kind"] != "train" or not ctx["steps"]:
        return None
    parts = trace.by_part(ctx)
    return 1e3 * (parts["train.compress"] + parts["train.adamw"]) / ctx["steps"]
