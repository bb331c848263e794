"""Device time a step of the kernels outside the program's ``train.compress``
and ``train.adamw`` marks: the loss and its gradients (``trace.by_part``)."""

from chipbench import trace


def read(ctx):
    if ctx["kind"] != "train" or not ctx["steps"]:
        return None
    return 1e3 * trace.by_part(ctx)["train.grad"] / ctx["steps"]
