"""The whole training step's share of the card's bf16 peak: the model FLOPs
of the steps in the traced window (6 N T and attention's forward and
backward, no recompute; ``work.train_step_flops``) over the window's wall
time times 989 TFLOP/s."""

from chipbench import work


def read(ctx):
    if ctx["kind"] != "train" or not ctx["steps"]:
        return None
    flops = ctx["steps"] * work.train_step_flops(ctx["cfg"], ctx["mix"]["batch"], ctx["mix"]["seq"])
    return 100.0 * flops / (ctx["window_s"] * work.PEAK_BF16_FLOPS)
