"""The whole training step's share of the card's bf16 peak for the
granitemoehybrid family: the model FLOPs of the steps in the traced window
(6 T times the matrix parameters a token multiplies, and three times the
scans' and attention's forward; ``models/granitemoehybrid.train_step_flops``)
over the window's wall time times 989 TFLOP/s."""

from chipbench import registry, work


def read(ctx):
    cfg = ctx["cfg"]
    if ctx["kind"] != "train" or not ctx["steps"] or cfg.get("family") != "granitemoehybrid":
        return None
    flops = ctx["steps"] * registry.family(cfg).train_step_flops(cfg, ctx["mix"]["batch"], ctx["mix"]["seq"])
    return 100.0 * flops / (ctx["window_s"] * work.PEAK_BF16_FLOPS)
