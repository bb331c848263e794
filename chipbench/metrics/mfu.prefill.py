"""The whole prefill's share of the card's bf16 peak: the model FLOPs of
the batches in the traced window (2 N T, the last token's unembedding and
attention's forward; ``work.prefill_flops``) over the window's wall time
times 989 TFLOP/s."""

from chipbench import work


def read(ctx):
    if ctx["kind"] != "prefill" or not ctx["batches"]:
        return None
    flops = sum(work.prefill_flops(ctx["cfg"], b, length) for _, b, length in ctx["batches"])
    return 100.0 * flops / (ctx["window_s"] * work.PEAK_BF16_FLOPS)
