"""Flash attention's backward in training: the least time a step needs for
it over the device time a step of the kernels whose innermost span is
``flash_attention.bwd`` (``spans.ms_per_step``, as
``flash_attention_bwd_ms.train`` reads them), so that whatever implements
the backward is read against the same work.  The least time: every layer's
backward at the step's shape as ``work.train_step_flops`` counts it, twice
the forward's operations, and twice the forward's bytes (q, o and dO read
and dq written; k and v read and dk and dv written)."""

from chipbench import readers, spans


def read(ctx):
    ms = spans.ms_per_step(ctx, lambda n: n == "flash_attention.bwd")
    if not ms:
        return None
    cfg, mix = ctx["cfg"], ctx["mix"]
    least_s = cfg["num_hidden_layers"] * 2 * readers.flash_least_seconds(cfg, mix["batch"], mix["seq"])
    return 100.0 * least_s / (ms / 1e3)
