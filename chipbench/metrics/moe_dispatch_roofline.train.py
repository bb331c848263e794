"""``moe_dispatch`` in training: disp (B, S, E, C) and x (B, S, D) into the
experts' slots (E, B, C, D), bound by bytes; the least time of every launch
over their device time."""

from chipbench import readers, work

NAMES = ("moe_dispatch_kernel", "moe_dispatch_token_kernel")


def read(ctx):
    cfg = ctx["cfg"]
    if ctx["kind"] != "train" or not cfg.get("num_local_experts"):
        return None
    ks = readers.kernels_named(ctx, NAMES)
    B, S = ctx["mix"]["batch"], ctx["mix"]["seq"]
    one = work.least_seconds(*work.moe_dispatch_work(B, S, cfg["num_local_experts"], work.moe_capacity(cfg, S),
                                                     cfg["hidden_size"], cfg["num_experts_per_tok"]))
    return readers.roofline_percent(len(ks) * one, ks)
