"""Flash attention's forward kernels in training: the least time of every
launch at the step's shape (q (B, S, N, Dh), k/v (B, S, K, Dh), causal, the
file's window) over their device time."""

from chipbench import readers

NAMES = ("flash_fwd_tc_kernel", "flash_fwd_simt_kernel")


def read(ctx):
    if ctx["kind"] != "train":
        return None
    ks = readers.kernels_named(ctx, NAMES)
    least = len(ks) * readers.flash_least_seconds(ctx["cfg"], ctx["mix"]["batch"], ctx["mix"]["seq"])
    return readers.roofline_percent(least, ks)
