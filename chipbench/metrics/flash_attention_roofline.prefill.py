"""Flash attention's forward kernels in prefill: the least time of every
launch at its batch's shape (q (B, L, N, Dh), k/v (B, L, K, Dh), causal,
the file's window) over their device time."""

from chipbench import readers

NAMES = ("flash_fwd_tc_kernel", "flash_fwd_simt_kernel")


def read(ctx):
    if ctx["kind"] != "prefill":
        return None
    ks = readers.kernels_named(ctx, NAMES)
    find = readers.batch_of(ctx)
    least = sum(readers.flash_least_seconds(ctx["cfg"], *find(s)) for _, s, _ in ks)
    return readers.roofline_percent(least, ks)
