"""``ssd_scan``'s forward kernels in training: the least time of every
launch at the step's shape (x (B, S, H, P), B and C (B, S, N), the file's
chunk; ``scan_work.ssd_scan_work``) over their device time.  A step
launches it twice a Mamba2 layer: the forward and the recompute."""

from chipbench import readers, scan_work, work

NAMES = ("ssd_scan_tc_kernel", "ssd_scan_kernel")


def read(ctx):
    cfg = ctx["cfg"]
    if ctx["kind"] != "train" or "mamba" not in cfg.get("layer_types", ()):
        return None
    ks = readers.kernels_named(ctx, NAMES)
    one = work.least_seconds(*scan_work.ssd_scan_work(ctx["mix"]["batch"], ctx["mix"]["seq"], cfg["mamba_n_heads"],
                                                      cfg["mamba_d_head"], cfg["mamba_d_state"], cfg["mamba_chunk_size"]))
    return readers.roofline_percent(len(ks) * one, ks)
