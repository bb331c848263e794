"""``ccu_reduce`` in training: one launch a gradient leaf and step (the int8
payload, one peer, its scale), bound by bytes; the least time of every
launch at its leaf's size over their device time."""

from chipbench import readers, work

NAMES = ("ccu_kernel",)


def read(ctx):
    if ctx["kind"] != "train":
        return None
    ks = readers.kernels_named(ctx, NAMES)
    sizes = ctx["leaf_numels"]
    if not ks:
        return None
    if len(ks) % len(sizes):
        raise RuntimeError(f"{len(ks)} ccu_reduce launches in {ctx['steps']} steps of {len(sizes)} leaves")
    least = sum(work.least_seconds(*work.ccu_reduce_work(sizes[i % len(sizes)])) for i in range(len(ks)))
    return readers.roofline_percent(least, ks)
