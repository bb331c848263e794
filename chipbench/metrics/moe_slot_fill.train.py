"""The share of the expert products' capacity slots that hold a token:
100 × ``moe.kept`` / ``moe.slots``, the program's counters over the traced
window (``spans.counts``)."""

from chipbench import spans


def read(ctx):
    if ctx["kind"] != "train" or not ctx["cfg"].get("num_local_experts"):
        return None
    c = spans.counts()
    return 100.0 * c["moe.kept"] / c["moe.slots"] if c.get("moe.slots") else None
