"""The share of the (token, choice) assignments that the capacity drops:
100 × (``moe.assigned`` − ``moe.kept``) / ``moe.assigned``, the program's
counters over the traced window (``spans.counts``)."""

from chipbench import spans


def read(ctx):
    if ctx["kind"] != "train" or not ctx["cfg"].get("num_local_experts"):
        return None
    c = spans.counts()
    return 100.0 * (c["moe.assigned"] - c["moe.kept"]) / c["moe.assigned"] if c.get("moe.assigned") else None
