"""The yardstick's arithmetic for the Mamba2 chunked scan (``ssd_scan``):
the operations and bytes the function needs at a call's shapes, for the
metric readers.  Written for the benchmark, beside ``work.py``; it counts
what the function needs, not what a kernel does, so that a later kernel
for the same function is read against the same work.
"""

from __future__ import annotations


def ssd_scan_work(batch: int, seq: int, heads: int, head_dim: int, state: int, chunk: int,
                  elem_bytes: int = 2) -> tuple[float, float]:
    """(flops, bytes) of one chunked SSD scan, x (B, S, H, P), log_l
    (B, S, H) fp32, B and C (B, S, N) shared by the heads, y (B, S, H, P)
    and the final state (B, H, P, N) fp32, chunks of ``chunk`` rows (the
    last one ragged).  Operations, 2 a multiply-add: the scores C B^T over
    each chunk's causal pairs, once a chunk and batch row; att x over the
    same pairs, a head and column of P each; C h and the state update, a
    row, head, column of P and column of N each.  Bytes: x and y, log_l,
    B and C and the final state, each moved once."""
    pairs = sum(q * (q + 1) // 2 for q in (min(chunk, seq - s0) for s0 in range(0, seq, chunk)))
    flops = 2 * batch * pairs * state + 2 * batch * pairs * heads * head_dim \
        + 2 * 2 * batch * seq * heads * head_dim * state
    x = batch * seq * heads * head_dim * elem_bytes
    nbytes = 2 * x + batch * seq * heads * 4 + 2 * batch * seq * state * elem_bytes \
        + batch * heads * head_dim * state * 4
    return float(flops), float(nbytes)
